"""The θ build of the fused pair updates: the hand-written CUDA kernel
``csrc/theta_build.cu`` and its plain-torch twin.

Twin of the θ-build part of ``aqc_research_tpu/ops/fused_pair.py``: the
kernel replaces the Pallas TPU kernel ``theta_build_raw`` (body
``_theta_build``), pass A of the fused randomized-projection pair update
(ops/fused_rand.py); :func:`_prep_planes` is ported from the same module.
The fused half-layer megakernel ``_fused_pair_raw`` is not ported yet.

Dispatch rule of :func:`theta_build`: CPU tensors go to the plain twin
:func:`theta_build_reference`, CUDA tensors to the kernel — no fallback in
between; the kernel route raises on anything it does not take.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import cuda_build


def _prep_planes(lam_l, lam_c, lam_r, g1, g2, gate4, chi: int, dtype):
    """Flattens the batch and builds the θ-build input planes: the λ-scaled
    transposed Γ planes ``a[u][b, a'] = g1[u, a', b] lam_l[a'] lam_c[b]`` and
    ``bm[v][c, b] = g2[v, b, c] lam_r[c]`` as re/im f32 (B, 2, chi, chi), and
    the flat gate table (B, 32) (re of the 4x4 gate, then im).

    Returns (batch_shape, B, lam_l, lam_r (both (B, chi)), a_re, a_im, b_re,
    b_im, gate_planes)."""
    batch_shape = tuple(g1.shape[:-3])
    b_count = math.prod(batch_shape)
    g1f = g1.reshape((b_count, 2, chi, chi))
    g2f = g2.reshape((b_count, 2, chi, chi))
    ll = lam_l.broadcast_to(batch_shape + (chi,)).reshape((b_count, chi))
    lc = lam_c.broadcast_to(batch_shape + (chi,)).reshape((b_count, chi))
    lr = lam_r.broadcast_to(batch_shape + (chi,)).reshape((b_count, chi))
    g4 = gate4.to(dtype).broadcast_to(batch_shape + (4, 4)).reshape((b_count, 4, 4))

    a = g1f.transpose(-1, -2) * lc[:, None, :, None].to(dtype) * ll[:, None, None, :].to(dtype)
    bm = g2f.transpose(-1, -2) * lr[:, None, :, None].to(dtype)

    def planes(x):
        return x.real.to(torch.float32).contiguous(), x.imag.to(torch.float32).contiguous()

    a_re, a_im = planes(a)
    b_re, b_im = planes(bm)
    gate_planes = torch.cat([g4.real.reshape(b_count, 16), g4.imag.reshape(b_count, 16)], dim=-1)
    gate_planes = gate_planes.to(torch.float32).contiguous()
    return batch_shape, b_count, ll, lr, a_re, a_im, b_re, b_im, gate_planes


def theta_build_reference(
    gate_planes: torch.Tensor,
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    b_re: torch.Tensor,
    b_im: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel: ``W0[t*chi + c, s*chi + a'] =
    sum_uv gate[(s,t),(u,v)] (bm[v] @ a[u])[c, a']`` in complex64, returned
    as re/im f32 planes (B, 2chi, 2chi)."""
    b, _, chi, _ = a_re.shape
    a = torch.complex(a_re, a_im)  # [b, u, x, a']
    bm = torch.complex(b_re, b_im)  # [b, v, c, x]
    g = torch.complex(gate_planes[:, :16], gate_planes[:, 16:]).reshape(b, 2, 2, 2, 2)
    prods = torch.einsum("bvcx,buxa->buvca", bm, a)
    w = torch.einsum("bstuv,buvca->btcsa", g, prods)
    w0 = w.reshape(b, 2 * chi, 2 * chi)
    return w0.real.contiguous(), w0.imag.contiguous()


def check_theta_args(gate_planes, a_re, a_im, b_re, b_im) -> None:
    """Raises ValueError unless the inputs are what the kernel takes."""
    planes = (a_re, a_im, b_re, b_im)
    if any(t.dtype != torch.float32 for t in (gate_planes, *planes)):
        raise ValueError("theta_build takes float32 planes and gate table")
    shape = a_re.shape
    if len(shape) != 4 or shape[1] != 2 or shape[2] != shape[3] or any(t.shape != shape for t in planes):
        raise ValueError(
            f"theta_build takes four (B, 2, chi, chi) planes, got {[tuple(t.shape) for t in planes]}"
        )
    if tuple(gate_planes.shape) != (shape[0], 32):
        raise ValueError(f"theta_build takes a (B, 32) gate table, got {tuple(gate_planes.shape)}")
    if any(t.device != a_re.device for t in (gate_planes, *planes)):
        raise ValueError("theta_build: inputs on different devices")
    if not all(t.is_contiguous() for t in (gate_planes, *planes)):
        raise ValueError("theta_build takes contiguous inputs")
    if not 1 <= shape[0] <= 65535:
        raise ValueError(f"theta_build takes 1 to 65535 matrices, got {shape[0]}")


def theta_build(
    gate_planes: torch.Tensor,
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    b_re: torch.Tensor,
    b_im: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The θᵀ planes (B, 2chi, 2chi) of a batch of pair updates from the
    :func:`_prep_planes` outputs — see :func:`theta_build_reference`.

    CPU tensors run the plain twin; CUDA tensors launch the kernel and every
    launch adds one to ``theta_build.launches``; any other device raises."""
    if a_re.device.type == "cpu":
        return theta_build_reference(gate_planes, a_re, a_im, b_re, b_im)
    if a_re.device.type != "cuda":
        raise ValueError(f"theta_build: unsupported device {a_re.device}")
    check_theta_args(gate_planes, a_re, a_im, b_re, b_im)
    b, _, chi, _ = a_re.shape
    w0_re = torch.empty((b, 2 * chi, 2 * chi), dtype=torch.float32, device=a_re.device)
    w0_im = torch.empty_like(w0_re)
    cuda_build.launch(
        "theta_build_launch", cuda_build.device_index(a_re),
        gate_planes.data_ptr(), a_re.data_ptr(), a_im.data_ptr(), b_re.data_ptr(),
        b_im.data_ptr(), w0_re.data_ptr(), w0_im.data_ptr(), b, chi,
    )
    theta_build.launches += 1
    return w0_re, w0_im


theta_build.launches = 0
