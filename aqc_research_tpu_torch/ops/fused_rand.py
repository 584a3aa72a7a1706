"""Fused randomized-projection pair update (twin of
``aqc_research_tpu/ops/fused_rand.py``): the rand route of the MPS engine.

  pass A (kernel)  θ build — ops/fused_pair.theta_build (csrc/theta_build.cu);
  middle (torch)   the HMT range-finder and projection B = Q^H θ
                   (ops/rand_svd._range_project);
  pass C (kernel)  :func:`rand_tail` (csrc/rand_tail.cu): the reduced
                   one-sided Jacobi on conj(B), the stable top-chi selection,
                   the 32 eps noise guard, the discarded-weight rule against
                   the FULL θ weight, λ, 1/s and the vh rows;
  tail (torch)     u = θ vhᴴ diag(1/s) in one product, then the Vidal gauge
                   scalings.

The kernel sees only the projected (l, n) problem, but the truncation rule
and the norm rescale are defined against the full θ Frobenius weight
(ops/mps._pair_update): pass A's output gives it in one reduction.

Dispatch rule of :func:`rand_tail`: CPU tensors go to the plain twin
:func:`rand_tail_reference`, CUDA tensors to the kernel — no fallback in
between; the kernel route raises on anything it does not take.  The planes
live where :func:`tail_plane_home` puts them: on the path shapes (chi = 64
and 128) in the shared memory of a thread-block cluster per matrix, with
the epilogue spread over its CTAs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import jacobi_criterion
from . import cuda_build, rand_svd
from .fused_pair import _prep_planes, theta_build
from .jacobi_kernel import jacobi_rows_reference, launch_shape, plane_home, rank_truncate_reference
from .jacobi_svd import DEFAULT_SWEEPS


def rand_tail_reference(
    m_re: torch.Tensor,
    m_im: torch.Tensor,
    tot2: torch.Tensor,
    thr2: float,
    chi: int,
    max_sweeps: int = DEFAULT_SWEEPS,
    criterion: str | None = None,
):
    """Plain-torch twin of the kernel.  ``m_re``/``m_im``: the (B, l, n) f32
    planes (Re B, -Im B); ``tot2``: (B,) full θ weight; ``thr2``: trunc_thr².

    Returns (vh_re, vh_im (B, chi, n), lam (B, chi), inv (B, chi), sweeps
    (B,) int32): the masked vh rows, the truncated and rescaled singular
    values, the mask-safe 1/s and each matrix's sweep count."""
    w_re, w_im, sweeps = jacobi_rows_reference(m_re, m_im, max_sweeps, criterion)
    ws_re, ws_im, lam, inv = rank_truncate_reference(w_re, w_im, tot2, thr2, chi)
    return ws_re * inv[..., None], -(ws_im * inv[..., None]), lam, inv, sweeps


def tail_extra_bytes(ell: int, chi: int) -> int:
    """Shared memory of the epilogue's arrays beside the planes: the row
    norms, the selected values, 1/s and the selected rows (ell + 3 chi
    floats, csrc/rank_truncate.cuh)."""
    return 4 * (ell + 3 * chi)


def tail_plane_home(ell: int, n: int, chi: int, max_smem: int) -> str:
    """Where the (l, n) planes live: ops/jacobi_kernel.plane_home on l rows
    of n lanes, beside the epilogue's arrays (every CTA of a cluster holds
    all of them)."""
    return plane_home(ell, n, max_smem, tail_extra_bytes(ell, chi))


def tail_cluster_occupancy(ell: int, n: int, chi: int, cluster: int, dev: int = 0) -> int:
    """Clusters of K3's cluster home at (l, n, chi, cluster) that card
    ``dev`` keeps resident at once (cudaOccupancyMaxActiveClusters); raises
    on an error."""
    with torch.cuda.device(dev):
        got = int(cuda_build.load().rand_tail_cluster_occupancy(ell, n, chi, cluster))
    if got < 0:
        raise RuntimeError(f"rand_tail_cluster_occupancy failed: CUDA error {-got}")
    return got


def check_tail_args(m_re, m_im, tot2, chi: int) -> None:
    """Raises ValueError unless the inputs are what the kernel takes (any
    size: planes that do not fit shared memory stay in device memory)."""
    if any(t.dtype != torch.float32 for t in (m_re, m_im, tot2)):
        raise ValueError(f"rand_tail takes float32 planes and weights, got {m_re.dtype}/{m_im.dtype}/{tot2.dtype}")
    if m_re.ndim != 3 or m_re.shape != m_im.shape or tuple(tot2.shape) != (m_re.shape[0],):
        raise ValueError(
            f"rand_tail takes two (B, l, n) planes and (B,) weights, got "
            f"{tuple(m_re.shape)}/{tuple(m_im.shape)}/{tuple(tot2.shape)}"
        )
    if m_im.device != m_re.device or tot2.device != m_re.device:
        raise ValueError("rand_tail: inputs on different devices")
    if not (m_re.is_contiguous() and m_im.is_contiguous() and tot2.is_contiguous()):
        raise ValueError("rand_tail takes contiguous inputs")
    _, ell, n = m_re.shape
    if ell < 2 or ell % 2 or n < ell or not 1 <= chi <= ell:
        raise ValueError(f"rand_tail needs an even l >= 2, n >= l and 1 <= chi <= l, got l={ell} n={n} chi={chi}")


def rand_tail(
    m_re: torch.Tensor,
    m_im: torch.Tensor,
    tot2: torch.Tensor,
    thr2: float,
    chi: int,
    max_sweeps: int = DEFAULT_SWEEPS,
    criterion: str | None = None,
    *,
    home: str | None = None,
    cluster: int | None = None,
):
    """Reduced Jacobi + selection + truncation + vh rows of the rand route
    (see :func:`rand_tail_reference` for the contract).

    CPU tensors run the plain twin; CUDA tensors launch the kernel, the
    planes where :func:`tail_plane_home` puts them (``home``/``cluster``
    choose another home or cluster size, for A/B timings and the card
    tests; the engine never passes them), and every launch adds one to
    ``rand_tail.launches``, ``rand_tail.launches_at[n]`` and
    ``rand_tail.launches_home[home]``; any other device raises, and so does
    a launch the card refuses."""
    criterion = criterion or jacobi_criterion()
    if m_re.device.type == "cpu":
        return rand_tail_reference(m_re, m_im, tot2, thr2, chi, max_sweeps, criterion)
    if m_re.device.type != "cuda":
        raise ValueError(f"rand_tail: unsupported device {m_re.device}")
    check_tail_args(m_re, m_im, tot2, chi)
    dev = cuda_build.device_index(m_re)
    b, ell, n = m_re.shape
    home = home or tail_plane_home(ell, n, chi, cuda_build.max_smem(dev))
    code, threads, ctas = launch_shape(ell, home, cluster)
    # Planes in device memory are rotated in place in a scratch pair.
    wk_re, wk_im = (torch.empty_like(m_re), torch.empty_like(m_im)) if home == "global" else (None, None)
    vh_re = torch.empty((b, chi, n), dtype=torch.float32, device=m_re.device)
    vh_im = torch.empty_like(vh_re)
    lam = torch.empty((b, chi), dtype=torch.float32, device=m_re.device)
    inv = torch.empty_like(lam)
    sweeps = torch.empty(b, dtype=torch.int32, device=m_re.device)
    if b == 0:
        return vh_re, vh_im, lam, inv, sweeps
    cuda_build.launch(
        "rand_tail_launch", dev,
        m_re.data_ptr(), m_im.data_ptr(), tot2.data_ptr(),
        None if wk_re is None else wk_re.data_ptr(), None if wk_im is None else wk_im.data_ptr(),
        vh_re.data_ptr(), vh_im.data_ptr(), lam.data_ptr(), inv.data_ptr(), sweeps.data_ptr(),
        b, ell, n, chi, int(max_sweeps), int(criterion == "hybrid"), float(thr2), threads, code, ctas,
    )
    rand_tail.launches += 1
    rand_tail.launches_at[n] = rand_tail.launches_at.get(n, 0) + 1
    rand_tail.launches_home[home] = rand_tail.launches_home.get(home, 0) + 1
    return vh_re, vh_im, lam, inv, sweeps


rand_tail.launches = 0
rand_tail.launches_at = {}
rand_tail.launches_home = {}


def fused_rand_pair_update(
    lam_l, lam_c, lam_r, g1, g2, gate4, chi: int, trunc_thr: float, dtype, rdtype,
    sweeps: int = DEFAULT_SWEEPS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rand-route computation of ops.mps._pair_update (same contract:
    ``lam_*`` (..., chi), ``g1/g2`` (..., 2, chi, chi), ``gate4`` (..., 4,
    4); returns (new_g1, new_g2, new_lam)).  complex64 only; the caller
    checks the shape guards (ops.mps._fused_rand_eligible)."""
    from .mps import _safe_inv

    batch_shape, b_count, ll, lr, a_re, a_im, b_re, b_im, gate_planes = _prep_planes(
        lam_l, lam_c, lam_r, g1, g2, gate4, chi, dtype
    )
    n = 2 * chi
    ell = rand_svd.rand_ell(n, chi)

    # ---- pass A: θᵀ planes ----
    w0_re, w0_im = theta_build(gate_planes, a_re, a_im, b_re, b_im)

    # ---- middle: range-finder + projection on θ = W0ᵀ ----
    a = torch.complex(w0_re, w0_im).transpose(-1, -2)
    total2 = (w0_re * w0_re + w0_im * w0_im).sum((-2, -1))
    bm = rand_svd._range_project(a, ell, rand_svd._POWER_ITERS, intermediate=rand_svd._INTERMEDIATE)
    m_re = bm.real.contiguous()
    m_im = (-bm.imag).contiguous()

    # ---- pass C: reduced Jacobi + truncation + vh rows ----
    vh_re, vh_im, lam, inv, _ = rand_tail(m_re, m_im, total2, float(trunc_thr) ** 2, chi, sweeps)

    # ---- tail: u = θ vhᴴ diag(1/s), then the gauge scalings ----
    vh = torch.complex(vh_re, vh_im).to(dtype)
    u = torch.matmul(a.to(dtype), vh.conj().transpose(-1, -2)) * inv[:, None, :].to(dtype)
    inv_l = _safe_inv(ll).to(dtype)
    inv_r = _safe_inv(lr).to(dtype)
    new_g1 = u.reshape((b_count, 2, chi, chi)) * inv_l[:, None, :, None]
    new_g2 = vh.reshape((b_count, chi, 2, chi)).transpose(-3, -2) * inv_r[:, None, None, :]
    return (
        new_g1.reshape(batch_shape + (2, chi, chi)),
        new_g2.reshape(batch_shape + (2, chi, chi)),
        lam.to(rdtype).reshape(batch_shape + (chi,)),
    )
