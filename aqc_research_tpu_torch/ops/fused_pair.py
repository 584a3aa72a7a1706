"""The fused pair updates' hand-written CUDA kernels and their plain-torch
twins (twin of ``aqc_research_tpu/ops/fused_pair.py``):

* K2 :func:`theta_build` (``csrc/theta_build.cu``, replaces the Pallas
  kernel ``theta_build_raw``): the gated θᵀ planes, pass A of the fused
  randomized-projection pair update (ops/fused_rand.py);
* K4 :func:`fused_pair` (``csrc/fused_pair.cu``, replaces
  ``_fused_pair_raw``): θ build, adaptive Jacobi, selection, truncation and
  both factors in one kernel — the jacobi route's pair update at χ >= 96
  on CUDA (:func:`fused_pair_update`, dispatched by ops/mps._pair_update
  under ``config.fused_pair_enabled``).

:func:`_prep_planes` is ported from the same module.  Dispatch rule of both
wrappers: CPU tensors go to the plain twin, CUDA tensors to the kernel — no
fallback in between; the kernel route raises on anything it does not take.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import jacobi_criterion
from . import cuda_build
from .jacobi_kernel import (
    BLOCK_ROWS,
    block_ctas,
    block_jacobi_rows_reference,
    jacobi_rows_reference,
    rank_truncate_reference,
)
from .jacobi_svd import DEFAULT_SWEEPS


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


def check_theta_args(gate_planes, a_re, a_im, b_re, b_im, name: str = "theta_build") -> None:
    """Raises ValueError unless the inputs are what the kernel ``name``
    takes (K2 and K4 take the same inputs)."""
    planes = (a_re, a_im, b_re, b_im)
    if any(t.dtype != torch.float32 for t in (gate_planes, *planes)):
        raise ValueError(f"{name} takes float32 planes and gate table")
    shape = a_re.shape
    if len(shape) != 4 or shape[1] != 2 or shape[2] != shape[3] or any(t.shape != shape for t in planes):
        raise ValueError(
            f"{name} takes four (B, 2, chi, chi) planes, got {[tuple(t.shape) for t in planes]}"
        )
    if tuple(gate_planes.shape) != (shape[0], 32):
        raise ValueError(f"{name} takes a (B, 32) gate table, got {tuple(gate_planes.shape)}")
    if any(t.device != a_re.device for t in (gate_planes, *planes)):
        raise ValueError(f"{name}: inputs on different devices")
    if not all(t.is_contiguous() for t in (gate_planes, *planes)):
        raise ValueError(f"{name} takes contiguous inputs")
    if not 1 <= shape[0] <= 65535:
        raise ValueError(f"{name} takes 1 to 65535 matrices, got {shape[0]}")


def theta_tile_edge(batch: int, chi: int, sms: int) -> int:
    """K2's output tile edge (csrc/theta_build.cu; 256 threads a block
    either way): 32, with a 2x2 micro-tile a thread, where the batch's 32x32
    tiles outnumber the card's ``sms`` SMs, else 16, one position a thread,
    so that a half-layer batch fills the card: B=14 chi=128 takes 224
    blocks of 32, B=10 chi=64 160 blocks of 16."""
    return 32 if batch * math.ceil(chi / 32) ** 2 > sms else 16


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
    dev = cuda_build.device_index(a_re)
    b, _, chi, _ = a_re.shape
    w0_re = torch.empty((b, 2 * chi, 2 * chi), dtype=torch.float32, device=a_re.device)
    w0_im = torch.empty_like(w0_re)
    cuda_build.launch(
        "theta_build_launch", dev,
        gate_planes.data_ptr(), a_re.data_ptr(), a_im.data_ptr(), b_re.data_ptr(),
        b_im.data_ptr(), w0_re.data_ptr(), w0_im.data_ptr(), b, chi,
        theta_tile_edge(b, chi, cuda_build.sm_count(dev)),
    )
    theta_build.launches += 1
    theta_build.launches_at[2 * chi] = theta_build.launches_at.get(2 * chi, 0) + 1
    return w0_re, w0_im


theta_build.launches = 0
theta_build.launches_at = {}


# -----------------------------------------------------------------------------
# K4: the fused pair update of the jacobi route.
# -----------------------------------------------------------------------------

# Static shared memory of every K4 block: the gate table and the go flag
# (the tile groups' buffers share the dynamic shared memory with the planes).
_FUSED_STATIC_SMEM = 256
# One tile group's buffers (csrc/fused_pair.cu TileBuf: two cp.async stages
# of a 32-wide θ k-tile, csrc/theta_tiles.cuh), in floats.
_TILE_BUF_FLOATS = 2 * 4 * 16 * (32 + 2) + 2 * 4 * 16 * 32
_TILE_THREADS = 256
# K4's cluster path (csrc/block_sweeps.cuh): the largest matrix it takes
# (2chi rows of 2chi lanes, 8 entries per lane), a warp per row of a block
# (two 256-thread tile groups) and three block buffers per CTA.
FUSED_CLUSTER_MAX_ROWS = 256
FUSED_CLUSTER_THREADS = 32 * BLOCK_ROWS
_BLOCK_BUFFERS = 3
_BLOCK_STATS_FLOATS = 2 * BLOCK_ROWS + 2
# Dynamic shared memory one block may use on an H100: the card the CPU twin
# stands in for when it picks K4's schedule (fused_schedule).
H100_MAX_SMEM = 232448
_HOME_CODES = {"shared": 0, "cluster": 1, "global": 2}
# The order of K4's sweeps on each home: csrc/block_sweeps.cuh on the
# cluster, the Brent-Luk round robin of csrc/seat_sweeps.cuh elsewhere.
_SCHEDULES = {"shared": "ring", "cluster": "block", "global": "ring"}


def _head_floats(stats: int, chi: int) -> int:
    """Shared floats ahead of the planes: the sweeps' statistics and the
    epilogue's arrays (2chi + 3chi), rounded up to 16 bytes."""
    return -(-(stats + 2 * chi + 3 * chi) // 4) * 4


def fused_smem_bytes(chi: int, home: str) -> int:
    """Dynamic shared memory of one K4 block per matrix (the "shared" and
    "global" homes of csrc/fused_pair.cu): statistics and epilogue arrays,
    then the larger of the planes (shared home) and the tile groups'
    buffers (1 group of 256 threads in shared, 4 in global)."""
    n = 2 * chi
    groups = 1 if home == "shared" else 4
    planes = 2 * n * n if home == "shared" else 0
    return 4 * (_head_floats(3 * n, chi) + max(planes, groups * _TILE_BUF_FLOATS))


def fused_cluster_size(chi: int) -> int:
    """CTAs per matrix on the cluster path: two blocks of BLOCK_ROWS rows
    each, ceil(2chi / 32) (8 at chi = 128, 7 at chi = 100, 6 at chi = 96)."""
    return block_ctas(2 * chi)


def fused_cluster_smem_bytes(chi: int) -> int:
    """Dynamic shared memory of one CTA on the cluster path: the loop's
    statistics, all 2chi row norms and the epilogue's arrays, then the
    larger of its three block buffers (BLOCK_ROWS rows of 2chi lanes, re
    and im) and its two tile groups' buffers."""
    n = 2 * chi
    groups = FUSED_CLUSTER_THREADS // _TILE_THREADS
    return 4 * (_head_floats(_BLOCK_STATS_FLOATS, chi)
                + max(2 * _BLOCK_BUFFERS * BLOCK_ROWS * n, groups * _TILE_BUF_FLOATS))


def fused_plane_home(chi: int, max_smem: int) -> str:
    """Where K4 keeps a matrix's (2chi, 2chi) working planes, given the
    ``max_smem`` bytes one block may use: ``"shared"`` when one block holds
    them (2chi <= 160 on an H100), else ``"cluster"`` (the shared memory
    of a cluster of :func:`fused_cluster_size` CTAs, up to 2chi = 256), else
    ``"global"`` (device memory).  θᵀ itself always stays in device memory."""
    if fused_smem_bytes(chi, "shared") + _FUSED_STATIC_SMEM <= max_smem:
        return "shared"
    if 2 * chi <= FUSED_CLUSTER_MAX_ROWS and fused_cluster_smem_bytes(chi) + _FUSED_STATIC_SMEM <= max_smem:
        return "cluster"
    return "global"


def fused_schedule(chi: int, device) -> str:
    """The order of K4's Jacobi sweeps at ``chi`` on ``device``: ``"block"``
    (csrc/block_sweeps.cuh) on the cluster home, ``"ring"`` (the Brent-Luk
    round robin of csrc/seat_sweeps.cuh) on the other two.  A CPU device
    takes the H100's home rule."""
    device = torch.device(device)
    if device.type == "cuda":
        max_smem = cuda_build.max_smem(torch.cuda.current_device() if device.index is None else device.index)
    else:
        max_smem = H100_MAX_SMEM
    return _SCHEDULES[fused_plane_home(chi, max_smem)]


def fused_cluster_occupancy(chi: int, dev: int = 0) -> int:
    """Clusters of K4's cluster path at ``chi`` that card ``dev`` keeps
    resident at once (cudaOccupancyMaxActiveClusters); raises on an error."""
    with torch.cuda.device(dev):
        got = int(cuda_build.load().fused_pair_cluster_occupancy(chi, fused_cluster_size(chi)))
    if got < 0:
        raise RuntimeError(f"fused_pair_cluster_occupancy failed: CUDA error {-got}")
    return got


def fused_pair_reference(
    gate_planes: torch.Tensor,
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    b_re: torch.Tensor,
    b_im: torch.Tensor,
    thr2: float,
    max_sweeps: int = DEFAULT_SWEEPS,
    criterion: str | None = None,
):
    """Plain-torch twin of K4 on the :func:`_prep_planes` outputs:
    θᵀ = W0 (K2's twin), the adaptive Jacobi on its rows in the order K4
    takes on this device (:func:`fused_schedule`: the blocked twin
    ``block_jacobi_rows_reference`` on the cluster home, else K1's twin, L =
    rows 0..chi-1, R = rows chi..2chi-1), the selection and the
    discarded-weight rule against W0's own rotated weight (the epilogue
    twin), then

        uᵀ = inv * (selected rows),   vh = inv * conj(uᵀ) @ W0ᵀ.

    Returns (ut_re, ut_im, vh_re, vh_im (B, chi, 2chi), lam (B, chi),
    sweeps (B,) int32)."""
    w0_re, w0_im = theta_build_reference(gate_planes, a_re, a_im, b_re, b_im)
    chi = a_re.shape[-1]
    if fused_schedule(chi, a_re.device) == "block":
        w_re, w_im, sweeps = block_jacobi_rows_reference(w0_re, w0_im, max_sweeps, criterion)
    else:
        w_re, w_im, sweeps = jacobi_rows_reference(w0_re, w0_im, max_sweeps, criterion)
    ws_re, ws_im, lam, inv = rank_truncate_reference(w_re, w_im, None, thr2, chi)
    ut_re, ut_im = ws_re * inv[..., None], ws_im * inv[..., None]
    vh = torch.matmul(torch.complex(ut_re, ut_im).conj(), torch.complex(w0_re, w0_im).transpose(-1, -2))
    vh = vh * inv[..., None]
    return ut_re, ut_im, vh.real.contiguous(), vh.imag.contiguous(), lam, sweeps


def fused_pair(
    gate_planes: torch.Tensor,
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    b_re: torch.Tensor,
    b_im: torch.Tensor,
    thr2: float,
    max_sweeps: int = DEFAULT_SWEEPS,
    criterion: str | None = None,
):
    """The fused pair update of a batch from the :func:`_prep_planes`
    outputs — see :func:`fused_pair_reference` for the contract.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (one
    thread block, or on the cluster path a cluster of
    :func:`fused_cluster_size` CTAs, per matrix; the working planes where
    :func:`fused_plane_home` puts them) and every launch adds one to
    ``fused_pair.launches``, ``fused_pair.launches_at[2 chi]`` and
    ``fused_pair.launches_by_schedule[s]`` (s: :func:`fused_schedule`,
    "ring" or "block"); any other device raises."""
    criterion = criterion or jacobi_criterion()
    if a_re.device.type == "cpu":
        return fused_pair_reference(gate_planes, a_re, a_im, b_re, b_im, thr2, max_sweeps, criterion)
    if a_re.device.type != "cuda":
        raise ValueError(f"fused_pair: unsupported device {a_re.device}")
    check_theta_args(gate_planes, a_re, a_im, b_re, b_im, name="fused_pair")
    dev = cuda_build.device_index(a_re)
    b, _, chi, _ = a_re.shape
    n = 2 * chi
    home = fused_plane_home(chi, cuda_build.max_smem(dev))

    def planes(rows):
        return tuple(torch.empty((b, rows, n), dtype=torch.float32, device=a_re.device) for _ in range(2))

    w0_re, w0_im = planes(n)  # θᵀ, kept for the vh product
    wk_re, wk_im = planes(n) if home == "global" else (None, None)  # working planes in device memory
    ut_re, ut_im = planes(chi)
    vh_re, vh_im = planes(chi)
    lam = torch.empty((b, chi), dtype=torch.float32, device=a_re.device)
    sweeps = torch.empty(b, dtype=torch.int32, device=a_re.device)
    cuda_build.launch(
        "fused_pair_launch", dev,
        gate_planes.data_ptr(), a_re.data_ptr(), a_im.data_ptr(), b_re.data_ptr(), b_im.data_ptr(),
        w0_re.data_ptr(), w0_im.data_ptr(),
        None if wk_re is None else wk_re.data_ptr(), None if wk_im is None else wk_im.data_ptr(),
        ut_re.data_ptr(), ut_im.data_ptr(), vh_re.data_ptr(), vh_im.data_ptr(), lam.data_ptr(),
        sweeps.data_ptr(), b, chi, int(max_sweeps), int(criterion == "hybrid"), float(thr2),
        _HOME_CODES[home], fused_cluster_size(chi), None,
    )
    schedule = _SCHEDULES[home]
    fused_pair.launches += 1
    fused_pair.launches_at[n] = fused_pair.launches_at.get(n, 0) + 1
    fused_pair.launches_by_schedule[schedule] = fused_pair.launches_by_schedule.get(schedule, 0) + 1
    return ut_re, ut_im, vh_re, vh_im, lam, sweeps


fused_pair.launches = 0
fused_pair.launches_at = {}
fused_pair.launches_by_schedule = {}


def fused_pair_update(
    lam_l, lam_c, lam_r, g1, g2, gate4, chi: int, trunc_thr: float, dtype, rdtype,
    sweeps: int = DEFAULT_SWEEPS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused computation of ops.mps._pair_update on the jacobi route
    (same contract: ``lam_*`` (..., chi), ``g1/g2`` (..., 2, chi, chi),
    ``gate4`` (..., 4, 4); returns (new_g1, new_g2, new_lam)); the gauge
    scalings stay in torch, as in the JAX package.  complex64 only; the
    caller checks the guards (ops.mps._pair_update)."""
    from .mps import _safe_inv

    batch_shape, b_count, ll, lr, a_re, a_im, b_re, b_im, gate_planes = _prep_planes(
        lam_l, lam_c, lam_r, g1, g2, gate4, chi, dtype
    )
    ut_re, ut_im, vh_re, vh_im, lam, _ = fused_pair(
        gate_planes, a_re, a_im, b_re, b_im, float(trunc_thr) ** 2, sweeps
    )
    utc = torch.complex(ut_re, ut_im).to(dtype)
    vhc = torch.complex(vh_re, vh_im).to(dtype)
    inv_l = _safe_inv(ll).to(dtype)
    inv_r = _safe_inv(lr).to(dtype)
    new_g1 = utc.transpose(-1, -2).reshape((b_count, 2, chi, chi)) * inv_l[:, None, :, None]
    new_g2 = vhc.reshape((b_count, chi, 2, chi)).transpose(-3, -2) * inv_r[:, None, None, :]
    return (
        new_g1.reshape(batch_shape + (2, chi, chi)),
        new_g2.reshape(batch_shape + (2, chi, chi)),
        lam.to(rdtype).reshape(batch_shape + (chi,)),
    )
