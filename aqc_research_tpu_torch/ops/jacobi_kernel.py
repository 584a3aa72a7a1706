"""Batched one-sided complex Jacobi on transposed re/im planes: the
hand-written CUDA kernel ``csrc/jacobi_rows.cu`` and its plain-torch twin.

Twin of ``aqc_research_tpu/ops/pallas_jacobi.py``: the kernel replaces the
Pallas TPU kernel ``_jacobi_pallas_raw``, and the functions around it
(``_sort_guard_top_k``, ``_jacobi_u_s``, ``jacobi_svd_kernel_top_k``) are
ported from the same module.

Working layout: row j of a (c, r) plane pair is column j of the input
matrix, so a "column pair" rotation touches two contiguous rows.  V is not
accumulated; the right factor is recovered outside as ``vh = diag(1/s) u^H
m`` (one batched product).

K4's cluster home rotates the same pairs in a block-cyclic order
(csrc/block_sweeps.cuh); its twin is :func:`block_jacobi_rows_reference`.

Dispatch rule of :func:`jacobi_rows`: CPU tensors go to the plain twin
:func:`jacobi_rows_reference`, CUDA tensors to the kernel — no fallback in
between; the kernel route raises on anything it does not take.  Where the
planes live is the "home" (:func:`plane_home`): the shared memory of a
thread-block cluster of :func:`cluster_size` CTAs per matrix, a warp per row
pair (the path shapes), one block's shared memory (the heads the rule keeps
there), or device memory.  The kernel library is built with ``nvcc`` from
``csrc/`` at first use, into ``aqc_research_tpu_torch/_build/``
(ops/cuda_build.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import jacobi_criterion
from . import cuda_build
from .jacobi_svd import DEFAULT_SWEEPS

_EPS32 = float(torch.finfo(torch.float32).eps)

# Convergence tolerance of the adaptive sweep loop, on the entry-absolute
# residual |c| / (s_max * max(|w_i|, |w_j|)) — the f32 accuracy floor
# (ops/pallas_jacobi.py:85-93 in the JAX package).
_CONV_TOL = 1e-6


def truncation_supported(trunc_thr: float) -> bool:
    """True when the f32 entry-absolute criterion resolves the keep/drop
    boundary of ``trunc_thr`` (sqrt(thr) >= tol), or thr disables truncation
    in f32 anyway (<= eps_f32^2)."""
    return trunc_thr <= _EPS32**2 or math.sqrt(trunc_thr) >= _CONV_TOL


# -----------------------------------------------------------------------------
# Plain twin: the same schedule, criterion and per-matrix stopping in torch.
# -----------------------------------------------------------------------------


def _rotate(wl_re, wl_im, wr_re, wr_im):
    """One rotation of each row pair (L, R) along the last axis but one, the
    kernels' formulas term for term; returns (L', R' as re/im, and each
    pair's aa = |L|^2, bb = |R|^2 and |c| = |<L, R>| before it)."""
    aa = (wl_re * wl_re + wl_im * wl_im).sum(-1)
    bb = (wr_re * wr_re + wr_im * wr_im).sum(-1)
    c_re = (wl_re * wr_re + wl_im * wr_im).sum(-1)
    c_im = (wl_re * wr_im - wl_im * wr_re).sum(-1)

    abs_c = torch.sqrt(c_re * c_re + c_im * c_im)
    norm_ab = torch.sqrt(torch.clamp(aa * bb, min=1e-30))
    one, zero = torch.ones_like(abs_c), torch.zeros_like(abs_c)
    active = abs_c > _EPS32 * norm_ab
    safe_c = torch.where(active, abs_c, one)
    ph_re = torch.where(active, c_re / safe_c, one)
    ph_im = torch.where(active, c_im / safe_c, zero)
    tau = (bb - aa) / (2.0 * safe_c)
    sgn = torch.where(tau >= 0, one, -one)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    cs = torch.rsqrt(1.0 + t * t)
    sn_r = t * cs
    cs = torch.where(active, cs, one)[..., None]
    sn_r = torch.where(active, sn_r, zero)
    sn_re = (sn_r * ph_re)[..., None]
    sn_im = (sn_r * ph_im)[..., None]

    # L' = cs L - conj(sn) R ;  R' = sn L + cs R   (complex)
    nl_re = cs * wl_re - (sn_re * wr_re + sn_im * wr_im)
    nl_im = cs * wl_im - (sn_re * wr_im - sn_im * wr_re)
    nr_re = sn_re * wl_re - sn_im * wl_im + cs * wr_re
    nr_im = sn_re * wl_im + sn_im * wl_re + cs * wr_im
    return nl_re, nl_im, nr_re, nr_im, aa, bb, abs_c


def _ratio(aa, bb, abs_c, smax2, hybrid: bool):
    """The stopping rule's ratio |c| / sqrt(s_max^2 * gate) of each pair
    against s_max^2 ``smax2`` (broadcast over the pairs)."""
    if hybrid:
        gate = torch.maximum(torch.minimum(aa, bb), (32.0 * _EPS32) ** 2 * smax2)
    else:
        gate = torch.maximum(aa, bb)
    return abs_c / torch.sqrt(torch.clamp(smax2 * gate, min=1e-30))


def _seat_phase(wl_re, wl_im, wr_re, wr_im, hybrid: bool):
    """One Brent-Luk phase on seat blocks (b, p, r); returns the rotated and
    re-seated blocks and each matrix's residual (b,) against the phase's
    own s_max^2."""
    p = wl_re.shape[1]
    nl_re, nl_im, nr_re, nr_im, aa, bb, abs_c = _rotate(wl_re, wl_im, wr_re, wr_im)
    smax2 = torch.maximum(aa, bb).amax(1, keepdim=True)
    resid = _ratio(aa, bb, abs_c, smax2, hybrid).amax(1)

    def seats(l, r):
        nl = torch.cat([l[:, :1], r[:, :1], l[:, 1 : p - 1]], dim=1)
        nr = torch.cat([r[:, 1:], l[:, p - 1 :]], dim=1)
        return nl, nr

    wl_re, wr_re = seats(nl_re, nr_re)
    wl_im, wr_im = seats(nl_im, nr_im)
    return wl_re, wl_im, wr_re, wr_im, resid


def jacobi_rows_reference(
    w_re: torch.Tensor,
    w_im: torch.Tensor,
    max_sweeps: int = DEFAULT_SWEEPS,
    criterion: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel: planes (B, c, r) f32, c even.
    Returns (w_re, w_im, sweeps) with W = (m V)^T rows in input row order
    (a full sweep of 2p-1 round-robin phases returns every row to its seat)
    and each matrix's sweep count (int32)."""
    hybrid = (criterion or jacobi_criterion()) == "hybrid"
    b, c, _ = w_re.shape
    p = c // 2
    wl_re, wr_re = w_re[:, :p], w_re[:, p:]
    wl_im, wr_im = w_im[:, :p], w_im[:, p:]
    sweeps = torch.zeros(b, dtype=torch.int32, device=w_re.device)
    active = torch.ones(b, dtype=torch.bool, device=w_re.device)
    for _ in range(max_sweeps):
        if not bool(active.any()):
            break
        nl_re, nl_im, nr_re, nr_im = wl_re, wl_im, wr_re, wr_im
        resid = torch.zeros(b, dtype=w_re.dtype, device=w_re.device)
        for _ in range(2 * p - 1):
            nl_re, nl_im, nr_re, nr_im, r = _seat_phase(nl_re, nl_im, nr_re, nr_im, hybrid)
            resid = torch.maximum(resid, r)
        # Per-matrix stopping: a converged matrix keeps its rows frozen.
        keep = active[:, None, None]
        wl_re = torch.where(keep, nl_re, wl_re)
        wl_im = torch.where(keep, nl_im, wl_im)
        wr_re = torch.where(keep, nr_re, wr_re)
        wr_im = torch.where(keep, nr_im, wr_im)
        sweeps += active.to(torch.int32)
        active = active & (resid >= _CONV_TOL)
    return torch.cat([wl_re, wr_re], 1), torch.cat([wl_im, wr_im], 1), sweeps


# The block-cyclic schedule of K4's cluster home (csrc/block_sweeps.cuh): rows
# in blocks of BLOCK_ROWS, two blocks a CTA.
BLOCK_ROWS = 16


def block_pair(cta: int, rnd: int, ctas: int) -> Tuple[int, int]:
    """The blocks (a, b) CTA ``cta`` of ``ctas`` holds in round ``rnd``
    (counted across sweeps) of the circle method over 2 ctas blocks: a is
    sent on at the round's end, b kept (csrc/block_sweeps.cuh block_pair,
    line for line)."""
    circle = 2 * ctas - 1
    h = ctas - 1
    r = rnd % circle
    k = cta
    if rnd % 2 and k > 0:
        k = (k + 1 if k < h else k) if k % 2 else k - 1
    plus = (r + k) % circle
    minus = circle if k == 0 else (r - k) % circle
    return (plus, minus) if (k == 0 or k % 2) else (minus, plus)


def _cycle_row(i: int, p: int) -> int:
    return i + 1 if i < p - 1 else 3 * p - 2 - i


def _seat_l(j: int, t: int, p: int) -> int:
    """Row of the round-robin seat L[j] in phase t (csrc/seat_sweeps.cuh)."""
    return 0 if j == 0 else _cycle_row((j - 1 - t) % (2 * p - 1), p)


def _seat_r(j: int, t: int, p: int) -> int:
    return _cycle_row((2 * p - 2 - j - t) % (2 * p - 1), p)


def block_ctas(rows: int, block: int = BLOCK_ROWS) -> int:
    """CTAs of the block-cyclic schedule on ``rows`` rows: two blocks each."""
    return -(-rows // (2 * block))


def block_sweep_phases(ctas: int, block: int, first_round: int):
    """The local phases of one sweep of the block-cyclic schedule on 2 ctas
    blocks of ``block`` rows (row i of block b is row b * block + i), its
    block rounds numbered from ``first_round``: a list of (L rows, R rows),
    each phase's pairs disjoint.  First the intra-block round (block - 1
    phases of the round robin inside every block, rows in place), then
    2 ctas - 1 block rounds of ``block`` phases: in phase s of a round, row i
    of each CTA's block a meets row (i + s) mod block of its block b."""
    p = block // 2
    blocks = range(2 * ctas)
    phases = [([x * block + _seat_l(j, t, p) for x in blocks for j in range(p)],
               [x * block + _seat_r(j, t, p) for x in blocks for j in range(p)]) for t in range(block - 1)]
    for q in range(2 * ctas - 1):
        pairs = [block_pair(c, first_round + q, ctas) for c in range(ctas)]
        for s in range(block):
            phases.append(([a * block + i for a, _ in pairs for i in range(block)],
                           [b * block + (i + s) % block for _, b in pairs for i in range(block)]))
    return phases


def block_jacobi_rows_reference(
    w_re: torch.Tensor,
    w_im: torch.Tensor,
    max_sweeps: int = DEFAULT_SWEEPS,
    criterion: str | None = None,
    *,
    block: int = BLOCK_ROWS,
    ctas: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of K4's sweeps on its cluster home
    (csrc/block_sweeps.cuh): the same contract as
    :func:`jacobi_rows_reference`, the rotations in the block-cyclic order of
    :func:`block_sweep_phases` on ``ctas`` CTAs (:func:`block_ctas` by
    default), the rows padded with zero rows to 2 ctas ``block``.

    Stopping, per matrix: s_max^2 is the largest row norm^2 at the sweep's
    start; the sweep's residual is the largest ratio |c| / sqrt(max(s_max^2
    gate, 1e-30)) over the pairs it rotates (gate max(|L|^2, |R|^2) under
    "entry", max(min(|L|^2, |R|^2), (32 eps)^2 s_max^2) under "hybrid"); a
    matrix stops after a sweep whose residual is below 1e-6, or after
    ``max_sweeps``."""
    hybrid = (criterion or jacobi_criterion()) == "hybrid"
    b, c, _ = w_re.shape
    ctas = ctas or block_ctas(c, block)
    rows = 2 * ctas * block
    if block < 2 or block % 2 or rows < c:
        raise ValueError(f"block_jacobi_rows_reference: {c} rows do not fit {2 * ctas} blocks of {block}")
    pad = (0, 0, 0, rows - c)
    w_re = torch.nn.functional.pad(w_re, pad)
    w_im = torch.nn.functional.pad(w_im, pad)
    sweeps = torch.zeros(b, dtype=torch.int32, device=w_re.device)
    active = torch.ones(b, dtype=torch.bool, device=w_re.device)
    # A sweep starts at a round that is a multiple of the odd 2 ctas - 1, so
    # the sweeps alternate between two schedules.
    schedules = [[(torch.tensor(li, device=w_re.device), torch.tensor(ri, device=w_re.device))
                  for li, ri in block_sweep_phases(ctas, block, first)] for first in (0, 2 * ctas - 1)]
    for k in range(max_sweeps):
        if not bool(active.any()):
            break
        n_re, n_im = w_re.clone(), w_im.clone()
        smax2 = (n_re * n_re + n_im * n_im).sum(-1).amax(-1, keepdim=True)
        resid = torch.zeros(b, dtype=w_re.dtype, device=w_re.device)
        for li, ri in schedules[k % 2]:
            nl_re, nl_im, nr_re, nr_im, aa, bb, abs_c = _rotate(n_re[:, li], n_im[:, li], n_re[:, ri], n_im[:, ri])
            resid = torch.maximum(resid, _ratio(aa, bb, abs_c, smax2, hybrid).amax(1))
            n_re[:, li], n_im[:, li], n_re[:, ri], n_im[:, ri] = nl_re, nl_im, nr_re, nr_im
        # Per-matrix stopping: a converged matrix keeps its rows frozen.
        keep = active[:, None, None]
        w_re = torch.where(keep, n_re, w_re)
        w_im = torch.where(keep, n_im, w_im)
        sweeps += active.to(torch.int32)
        active = active & (resid >= _CONV_TOL)
    return w_re[:, :c].contiguous(), w_im[:, :c].contiguous(), sweeps


# -----------------------------------------------------------------------------
# The CUDA kernel (built and launched through ops/cuda_build.py).
# -----------------------------------------------------------------------------


SMEM_THREADS = 256  # block size cap with the planes in shared memory (seat_sweeps.cuh)
MAX_THREADS = 1024  # block size cap with the planes in device memory
HOME_CODES = {"shared": 0, "cluster": 1, "global": 2}  # the C entry points' ``home``

# The cluster home (csrc/cluster_sweeps.cuh): at most 8 CTAs per matrix (the
# portable cluster size), 16 pairs per CTA (16 pair warps and the stats warp:
# 544 threads), 256 rows of 256 lanes; 16 bytes of static shared memory per
# CTA (the go flag).
CLUSTER_MAX = 8
CLUSTER_MAX_PAIRS = 16
CLUSTER_MAX_ROWS = 256
CLUSTER_MAX_LANES = 256
_CLUSTER_STATIC_SMEM = 16
# The fewest rows the rule moves onto a cluster, from the card's times of
# every home and cluster size (chip_smoke.py; PERF.md §6, H100): one block
# per matrix wins at 8 rows (a warp for each of its 4 pairs already), the
# cluster from 16.
CLUSTER_MIN_ROWS = 16


def rows_smem_bytes(c: int, r: int) -> int:
    """Shared memory of one block holding a (c, r) plane pair: both planes
    plus the double-buffered per-pair statistics (3 x 2 x c/2 floats)."""
    return 4 * (2 * c * r + 3 * c)


def cluster_size(c: int) -> int:
    """CTAs per matrix of c rows on the cluster home: the fewest pairs per
    CTA that CLUSTER_MAX CTAs allow, on as few CTAs as hold them (none
    idle).  On the H100 this spread was the fastest size, or within 1% of
    it, at every shape timed (K1 at 16 to 256 rows, K3 at chi = 64 and
    128; PERF.md §6)."""
    p = max(1, c // 2)
    pairs = -(-p // CLUSTER_MAX)
    return -(-p // pairs)


def cluster_pairs(c: int, cluster: int) -> int:
    """Row pairs (seats of each side) one CTA of the cluster holds."""
    return -(-(c // 2) // cluster)


def cluster_threads(c: int, cluster: int) -> int:
    """Threads of one CTA on the cluster home: a warp per pair it holds and
    the stats warp."""
    return 32 * (cluster_pairs(c, cluster) + 1)


def cluster_smem_bytes(c: int, r: int, cluster: int, extra_bytes: int = 0) -> int:
    """Dynamic shared memory of one CTA on the cluster home: its pairs'
    statistics of four phases and ``extra_bytes`` of the caller's own
    arrays (rounded up to 16 bytes), then two seat buffers of both sides, re
    and im, rows of r lanes (csrc/cluster_sweeps.cuh cluster_cta_floats)."""
    pairs = cluster_pairs(c, cluster)
    head = -(-(4 * 3 * pairs + extra_bytes // 4) // 4) * 4
    return 4 * (head + 8 * pairs * r)


def cluster_fits(c: int, r: int, cluster: int, max_smem: int, extra_bytes: int = 0) -> bool:
    """Whether the cluster loop takes a (c, r) plane pair on ``cluster``
    CTAs within the ``max_smem`` bytes one block may use."""
    return (
        4 <= c <= CLUSTER_MAX_ROWS and c % 2 == 0 and r <= CLUSTER_MAX_LANES
        and 1 <= cluster <= CLUSTER_MAX and cluster_pairs(c, cluster) <= CLUSTER_MAX_PAIRS
        and cluster_smem_bytes(c, r, cluster, extra_bytes) + _CLUSTER_STATIC_SMEM <= max_smem
    )


def plane_home(c: int, r: int, max_smem: int, extra_bytes: int = 0) -> str:
    """Where a (c, r) plane pair lives, given the ``max_smem`` bytes one
    block may use and ``extra_bytes`` of the caller's own shared arrays:
    ``"cluster"`` (the shared memory of :func:`cluster_size` CTAs, from
    CLUSTER_MIN_ROWS rows up to 256 rows of 256 lanes), else ``"shared"``
    when one block holds both planes and the loop's statistics, else
    ``"global"`` (device memory, L2-resident; csrc/seat_sweeps.cuh)."""
    if c >= CLUSTER_MIN_ROWS and cluster_fits(c, r, cluster_size(c), max_smem, extra_bytes):
        return "cluster"
    return "shared" if rows_smem_bytes(c, r) + extra_bytes <= max_smem else "global"


def block_threads(c: int, home: str = "shared") -> int:
    """Threads of one block working on c rows (the one-block homes): a warp
    per row pair, up to 8 with the planes in shared memory, up to 32 in
    device memory."""
    cap = (SMEM_THREADS if home == "shared" else MAX_THREADS) // 32
    return 32 * min(cap, c // 2)


def launch_shape(c: int, home: str, cluster: int | None) -> tuple:
    """(home code, threads per block, CTAs per matrix) of a launch on c rows
    at ``home`` (a cluster of ``cluster`` CTAs, :func:`cluster_size` when
    None); raises on an unknown home."""
    if home not in HOME_CODES:
        raise ValueError(f"unknown plane home {home!r}: expected one of {sorted(HOME_CODES)}")
    if home != "cluster":
        return HOME_CODES[home], block_threads(c, home), 1
    cluster = cluster or cluster_size(c)
    return HOME_CODES[home], cluster_threads(c, cluster), cluster


def cluster_occupancy(c: int, r: int, cluster: int, dev: int = 0) -> int:
    """Clusters of K1's cluster home at (c, r, cluster) that card ``dev``
    keeps resident at once (cudaOccupancyMaxActiveClusters); raises on an
    error."""
    with torch.cuda.device(dev):
        got = int(cuda_build.load().jacobi_rows_cluster_occupancy(c, r, cluster))
    if got < 0:
        raise RuntimeError(f"jacobi_rows_cluster_occupancy failed: CUDA error {-got}")
    return got


def check_rows_args(w_re: torch.Tensor, w_im: torch.Tensor) -> None:
    """Raises ValueError unless the planes are what the kernel takes (any
    size: planes that do not fit shared memory stay in device memory)."""
    if w_re.dtype != torch.float32 or w_im.dtype != torch.float32:
        raise ValueError(f"jacobi_rows takes float32 planes, got {w_re.dtype}/{w_im.dtype}")
    if w_re.ndim != 3 or w_re.shape != w_im.shape:
        raise ValueError(f"jacobi_rows takes two (B, c, r) planes, got {tuple(w_re.shape)}/{tuple(w_im.shape)}")
    if w_re.device != w_im.device:
        raise ValueError("jacobi_rows: planes on different devices")
    if not (w_re.is_contiguous() and w_im.is_contiguous()):
        raise ValueError("jacobi_rows takes contiguous planes")
    _, c, r = w_re.shape
    if c < 2 or c % 2 or r < c:
        raise ValueError(f"jacobi_rows needs an even c >= 2 and r >= c, got c={c} r={r}")


def jacobi_rows(
    w_re: torch.Tensor,
    w_im: torch.Tensor,
    max_sweeps: int = DEFAULT_SWEEPS,
    criterion: str | None = None,
    *,
    home: str | None = None,
    cluster: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adaptive one-sided Jacobi on (B, c, r) f32 planes: returns (w_re,
    w_im, sweeps) — see :func:`jacobi_rows_reference` for the contract.

    CPU tensors run the plain twin; CUDA tensors launch the kernel, the
    planes where :func:`plane_home` puts them (``home``/``cluster`` choose
    another home or cluster size, for A/B timings and the card tests; the
    engine never passes them), and every launch adds one to
    ``jacobi_rows.launches``, ``jacobi_rows.launches_at[c]`` and
    ``jacobi_rows.launches_home[home]``; any other device raises, and so
    does a launch the card refuses."""
    criterion = criterion or jacobi_criterion()
    if w_re.device.type == "cpu":
        return jacobi_rows_reference(w_re, w_im, max_sweeps, criterion)
    if w_re.device.type != "cuda":
        raise ValueError(f"jacobi_rows: unsupported device {w_re.device}")
    check_rows_args(w_re, w_im)
    dev = cuda_build.device_index(w_re)
    b, c, r = w_re.shape
    home = home or plane_home(c, r, cuda_build.max_smem(dev))
    code, threads, ctas = launch_shape(c, home, cluster)
    out_re = torch.empty_like(w_re)
    out_im = torch.empty_like(w_im)
    sweeps = torch.empty(b, dtype=torch.int32, device=w_re.device)
    if b == 0:
        return out_re, out_im, sweeps
    cuda_build.launch(
        "jacobi_rows_launch", dev,
        w_re.data_ptr(), w_im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        sweeps.data_ptr(), b, c, r, int(max_sweeps), int(criterion == "hybrid"), threads, code, ctas,
    )
    jacobi_rows.launches += 1
    jacobi_rows.launches_at[c] = jacobi_rows.launches_at.get(c, 0) + 1
    jacobi_rows.launches_home[home] = jacobi_rows.launches_home.get(home, 0) + 1
    return out_re, out_im, sweeps


jacobi_rows.launches = 0
jacobi_rows.launches_at = {}
jacobi_rows.launches_home = {}


def rank_truncate_reference(w_re, w_im, tot2, thr2: float, chi: int):
    """Plain-torch twin of the epilogue the rand tail and the fused pair
    kernels share (csrc/rank_truncate.cuh), on rotated (B, rows, n) planes:
    the stable top-chi selection by row norm, the 32 eps noise guard and the
    discarded-weight rule against the full weight ``tot2`` (B,) — None for
    the rows' own total, as the fused kernel takes it.

    Returns (ws_re, ws_im (B, chi, n) the selected rows unscaled, lam
    (B, chi) the truncated and rescaled singular values, inv (B, chi) the
    mask-safe 1/s)."""
    s2 = (w_re * w_re + w_im * w_im).sum(-1)
    if tot2 is None:
        tot2 = s2.sum(-1)
    order = torch.argsort(-s2, dim=-1, stable=True)[:, :chi]
    s2s = torch.take_along_dim(s2, order, dim=-1)
    ws_re = torch.take_along_dim(w_re, order[..., None], dim=-2)
    ws_im = torch.take_along_dim(w_im, order[..., None], dim=-2)

    zero = torch.zeros_like(s2s)
    guard = s2s > (32.0 * _EPS32) ** 2 * s2s[:, :1]
    s2g = torch.where(guard, s2s, zero)
    seen2 = torch.flip(torch.cumsum(torch.flip(s2g, [-1]), -1), [-1])
    t2 = tot2[:, None]
    rest2 = torch.clamp(t2 - s2s.sum(-1, keepdim=True) - 16.0 * _EPS32 * t2, min=0.0)
    keep = (seen2 + rest2 > thr2 * t2) & guard
    kept2 = torch.where(keep, s2s, zero).sum(-1, keepdim=True)
    rescale = torch.sqrt(t2 / torch.clamp(kept2, min=1e-38))
    s = torch.sqrt(s2s)
    lam = torch.where(keep, s * rescale, zero)
    inv = torch.where(keep, 1.0 / torch.clamp(s, min=1e-38), zero)
    return ws_re, ws_im, lam, inv


# -----------------------------------------------------------------------------
# Truncated SVD on top of the rows (ops/pallas_jacobi.py:273-375).
# -----------------------------------------------------------------------------


def _sort_guard_top_k(w_re, w_im, k: int, cdtype):
    """Sorts the rows by norm, keeps the top ``k`` and zeroes every direction
    below the 32*eps*s_max noise floor (f32 rotation residue whose direction
    is garbage — normalizing it would keep O(1) wrong contributions in
    u diag(s) vh).  Returns (w (B, k, r) complex rows, s (B, k), inv)."""
    s = torch.sqrt((w_re * w_re + w_im * w_im).sum(-1))
    w = torch.complex(w_re, w_im).to(cdtype)
    order = torch.argsort(-s, dim=-1, stable=True)[..., :k]
    s = torch.take_along_dim(s, order, dim=-1)
    w = torch.take_along_dim(w, order[..., :, None], dim=-2)
    keep = s > (32.0 * _EPS32) * s[..., :1]
    s = torch.where(keep, s, torch.zeros_like(s))
    inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    return w, s, inv


def _jacobi_u_s(m: torch.Tensor, sweeps: int, k: int):
    """Kernel run + sort + truncate to k: returns (u_k (B, n, k) isometric
    columns, s_k, inv_k, mb, batch_shape)."""
    n = m.shape[-1]
    if m.shape[-2] != n or n % 2:
        raise ValueError(f"square even-sized input expected, got {tuple(m.shape)}")
    batch_shape = m.shape[:-2]
    mb = m.reshape((-1, n, n))
    # Transposed planes: columns become rows.
    mt = mb.transpose(-1, -2)
    if mb.is_complex():
        m_re = mt.real.to(torch.float32).contiguous()
        m_im = mt.imag.to(torch.float32).contiguous()
        cdtype = mb.dtype
    else:
        m_re = mt.to(torch.float32).contiguous()
        m_im = torch.zeros_like(m_re)
        cdtype = torch.complex64
    w_re, w_im, _ = jacobi_rows(m_re, m_im, sweeps)
    w, s, inv = _sort_guard_top_k(w_re, w_im, k, cdtype)
    u = (w * inv[..., :, None].to(w.dtype)).transpose(-1, -2)
    return u, s, inv, mb, batch_shape


def jacobi_svd_kernel_top_k(
    m: torch.Tensor, k: int, sweeps: int = DEFAULT_SWEEPS
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k truncated SVD through the Jacobi rows (the MPS pair-update
    shape: k = chi, n = 2 chi).  Singular values below the noise floor come
    back as exact zeros with zeroed factor columns."""
    n = m.shape[-1]
    u, s, inv, mb, batch_shape = _jacobi_u_s(m, sweeps, k)
    # Right factor: vh = diag(1/s) u^H m (zero rows for masked values).
    vh = inv[..., :, None].to(u.dtype) * torch.matmul(u.conj().transpose(-1, -2), mb)
    return (
        u.reshape(batch_shape + (n, k)),
        s.reshape(batch_shape + (k,)),
        vh.reshape(batch_shape + (k, n)),
    )
