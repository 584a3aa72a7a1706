"""Batched reduced Householder QR, Q only: the hand-written CUDA kernel
``csrc/householder_qr.cu`` and its plain-torch twin.

The rand range-finder (ops/rand_svd._orth) orthonormalizes a batch of
(n, l) samples three times per pair update.  cuSOLVER factors such a batch
one matrix after another (torch.linalg.qr in chunks kept off cuBLAS's
batched geqrf, which returns NaN on zero-padded pair samples); this kernel
factors every matrix of the batch in one launch, each on its own CTA or
cluster of CTAs, and returns Q.  It replaces no TPU kernel: the JAX package
leaves this QR to XLA.

What it computes is LAPACK's cgeqrf + cungqr in f32 arithmetic: clarfg's
reflectors (beta = -sign(Re alpha) * norm, real), so Q agrees with
LAPACK's column for column where the sample has full rank, then Q = H_0 ...
H_{l-1} I[:, :l].  Column norms are taken with the column scaled by the
power of two that brings its largest entry into [1, 2), so columns far
below f32's normal range keep their norm; a column whose largest entry lies
below :data:`FLOOR` (2^-100) gets tau = 0 (H = I), as a zero column does in
LAPACK.  Q is finite and orthonormal on rank-deficient samples too.

Dispatch rule of :func:`householder_qr`: CPU tensors go to the plain twin
:func:`householder_qr_reference`, CUDA tensors to the kernel — no fallback
in between; the kernel route raises on anything it does not take and on a
launch the card refuses.  Where a matrix lives is :func:`qr_cluster`'s
rule, from (n, l), the batch and the card's SMs: the shared memory of a
cluster of CTAs, rows dealt out cyclically — of four CTAs while the
batch's clusters fit the card at once (a half-layer's 13-14 matrices,
"cluster"), else of the fewest that hold the rows (one CTA at (128, 72)
in the folded fleets' batches of 40 and 80, "shared").
"""

from __future__ import annotations

import torch

from . import cuda_build

#: The kernel's shapes: n <= MAX_ROWS rows, 1 <= l <= n columns; a CTA holds
#: at most MAX_CTA_ROWS rows, a cluster 1, 2 or 4 CTAs.
MAX_ROWS = 256
MAX_CTA_ROWS = 128
CLUSTERS = (1, 2, 4)
#: Columns whose largest entry (by real and imaginary part) lies below this
#: get tau = 0.
FLOOR = 2.0**-100


def householder_qr_reference(y: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of the kernel: the reduced Q (b, n, l) of each
    ``y`` (b, n, l) complex, l <= n, with the kernel's reflectors, scaling
    and floor, in the input's precision.  Row j of the factor (R) is never
    formed: Q is all the range-finder needs."""
    b, n, ell = y.shape
    a = y.clone()
    taus = torch.zeros((b, ell), dtype=y.dtype, device=y.device)
    for j in range(ell):
        col = a[:, j:, j]
        big = torch.maximum(col.real.abs(), col.imag.abs()).amax(-1)
        live = big >= FLOOR
        # big = f 2^e with f in [0.5, 1): 2^(1 - e) brings it into [1, 2).
        _, e = torch.frexp(torch.where(live, big, torch.ones_like(big)))
        scale = torch.where(live, torch.ldexp(torch.ones_like(big), 1 - e), torch.zeros_like(big))
        cs = col * scale[:, None]
        alpha, x = cs[:, 0], cs[:, 1:]
        xn2 = (x.real * x.real + x.imag * x.imag).sum(-1)
        trivial = ~live | ((xn2 == 0) & (alpha.imag == 0))
        r = torch.sqrt(alpha.real * alpha.real + alpha.imag * alpha.imag + xn2)
        beta = torch.where(alpha.real >= 0, -r, r)
        beta = torch.where(trivial, torch.ones_like(beta), beta)
        tau = torch.where(trivial, 0, torch.complex((beta - alpha.real) / beta, -alpha.imag / beta))
        inv = torch.where(trivial, 0, 1.0 / (alpha - beta))
        v = x * inv[:, None]
        # w_k = v^H a_k = a_jk + conj(inv) sum_{i > j} conj(x_i) a_ik
        w = a[:, j, j + 1 :] + (x.conj()[..., None] * a[:, j + 1 :, j + 1 :]).sum(-2) * inv.conj()[:, None]
        a[:, j + 1 :, j + 1 :] -= tau.conj()[:, None, None] * v[..., None] * w[:, None, :]
        a[:, j + 1 :, j] = v
        taus[:, j] = tau
    q = torch.zeros_like(a)
    for i in range(ell - 1, -1, -1):
        v, tau = a[:, i + 1 :, i], taus[:, i]
        # Row i of the trailing columns is still zero: the dot runs below it.
        w = (v.conj()[..., None] * q[:, i + 1 :, i + 1 :]).sum(-2)
        q[:, i + 1 :, i + 1 :] -= tau[:, None, None] * v[..., None] * w[:, None, :]
        q[:, i, i + 1 :] = -tau[:, None] * w
        q[:, i, i] = 1 - tau
        q[:, i + 1 :, i] = -tau[:, None] * v
    return q


def qr_slots(rows: int) -> int:
    """Slots of 16 rows a CTA holds for ``rows`` rows (1, 2, 4 or 8)."""
    return next(s for s in (1, 2, 4, 8) if 16 * s >= rows)


def qr_smem_bytes(n: int, ell: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA (csrc/householder_qr.cu
    qr_smem_bytes): its rows of every column (16 slots + 2 entries a
    column), tau, two buffers of the partial dots and of the pivot row, the
    partial norms and exponents."""
    ld = 16 * qr_slots(-(-n // cluster)) + 2
    return 8 * (ld * ell + ell + 2 * cluster * ell + 2 * ell) + 8 * 2 * cluster


def qr_cluster(n: int, ell: int, max_smem: int, batch: int, sms: int) -> int:
    """CTAs per matrix for a batch of ``batch`` (n, l) matrices on a card
    of ``sms`` SMs with ``max_smem`` bytes of shared memory a block: 4 when
    n > 64 and the batch's clusters of 4 fit the SMs at once (a step's
    redundant per-warp work shrinks with the rows a CTA holds: at b = 14 on
    an H100, (256, 136) 0.63 ms on 4 CTAs against 0.78 on 2, (128, 72) 0.24
    against 0.26 on 1), else the fewest whose share of the rows, at most
    MAX_CTA_ROWS, fits ``max_smem`` (b = 40 at (128, 72): 0.26 ms on 1, 0.32
    on 4)."""
    fits = [c for c in CLUSTERS if -(-n // c) <= MAX_CTA_ROWS and qr_smem_bytes(n, ell, c) <= max_smem]
    if not fits:
        raise ValueError(f"householder_qr: no cluster holds a ({n}, {ell}) matrix in {max_smem} B")
    return CLUSTERS[-1] if n > 64 and batch * CLUSTERS[-1] <= sms else fits[0]


def check_qr_args(y: torch.Tensor) -> None:
    """Raises ValueError unless ``y`` is what the kernel takes."""
    if y.dtype != torch.complex64:
        raise ValueError(f"householder_qr takes complex64, got {y.dtype}")
    if y.ndim != 3:
        raise ValueError(f"householder_qr takes a (b, n, l) batch, got {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError("householder_qr takes a contiguous batch")
    _, n, ell = y.shape
    if not 1 <= ell <= n <= MAX_ROWS:
        raise ValueError(f"householder_qr needs 1 <= l <= n <= {MAX_ROWS}, got n={n} l={ell}")


def householder_qr(y: torch.Tensor, *, cluster: int | None = None) -> torch.Tensor:
    """The reduced Q (b, n, l) of each ``y`` (b, n, l); see
    :func:`householder_qr_reference` for the contract.

    CPU tensors run the plain twin; CUDA tensors launch the kernel on
    :func:`qr_cluster`'s CTAs per matrix (``cluster`` chooses another
    count, for A/B timings and the card tests; the range-finder never
    passes it), and every launch adds one to ``householder_qr.launches``,
    ``householder_qr.launches_at[n]`` and ``householder_qr.launches_home``
    ("shared": one CTA a matrix, "cluster": more); any other device raises,
    and so does a launch the card refuses."""
    if y.device.type == "cpu":
        return householder_qr_reference(y)
    if y.device.type != "cuda":
        raise ValueError(f"householder_qr: unsupported device {y.device}")
    check_qr_args(y)
    dev = cuda_build.device_index(y)
    b, n, ell = y.shape
    cluster = cluster or qr_cluster(n, ell, cuda_build.max_smem(dev), b, cuda_build.sm_count(dev))
    q = torch.empty_like(y)
    if b == 0:
        return q
    cuda_build.launch("householder_qr_launch", dev, y.data_ptr(), q.data_ptr(), b, n, ell, cluster)
    home = "shared" if cluster == 1 else "cluster"
    householder_qr.launches += 1
    householder_qr.launches_at[n] = householder_qr.launches_at.get(n, 0) + 1
    householder_qr.launches_home[home] = householder_qr.launches_home.get(home, 0) + 1
    return q


householder_qr.launches = 0
householder_qr.launches_at = {}
householder_qr.launches_home = {}
