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

The kernel and its twin are LAPACK's blocked cgeqrf + cungqr (compact WY,
panels of 16 or 8 columns): :func:`householder_qr_reference` repeats the
kernel's panel, T and block-update arithmetic.  Dispatch rule of
:func:`householder_qr`: CPU tensors go to the twin, CUDA tensors to the
kernel — no fallback in between; the kernel route raises on anything it
does not take and on a launch the card refuses.  Where a matrix lives
and how wide its panels are is :func:`qr_plan`'s rule, from (n, l), the
batch and the card: the shared memory of a cluster of CTAs, rows dealt out
cyclically — of four CTAs while the batch's clusters fit the card at once
(a half-layer's 13-14 matrices), else of the fewest that hold the rows
(two at (256, 136) in the fleet's batch of 56, one at (128, 72) in the
folded fleets' 40 and 80) — and panels of 16 columns, 8 where 16 do not
fit or l < 16 (:func:`qr_panel`; l < 8 is one ragged panel of 8).
"""

from __future__ import annotations

import torch

from . import cuda_build

#: The kernel's shapes: n <= MAX_ROWS rows, 1 <= l <= n columns; a CTA holds
#: at most MAX_CTA_ROWS rows, a cluster 1, 2 or 4 CTAs.
MAX_ROWS = 256
MAX_CTA_ROWS = 128
CLUSTERS = (1, 2, 4)
#: Panel widths of the blocked kernel, widest first.
PANELS = (16, 8)
#: Columns whose largest entry (by real and imaginary part) lies below this
#: get tau = 0.
FLOOR = 2.0**-100


def _reflector(col: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """clarfg as the kernels take it, on columns ``col`` (b, m) with the
    pivot first: tau (b,), inv = 1 / (alpha - beta) (b,) and the entries
    below the pivot scaled by the power of two that brings the column's
    largest entry into [1, 2) (b, m - 1); tau and inv are 0 where that entry
    lies below :data:`FLOOR` or nothing is left to reflect."""
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
    return tau, inv, x


def householder_qr_reference(y: torch.Tensor, nb: int = PANELS[0]) -> torch.Tensor:
    """Plain-torch twin of the kernel: the reduced Q (b, n, l) of each
    ``y`` (b, n, l) complex, l <= n, with the kernel's reflectors, scaling
    and floor, by panels of ``nb`` columns, in the input's precision.  Per
    panel: the reflectors (:func:`_reflector`) on the panel, each applied
    to the panel's later columns as H^H a = a - conj(tau) v (v^H a) with v
    explicit (1 at its row, 0 above; the kernel takes the next column's
    v^H a as a_j + conj(inv) x^H a, equal to rounding); T by clarft's
    recurrence from V^H V; the trailing columns less V (T^H (V^H A)).  Then
    Q from I[:, :l], the panels from the last: Q[:, j0:] less
    V (T (V^H Q[:, j0:])).  The factor R is never formed: Q is all the
    range-finder needs."""
    b, n, ell = y.shape
    a = y.clone()
    panels = []
    for j0 in range(0, ell, nb):
        jn = min(j0 + nb, ell)
        p = a[:, :, j0:jn].clone()
        p[:, :j0] = 0
        taus = torch.zeros((b, jn - j0), dtype=y.dtype, device=y.device)
        for k in range(jn - j0):
            j = j0 + k
            tau, inv, x = _reflector(p[:, j:, k])
            v = torch.zeros_like(p[:, :, k])
            v[:, j] = 1
            v[:, j + 1 :] = x * inv[:, None]
            w = (v.conj()[..., None] * p[:, :, k + 1 :]).sum(-2)
            p[:, :, k + 1 :] -= v[..., None] * (tau.conj()[:, None] * w)[:, None, :]
            p[:, :, k] = v
            taus[:, k] = tau
        gram = p.mH @ p
        t = torch.zeros((b, jn - j0, jn - j0), dtype=y.dtype, device=y.device)
        for k in range(jn - j0):
            t[:, :k, k] = -taus[:, k, None] * (t[:, :k, :k] @ gram[:, :k, k, None])[..., 0]
            t[:, k, k] = taus[:, k]
        if jn < ell:
            a[:, :, jn:] -= p @ (t.mH @ (p.mH @ a[:, :, jn:]))
        panels.append((j0, p, t))
    q = torch.zeros_like(a)
    diag = torch.arange(ell, device=y.device)
    q[:, diag, diag] = 1
    for j0, p, t in reversed(panels):
        q[:, :, j0:] -= p @ (t @ (p.mH @ q[:, :, j0:]))
    return q


def qr_slots(rows: int) -> int:
    """Slots of 16 rows a CTA holds for ``rows`` rows (1, 2, 4 or 8)."""
    return next(s for s in (1, 2, 4, 8) if 16 * s >= rows)


def qr_blocked_smem_bytes(n: int, ell: int, cluster: int, nb: int) -> int:
    """Dynamic shared memory of one CTA of the kernel (csrc/householder_qr.cu
    blocked_smem_bytes): its rows of every column, T of every panel, the
    block coefficients (at least a panel column: the column handed on in
    the factorization) and partial-W buffer 0 (rows of l rounded up to
    even), the panel (a segment of 16 slots + 16 / cluster rows a CTA;
    partial-W buffer 1 in ungqr), V^H V, tau and 1 / (alpha - beta)."""
    slots = qr_slots(-(-n // cluster))
    pld = cluster * (16 * slots + (16 // cluster if cluster > 1 else 0))
    ldw = ell + (ell & 1)
    panels = -(-ell // nb)
    return 8 * ((16 * slots + 2) * ell + panels * nb * nb + max(pld, nb * ldw) + nb * ldw + max(nb * pld, nb * ldw)
                + nb * nb + 2 * nb)


def qr_panel(n: int, ell: int, cluster: int, max_smem: int) -> int:
    """Panel width for (n, l) matrices on ``cluster`` CTAs each: the widest
    of :data:`PANELS` not above max(l, 8) whose shared memory fits
    ``max_smem`` (l < 8: one ragged panel of 8), else 0 (rows past a CTA's
    MAX_CTA_ROWS, or no panel fits: the launch refuses it).  On an H100 a
    panel of 16 is the faster wherever it fits l (0.356 against 0.368 ms at
    (14, 256, 136) on 4 CTAs)."""
    if -(-n // cluster) > MAX_CTA_ROWS:
        return 0
    return next((nb for nb in PANELS if nb <= max(ell, PANELS[-1]) and qr_blocked_smem_bytes(n, ell, cluster, nb)
                 <= max_smem), 0)


def qr_plan(n: int, ell: int, max_smem: int, batch: int, sms: int) -> tuple[int, int]:
    """(CTAs a matrix, panel width) for a batch of ``batch`` (n, l)
    matrices on a card of ``sms`` SMs with ``max_smem`` bytes of shared
    memory a block: :func:`qr_cluster`'s CTAs, then :func:`qr_panel`'s
    width on them."""
    cluster = qr_cluster(n, ell, max_smem, batch, sms)
    return cluster, qr_panel(n, ell, cluster, max_smem)


def qr_cluster(n: int, ell: int, max_smem: int, batch: int, sms: int) -> int:
    """CTAs per matrix for a batch of ``batch`` (n, l) matrices on a card
    of ``sms`` SMs with ``max_smem`` bytes of shared memory a block, among
    those whose share of the rows (at most MAX_CTA_ROWS) takes some panel
    width (:func:`qr_panel`): 4 when n > 64 and the batch's clusters of 4
    fit the SMs at once (the per-warp work of a column step and of a block
    update shrinks with the rows a CTA holds: at b = 14 on an H100,
    (256, 136) 0.356 ms on 4 CTAs against 0.458 on 2, (128, 72) 0.115
    against 0.142 on 1), else the fewest (b = 56 at (256, 136): 0.460 ms on
    2, 0.712 on 4; b = 80 at (128, 72): 0.143 on 1, 0.250 on 2)."""
    fits = [c for c in CLUSTERS if qr_panel(n, ell, c, max_smem)]
    if not fits:
        raise ValueError(f"householder_qr: no cluster holds a ({n}, {ell}) matrix in {max_smem} B")
    return CLUSTERS[-1] if n > 64 and batch * CLUSTERS[-1] <= sms and CLUSTERS[-1] in fits else fits[0]


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


def householder_qr(y: torch.Tensor, *, cluster: int | None = None, panel: int | None = None) -> torch.Tensor:
    """The reduced Q (b, n, l) of each ``y`` (b, n, l); see
    :func:`householder_qr_reference` for the contract.

    CPU tensors run the plain twin at panels of ``PANELS[0]`` columns;
    CUDA tensors launch the kernel as :func:`qr_plan` says: its CTAs per
    matrix and its panel width.
    ``cluster`` chooses another count and ``panel`` another panel width
    (16 or 8), for A/B timings and the card tests; the range-finder passes
    neither.  Every launch adds one to ``householder_qr.launches``,
    ``householder_qr.launches_at[n]`` and
    ``householder_qr.launches_home["blocked"]``; any other device raises,
    and so does a launch the card refuses."""
    if y.device.type == "cpu":
        return householder_qr_reference(y)
    if y.device.type != "cuda":
        raise ValueError(f"householder_qr: unsupported device {y.device}")
    check_qr_args(y)
    if panel is not None and panel not in PANELS:
        raise ValueError(f"householder_qr: panels of {PANELS} columns, got {panel}")
    dev = cuda_build.device_index(y)
    b, n, ell = y.shape
    smem = cuda_build.max_smem(dev)
    cluster = cluster or qr_cluster(n, ell, smem, b, cuda_build.sm_count(dev))
    nb = qr_panel(n, ell, cluster, smem) if panel is None else panel
    q = torch.empty_like(y)
    if b == 0:
        return q
    cuda_build.launch("householder_qr_launch", dev, y.data_ptr(), q.data_ptr(), b, n, ell, cluster, nb)
    householder_qr.launches += 1
    householder_qr.launches_at[n] = householder_qr.launches_at.get(n, 0) + 1
    householder_qr.launches_home["blocked"] = householder_qr.launches_home.get("blocked", 0) + 1
    return q


householder_qr.launches = 0
householder_qr.launches_at = {}
householder_qr.launches_home = {}
