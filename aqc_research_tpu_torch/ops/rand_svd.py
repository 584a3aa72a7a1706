"""Randomized range-finder of the rand pair-update route (twin of the parts
of ``aqc_research_tpu/ops/rand_svd.py`` that the fused route runs).

The MPS pair update keeps only the top chi of the 2chi singular triplets of
its (2chi, 2chi) matrix.  The Halko-Martinsson-Tropp range-finder shrinks
the Jacobi problem to l = chi + 8 columns first:

    1. sample       Y = A @ Omega                (n x l)
    2. power iter   Y <- A (A^H Y), QR or LU     [sharpens the subspace]
                    between the legs
    3. orthobasis   Q = QR(Y).Q                  (n x l isometry)
    4. project      B = Q^H A                    (l x n)

The reduced Jacobi on B^H and the truncation then run in the rand-tail
kernel (ops/fused_rand.py), or, in the unfused :func:`rand_svd_top_k`, in
the Jacobi-rows kernel K1 on the (l, n) rows of B^H.  Steps 1-4 are plain
torch products, as the JAX package leaves them to XLA, and, on CUDA, the
hand-written batched Householder QR of ops/householder_qr.py.

The sketch Omega is a real Gaussian drawn once per (b, n, l, dtype, device)
from a CPU ``torch.Generator`` seeded with the JAX package's constant
``0x5EED ^ (n << 8) ^ l``, and cached: every call at one shape reuses it,
as the JAX package's fixed key does.  torch cannot redraw JAX's bits, so
parity tests hand the JAX sketch in (``omega=`` or by replacing
:func:`sketch`).

Knobs (environment, read once at import; the JAX package's
``AQC_TPU_RAND_*``): ``AQC_TORCH_RAND_OVERSAMPLE`` (8),
``AQC_TORCH_RAND_POWER_ITERS`` (1), ``AQC_TORCH_RAND_MIN_N`` (128) and
``AQC_TORCH_RAND_INTERMEDIATE`` ("qr"; "lu" is the only other mode, the one
the JAX package measured safe).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from . import householder_qr
from .jacobi_kernel import _sort_guard_top_k, jacobi_rows
from .jacobi_svd import DEFAULT_SWEEPS

# The range-finder's knobs, read from the environment once at import into
# module attributes that the code reads at call time (tests set them).
# l = k + _OVERSAMPLE sampled columns, rounded up to even (the Jacobi seats
# pair the columns); 8 keeps l a multiple of 8 at chi % 8 == 0.
_OVERSAMPLE = int(os.environ.get("AQC_TORCH_RAND_OVERSAMPLE", "8"))
# Subspace-sharpening power iterations (Y <- A A^H Y, stabilized between).
_POWER_ITERS = int(os.environ.get("AQC_TORCH_RAND_POWER_ITERS", "1"))
# The stabilization between the power legs: "qr" (Householder
# re-orthonormalization, the default) or "lu" (P L of the partial-pivot
# LU, :func:`_lu_stab`: a bounded basis of the same span, without the
# orthogonal factor).  The last leg always goes into the final basis.  The
# JAX package's other modes (qrlite, colnorm, cholqr) and its final-basis
# cholqrK were measured unsafe on its chip: they raise here.
_INTERMEDIATE = os.environ.get("AQC_TORCH_RAND_INTERMEDIATE", "qr")
_INTERMEDIATES = ("qr", "lu")
_FINALS = ("qr",)
# Below this matrix size the projection cannot pay; the pair update takes
# the jacobi route there (the chi-growth heads).
RAND_MIN_N = int(os.environ.get("AQC_TORCH_RAND_MIN_N", "128"))

_SKETCHES: dict = {}


def rand_ell(n: int, k: int, oversample: int | None = None) -> int:
    """The sketch width l = k + oversample, clamped to n and rounded up to
    even (the Jacobi kernel's seats pair the columns)."""
    ell = min(n, k + (_OVERSAMPLE if oversample is None else oversample))
    return ell + ell % 2


def _orth(y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the columns of each ``y`` (b, n, l): Householder
    QR, backward-stable at any condition (CholeskyQR squares the graded
    sample's condition past f32).

    On CUDA, n <= 256 (every range-finder shape the engine makes: n = 2χ,
    l = χ + 8), the whole batch goes to the hand-written kernel
    (ops/householder_qr.py) in one launch; it returns finite, orthonormal
    columns on the zero-padded pair samples, where cuBLAS's batched geqrf
    returns NaN.  CUDA inputs with n > 256 take ``torch.linalg.qr``,
    which factors them with cuSOLVER's geqrf one matrix after another
    (torch's batched path takes at most 256 rows).  The CPU takes
    ``torch.linalg.qr`` (LAPACK)."""
    if y.device.type != "cuda" or y.shape[-2] > householder_qr.MAX_ROWS:
        return torch.linalg.qr(y, mode="reduced")[0]
    return householder_qr.householder_qr(y.contiguous())


def sketch(b: int, n: int, ell: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The (b, n, ell) Gaussian test matrices of one shape, cast to
    ``dtype`` on ``device``; drawn once per shape and cached."""
    device = torch.device(device)
    key = (b, n, ell, dtype, device)
    omega = _SKETCHES.get(key)
    if omega is None:
        gen = torch.Generator(device="cpu").manual_seed(0x5EED ^ (n << 8) ^ ell)
        draw = torch.randn((b, n, ell), generator=gen, dtype=torch.float32)
        omega = draw.to(dtype).to(device)
        _SKETCHES[key] = omega
    return omega


def _lu_stab(y: torch.Tensor) -> torch.Tensor:
    """P L of the partial-pivot LU of each ``y`` (b, n, l), n >= l: a
    unit-lower-trapezoidal basis, row-permuted, with bounded entries
    (|l| <= sqrt(2): complex pivoting compares |re| + |im|) and
    span(P L) = span(y) where y has full column rank (the JAX package's
    ``_lu_stab``, scikit-learn's "LU" power-iteration normalizer).  A
    rank-deficient y (the zero-padded pair samples) keeps its span inside
    span(P L): a zero pivot leaves its column of L a unit vector, as
    LAPACK's getrf does, so P L never loses rank.  No orthogonal factor is
    formed, so it costs less than Householder QR; only the final basis
    needs the real QR."""
    p, l_fac, _ = torch.linalg.lu(y)
    # Row i of P L is row j of L where P[i, j] = 1: a gather, exact.
    rows = p.abs().argmax(-1)
    return torch.take_along_dim(l_fac, rows[..., None], dim=-2)


def _intermediate(intermediate: str | None, final: str | None) -> str:
    """The intermediate stabilization in effect, after checking both modes;
    the modes the JAX package measured unsafe raise."""
    im = _INTERMEDIATE if intermediate is None else intermediate
    fm = "qr" if final is None else final
    for kind, mode, allowed in (("intermediate", im, _INTERMEDIATES), ("final", fm, _FINALS)):
        if mode in allowed:
            continue
        if mode in ("qrlite", "colnorm") or mode.startswith("cholqr"):
            raise ValueError(
                f"rand {kind} {mode!r} is not ported: measured unsafe on the JAX package's chip "
                f"(ROADMAP.md, \"Not to port\": the rand knobs qrlite, colnorm, cholqr and cholqr2/3); "
                f"use one of {allowed}")
        raise ValueError(f"unknown rand {kind} {mode!r} (use one of {allowed})")
    return im


def _range_project(
    a: torch.Tensor,
    ell: int,
    q_iters: int,
    omega: torch.Tensor | None = None,
    intermediate: str | None = None,
    final: str | None = None,
) -> torch.Tensor:
    """HMT range-finder + projection: B = Q^H A of shape (b, l, n) for ``a``
    (b, n, n) complex, Q an orthonormal basis of the sketched, power-iterated
    range of A (the JAX package's ops/rand_svd.py:365-429).  The power legs
    are stabilized by ``intermediate`` ("qr" or "lu"; None reads the
    module's ``_INTERMEDIATE``), except the last, which goes into the final
    basis (``final``: "qr", Householder); with ``q_iters == 0`` the sample
    goes into the final basis at once.

    In complex64, rows of B below 32 eps of its largest row (the
    noise floor of the rand tail's hybrid Jacobi criterion,
    csrc/cluster_sweeps.cuh) come out as zeros: on zero-padded pair
    matrices the basis holds directions that A does not reach, and B's rows
    for them are rounding residue that the Jacobi would otherwise rotate,
    sweep after sweep.  complex128 keeps B as computed, as the JAX
    package's ``_range_project`` does."""
    stab = _lu_stab if _intermediate(intermediate, final) == "lu" else _orth
    b, n = a.shape[0], a.shape[-1]
    if omega is None:
        omega = sketch(b, n, ell, a.dtype, a.device)
    y = torch.matmul(a, omega)
    y = _orth(y) if q_iters == 0 else stab(y)
    ah = a.conj().transpose(-1, -2)
    for i in range(q_iters):
        z = stab(torch.matmul(ah, y))
        y = torch.matmul(a, z)
        y = stab(y) if i < q_iters - 1 else _orth(y)
    bm = torch.matmul(y.conj().transpose(-1, -2), a)
    if bm.dtype != torch.complex64:
        return bm
    rows2 = (bm.real.square() + bm.imag.square()).sum(-1)
    floor2 = (32 * torch.finfo(rows2.dtype).eps) ** 2 * rows2.amax(-1, keepdim=True)
    return bm.masked_fill((rows2 <= floor2)[..., None], 0)


def rand_svd_top_k(
    m: torch.Tensor,
    k: int,
    sweeps: int = DEFAULT_SWEEPS,
    oversample: int | None = None,
    power_iters: int | None = None,
    intermediate: str | None = None,
    final: str | None = None,
    omega: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k truncated SVD by randomized projection and the reduced Jacobi
    rows (twin of the JAX package's ``rand_svd_top_k``, its
    ops/rand_svd.py:440): the range-finder gives B = Q^H A (l, n), K1 (its
    plain twin on CPU tensors) orthogonalizes the l rows of conj(B) — the
    columns of B^H — and the sort and noise guard of the Jacobi route pick
    the top k.  Row j of the result is (s_j u_j)^T of B^H, so its rows
    scaled by 1/s are Vh of A directly; u = A vh^H diag(1/s).  Singular
    values below the 32 eps s_max floor come back as exact zeros with
    zeroed factor columns.

    ``m``: (..., n, n) complex64 (complex128 is projected in complex64, as
    in the JAX package), n even.  ``oversample``, ``power_iters``,
    ``intermediate`` and ``final`` override the module's knobs (None reads
    them; see :func:`_range_project`).  ``omega``: the (b, n, l) sketch,
    for parity tests (default :func:`sketch`)."""
    n = m.shape[-1]
    if m.shape[-2] != n or n % 2:
        raise ValueError(f"square even-sized input expected, got {tuple(m.shape)}")
    batch_shape = m.shape[:-2]
    cdtype = m.dtype if m.is_complex() else torch.complex64
    a = m.reshape((-1, n, n)).to(torch.complex64)
    q_iters = _POWER_ITERS if power_iters is None else power_iters
    bm = _range_project(a, rand_ell(n, k, oversample), q_iters, omega, intermediate, final)  # (b, l, n)
    w_re, w_im, _ = jacobi_rows(bm.real.contiguous(), (-bm.imag).contiguous(), sweeps)
    w, s, inv = _sort_guard_top_k(w_re, w_im, k, cdtype)
    vh = w.conj() * inv[..., :, None].to(cdtype)  # (b, k, n)
    u = torch.matmul(a.to(cdtype), vh.conj().transpose(-1, -2)) * inv[..., None, :].to(cdtype)
    return (
        u.reshape(batch_shape + (n, k)),
        s.reshape(batch_shape + (k,)),
        vh.reshape(batch_shape + (k, n)),
    )
