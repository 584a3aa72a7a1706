"""Randomized range-finder of the rand pair-update route (twin of the parts
of ``aqc_research_tpu/ops/rand_svd.py`` that the fused route runs).

The MPS pair update keeps only the top chi of the 2chi singular triplets of
its (2chi, 2chi) matrix.  The Halko-Martinsson-Tropp range-finder shrinks
the Jacobi problem to l = chi + 8 columns first:

    1. sample       Y = A @ Omega                (n x l)
    2. power iter   Y <- A (A^H Y), QR between   [sharpens the subspace]
    3. orthobasis   Q = QR(Y).Q                  (n x l isometry)
    4. project      B = Q^H A                    (l x n)

The reduced Jacobi on B^H and the truncation then run in the rand-tail
kernel (ops/fused_rand.py), or, in the unfused :func:`rand_svd_top_k`, in
the Jacobi-rows kernel K1 on the (l, n) rows of B^H.  Steps 1-4 are plain
torch ops (batched complex products and Householder QR), as the JAX package
leaves them to XLA.

The sketch Omega is a real Gaussian drawn once per (b, n, l, dtype, device)
from a CPU ``torch.Generator`` seeded with the JAX package's constant
``0x5EED ^ (n << 8) ^ l``, and cached: every call at one shape reuses it,
as the JAX package's fixed key does.  torch cannot redraw JAX's bits, so
parity tests hand the JAX sketch in (``omega=`` or by replacing
:func:`sketch`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .jacobi_kernel import _sort_guard_top_k, jacobi_rows
from .jacobi_svd import DEFAULT_SWEEPS

# l = k + _OVERSAMPLE sampled columns, rounded up to even (the Jacobi seats
# pair the columns); 8 keeps l a multiple of 8 at chi % 8 == 0.
_OVERSAMPLE = 8
# Subspace-sharpening power iterations (Y <- A A^H Y, re-orthonormalized).
_POWER_ITERS = 1
# Below this matrix size the projection cannot pay; the pair update takes
# the jacobi route there (the chi-growth heads).  Module attributes, read at
# call time, so tests can lower them.
RAND_MIN_N = 128

_SKETCHES: dict = {}


def rand_ell(n: int, k: int, oversample: int | None = None) -> int:
    """The sketch width l = k + oversample, clamped to n and rounded up to
    even (the Jacobi kernel's seats pair the columns)."""
    ell = min(n, k + (_OVERSAMPLE if oversample is None else oversample))
    return ell + ell % 2


def qr_chunk(rows: int) -> int:
    """The most matrices of ``rows`` rows that one CUDA ``torch.linalg.qr``
    call may take and still factor them with cuSOLVER's geqrf, one matrix
    after another: torch hands a batch to cuBLAS's batched geqrf when
    rows <= 256 and the batch holds at least max(2, rows // 16) matrices."""
    if rows > 256:
        return 1 << 30
    return max(1, max(2, rows // 16) - 1)


def _orth(y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the columns of each ``y`` (b, n, l): Householder
    QR, backward-stable at any condition (CholeskyQR squares the graded
    sample's condition past f32).

    On CUDA the batch goes in chunks of :func:`qr_chunk` matrices: cuBLAS's
    batched geqrf returns NaN for a sample whose nonzero rows lie in the two
    blocks {0..r-1} and {χ..χ+r-1} that the zero padding of θ leaves at a
    bond rank r < χ (every pair update of the 20-qubit χ=64 cell; H100,
    torch 2.11), while cuSOLVER's geqrf factors it as LAPACK does."""
    if y.device.type != "cuda":
        return torch.linalg.qr(y, mode="reduced")[0]
    return torch.cat([torch.linalg.qr(c, mode="reduced")[0] for c in y.split(qr_chunk(y.shape[-2]))])


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


def _range_project(
    a: torch.Tensor, ell: int, q_iters: int, omega: torch.Tensor | None = None
) -> torch.Tensor:
    """HMT range-finder + projection: B = Q^H A of shape (b, l, n) for ``a``
    (b, n, n) complex, Q an orthonormal basis of the sketched, power-iterated
    range of A (Householder QR between the legs and for the final basis)."""
    b, n = a.shape[0], a.shape[-1]
    if omega is None:
        omega = sketch(b, n, ell, a.dtype, a.device)
    y = _orth(torch.matmul(a, omega))
    ah = a.conj().transpose(-1, -2)
    for _ in range(q_iters):
        z = _orth(torch.matmul(ah, y))
        y = _orth(torch.matmul(a, z))
    return torch.matmul(y.conj().transpose(-1, -2), a)


def rand_svd_top_k(
    m: torch.Tensor, k: int, sweeps: int = DEFAULT_SWEEPS, omega: torch.Tensor | None = None
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
    in the JAX package), n even.  ``omega``: the (b, n, l) sketch, for
    parity tests (default :func:`sketch`)."""
    n = m.shape[-1]
    if m.shape[-2] != n or n % 2:
        raise ValueError(f"square even-sized input expected, got {tuple(m.shape)}")
    batch_shape = m.shape[:-2]
    cdtype = m.dtype if m.is_complex() else torch.complex64
    a = m.reshape((-1, n, n)).to(torch.complex64)
    bm = _range_project(a, rand_ell(n, k), _POWER_ITERS, omega)  # (b, l, n)
    w_re, w_im, _ = jacobi_rows(bm.real.contiguous(), (-bm.imag).contiguous(), sweeps)
    w, s, inv = _sort_guard_top_k(w_re, w_im, k, cdtype)
    vh = w.conj() * inv[..., :, None].to(cdtype)  # (b, k, n)
    u = torch.matmul(a.to(cdtype), vh.conj().transpose(-1, -2)) * inv[..., None, :].to(cdtype)
    return (
        u.reshape(batch_shape + (n, k)),
        s.reshape(batch_shape + (k,)),
        vh.reshape(batch_shape + (k, n)),
    )
