"""Batch-vectorized one-sided Jacobi SVD, Brent-Luk round-robin schedule
(twin of ``aqc_research_tpu/ops/jacobi_svd.py``, the pure-XLA spec of the
Jacobi kernel — here in plain torch).

* columns live in two "seat" blocks L | R of n/2 columns each; a phase
  orthogonalizes every column pair (L[j], R[j]) at once;
* the round-robin tournament permutation (L[0] fixed, others cycle) visits
  every pair exactly once per sweep of n-1 phases;
* sweeps repeat until a sweep's largest off-diagonal residual drops below
  the dtype's convergence floor (shared over the batch, as in the spec), at
  most ``sweeps`` times;
* afterwards column norms are the singular values; sorting descending and
  normalizing gives U, S, V^H.

The MPS engine sends matrices with fewer than 8 columns here (the χ-growth
heads), the rest to the kernel route (ops/jacobi_kernel.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import jacobi_criterion, real_of
from .cuda_graphs import tracing

DEFAULT_SWEEPS = 12


def _pair_rotation(a, b, c, eps):
    """Rotation diagonalizing the 2x2 Hermitian [[a, c], [conj(c), b]]:
    returns (cs, sn_r, phase) with A_i' = cs A_i - sn_r conj(phase) A_j,
    A_j' = sn_r phase A_i + cs A_j.  Small |c| yields the identity."""
    abs_c = c.abs()
    active = abs_c > eps * torch.sqrt(torch.clamp(a * b, min=1e-30))
    safe_c = torch.where(active, abs_c, torch.ones_like(abs_c))
    phase = c / safe_c
    tau = (b - a) / (2.0 * safe_c)
    # sign(0) must be +1: equal column norms still need the full pi/4 turn.
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(tau.dtype)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    cs = 1.0 / torch.sqrt(1.0 + t * t)
    sn_r = t * cs
    cs = torch.where(active, cs, torch.ones_like(cs))
    sn_r = torch.where(active, sn_r, torch.zeros_like(sn_r))
    phase = torch.where(active, phase, torch.ones_like(phase))
    return cs, sn_r, phase


def _phase_update(al, ar, vl, vr, eps, criterion="relative"):
    """One Brent-Luk phase on column blocks ``al, ar`` (..., n, p) and the
    matching blocks of the accumulated V; returns the updated blocks and
    each matrix's largest pre-rotation residual (criteria as in the JAX
    spec: "relative", "entry" or "hybrid")."""
    a = (al.abs() ** 2).sum(-2)
    b = (ar.abs() ** 2).sum(-2)
    c = (al.conj() * ar).sum(-2)
    if criterion in ("entry", "hybrid"):
        smax2 = torch.maximum(a, b).amax(-1, keepdim=True)
        if criterion == "entry":
            denom2 = smax2 * torch.maximum(a, b)
        else:
            floor2 = (32.0 * eps) ** 2 * smax2
            denom2 = smax2 * torch.maximum(torch.minimum(a, b), floor2)
    else:
        denom2 = a * b
    resid = (c.abs() / torch.sqrt(torch.clamp(denom2, min=1e-30))).amax(-1)

    cs, sn_r, phase = _pair_rotation(a, b, c, eps)
    cs = cs[..., None, :].to(al.dtype)
    sn = (sn_r * phase)[..., None, :].to(al.dtype)
    sn_c = (sn_r * phase.conj())[..., None, :].to(al.dtype)
    if vl is None:
        return cs * al - sn_c * ar, sn * al + cs * ar, None, None, resid
    return (
        cs * al - sn_c * ar,
        sn * al + cs * ar,
        cs * vl - sn_c * vr,
        sn * vl + cs * vr,
        resid,
    )


def _rotate_seats(l, r):
    """L: [l0, l1, ..., l_{p-1}] -> [l0, r0, l1, ..., l_{p-2}];
    R: [r0, r1, ..., r_{p-1}] -> [r1, ..., r_{p-1}, l_{p-1}]."""
    new_l = torch.cat([l[..., :, :1], r[..., :, :1], l[..., :, 1:-1]], dim=-1)
    new_r = torch.cat([r[..., :, 1:], l[..., :, -1:]], dim=-1)
    return new_l, new_r


def _adaptive_sweeps(al, ar, vl, vr, sweeps: int, criterion: str):
    """The spec's adaptive loop on the seat blocks ``al, ar`` (..., rows, p)
    and the matching blocks of V (None: not accumulated): sweeps of 2p - 1
    phases until a sweep's largest residual over the batch drops below the
    dtype's tolerance (f32 1e-6, f64 1e-13), at most ``sweeps``.  Returns
    the blocks and each matrix's count, int32 of the batch shape: the
    sweeps until its own residual first dropped below the tolerance."""
    rdtype = real_of(al.dtype)
    eps = float(torch.finfo(rdtype).eps)
    conv_tol = 1e-6 if rdtype == torch.float32 else 1e-13
    batch = al.shape[:-2]
    count = torch.zeros(batch, dtype=torch.int32, device=al.device)
    active = torch.ones(batch, dtype=torch.bool, device=al.device)
    # In a device program the loop reads no device value: every sweep runs,
    # and once the batch has converged the sweeps after it are masked out
    # (the same blocks and counts as the early exit).
    going = torch.ones((), dtype=torch.bool, device=al.device) if tracing() else None
    for _ in range(sweeps):
        before = (al, ar, vl, vr)
        resid = torch.zeros(batch, dtype=rdtype, device=al.device)
        for _ in range(2 * al.shape[-1] - 1):
            al, ar, vl, vr, r = _phase_update(al, ar, vl, vr, eps, criterion)
            al, ar = _rotate_seats(al, ar)
            if vl is not None:
                vl, vr = _rotate_seats(vl, vr)
            resid = torch.maximum(resid, r)
        if going is None:
            count += active.to(torch.int32)
            active = active & (resid >= conv_tol)
            if not float(resid.max()) >= conv_tol:
                break
            continue
        al, ar, vl, vr = (b if a is None else torch.where(going, a, b) for a, b in zip((al, ar, vl, vr), before))
        count += (active & going).to(torch.int32)
        active = active & (resid >= conv_tol)
        going = going & (resid.max() >= conv_tol)
    return al, ar, vl, vr, count


def jacobi_svd(
    m: torch.Tensor, sweeps: int = DEFAULT_SWEEPS, sort: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full SVD of square (..., n, n) matrices, n even; returns (u, s, vh)
    with m = u diag(s) vh, singular values sorted descending (with ``sort``
    False: in the order the rotations leave the columns)."""
    n = m.shape[-1]
    if m.shape[-2] != n or n % 2:
        raise ValueError(f"square even-sized input expected, got {tuple(m.shape)}")
    p = n // 2
    dtype = m.dtype
    rdtype = real_of(dtype)

    eye = torch.eye(n, dtype=dtype, device=m.device).expand(m.shape)
    # f32 uses the kernel's entry-absolute (or hybrid) criterion; f64 keeps
    # the relative one, as in the spec.
    criterion = jacobi_criterion() if rdtype == torch.float32 else "relative"
    al, ar, vl, vr, _ = _adaptive_sweeps(m[..., :, :p], m[..., :, p:], eye[..., :, :p], eye[..., :, p:],
                                         sweeps, criterion)

    a = torch.cat([al, ar], dim=-1)
    v = torch.cat([vl, vr], dim=-1)
    s = torch.linalg.vector_norm(a, dim=-2).to(rdtype)
    if sort:
        order = torch.argsort(-s, dim=-1, stable=True)
        s = torch.take_along_dim(s, order, dim=-1)
        a = torch.take_along_dim(a, order[..., None, :], dim=-1)
        v = torch.take_along_dim(v, order[..., None, :], dim=-1)
    pos = s > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, s, torch.ones_like(s)), torch.zeros_like(s))
    u = a * inv[..., None, :].to(dtype)
    vh = v.conj().transpose(-1, -2)
    return u, s, vh


def jacobi_svd_top_k(
    m: torch.Tensor, k: int, sweeps: int = DEFAULT_SWEEPS
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k truncated SVD via :func:`jacobi_svd`."""
    u, s, vh = jacobi_svd(m, sweeps=sweeps)
    return u[..., :, :k], s[..., :k], vh[..., :k, :]


def jacobi_sweeps_per_matrix(
    m: torch.Tensor, sweeps: int = DEFAULT_SWEEPS, criterion: str | None = None
) -> torch.Tensor:
    """Adaptive sweep count of the one-sided Jacobi on each matrix of ``m``
    (..., rows, n): n columns of length rows, n even; returns (B,) int32
    over the flattened batch, on ``m``'s device.

    The tolerance and criterion rule of the spec: f32 stops at 1e-6 under
    ``criterion`` (None: :func:`config.jacobi_criterion`), f64 at 1e-13
    under "relative".  The f32 "entry"/"hybrid" counts from 8 columns on
    come from the Jacobi rows of ops/jacobi_kernel.py on the transposed
    planes (rows must be at least n), as the engine sends them: on CPU
    tensors its plain twin, on CUDA tensors the kernel K1, which reports
    each matrix's sweeps.  Every other case (the χ-growth heads, f64) runs
    :func:`jacobi_svd`'s loop without V."""
    n = m.shape[-1]
    if n % 2:
        raise ValueError(f"an even column count is expected, got {tuple(m.shape)}")
    mb = m.reshape((-1,) + tuple(m.shape[-2:]))
    rdtype = real_of(mb.dtype)
    is_f32 = rdtype == torch.float32
    if criterion is None:
        criterion = jacobi_criterion() if is_f32 else "relative"
    if is_f32 and criterion in ("entry", "hybrid") and 8 <= n <= mb.shape[-2]:
        from .jacobi_kernel import jacobi_rows

        mt = mb.transpose(-1, -2)
        w_re = (mt.real if mt.is_complex() else mt).contiguous()
        w_im = (mt.imag.contiguous() if mt.is_complex() else torch.zeros_like(w_re))
        return jacobi_rows(w_re, w_im, sweeps, criterion)[2]

    p = n // 2
    return _adaptive_sweeps(mb[..., :, :p], mb[..., :, p:], None, None, sweeps, criterion)[4]


def jacobi_sweeps_used(
    m: torch.Tensor, sweeps: int = DEFAULT_SWEEPS, criterion: str | None = None
) -> torch.Tensor:
    """Number of adaptive sweeps the Jacobi loop executes on ``m`` (...,
    rows, n): one int32 scalar for the whole batch, the count of its
    slowest matrix — what the spec's shared loop runs, and what the
    roofline's flop model multiplies (ops/roofline.py).  One sweep is n - 1
    phases.  Each matrix's own count is :func:`jacobi_sweeps_per_matrix`,
    whose rules this follows."""
    return jacobi_sweeps_per_matrix(m, sweeps, criterion).max()
