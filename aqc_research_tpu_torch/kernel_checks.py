"""Inputs, tolerance masks and the λ check shared by the kernel-vs-twin
checks of the θ-build, rand-tail and fused-pair kernels: ``chip_smoke.py``
and ``tests/test_torch_kernel.py``.  Nothing on the engine's path imports
this module."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ops.fused_pair import _prep_planes

_EPS32 = float(np.finfo(np.float32).eps)


def path_planes(rng, batch: int, chi: int, dev, rank: int | None = None, decades: float = 6.0):
    """θ-build inputs as the fused routes make them (ops/fused_pair._prep_planes):
    random Γ planes, graded bond values 1 .. 10^-decades (1e-6 by default,
    as the JAX package's tests/test_fused_rand.py grades them, so that
    truncation bites) and random gates.  With ``rank`` every bond holds
    only its first ``rank`` values (the rest exactly zero), so θ is zero
    outside the row and column blocks {0..rank-1} and {chi..chi+rank-1}, as
    on the MPS path where bond ranks stay far below chi.  Returns (gate,
    a_re, a_im, b_re, b_im) on ``dev``."""

    def c64(*shape):
        return torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                            dtype=torch.complex64)

    def lams():
        lam = (rng.random((batch, chi)) + 0.05) * np.logspace(0, -decades, chi)[None, :]
        lam = np.sort(lam, axis=-1)[..., ::-1]
        if rank is not None:
            lam[:, rank:] = 0.0
        return torch.tensor(lam / np.linalg.norm(lam, axis=-1, keepdims=True), dtype=torch.float32)

    g1, g2 = c64(batch, 2, chi, chi), c64(batch, 2, chi, chi)
    ll, lc, lr = lams(), lams(), lams()
    planes = _prep_planes(ll, lc, lr, g1, g2, c64(batch, 4, 4), chi, torch.complex64)[4:]
    a_re, a_im, b_re, b_im, gate = (t.to(dev) for t in planes)
    return gate, a_re, a_im, b_re, b_im


def padded_pair_batch(rng, batch: int, n: int, rank: int) -> torch.Tensor:
    """(batch, n, n) complex64 pair matrices of bonds of rank ``rank`` held
    at χ = n/2, laid out as θ is: the nonzero rows and columns are the two
    blocks {0..rank-1} and {χ..χ+rank-1}, everything else exactly zero.
    Unit Frobenius norm, on the CPU."""
    chi = n // 2
    idx = np.concatenate([np.arange(rank), chi + np.arange(rank)])
    a = np.zeros((batch, n, n), np.complex128)
    block = rng.standard_normal((batch, 2 * rank, 2 * rank)) + 1j * rng.standard_normal((batch, 2 * rank, 2 * rank))
    a[:, idx[:, None], idx[None, :]] = block
    a /= np.linalg.norm(a, axis=(-2, -1), keepdims=True)
    return torch.tensor(a.astype(np.complex64))


def near_threshold(s: torch.Tensor, tot2: torch.Tensor, thr2: float, chi: int, rel: float = 1e-5):
    """(B, chi) mask of the values whose keep decision two f32 routes may
    take either way.

    The rand tail's rule (ops/fused_rand.rand_tail_reference), evaluated in
    f64 on ``s`` (the descending singular values of B):

        tail2_i = sum_{j >= i} s_j^2 + rest2,
        rest2   = max(r - 16 eps tot2, 0),   r = tot2 - sum_{j < chi} s_j^2,
        keep_i  = tail2_i > thr^2 tot2  and  s_i > 32 eps s_max.

    A value is near when moving every s_j by ``rel * s_max`` (the λ
    tolerance) can carry its seen tail across the threshold, or its value
    across the guard, or when rest2 itself is in doubt: the rule budgets
    16 eps tot2 for the rounding of r, so rest2 may lie anywhere between
    max(r - 32 eps tot2, 0) and max(r, 0).  Where the remainder r is far
    below that budget, both routes clamp rest2 to 0 and it adds no doubt;
    where it lies inside the budget, every value whose tail is within r of
    the threshold is near.  On the graded inputs of :func:`path_planes` r
    is rounding noise of a few eps tot2, so at trunc 1e-6 (thr^2 = 1e-12,
    five orders below f32's eps) about half the values are near and the
    mask check bites only at coarse thresholds such as 1e-2.  A flip inside
    this set also moves the kept values' λ through the rescale
    sqrt(tot2 / kept^2): :func:`lambda_check` allows for that."""
    s = s[:, :chi].double()
    t2 = tot2.double()[:, None]
    delta = rel * s[:, :1]
    s2 = s * s
    r = t2 - s2.sum(-1, keepdim=True)
    budget = 16.0 * _EPS32 * t2
    rest2 = torch.clamp(r - budget, min=0.0)
    rest_doubt = torch.clamp(r, min=0.0) - torch.clamp(r - 2.0 * budget, min=0.0)
    tail2 = torch.flip(torch.cumsum(torch.flip(s2, [-1]), -1), [-1]) + rest2
    slack = torch.flip(torch.cumsum(torch.flip(2 * s * delta + delta * delta, [-1]), -1), [-1])
    slack = slack + rest_doubt
    at_cut = (tail2 - thr2 * t2).abs() <= slack
    at_guard = ((s - 32.0 * _EPS32 * s[:, :1]).abs() <= delta) & (tail2 + slack > thr2 * t2)
    return at_cut | at_guard


class LambdaCheck(NamedTuple):
    """What :func:`lambda_check` found: the largest |Δλ| over the values
    both sides keep, the largest relative rescale change the flips imply,
    the number of keep flips, and whether λ and the masks pass."""

    d_lam: float
    rescale: float
    flips: int
    lam_ok: bool
    mask_ok: bool


def lambda_check(k_lam: torch.Tensor, p_lam: torch.Tensor, near: torch.Tensor, tol: float) -> LambdaCheck:
    """Holds a kernel's truncated, rescaled singular values ``k_lam`` (B,
    chi; 0 where dropped) against its twin's ``p_lam``, given the
    :func:`near_threshold` mask ``near``.

    * masks: a keep decision may differ only inside ``near``;
    * λ, on the values both sides keep: |Δλ| <= tol * s_max + λ_twin * ρ.
      s_max is the twin's largest λ over the batch.  ρ is the relative
      change of the rescale sqrt(tot2 / kept^2) that the flipped values
      imply: a value of weight s_f^2 kept by one side only changes kept^2
      by the fraction w = s_f^2 / kept^2 = λ_f^2 / Σλ^2 (λ of the side that
      keeps it: the twin's where it keeps the value), so the rescales of
      the two sides differ by at most 1 / sqrt(1 - Σ_f w_f) - 1.  Without
      a flip ρ = 0 and the check is |Δλ| <= tol * s_max over every value,
      as before; a dropped value's λ is 0 on both sides."""
    k, p = k_lam.double(), p_lam.double()
    k_keep, p_keep = k > 0, p > 0
    differ = k_keep != p_keep
    both = k_keep & p_keep
    smax = float(p.max())

    def weights(lam):
        return lam * lam / torch.clamp((lam * lam).sum(-1, keepdim=True), min=1e-300)

    flipped = torch.where(differ, torch.where(p_keep, weights(p), weights(k)), torch.zeros_like(p))
    frac = torch.clamp(flipped.sum(-1, keepdim=True), max=1.0 - 1e-12)
    rho = 1.0 / torch.sqrt(1.0 - frac) - 1.0
    d = torch.where(both, (k - p).abs(), torch.zeros_like(p))
    lam_ok = bool(torch.isfinite(k).all()) and not bool((d > tol * smax + p * rho).any())
    return LambdaCheck(
        d_lam=float(d.max()) if d.numel() else 0.0,
        rescale=float(rho.max()) if rho.numel() else 0.0,
        flips=int(differ.sum()),
        lam_ok=lam_ok,
        mask_ok=not bool((differ & ~near.to(differ.device)).any()),
    )
