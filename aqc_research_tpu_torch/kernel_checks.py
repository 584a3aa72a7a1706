"""Inputs and tolerance masks shared by the kernel-vs-twin checks of the
θ-build, rand-tail and fused-pair kernels: ``chip_smoke.py`` and
``tests/test_torch_kernel.py``.  Nothing on the engine's path imports this
module."""

from __future__ import annotations

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
    mask check bites only at coarse thresholds such as 1e-2.  The λ check
    still bounds every flip: a flipped value's λ moves by its whole size, so
    a flip of any value above rel * s_max fails it."""
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
