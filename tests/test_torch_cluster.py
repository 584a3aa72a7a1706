"""The cluster home of K1 and K3 (csrc/cluster_sweeps.cuh) on the CPU: the
shape helpers the wrappers launch with (ops/jacobi_kernel.py,
ops/fused_rand.py), the next-seat map the loop moves rows by, and the λ
check that holds K3 and K4 against their twins on the card
(kernel_checks.lambda_check).  The kernels themselves run only on a CUDA
card: tests/test_torch_kernel.py."""

import numpy as np
import pytest
import torch

from aqc_research_tpu_torch.kernel_checks import lambda_check
from aqc_research_tpu_torch.ops import fused_rand as tfr
from aqc_research_tpu_torch.ops import jacobi_kernel as jk
from aqc_research_tpu_torch.ops import rand_svd as trs
from tests import _torch_threads  # noqa: F401

SMEM_H100 = 232448  # opt-in shared memory of one H100 block

# (c rows, r lanes, extra bytes of the caller's shared arrays): K1's heads and
# path shapes (c = r = 2chi), K3's (l, 2chi) planes beside its epilogue.
K1_SHAPES = [(c, c, 0) for c in (16, 32, 64, 128, 256)]
K3_SHAPES = [(trs.rand_ell(2 * chi, chi), 2 * chi, tfr.tail_extra_bytes(trs.rand_ell(2 * chi, chi), chi))
             for chi in (32, 64, 96, 128)]


def next_seats(j: int, p: int):
    """The seats, (side, seat) with side 0 = L and 1 = R, that the rows of
    pair j take in the next phase: csrc/cluster_sweeps.cuh's l_side/l_seat
    and r_side/r_seat, line for line."""
    l_side = 1 if j == p - 1 else 0
    l_seat = 0 if j == 0 else (p - 1 if j == p - 1 else j + 1)
    r_seat = 1 if j == 0 else j - 1
    r_side = 0 if j == 0 else 1
    return (l_side, l_seat), (r_side, r_seat)


@pytest.mark.parametrize("c,r,extra", K1_SHAPES + K3_SHAPES)
def test_cluster_shape_helpers(c, r, extra):
    """For every cluster size the loop takes on a shape: a warp per pair a
    CTA holds plus the stats warp, a CTA within an H100 block's shared
    memory, and every seat pair owned by exactly one CTA; the rule's own
    size spreads the pairs as thin as 8 CTAs allow and leaves no CTA
    idle."""
    p = c // 2
    for k in range(1, jk.CLUSTER_MAX + 1):
        pairs = jk.cluster_pairs(c, k)
        if pairs > jk.CLUSTER_MAX_PAIRS:  # more than 17 warps a CTA
            assert not jk.cluster_fits(c, r, k, SMEM_H100, extra)
            continue
        assert jk.cluster_fits(c, r, k, SMEM_H100, extra)
        assert jk.cluster_threads(c, k) == 32 * (pairs + 1) <= 544
        smem = jk.cluster_smem_bytes(c, r, k, extra)
        assert smem >= 4 * (8 * pairs * r + 12 * pairs) + extra  # seats, statistics, the caller's arrays
        assert smem + jk._CLUSTER_STATIC_SMEM <= SMEM_H100
        owners = [j // pairs for j in range(p)]
        held = [owners.count(q) for q in range(k)]
        assert sum(held) == p and all(0 <= h <= pairs for h in held)
        assert owners == sorted(owners)  # CTA q holds the contiguous seats [q P, q P + P)
    k = jk.cluster_size(c)
    pairs = jk.cluster_pairs(c, k)
    assert (k - 1) * pairs < p  # the last CTA holds a seat too
    assert pairs == jk.cluster_pairs(c, jk.CLUSTER_MAX)  # the fewest pairs per CTA
    assert k == jk.CLUSTER_MAX or jk.cluster_pairs(c, k - 1) > pairs  # on as few CTAs as hold them


@pytest.mark.parametrize("p", [2, 3, 4, 8, 20, 36, 64, 68, 128])
def test_next_seat_map_returns_rows_after_a_sweep(p):
    """The next-seat map is a permutation of the 2p seats that moves rows as
    the plain twin re-seats them (jacobi_kernel._seat_phase), and 2p - 1
    phases (one sweep) bring every row back to its first seat."""
    seat_of = {row: (0, row) if row < p else (1, row - p) for row in range(2 * p)}
    first = dict(seat_of)
    # One phase of the twin on orthonormal rows (no pair rotates): row i is
    # the unit vector e_i, so each seat's row reads off its argmax.
    rows = torch.eye(2 * p)[None]
    zero = torch.zeros_like(rows[:, :p])
    wl, _, wr, _, _ = jk._seat_phase(rows[:, :p], zero, rows[:, p:], zero, hybrid=False)
    twin = {int(v): (0, s) for s, v in enumerate(wl[0].argmax(-1).tolist())}
    twin.update({int(v): (1, s) for s, v in enumerate(wr[0].argmax(-1).tolist())})
    for phase in range(2 * p - 1):
        seated = {seat: row for row, seat in seat_of.items()}
        moved = {}
        for j in range(p):
            to_l, to_r = next_seats(j, p)
            moved[seated[(0, j)]] = to_l
            moved[seated[(1, j)]] = to_r
        assert sorted(moved.values()) == sorted(seat_of.values())  # a permutation of the seats
        if phase == 0:
            assert moved == twin
        seat_of = moved
    assert seat_of == first


def test_home_helpers_agree_with_the_launch_shape():
    """The wrapper's launch arguments on each home: the C entry points'
    home codes, a block of up to 8 (shared) or 32 (global) warps, and on the
    cluster home the rule's size unless the caller names one."""
    assert jk.launch_shape(128, "shared", None) == (0, 256, 1)
    assert jk.launch_shape(256, "global", None) == (2, 1024, 1)
    k = jk.cluster_size(128)
    assert k == 8 and jk.launch_shape(128, "cluster", None) == (1, 32 * 9, 8)
    assert jk.launch_shape(128, "cluster", 4) == (1, 32 * 17, 4)
    with pytest.raises(ValueError, match="unknown plane home"):
        jk.launch_shape(128, "smem", None)


# -----------------------------------------------------------------------------
# The λ check of the card runs (chip_smoke.py, tests/test_torch_kernel.py).
# -----------------------------------------------------------------------------


def _lams(s, keep, tot2):
    """λ as the rule makes it: s * sqrt(tot2 / kept^2) where kept, else 0."""
    s, keep = np.asarray(s, np.float64), np.asarray(keep)
    kept2 = float((s[keep] ** 2).sum())
    return torch.tensor(np.where(keep, s * np.sqrt(tot2 / kept2), 0.0)[None], dtype=torch.float32)


S = [1.0, 0.5, 0.2, 0.1, 0.05]
TOT2 = float(np.sum(np.square(S)))
ALL = [True] * 5
NEAR_LAST = torch.tensor([[False, False, False, False, True]])
NOT_NEAR = torch.zeros((1, 5), dtype=torch.bool)


@pytest.mark.parametrize(
    "k_keep,k_shift,near,lam_ok,mask_ok",
    [
        (ALL, 0.0, NOT_NEAR, True, True),  # the same values
        (ALL, 2e-5, NOT_NEAR, False, True),  # a kept value off by 2e-5 s_max
        (ALL[:4] + [False], 0.0, NEAR_LAST, True, True),  # a near flip and the rescale it implies
        (ALL[:4] + [False], 0.0, NOT_NEAR, True, False),  # the same flip away from the threshold
        (ALL[:4] + [False], 5e-4, NEAR_LAST, False, True),  # a near flip does not excuse more than its rescale
    ],
    ids=["equal", "value-off", "near-flip", "flip-away", "near-flip-value-off"],
)
def test_lambda_check(k_keep, k_shift, near, lam_ok, mask_ok):
    """λ is held on the values both sides keep, to tol * s_max plus the
    relative rescale change of the flipped weight; a flip must lie in the
    near set.  The old check (|Δλ| <= tol * s_max over every value) fails
    on the near flip: the kernel's dropped value and the rescale move λ."""
    p_lam = _lams(S, ALL, TOT2)
    k_lam = _lams(S, k_keep, TOT2)
    k_lam[0, 1] += k_shift * float(p_lam.max())
    got = lambda_check(k_lam, p_lam, near, 1e-5)
    assert (got.lam_ok, got.mask_ok) == (lam_ok, mask_ok)
    assert got.flips == int((~torch.tensor(k_keep)).sum())
    if got.flips:
        w = S[4] ** 2 / TOT2  # the flipped weight's share of the twin's kept weight
        assert got.rescale == pytest.approx(1 / np.sqrt(1 - w) - 1, rel=1e-5)
        assert float((k_lam - p_lam).abs().max()) > 1e-5 * float(p_lam.max())  # the old check fails
    else:
        assert got.rescale == 0.0
