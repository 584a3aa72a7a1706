"""The batched Householder QR (ops/householder_qr.py): the plain twin
against LAPACK on the CPU, and the hand-written kernel
(csrc/householder_qr.cu) against the twin, cuSOLVER and the range-finder's
consumers on a CUDA card (marked ``cuda``: skips without a card).  This
file imports no JAX, so its card tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_householder_qr.py -q

Shapes: the range-finder's (b, 2χ, χ + 8) at χ = 128 and 64, b = 13-14 a
half-layer, 40, 56 and 80 in the folded fleets; full-rank graded samples and
``kernel_checks.padded_pair_batch`` samples (θ's zero padding at bond ranks
4, 20 and 64).  Tolerances: in complex128 the twin's columns (panels of
4, 8 and 16 columns) equal LAPACK's to 1e-10 to 1e-12 (graded to 1e-3:
rounding times the condition); in f32 Q is orthonormal and spans the
sample to 2e-5 (rounding over 256 rows), and its columns equal LAPACK's
to 1e-4 on samples graded to 1e-2."""

import numpy as np
import pytest
import torch

from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.kernel_checks import lambda_check, near_threshold, padded_pair_batch, path_planes
from aqc_research_tpu_torch.ops import fused_pair as tfp
from aqc_research_tpu_torch.ops import fused_rand as tfr
from aqc_research_tpu_torch.ops import householder_qr as hq
from aqc_research_tpu_torch.ops import rand_svd as trs
from tests import _torch_threads  # noqa: F401

# The range-finder's shapes on the card (b, n = 2χ, l = χ + 8).
PATH_SHAPES = [(14, 256, 136), (13, 256, 136), (14, 128, 72), (13, 128, 72), (40, 128, 72), (80, 128, 72),
               (56, 256, 136)]
H100 = (232_448, 132)  # an H100's shared memory a block may opt into, its SMs
C128 = torch.complex128


def graded(seed: int, batch: int, n: int, ell: int, decades: float, dtype=C128) -> torch.Tensor:
    """(batch, n, ell) samples of full rank, singular values 1 .. 10^-decades."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((batch, n, ell)) + 1j * rng.standard_normal((batch, n, ell))
    u, _, vh = np.linalg.svd(g, full_matrices=False)
    s = 10.0 ** (-decades * np.arange(ell) / max(ell - 1, 1))
    return torch.tensor((u * s[None, None, :]) @ vh, dtype=dtype)


def padded_samples(seed: int, batch: int, n: int, rank: int, dtype=C128) -> torch.Tensor:
    """The range-finder's first sample Y = A Ω of zero-padded pair matrices
    A (bonds of rank ``rank`` held at χ = n/2): rank 2 rank, rows outside
    the two blocks exactly zero."""
    a = padded_pair_batch(np.random.default_rng(seed), batch, n, rank).to(dtype)
    return torch.matmul(a, trs.sketch(batch, n, trs.rand_ell(n, n // 2), dtype, "cpu"))


def orth_err(q: torch.Tensor) -> float:
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    return float((q.mH @ q - eye).abs().max())


def span_err(q: torch.Tensor, y: torch.Tensor) -> float:
    """max |(I - Q Q^H) Y| over max |Y|, in complex128."""
    q, y = q.to(C128), y.to(C128)
    return float((y - q @ (q.mH @ y)).abs().max() / y.abs().max())


def finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all())


# -----------------------------------------------------------------------------
# The twin, on the CPU.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("batch,n,ell", [(2, 256, 136), (14, 256, 136), (4, 128, 72)])
def test_twin_matches_lapack_on_graded_samples(batch, n, ell):
    y = graded(batch + n, batch, n, ell, 3.0)
    q = hq.householder_qr_reference(y)
    want = torch.linalg.qr(y, mode="reduced")[0]
    assert float((q - want).abs().max()) <= 1e-10
    assert orth_err(q) <= 1e-12 and span_err(q, y) <= 1e-12


@pytest.mark.parametrize("n,rank", [(128, 4), (256, 20), (256, 64)])
def test_twin_on_padded_pair_samples(n, rank):
    """Rank 2 rank of l columns: the leading 2 rank columns equal LAPACK's,
    the rest come out orthonormal, finite, and the span holds the sample."""
    y = padded_samples(n + rank, 6, n, rank)
    q = hq.householder_qr_reference(y)
    want = torch.linalg.qr(y, mode="reduced")[0]
    assert finite(q) and orth_err(q) <= 1e-12 and span_err(q, y) <= 1e-12
    assert float((q[..., : 2 * rank] - want[..., : 2 * rank]).abs().max()) <= 1e-8


@pytest.mark.parametrize("n,rank", [(128, 4), (256, 20), (256, 64)])
def test_twin_on_padded_pair_samples_in_f32(n, rank):
    y = padded_samples(n + rank, 6, n, rank, torch.complex64)
    q = hq.householder_qr_reference(y)
    assert finite(q) and orth_err(q) <= 2e-5 and span_err(q, y) <= 2e-5


@pytest.mark.parametrize("scale", [1e-23, 1e-26])
def test_twin_keeps_columns_scaled_far_below_f32s_normal_range(scale):
    """QR of Y D with D > 0 diagonal has the Q of Y: half the columns scaled
    to `scale` (their squares underflow f32, their entries stay above the
    2^-100 floor) keep LAPACK's columns."""
    y = graded(7, 3, 128, 72, 2.0)
    ys = y.clone()
    ys[..., 36:] *= scale
    q = hq.householder_qr_reference(ys.to(torch.complex64))
    want = torch.linalg.qr(y, mode="reduced")[0]
    assert finite(q) and orth_err(q) <= 2e-5
    assert float((q.to(C128) - want).abs().max()) <= 1e-4


def test_twin_gives_identity_reflectors_below_the_floor():
    """Zero columns, and columns below 2^-100, get tau = 0: Q stays finite
    and orthonormal and spans the columns above the floor."""
    y = graded(8, 3, 128, 72, 2.0, torch.complex64)
    y[..., 10] = 0
    y[..., 40:] *= 1e-35
    q = hq.householder_qr_reference(y)
    assert finite(q) and orth_err(q) <= 2e-5
    assert span_err(q, y[..., :40]) <= 2e-5


def test_wrapper_runs_the_twin_on_cpu_tensors():
    y = graded(9, 2, 64, 24, 2.0, torch.complex64)
    before = hq.householder_qr.launches
    assert torch.equal(hq.householder_qr(y), hq.householder_qr_reference(y))
    assert hq.householder_qr.launches == before


def test_orth_on_cpu_stays_lapacks():
    y = graded(10, 2, 64, 24, 2.0, torch.complex64)
    assert torch.equal(trs._orth(y), torch.linalg.qr(y, mode="reduced")[0])


@pytest.mark.parametrize("batch,n,ell,cluster", [
    (14, 256, 136, 4), (14, 128, 72, 4), (33, 256, 136, 4),  # a half-layer: four CTAs a matrix
    (34, 256, 136, 2), (40, 128, 72, 1), (80, 128, 72, 1),  # past one wave: the fewest that hold it
    (40, 128, 128, 1), (40, 256, 256, 4), (14, 64, 40, 1), (14, 16, 8, 1),
])
def test_qr_cluster_spreads_a_half_layer_and_packs_a_fleet(batch, n, ell, cluster):
    assert hq.qr_cluster(n, ell, H100[0], batch, H100[1]) == cluster
    assert hq.qr_blocked_smem_bytes(n, ell, cluster, hq.qr_panel(n, ell, cluster, H100[0])) <= H100[0]


def test_qr_cluster_raises_where_no_cluster_holds_a_panel():
    with pytest.raises(ValueError, match="no cluster holds"):
        hq.qr_cluster(256, 136, 100_000, 14, H100[1])


# Shapes for the twin at every panel width: the path's, a ragged last panel
# (l not a multiple of the panel), l below one panel, l = n.
BLOCKED_SHAPES = [(2, 256, 136), (3, 128, 72), (2, 100, 37), (3, 40, 7), (2, 64, 64)]


@pytest.mark.parametrize("nb", [4, 8, 16])
@pytest.mark.parametrize("batch,n,ell", BLOCKED_SHAPES)
def test_blocked_twin_matches_lapack_in_c128(batch, n, ell, nb):
    y = graded(batch * n + ell + nb, batch, n, ell, 3.0)
    q = hq.householder_qr_reference(y, nb)
    want = torch.linalg.qr(y, mode="reduced")[0]
    cols = min(ell, n - 1)  # at l = n the last column's phase is LAPACK's own choice
    assert float((q - want)[..., :cols].abs().max()) <= 1e-12
    assert orth_err(q) <= 1e-12 and span_err(q, y) <= 1e-12


@pytest.mark.parametrize("nb", [4, 8, 16])
@pytest.mark.parametrize("batch,n,ell", BLOCKED_SHAPES)
def test_blocked_twin_matches_the_unblocked_twin_in_f32(batch, n, ell, nb):
    """In f32 the twin's columns equal LAPACK's (complex128) to 1e-4 on
    samples graded to 1e-2, and Q is orthonormal and spans the sample."""
    y = graded(batch * n + ell + nb + 1, batch, n, ell, 2.0, torch.complex64)
    q = hq.householder_qr_reference(y, nb)
    want = torch.linalg.qr(y.to(C128), mode="reduced")[0]
    cols = min(ell, n - 1)  # at l = n the last column's phase is LAPACK's own choice
    assert float((q.to(C128) - want)[..., :cols].abs().max()) <= 1e-4
    assert orth_err(q) <= 2e-5 and span_err(q, y) <= 2e-5


@pytest.mark.parametrize("nb", [4, 8, 16])
@pytest.mark.parametrize("n,rank", [(128, 4), (256, 20), (256, 64)])
def test_blocked_twin_on_padded_pair_samples(n, rank, nb):
    """Whole panels of tau = 0 past rank 2 rank: the leading columns equal
    LAPACK's in complex128; in f32 Q is finite and orthonormal and spans
    the sample, and its leading columns lie within 1.61e-4 of LAPACK's:
    twice the largest error (8.04e-5, at rank 64, measured once) that an
    unblocked Householder QR with the same reflectors gives in f32 on these
    samples, whose condition (up to ~3e3 at rank 64) lets any f32 QR be
    1e-4 off."""
    y = padded_samples(n + rank + nb, 3, n, rank)
    q = hq.householder_qr_reference(y, nb)
    want = torch.linalg.qr(y, mode="reduced")[0][..., : 2 * rank]
    assert finite(q) and orth_err(q) <= 1e-12 and span_err(q, y) <= 1e-12
    assert float((q[..., : 2 * rank] - want).abs().max()) <= 1e-8
    y32 = y.to(torch.complex64)
    q32 = hq.householder_qr_reference(y32, nb)
    assert finite(q32) and orth_err(q32) <= 2e-5 and span_err(q32, y32) <= 2e-5
    assert float((q32[..., : 2 * rank].to(C128) - want).abs().max()) <= 1.61e-4


def near_floor_samples(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Graded (3, 128, 72) samples in complex128 and, in f32, the same with
    columns 36-49 scaled by 2^-80 (their residuals stay above the 2^-100
    floor, their squares far below f32's normal range) and columns 50- by
    2^-120 (below the floor: tau = 0)."""
    y = graded(seed, 3, 128, 72, 2.0)
    ys = y.clone()
    ys[..., 36:50] *= 2.0**-80
    ys[..., 50:] *= 2.0**-120
    return y, ys.to(torch.complex64)


@pytest.mark.parametrize("nb", [8, 16])
def test_blocked_twin_gives_identity_reflectors_below_the_floor(nb):
    """The columns above the floor keep LAPACK's columns, those below get
    tau = 0, and Q stays finite and orthonormal."""
    y, ys = near_floor_samples(11)
    q = hq.householder_qr_reference(ys, nb)
    want = torch.linalg.qr(y[..., :50], mode="reduced")[0]
    assert finite(q) and orth_err(q) <= 2e-5
    assert float((q[..., :50].to(C128) - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("batch,n,ell,plan", [
    (14, 256, 136, (4, 16)), (13, 256, 136, (4, 16)), (14, 128, 72, (4, 16)),  # a half-layer
    (56, 256, 136, (2, 16)), (40, 128, 72, (1, 16)), (80, 128, 72, (1, 16)),  # the folded fleets
    (4, 256, 256, (4, 8)),  # l = n: 16 columns a panel do not fit four CTAs' shared memory
    (14, 64, 40, (1, 16)), (14, 64, 16, (1, 16)), (14, 64, 12, (1, 8)), (14, 16, 8, (1, 8)),  # one panel and more
    (14, 16, 7, (1, 8)), (14, 16, 1, (1, 8)), (14, 256, 5, (4, 8)),  # l below the narrowest panel: one ragged panel
    (40, 256, 256, (4, 8)),  # past one wave, but no panel fits two CTAs' shared memory: four
])
def test_qr_plan_chooses_ctas_and_panel_width(batch, n, ell, plan):
    assert hq.qr_plan(n, ell, H100[0], batch, H100[1]) == plan
    cluster, nb = plan
    assert hq.qr_blocked_smem_bytes(n, ell, cluster, nb) <= H100[0]
    if nb == 8 and ell > 16:
        assert hq.qr_blocked_smem_bytes(n, ell, cluster, 16) > H100[0]
    if cluster > 1 and batch * 4 > H100[1]:  # the fewest CTAs that take a panel
        assert all(hq.qr_panel(n, ell, c, H100[0]) == 0 for c in hq.CLUSTERS if c < cluster)


def test_qr_panel_leaves_rows_past_a_cta_to_the_launch():
    """256 rows on one CTA: no panel; the launch refuses the shape."""
    assert hq.qr_panel(256, 136, 1, H100[0]) == 0


def test_qr_panel_takes_16_wherever_it_fits_l():
    assert hq.qr_panel(256, 136, 2, H100[0]) == 16  # the fleet's 28q batch: 231,808 B of 232,448
    assert hq.qr_blocked_smem_bytes(256, 136, 2, 16) == 231_808
    assert hq.qr_panel(256, 256, 4, H100[0]) == 8
    assert hq.qr_panel(256, 256, 2, H100[0]) == 0


@pytest.mark.parametrize("bad", ["dtype", "rank", "rows", "cols", "strided"])
def test_check_qr_args_raises(bad):
    y = torch.zeros((2, 64, 24), dtype=torch.complex64)
    y = {"dtype": y.to(C128), "rank": y[0], "rows": torch.zeros((1, 272, 24), dtype=torch.complex64),
         "cols": torch.zeros((1, 16, 24), dtype=torch.complex64), "strided": y[:, ::2]}[bad]
    with pytest.raises(ValueError):
        hq.check_qr_args(y)


# -----------------------------------------------------------------------------
# The kernel, on the card.
# -----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def chunked_qr(y: torch.Tensor) -> torch.Tensor:
    """cuSOLVER's QR: torch.linalg.qr in chunks of max(2, n // 16) - 1
    matrices, which it factors one at a time (cuBLAS's batched geqrf, which
    torch takes for larger batches, returns NaN on padded samples)."""
    return torch.cat([torch.linalg.qr(c, mode="reduced")[0] for c in y.split(max(1, max(2, y.shape[-2] // 16) - 1))])


def kernel_q(y: torch.Tensor, dev, cluster=None, panel=None) -> torch.Tensor:
    before = (hq.householder_qr.launches, hq.householder_qr.launches_at.get(y.shape[-2], 0))
    q = hq.householder_qr(y.to(dev), cluster=cluster, panel=panel)
    torch.cuda.synchronize()
    assert (hq.householder_qr.launches, hq.householder_qr.launches_at[y.shape[-2]]) == (before[0] + 1, before[1] + 1)
    return q.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,ell", PATH_SHAPES + [(4, 256, 256), (3, 200, 100), (5, 16, 8), (14, 128, 1),
                                                       (14, 256, 5), (3, 64, 7), (150, 256, 136)])
def test_kernel_matches_twin_and_cusolver_on_graded_samples_on_card(cuda_device, batch, n, ell):
    """Columns equal LAPACK's, the twin's and cuSOLVER's (at l = n the last
    column's phase is each library's own choice: it is left out)."""
    y = graded(batch + n + ell, batch, n, ell, 2.0, torch.complex64)
    q = kernel_q(y, cuda_device)
    assert finite(q) and orth_err(q) <= 2e-5 and span_err(q, y) <= 2e-5
    cols = min(ell, n - 1)
    for want in (torch.linalg.qr(y.to(C128), mode="reduced")[0], hq.householder_qr_reference(y),
                 chunked_qr(y.to(cuda_device)).cpu()):
        assert float((q.to(C128) - want.to(C128))[..., :cols].abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("nb", hq.PANELS)
@pytest.mark.parametrize("batch,n,ell", [
    (14, 256, 136), (56, 256, 136), (14, 128, 72), (40, 128, 72), (80, 128, 72),  # the path's
    (3, 200, 100), (5, 64, 12), (5, 64, 5),  # a ragged last panel; l below one panel
    (4, 256, 256), (3, 64, 64),  # l = n
])
def test_blocked_kernel_matches_lapack_twins_and_cusolver_on_card(cuda_device, batch, n, ell, nb):
    """The blocked kernel at both panel widths, on the rule's CTAs: its
    columns equal LAPACK's (complex128), the twin's and cuSOLVER's to 1e-4
    (at l = n the last column's phase is each library's own choice), Q is
    orthonormal and spans the sample, and the launch counts as blocked."""
    from aqc_research_tpu_torch.ops import cuda_build

    dev = cuda_build.device_index(torch.empty(0, device=cuda_device))
    cluster = hq.qr_cluster(n, ell, cuda_build.max_smem(dev), batch, cuda_build.sm_count(dev))
    if hq.qr_blocked_smem_bytes(n, ell, cluster, nb) > cuda_build.max_smem(dev):
        pytest.skip(f"panels of {nb} columns do not fit {cluster} CTAs' shared memory at ({n}, {ell})")
    y = graded(batch + n + ell + nb, batch, n, ell, 2.0, torch.complex64)
    blocked = hq.householder_qr.launches_home.get("blocked", 0)
    q = kernel_q(y, cuda_device, panel=nb)
    assert hq.householder_qr.launches_home["blocked"] == blocked + 1
    assert finite(q) and orth_err(q) <= 2e-5 and span_err(q, y) <= 2e-5
    cols = min(ell, n - 1)
    for want in (torch.linalg.qr(y.to(C128), mode="reduced")[0], hq.householder_qr_reference(y, nb),
                 chunked_qr(y.to(cuda_device)).cpu()):
        assert float((q.to(C128) - want.to(C128))[..., :cols].abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_near_the_floor_on_card(cuda_device):
    """Columns scaled to 2^-80 keep LAPACK's columns, columns at 2^-120 get
    tau = 0; the rule's (blocked) kernel equals its twin there."""
    y, ys = near_floor_samples(12)
    q = kernel_q(ys, cuda_device)
    assert finite(q) and orth_err(q) <= 2e-5
    want = torch.linalg.qr(y[..., :50], mode="reduced")[0]
    assert float((q[..., :50].to(C128) - want).abs().max()) <= 1e-4
    assert float((q - hq.householder_qr_reference(ys)).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,ell", [(14, 256, 136), (56, 256, 136), (14, 128, 72), (80, 128, 72)])
@pytest.mark.parametrize("panel", [None, 8])
def test_two_launches_give_the_same_bits_on_card(cuda_device, batch, n, ell, panel):
    """No atomics: the same input gives the same Q bit for bit, graded and
    padded, so a graph's replay equals its eager call."""
    for y in (graded(n + 3, batch, n, ell, 2.0, torch.complex64),
              padded_samples(n + 4, batch, n, 20, torch.complex64)):
        y = y.to(cuda_device)
        first = hq.householder_qr(y, panel=panel)
        second = hq.householder_qr(y, panel=panel)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,ell", PATH_SHAPES)
@pytest.mark.parametrize("rank", [4, 20, 64])
def test_kernel_on_padded_pair_samples_on_card(cuda_device, batch, n, ell, rank):
    """θ's zero padding (rank 2 rank of l columns): the kernel's Q, like the
    twin's and cuSOLVER's (chunked), is finite and orthonormal and spans the
    sample."""
    y = padded_samples(batch + n + rank, batch, n, rank, torch.complex64)
    q = kernel_q(y, cuda_device)
    for got in (q, hq.householder_qr_reference(y), chunked_qr(y.to(cuda_device)).cpu()):
        assert finite(got) and orth_err(got) <= 2e-5 and span_err(got, y) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,ell,clusters", [(256, 136, (2, 4)), (128, 72, (1, 2, 4))])
def test_kernel_at_every_cluster_size_on_card(cuda_device, n, ell, clusters):
    """Every panel width that fits, on every cluster size: Q equals the
    twin's on graded samples and is orthonormal on padded ones, and every
    launch counts as "blocked"."""
    from aqc_research_tpu_torch.ops import cuda_build

    smem = cuda_build.max_smem(cuda_build.device_index(torch.empty(0, device=cuda_device)))
    y = graded(n, 14, n, ell, 2.0, torch.complex64)
    pad = padded_samples(n + 1, 14, n, 20, torch.complex64)
    want = {nb: hq.householder_qr_reference(y, nb) for nb in hq.PANELS}
    home = hq.householder_qr.launches_home.copy()
    runs = 0
    for cluster in clusters:
        for nb in hq.PANELS:
            if hq.qr_blocked_smem_bytes(n, ell, cluster, nb) > smem:
                continue
            q = kernel_q(y, cuda_device, cluster, nb)
            assert float((q - want[nb]).abs().max()) <= 1e-4
            qp = kernel_q(pad, cuda_device, cluster, nb)
            assert finite(qp) and orth_err(qp) <= 2e-5 and span_err(qp, pad) <= 2e-5
            runs += 2
    assert runs >= 2 * len(clusters)
    counts = {h: hq.householder_qr.launches_home.get(h, 0) - home.get(h, 0) for h in ("shared", "cluster", "blocked")}
    assert counts == {"shared": 0, "cluster": 0, "blocked": runs}


@pytest.mark.cuda
def test_kernel_raises_on_a_refused_launch_on_card(cuda_device):
    y = graded(1, 2, 256, 136, 2.0, torch.complex64).to(cuda_device)
    with pytest.raises(RuntimeError, match="householder_qr_launch"):
        hq.householder_qr(y, cluster=1)  # 256 rows on one CTA: past its 128
    with pytest.raises(RuntimeError, match="householder_qr_launch"):
        hq.householder_qr(y, cluster=1, panel=16)
    with pytest.raises(ValueError):
        hq.householder_qr(y.to(C128))
    with pytest.raises(ValueError):
        hq.householder_qr(y, panel=12)
    with pytest.raises(ValueError):
        hq.householder_qr(y, panel=0)


@pytest.mark.cuda
@pytest.mark.parametrize("chi,batch,rank", [(64, 14, None), (64, 14, 4), (64, 80, 20), (128, 14, None), (128, 14, 20)])
@pytest.mark.parametrize("thr2", [1e-12, 1e-4])
def test_range_finder_and_rand_tail_agree_with_cusolvers_route_on_card(cuda_device, monkeypatch, chi, batch, rank,
                                                                       thr2):
    """The range-finder's B = Q^H θ and K3's λ with the kernel against the
    same with cuSOLVER's chunked QR, on the card: B's singular values within
    1e-5 s_max, λ and keep masks by kernel_checks.lambda_check (flips only
    near the threshold)."""
    w_re, w_im = tfp.theta_build_reference(*path_planes(np.random.default_rng(chi + batch), batch, chi, cuda_device,
                                                        rank=rank))
    a = torch.complex(w_re, w_im).transpose(-1, -2)
    tot2 = (w_re * w_re + w_im * w_im).sum((-2, -1))
    ell = trs.rand_ell(2 * chi, chi)
    out = {}
    for route in ("cusolver", "kernel"):
        if route == "cusolver":
            monkeypatch.setattr(trs, "_orth", chunked_qr)
        before = hq.householder_qr.launches
        bm = trs._range_project(a, ell, trs._POWER_ITERS)
        assert hq.householder_qr.launches - before == (3 if route == "kernel" else 0)
        monkeypatch.undo()
        lam = tfr.rand_tail(bm.real.contiguous(), (-bm.imag).contiguous(), tot2, thr2, chi, 12)[2]
        out[route] = (torch.linalg.svdvals(bm), lam)
    torch.cuda.synchronize()
    (s_old, lam_old), (s_new, lam_new) = out["cusolver"], out["kernel"]
    assert finite(s_new) and float((s_new - s_old).abs().max()) <= 1e-5 * float(s_old.max())
    checked = lambda_check(lam_new, lam_old, near_threshold(s_old, tot2, thr2, chi), 1e-5)
    assert checked.lam_ok and checked.mask_ok, checked


@pytest.mark.cuda
@pytest.mark.parametrize("chi", [64, 128])
def test_rand_programs_capture_the_kernel_on_card(cuda_device, chi):
    """The rand obj+grad program at 8 qubits χ=64 and χ=128 (every pair
    matrix zero-padded, Q1 at (128, 72) and (256, 136)): its replay equals
    its eager call bit for bit, and the launch ledger shows the kernel at 3
    launches per rand half-layer (one K3 launch each), every one blocked."""
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.ops import cuda_graphs
    from aqc_research_tpu_torch.ops import mps as tm
    from aqc_research_tpu_torch.targets.trotter import Trotter, init_ansatz_to_trotter, neel_init_state

    n = 8
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, 2), True)
    th = init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=1.2, delta=1.0)
    th = th + 0.05 * np.random.default_rng(5).standard_normal(circ.num_thetas)
    x0 = torch.tensor(th, dtype=torch.float32, device=cuda_device)
    t = Trotter(num_qubits=n, evol_time=1.2, num_steps=3, delta=1.0, second_order=True).as_mps(
        neel_init_state(n), trunc_thr=1e-6, chi_max=chi)
    target = tm.MPS(t.gammas.to(cuda_device, torch.complex64), t.lambdas.to(cuda_device, torch.float32))
    bits = tuple(1 if q % 2 == 0 else 0 for q in range(n))
    previous = config._DEVICE
    config.set_device("cpu")
    jit_asp.release_mps_programs()
    try:
        program = jit_asp._mps_value_and_grad_program(circ, bits, 1e-6, "rand")
        with cuda_graphs.eager():
            f_eager, g_eager = program(x0, target)
        f0, g0 = program(x0, target)
        torch.cuda.synchronize()
        ledger = program.entry(x0, target).launches
        launches = cuda_graphs.kernel_launches(ledger)
        assert launches["rand_tail"] > 0 and launches["householder_qr"] == 3 * launches["rand_tail"], launches
        assert ledger[("householder_qr", "home", "blocked")] == launches["householder_qr"], ledger
        assert ledger[("householder_qr", "at", 2 * chi)] == launches["householder_qr"], ledger
        assert torch.equal(f0, f_eager) and torch.equal(g0, g_eager)
        assert finite(g0.to(torch.complex64))
    finally:
        jit_asp.release_mps_programs()
        config.set_device(previous)
