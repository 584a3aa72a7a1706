"""The batched Householder QR (ops/householder_qr.py): the plain twin
against LAPACK on the CPU, and the hand-written kernel
(csrc/householder_qr.cu) against the twin, cuSOLVER and the range-finder's
consumers on a CUDA card (marked ``cuda``: skips without a card).  This
file imports no JAX, so its card tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_householder_qr.py -q

Shapes: the range-finder's (b, 2χ, χ + 8) at χ = 128 and 64, b = 13-14 a
half-layer, 40 and 80 in the folded fleets; full-rank graded samples and
``kernel_checks.padded_pair_batch`` samples (θ's zero padding at bond ranks
4, 20 and 64).  Tolerances: in complex128 the twin's columns equal
LAPACK's to 1e-10 (graded to 1e-3: rounding times the condition); in f32
Q is orthonormal and spans the sample to 2e-5 (rounding over 256 rows),
and its columns equal LAPACK's to 1e-4 on samples graded to 1e-2."""

import numpy as np
import pytest
import torch

from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.kernel_checks import lambda_check, near_threshold, padded_pair_batch, path_planes
from aqc_research_tpu_torch.ops import fused_pair as tfp
from aqc_research_tpu_torch.ops import fused_rand as tfr
from aqc_research_tpu_torch.ops import householder_qr as hq
from aqc_research_tpu_torch.ops import rand_svd as trs

# The range-finder's shapes on the card (b, n = 2χ, l = χ + 8).
PATH_SHAPES = [(14, 256, 136), (13, 256, 136), (14, 128, 72), (13, 128, 72), (40, 128, 72), (80, 128, 72)]
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
    h100 = (232_448, 132)  # an H100's shared memory a block may opt into, its SMs
    assert hq.qr_cluster(n, ell, h100[0], batch, h100[1]) == cluster
    assert hq.qr_smem_bytes(n, ell, cluster) <= h100[0]


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


def kernel_q(y: torch.Tensor, dev, cluster=None) -> torch.Tensor:
    before = (hq.householder_qr.launches, hq.householder_qr.launches_at.get(y.shape[-2], 0))
    q = hq.householder_qr(y.to(dev), cluster=cluster)
    torch.cuda.synchronize()
    assert (hq.householder_qr.launches, hq.householder_qr.launches_at[y.shape[-2]]) == (before[0] + 1, before[1] + 1)
    return q.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,ell", PATH_SHAPES + [(4, 256, 256), (3, 200, 100), (5, 16, 8)])
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
    y = graded(n, 14, n, ell, 2.0, torch.complex64)
    pad = padded_samples(n + 1, 14, n, 20, torch.complex64)
    want = hq.householder_qr_reference(y)
    home = hq.householder_qr.launches_home.copy()
    for cluster in clusters:
        q = kernel_q(y, cuda_device, cluster)
        assert float((q - want).abs().max()) <= 1e-4
        qp = kernel_q(pad, cuda_device, cluster)
        assert finite(qp) and orth_err(qp) <= 2e-5 and span_err(qp, pad) <= 2e-5
    assert hq.householder_qr.launches_home.get("cluster", 0) - home.get("cluster", 0) == 2 * sum(c > 1 for c in clusters)


@pytest.mark.cuda
def test_kernel_raises_on_a_refused_launch_on_card(cuda_device):
    y = graded(1, 2, 256, 136, 2.0, torch.complex64).to(cuda_device)
    with pytest.raises(RuntimeError, match="householder_qr_launch"):
        hq.householder_qr(y, cluster=1)  # 256 rows on one CTA: past its 128
    with pytest.raises(ValueError):
        hq.householder_qr(y.to(C128))


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
def test_rand_programs_capture_the_kernel_on_card(cuda_device):
    """The rand obj+grad program at 8 qubits χ=64 (every pair matrix
    zero-padded): its replay equals its eager call bit for bit, and the
    launch ledger shows the kernel at 3 launches per rand half-layer (one
    K3 launch each)."""
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.ops import cuda_graphs
    from aqc_research_tpu_torch.ops import mps as tm
    from aqc_research_tpu_torch.targets.trotter import Trotter, init_ansatz_to_trotter, neel_init_state

    n, chi = 8, 64
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
        launches = cuda_graphs.kernel_launches(program.entry(x0, target).launches)
        assert launches["rand_tail"] > 0 and launches["householder_qr"] == 3 * launches["rand_tail"], launches
        assert torch.equal(f0, f_eager) and torch.equal(g0, g_eager)
        assert finite(g0.to(torch.complex64))
    finally:
        jit_asp.release_mps_programs()
        config.set_device(previous)
