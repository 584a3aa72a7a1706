"""The hand-written kernels (csrc/jacobi_rows.cu, csrc/theta_build.cu,
csrc/rand_tail.cu, csrc/fused_pair.cu) against their plain twins, on a CUDA
card, with planes in one block's shared memory, in a thread-block cluster's
distributed shared memory (K1 and K3 at the path shapes, K4 at 176 <= 2chi
<= 256) and in device memory (K1 and K3 at their old homes past one block,
K4 from 2chi = 272).  Marked
``cuda``: skips without a card.  This file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py -q

Tolerances: singular values within 1e-5 * s_max (the f32 convergence floor
of the adaptive loop, tol 1e-6 per entry, plus two rounding orders); sweep
counts within 1 (a sweep's residual can land on either side of the tolerance
under different rounding); the θ build within 1e-5 relative Frobenius (f32
products in two orders); kept vh projectors within 2e-5 (K4: uᵀ and vh
projectors weighted by s_k / s_max — the stopping rule fixes a kept
direction only to ~1e-6 s_max / s_k, so a sweep count one apart moves the
small ones that far, and vh = diag(1/s) uᴴ m multiplies the product's
rounding by s_max / s_k — and the reconstruction within 1e-5 * s_max);
keep masks equal except where a value's keep decision lies within the λ
tolerance of the truncation threshold
(aqc_research_tpu_torch.kernel_checks.near_threshold), and λ held on the
values both sides keep, allowing for the rescale change such a flip
implies (kernel_checks.lambda_check)."""

import numpy as np
import pytest
import torch

from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.kernel_checks import lambda_check, near_threshold, padded_pair_batch, path_planes
from aqc_research_tpu_torch.ops import fused_pair as tfp
from aqc_research_tpu_torch.ops import fused_rand as tfr
from aqc_research_tpu_torch.ops import jacobi_kernel as jk
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops import rand_svd as trs
from aqc_research_tpu_torch.targets.trotter import (
    Trotter,
    _block_4x4_lo_hi,
    neel_init_state,
    trotter_alphas,
)


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


def graded(seed: int, batch: int, n: int) -> np.ndarray:
    """Complex64 matrices with a log-spaced spectrum 1 .. 1e-2."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    u, _, vh = np.linalg.svd(a)
    s = 10.0 ** (-2.0 * np.arange(n) / (n - 1))
    return ((u * s[None, None, :]) @ vh).astype(np.complex64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("criterion", ["entry", "hybrid"])
def test_kernel_matches_twin_on_card(cuda_device, criterion):
    for n in (8, 16, 32, 64, 128):
        m = torch.tensor(graded(n, 10, n), device=cuda_device)
        mt = m.transpose(-1, -2)
        re, im = mt.real.contiguous(), mt.imag.contiguous()
        before = jk.jacobi_rows.launches
        k_re, k_im, k_sw = jk.jacobi_rows(re, im, 12, criterion)
        assert jk.jacobi_rows.launches == before + 1
        p_re, p_im, p_sw = jk.jacobi_rows_reference(re, im, 12, criterion)
        torch.cuda.synchronize()
        ks = torch.sqrt((k_re**2 + k_im**2).sum(-1)).sort(-1).values
        ps = torch.sqrt((p_re**2 + p_im**2).sum(-1)).sort(-1).values
        assert float((ks - ps).abs().max()) <= 1e-5 * float(ps.max())
        assert int((k_sw - p_sw).abs().max()) <= 1


@pytest.mark.cuda
def test_kernel_takes_the_256_shape_on_card(cuda_device):
    """K1 at 256x256 (the 28q chi=128 pair matrices), planes in a cluster's
    distributed shared memory: the same singular values and sweep counts
    as its twin."""
    m = torch.tensor(graded(256, 2, 256), device=cuda_device)
    mt = m.transpose(-1, -2)
    re, im = mt.real.contiguous(), mt.imag.contiguous()
    assert jk.plane_home(256, 256, jk.cuda_build.max_smem(0)) == "cluster"
    before = jk.jacobi_rows.launches
    k_re, k_im, k_sw = jk.jacobi_rows(re, im, 12)
    assert jk.jacobi_rows.launches == before + 1
    p_re, p_im, p_sw = jk.jacobi_rows_reference(re, im, 12)
    torch.cuda.synchronize()
    ks = torch.sqrt((k_re**2 + k_im**2).sum(-1)).sort(-1).values
    ps = torch.sqrt((p_re**2 + p_im**2).sum(-1)).sort(-1).values
    assert float((ks - ps).abs().max()) <= 1e-5 * float(ps.max())
    assert int((k_sw - p_sw).abs().max()) <= 1


@pytest.mark.cuda
def test_pair_update_routes_agree_on_card(cuda_device):
    """A Trotter half-layer at χ=64 (128x128 pair matrices) on the jacobi
    route (one kernel launch) and on the native route give the same state
    to f32 accuracy (1e-4 per amplitude of a unit vector)."""
    n = 8
    trot = Trotter(num_qubits=n, evol_time=0.8, num_steps=2, delta=1.0, second_order=True)
    with config.svd_impl_override("native"):
        state = trot.as_mps(neel_init_state(n), trunc_thr=1e-6, chi_max=64,
                            dtype=torch.complex64, device=cuda_device)
    block = _block_4x4_lo_hi(trotter_alphas(0.3, 1.0), torch.complex64, cuda_device)
    out = {}
    for route in ("jacobi", "native"):
        with config.svd_impl_override(route):
            before = jk.jacobi_rows.launches
            out[route] = tm.mps_to_vector(
                tm.apply_pairs_mps(state, block.expand(3, 4, 4), (1, 3, 5), trunc_thr=1e-6)
            ).cpu().numpy()
            assert jk.jacobi_rows.launches == before + (route == "jacobi")
    np.testing.assert_allclose(out["jacobi"], out["native"], atol=1e-4)
    assert abs(np.vdot(out["jacobi"], out["native"])) >= 1 - 1e-5


def tail_inputs(seed: int, batch: int, chi: int, dev, rank=None):
    """conj(B) planes, full weights and B's singular values of projected
    rand-route pair matrices (the twin builds θ, torch projects it); with
    ``rank`` from bonds of that rank, zero-padded as on the MPS path."""
    w_re, w_im = tfp.theta_build_reference(*path_planes(np.random.default_rng(seed), batch, chi, dev, rank=rank))
    a = torch.complex(w_re, w_im).transpose(-1, -2)
    bm = trs._range_project(a, trs.rand_ell(2 * chi, chi), trs._POWER_ITERS)
    tot2 = (w_re * w_re + w_im * w_im).sum((-2, -1))
    return bm.real.contiguous(), (-bm.imag).contiguous(), tot2, torch.linalg.svdvals(bm)


@pytest.mark.cuda
@pytest.mark.parametrize("chi", [16, 64])
def test_theta_build_matches_twin_on_card(cuda_device, chi):
    planes = path_planes(np.random.default_rng(chi), 10, chi, cuda_device)
    before = tfp.theta_build.launches
    k_re, k_im = tfp.theta_build(*planes)
    assert tfp.theta_build.launches == before + 1
    p_re, p_im = tfp.theta_build_reference(*planes)
    torch.cuda.synchronize()
    err = torch.linalg.matrix_norm(torch.complex(k_re - p_re, k_im - p_im))
    assert float((err / torch.linalg.matrix_norm(torch.complex(p_re, p_im))).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("chi", [16, 64, 128])
def test_rand_tail_matches_twin_on_card(cuda_device, chi):
    batch = 10 if chi < 128 else 3  # chi = 128: planes in device memory
    m_re, m_im, tot2, s = tail_inputs(chi + 1, batch, chi, cuda_device)
    thr2 = 1e-4  # trunc_thr 1e-2: the cut sits well above the f32 noise
    before = tfr.rand_tail.launches
    k_vh_re, k_vh_im, k_lam, k_inv, k_sw = tfr.rand_tail(m_re, m_im, tot2, thr2, chi, 12)
    assert tfr.rand_tail.launches == before + 1
    p_vh_re, p_vh_im, p_lam, p_inv, p_sw = tfr.rand_tail_reference(m_re, m_im, tot2, thr2, chi, 12)
    torch.cuda.synchronize()
    checked = lambda_check(k_lam, p_lam, near_threshold(s, tot2, thr2, chi), 1e-5)
    assert checked.lam_ok and checked.mask_ok, checked
    k_keep, p_keep = k_lam > 0, p_lam > 0
    assert not bool(p_keep.all())  # truncation is active
    assert int((k_sw - p_sw).abs().max()) <= 1
    both = (k_keep & p_keep)[..., None].to(torch.complex64)
    kv = torch.complex(k_vh_re, k_vh_im) * both
    pv = torch.complex(p_vh_re, p_vh_im) * both
    proj = kv.conj().transpose(-1, -2) @ kv - pv.conj().transpose(-1, -2) @ pv
    assert float(proj.abs().max()) <= 2e-5


def rows_planes(m):
    """K1's transposed planes of (B, n, n) complex matrices on the card."""
    mt = m.transpose(-1, -2)
    return mt.real.contiguous(), mt.imag.contiguous()


# (n, batch, rank): the 20q path shape (B=10 at 128 rows), the 28q pair
# matrices at 256 rows, a head, each graded or zero-padded (bonds of rank
# ``rank`` held at chi = n/2, as on the MPS path).
K1_CLUSTER_CASES = [(128, 10, None), (128, 10, 4), (256, 3, None), (256, 3, 20), (64, 10, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch,rank", K1_CLUSTER_CASES)
def test_jacobi_rows_cluster_matches_twin_on_card(cuda_device, n, batch, rank):
    """K1 on the cluster home against its twin (singular values, sweep
    counts within 1), and the same sweep counts as its old one-block home
    (shared memory at 128 rows and below, device memory at 256) on the
    same inputs: the loop's arithmetic is the same term for term."""
    rng = np.random.default_rng(n + batch)
    a = graded(n, batch, n) if rank is None else padded_pair_batch(rng, batch, n, rank).numpy()
    re, im = rows_planes(torch.tensor(a, device=cuda_device))
    assert jk.plane_home(n, n, jk.cuda_build.max_smem(0)) == "cluster"
    before = dict(jk.jacobi_rows.launches_home)
    k_re, k_im, k_sw = jk.jacobi_rows(re, im, 12, home="cluster")
    assert jk.jacobi_rows.launches_home.get("cluster", 0) == before.get("cluster", 0) + 1
    p_re, p_im, p_sw = jk.jacobi_rows_reference(re, im, 12)
    o_re, o_im, o_sw = jk.jacobi_rows(re, im, 12, home="shared" if n <= 128 else "global")
    torch.cuda.synchronize()

    def values(w_re, w_im):
        return torch.sqrt((w_re**2 + w_im**2).sum(-1)).sort(-1).values

    ps = values(p_re, p_im)
    assert float((values(k_re, k_im) - ps).abs().max()) <= 1e-5 * float(ps.max())
    assert float((values(o_re, o_im) - ps).abs().max()) <= 1e-5 * float(ps.max())
    assert int((k_sw - p_sw).abs().max()) <= 1
    assert torch.equal(k_sw, o_sw)


# (chi, batch, rank): the 20q path shape (B=10 at chi = 64), the 28q one
# (B=14 at chi = 128), each on graded and on zero-padded pair matrices.
K3_CLUSTER_CASES = [(64, 10, None), (64, 10, 4), (128, 14, None), (128, 14, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("chi,batch,rank", K3_CLUSTER_CASES)
@pytest.mark.parametrize("thr2", [1e-12, 1e-4])
def test_rand_tail_cluster_matches_twin_on_card(cuda_device, chi, batch, rank, thr2):
    """K3 on the cluster home (its epilogue spread over the cluster's CTAs)
    against its twin at trunc 1e-6 and 1e-2: λ and keep masks, the kept vh
    projector, sweep counts within 1; and the same sweep counts as its old
    home (shared memory at chi = 64, device memory at 128)."""
    m_re, m_im, tot2, s = tail_inputs(chi + batch, batch, chi, cuda_device, rank)
    assert tfr.tail_plane_home(m_re.shape[1], 2 * chi, chi, jk.cuda_build.max_smem(0)) == "cluster"
    k_vh_re, k_vh_im, k_lam, _, k_sw = tfr.rand_tail(m_re, m_im, tot2, thr2, chi, 12, home="cluster")
    p_vh_re, p_vh_im, p_lam, _, p_sw = tfr.rand_tail_reference(m_re, m_im, tot2, thr2, chi, 12)
    o_sw = tfr.rand_tail(m_re, m_im, tot2, thr2, chi, 12, home="shared" if chi <= 112 else "global")[4]
    torch.cuda.synchronize()
    checked = lambda_check(k_lam, p_lam, near_threshold(s, tot2, thr2, chi), 1e-5)
    assert checked.lam_ok and checked.mask_ok, checked
    assert int((k_sw - p_sw).abs().max()) <= 1
    assert torch.equal(k_sw, o_sw)
    both = ((k_lam > 0) & (p_lam > 0))[..., None].to(torch.complex64)
    kv = torch.complex(k_vh_re, k_vh_im) * both
    pv = torch.complex(p_vh_re, p_vh_im) * both
    proj = kv.conj().transpose(-1, -2) @ kv - pv.conj().transpose(-1, -2) @ pv
    assert float(proj.abs().max()) <= 2e-5


@pytest.mark.cuda
def test_cluster_homes_fill_one_wave_on_card(cuda_device):
    """A half-layer batch fits one wave on the cluster home: B=10 at the 20q
    shapes, B=14 at the 28q ones (cudaOccupancyMaxActiveClusters)."""
    for n, batch in ((128, 10), (256, 14)):
        assert jk.cluster_occupancy(n, n, jk.cluster_size(n)) >= batch
    for chi, batch in ((64, 10), (128, 14)):
        ell = trs.rand_ell(2 * chi, chi)
        assert tfr.tail_cluster_occupancy(ell, 2 * chi, chi, jk.cluster_size(ell)) >= batch


@pytest.mark.cuda
def test_rand_tail_raises_on_card(cuda_device):
    f64 = torch.zeros((2, 24, 32), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tfr.rand_tail(f64, f64, torch.ones(2, dtype=torch.float64, device=cuda_device), 1e-12, 16)
    z = torch.zeros((2, 2, 8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tfp.fused_pair(torch.zeros((2, 32), device=cuda_device), z.double(), z, z, z, 1e-12)


def fused_matches_twin(planes, thr2: float = 1e-4) -> None:
    """K4 against its twin on ``planes`` (trunc_thr 1e-2 by default): one
    launch, λ, keep masks, sweep counts, weighted uᵀ and vh projectors and
    the reconstruction within the module's tolerances."""
    before = tfp.fused_pair.launches
    k_ut_re, k_ut_im, k_vh_re, k_vh_im, k_lam, k_sw = tfp.fused_pair(*planes, thr2, 12)
    assert tfp.fused_pair.launches == before + 1
    p_ut_re, p_ut_im, p_vh_re, p_vh_im, p_lam, p_sw = tfp.fused_pair_reference(*planes, thr2, 12)
    torch.cuda.synchronize()
    smax = float(p_lam.max())
    w0_re, w0_im = tfp.theta_build_reference(*planes)
    theta = torch.complex(w0_re, w0_im)
    chi = planes[1].shape[-1]
    k_keep, p_keep = k_lam > 0, p_lam > 0
    near = near_threshold(torch.linalg.svdvals(theta), (theta.abs() ** 2).sum((-2, -1)), thr2, chi)
    checked = lambda_check(k_lam, p_lam, near, 1e-5)
    assert checked.lam_ok and checked.mask_ok, checked
    assert int((k_sw - p_sw).abs().max()) <= 1
    both = (k_keep & p_keep).to(torch.complex64)
    weight = both * (p_lam / smax)

    def proj(rows, w):
        kept = rows * w[..., None]
        return kept.conj().transpose(-1, -2) @ kept

    k_ut, p_ut = torch.complex(k_ut_re, k_ut_im), torch.complex(p_ut_re, p_ut_im)
    k_vh, p_vh = torch.complex(k_vh_re, k_vh_im), torch.complex(p_vh_re, p_vh_im)
    assert float((proj(k_ut, weight) - proj(p_ut, weight)).abs().max()) <= 2e-5
    assert float((proj(k_vh, weight) - proj(p_vh, weight)).abs().max()) <= 2e-5
    rec = k_ut.transpose(-1, -2) @ (k_vh * (k_lam * both)[..., None])
    p_rec = p_ut.transpose(-1, -2) @ (p_vh * (p_lam * both)[..., None])
    assert float((rec - p_rec).abs().max()) <= 1e-5 * smax


@pytest.mark.cuda
@pytest.mark.parametrize("chi,rank", [(16, None), (64, None), (96, None), (128, None), (128, 20), (136, None)])
def test_fused_pair_matches_twin_on_card(cuda_device, chi, rank):
    """K4 against its twin, working planes in one block's shared memory
    (chi <= 80), in a cluster's distributed shared memory (96 <= chi <=
    128) and in device memory (chi = 136); rank 20: the zero-padded θ of
    bonds far below chi, as on the 28q path."""
    batch = 4 if chi < 128 else 2
    fused_matches_twin(path_planes(np.random.default_rng(chi), batch, chi, cuda_device, rank=rank))


PATH_CASES = [(96, 1, None), (96, 14, None), (100, 1, None), (100, 14, None), (128, 1, None), (128, 14, None),
              (128, 14, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("chi,batch,rank", PATH_CASES)
def test_fused_pair_cluster_matches_twin_on_card(cuda_device, chi, batch, rank):
    """K4's cluster path (8 CTAs per matrix) at the chi it takes, a ragged
    chi among them, on a single matrix and on a 28q half-layer batch."""
    assert tfp.fused_plane_home(chi, jk.cuda_build.max_smem(0)) == "cluster"
    fused_matches_twin(path_planes(np.random.default_rng(chi + batch), batch, chi, cuda_device, rank=rank))


@pytest.mark.cuda
@pytest.mark.parametrize("chi,batch,rank", PATH_CASES)
def test_theta_build_path_shapes_on_card(cuda_device, chi, batch, rank):
    """K2's register-blocked tiles (edge 16 or 32 by theta_tile_edge) at
    the cluster path's chi, a ragged chi among them, B=1 and B=14."""
    planes = path_planes(np.random.default_rng(chi * batch), batch, chi, cuda_device, rank=rank)
    before = tfp.theta_build.launches
    k_re, k_im = tfp.theta_build(*planes)
    assert tfp.theta_build.launches == before + 1
    p_re, p_im = tfp.theta_build_reference(*planes)
    torch.cuda.synchronize()
    err = torch.linalg.matrix_norm(torch.complex(k_re - p_re, k_im - p_im))
    assert float((err / torch.linalg.matrix_norm(torch.complex(p_re, p_im))).max()) <= 1e-5


@pytest.mark.cuda
def test_rand_route_pair_update_agrees_with_native_on_card(cuda_device):
    """The same χ=64 half-layer as above on the rand route: one θ-build and
    one rand-tail launch, the state within 1e-4 of the native route's."""
    n = 8
    trot = Trotter(num_qubits=n, evol_time=0.8, num_steps=2, delta=1.0, second_order=True)
    with config.svd_impl_override("native"):
        state = trot.as_mps(neel_init_state(n), trunc_thr=1e-6, chi_max=64,
                            dtype=torch.complex64, device=cuda_device)
    block = _block_4x4_lo_hi(trotter_alphas(0.3, 1.0), torch.complex64, cuda_device)
    out = {}
    for route in ("rand", "native"):
        with config.svd_impl_override(route):
            before = (tfp.theta_build.launches, tfr.rand_tail.launches)
            out[route] = tm.mps_to_vector(
                tm.apply_pairs_mps(state, block.expand(3, 4, 4), (1, 3, 5), trunc_thr=1e-6)
            ).cpu().numpy()
            launched = (route == "rand") * 1
            assert (tfp.theta_build.launches, tfr.rand_tail.launches) == (
                before[0] + launched, before[1] + launched)
    np.testing.assert_allclose(out["rand"], out["native"], atol=1e-4)
    assert abs(np.vdot(out["rand"], out["native"])) >= 1 - 1e-5


@pytest.mark.cuda
def test_rand_route_with_fusion_off_runs_k1_on_card(cuda_device):
    """With ``set_fused_pair(False)`` the rand route runs K1 on the square θ
    on CUDA tensors (never the unfused rand SVD or a plain twin): one K1
    launch at 2χ = 128 rows, no θ-build or rand-tail launch, the state
    within 1e-4 of the native route's."""
    n = 8
    trot = Trotter(num_qubits=n, evol_time=0.8, num_steps=2, delta=1.0, second_order=True)
    with config.svd_impl_override("native"):
        state = trot.as_mps(neel_init_state(n), trunc_thr=1e-6, chi_max=64,
                            dtype=torch.complex64, device=cuda_device)
    block = _block_4x4_lo_hi(trotter_alphas(0.3, 1.0), torch.complex64, cuda_device)
    with config.svd_impl_override("native"):
        want = tm.mps_to_vector(tm.apply_pairs_mps(state, block.expand(3, 4, 4), (1, 3, 5), trunc_thr=1e-6))
    config.set_fused_pair(False)
    try:
        before = (jk.jacobi_rows.launches_at.get(128, 0), tfp.theta_build.launches, tfr.rand_tail.launches)
        with config.svd_impl_override("rand"):
            got = tm.mps_to_vector(tm.apply_pairs_mps(state, block.expand(3, 4, 4), (1, 3, 5), trunc_thr=1e-6))
        after = (jk.jacobi_rows.launches_at.get(128, 0), tfp.theta_build.launches, tfr.rand_tail.launches)
    finally:
        config.set_fused_pair(None)
    assert after == (before[0] + 1, before[1], before[2])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)


@pytest.mark.cuda
def test_range_finder_at_256_rows_on_card(cuda_device):
    """The 28q chi=128 pair matrices: 256 rows, 14 matrices (one
    half-layer), zero-padded as θ is.  ``qr_chunk(256)`` = 15, so the
    half-layer stays on cuSOLVER's one-matrix path; B must be finite and
    match LAPACK's on the host."""
    a = padded_pair_batch(np.random.default_rng(4), 14, 256, 20)
    ell = trs.rand_ell(256, 128)
    assert trs.qr_chunk(256) == 15
    got = trs._range_project(a.to(cuda_device), ell, trs._POWER_ITERS).cpu()
    want = trs._range_project(a, ell, trs._POWER_ITERS)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    s_got, s_want = torch.linalg.svdvals(got), torch.linalg.svdvals(want)
    assert float((s_got - s_want).abs().max()) <= 1e-5 * float(s_want.max())


@pytest.mark.cuda
def test_range_finder_handles_rank_deficient_batches_on_card(cuda_device):
    """Pair matrices of rank-4 bonds held at χ=64, zero-padded as θ is
    (nonzero rows in two blocks at 0 and χ), in a batch of 10: torch's
    batched CUDA QR returns NaN on their samples, so this batch shows the
    fault that ``rand_svd._orth`` works around.  The range-finder must
    return a finite B whose singular values match LAPACK's on the host."""
    a = padded_pair_batch(np.random.default_rng(3), 10, 128, 4)
    ell = trs.rand_ell(128, 64)
    y = torch.matmul(a.to(cuda_device), trs.sketch(10, 128, ell, a.dtype, cuda_device))
    batched = torch.linalg.qr(y, mode="reduced")[0]
    # If this fails, torch's batched QR handles the padding now and _orth
    # may send the whole batch at once.
    assert not bool(torch.isfinite(torch.view_as_real(batched)).all())
    assert bool(torch.isfinite(torch.view_as_real(trs._orth(y))).all())
    got = trs._range_project(a.to(cuda_device), ell, trs._POWER_ITERS).cpu()
    want = trs._range_project(a, ell, trs._POWER_ITERS)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    s_got, s_want = torch.linalg.svdvals(got), torch.linalg.svdvals(want)
    assert float((s_got - s_want).abs().max()) <= 1e-5 * float(s_want.max())


@pytest.mark.cuda
def test_fused_route_pair_update_agrees_with_native_on_card(cuda_device):
    """A Trotter half-layer at chi=128 (256x256 pair matrices) on the jacobi
    route takes K4 by the auto rule (one launch) and gives the native
    route's state to f32 accuracy."""
    n = 8
    trot = Trotter(num_qubits=n, evol_time=0.8, num_steps=2, delta=1.0, second_order=True)
    with config.svd_impl_override("native"):
        state = trot.as_mps(neel_init_state(n), trunc_thr=1e-6, chi_max=128,
                            dtype=torch.complex64, device=cuda_device)
    block = _block_4x4_lo_hi(trotter_alphas(0.3, 1.0), torch.complex64, cuda_device)
    out = {}
    for route in ("jacobi", "native"):
        with config.svd_impl_override(route):
            before = (tfp.fused_pair.launches, jk.jacobi_rows.launches)
            out[route] = tm.mps_to_vector(
                tm.apply_pairs_mps(state, block.expand(3, 4, 4), (1, 3, 5), trunc_thr=1e-6)
            ).cpu().numpy()
            assert (tfp.fused_pair.launches, jk.jacobi_rows.launches) == (
                before[0] + (route == "jacobi"), before[1])
    np.testing.assert_allclose(out["jacobi"], out["native"], atol=1e-4)
    assert abs(np.vdot(out["jacobi"], out["native"])) >= 1 - 1e-5
