"""The jacobi route's fused pair update K4 (ops/fused_pair.py: the twin
``fused_pair_reference``, the wrapper ``fused_pair``, ``fused_pair_update``;
the dispatch in ops/mps._pair_update and config.set_fused_pair) held against
the JAX package on the CPU, with its Pallas kernel ``_fused_pair_raw`` in
interpret mode (chunk 1: per-matrix stopping, as the port's one block per
matrix), both Jacobi criteria set to the port's default ("hybrid").

Tolerances, as for the rand tail (tests/test_torch_rand.py):

* λ within 1e-5 * s_max, the kept uᵀ projector, the kept vh projector
  weighted by s_k / s_max (vh = diag(1/s) uᴴ m multiplies the product's f32
  rounding by s_max / s_k) and the reconstruction uᵀᵀ diag(λ) vh, each
  within 1e-5 (* s_max) (the f32 Jacobi floor, 1e-6 * s_max per entry,
  plus two rounding orders); keep masks equal except where a value's keep
  decision lies within the λ tolerance of the threshold
  (kernel_checks.near_threshold); raw factors are not compared (phases are
  arbitrary);
* pair update: the reconstructed two-site tensor within 3e-5 * max|θ| and
  λ within 3e-5 * max λ: the port's ``fused_pair_update``, its native
  (torch.linalg.svd) route and its unfused jacobi route, each against the
  JAX package's ``fused_pair_update``;
* horizon: fobj within 1e-4 of JAX's (f32 decompositions along 8 L-BFGS
  iterations), as tests/test_torch_horizon.py holds the jacobi route.

The kernel itself runs only on a CUDA card: tests/test_torch_kernel.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.models.sp_lhs import jit_asp as jja
from aqc_research_tpu.ops import fused_pair as jfp
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.kernel_checks import lambda_check, near_threshold
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.ops import fused_pair as tfp
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops.jacobi_kernel import rank_truncate_reference
from tests import _torch_threads  # noqa: F401

BATCH = 3


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


@pytest.fixture(autouse=True, scope="module")
def _hybrid():
    """Both packages on the port's default Jacobi criterion for the whole
    module (one trace of each Pallas shape); restored after."""
    previous = config.jacobi_criterion()
    jcfg.set_jacobi_criterion("hybrid")
    config.set_jacobi_criterion("hybrid")
    jax.clear_caches()
    yield
    jcfg.set_jacobi_criterion(None)
    config.set_jacobi_criterion(previous)
    jax.clear_caches()


def _rand_c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pair_inputs(seed, batch, chi, kind, rank=3):
    """Pair-update inputs (numpy): lam_l, lam_c, lam_r, g1, g2, gate4.
    ``kind``: "random" bond values, "graded" (1 .. 1e-6, truncation bites),
    "boundary" (lam_l = lam_r = e_0, the chain's edge pairs) or "padded"
    (bonds of rank ``rank``: θ zero outside two row and column blocks)."""
    rng = np.random.default_rng(seed)
    g1 = _rand_c64(rng, batch, 2, chi, chi)
    g2 = _rand_c64(rng, batch, 2, chi, chi)

    def lams():
        lam = rng.random((batch, chi)).astype(np.float32) + 0.05
        if kind == "graded":
            lam = lam * np.logspace(0, -6, chi, dtype=np.float32)[None, :]
        lam = np.sort(lam, axis=-1)[..., ::-1].copy()
        if kind == "padded":
            lam[:, rank:] = 0.0
        return lam / np.linalg.norm(lam, axis=-1, keepdims=True)

    ll, lc, lr = lams(), lams(), lams()
    if kind == "boundary":
        ll = np.zeros((batch, chi), np.float32)
        ll[:, 0] = 1.0
        lr = ll.copy()
    return ll, lc, lr, g1, g2, _rand_c64(rng, batch, 4, 4)


def _planes(ins, chi):
    """The kernel inputs of both packages: (gate, a_re, a_im, b_re, b_im)."""
    *_, a_re, a_im, b_re, b_im, gate = tfp._prep_planes(*(torch.tensor(x) for x in ins), chi, torch.complex64)
    *_, ja_re, ja_im, jb_re, jb_im, jgate = jfp._prep_planes(*(jnp.asarray(x) for x in ins), chi, jnp.complex64)
    return (gate, a_re, a_im, b_re, b_im), (jgate, ja_re, ja_im, jb_re, jb_im)


def _projector(rows, mask, weight=None):
    """Σ_k w_k² row_k^H row_k over the kept rows k: the kept subspace,
    phase-free (w = 1 unless ``weight`` is given)."""
    kept = rows * (mask if weight is None else mask * weight)[..., None]
    return np.conj(np.swapaxes(kept, -1, -2)) @ kept


# -----------------------------------------------------------------------------
# K4's twin against the Pallas kernel.
# -----------------------------------------------------------------------------


def _assert_twin_matches_pallas(chi, kind, trunc_thr, rank=3):
    """K4's twin (``tfp.fused_pair`` on CPU tensors) against the Pallas
    kernel at chunk 1 on the same inputs, within the module's tolerances;
    returns the twin's outputs and θ's singular values (f64)."""
    ins = _pair_inputs(chi + len(kind), BATCH, chi, kind, rank)
    t_in, j_in = _planes(ins, chi)
    thr2 = trunc_thr**2
    j_out = jfp._fused_pair_raw(jnp.full((1, 1), thr2, jnp.float32), *j_in, chi, 12, 1)
    jut_re, jut_im, jvh_re, jvh_im, jlam = (np.asarray(x) for x in j_out)
    jlam = jlam[:, 0]

    before = tfp.fused_pair.launches
    out = tfp.fused_pair(*t_in, thr2, 12)
    ut_re, ut_im, vh_re, vh_im, lam, sweeps = out
    assert tfp.fused_pair.launches == before  # CPU tensors: the twin
    assert ut_re.shape == vh_re.shape == (BATCH, chi, 2 * chi) and lam.shape == (BATCH, chi)
    assert int(sweeps.min()) >= 1 and int(sweeps.max()) <= 12
    lam = lam.numpy()
    assert np.isfinite(lam).all()

    smax = float(jlam.max())
    assert np.abs(lam - jlam).max() <= 1e-5 * smax
    w0_re, w0_im = tfp.theta_build_reference(*t_in)
    theta = torch.complex(w0_re, w0_im).to(torch.complex128)
    s_theta = torch.linalg.svdvals(theta)
    near = near_threshold(s_theta, (theta.abs() ** 2).sum((-2, -1)), thr2, chi).numpy()
    keep, jkeep = lam > 0, jlam > 0
    assert not bool((keep != jkeep)[~near].any())
    if kind == "graded" and trunc_thr == 1e-2:
        assert not keep.all()  # truncation is active
    if kind == "padded":
        assert not keep[:, 2 * rank:].any()  # two rank-r bonds: rank <= 2r

    both = keep & jkeep
    ut, jut = ut_re.numpy() + 1j * ut_im.numpy(), jut_re + 1j * jut_im
    vh, jvh = vh_re.numpy() + 1j * vh_im.numpy(), jvh_re + 1j * jvh_im
    assert np.abs(_projector(ut, both) - _projector(jut, both)).max() <= 1e-5
    # vh = diag(1/s) u^H m carries the f32 rounding of the product times
    # s_max / s_k, so its rows are compared weighted by s_k / s_max: the kept
    # part of m^H m.
    weight = jlam / smax
    assert np.abs(_projector(vh, both, weight) - _projector(jvh, both, weight)).max() <= 1e-5
    rec = np.einsum("bki,bk,bkj->bij", ut, lam * both, vh)
    jrec = np.einsum("bki,bk,bkj->bij", jut, jlam * both, jvh)
    assert np.abs(rec - jrec).max() <= 1e-5 * smax
    # Dropped values come back as exact zeros with zero rows.
    assert float(np.abs(ut[~keep]).max(initial=0.0)) == 0.0
    assert float(np.abs(vh[~keep]).max(initial=0.0)) == 0.0
    return out, s_theta, thr2


@pytest.mark.parametrize("trunc_thr", [1e-6, 1e-2])
@pytest.mark.parametrize("kind", ["random", "graded", "boundary", "padded"])
@pytest.mark.parametrize("chi", [8, 16])
def test_fused_twin_matches_pallas_interpret(chi, kind, trunc_thr):
    _assert_twin_matches_pallas(chi, kind, trunc_thr)


@pytest.mark.parametrize("trunc_thr", [1e-6, 1e-2])
@pytest.mark.parametrize("chi,kind,rank", [(16, "graded", 3), (16, "padded", 3), (32, "graded", 3),
                                           (32, "padded", 20)])
def test_blocked_twin_matches_pallas_interpret_and_svd(monkeypatch, chi, kind, rank, trunc_thr):
    """K4's twin with the blocked schedule of its cluster home, cut to
    8-row blocks so that 2chi = 32 and 64 rows take 2 and 4 CTAs (on an
    H100 the blocked twin runs from 2chi = 176, 16-row blocks), against the
    Pallas kernel as above (a zero-padded rank-20 case among them), and its
    λ against the rule applied to θ's singular values from LAPACK in f64
    (kernel_checks.lambda_check: 1e-5 s_max, keep flips only near the
    threshold)."""
    calls = []
    real = tfp.block_jacobi_rows_reference

    def blocked(w_re, w_im, max_sweeps, criterion):
        calls.append(w_re.shape[-1])
        return real(w_re, w_im, max_sweeps, criterion, block=8)

    monkeypatch.setattr(tfp, "fused_schedule", lambda chi, device: "block")
    monkeypatch.setattr(tfp, "block_jacobi_rows_reference", blocked)
    (_, _, _, _, lam, _), s_theta, thr2 = _assert_twin_matches_pallas(chi, kind, trunc_thr, rank)
    assert calls == [2 * chi]
    rows = torch.diag_embed(s_theta[:, :chi]).to(torch.float32)
    s2 = s_theta.double() ** 2
    _, _, exact, _ = rank_truncate_reference(rows, torch.zeros_like(rows), s2.sum(-1).float(), thr2, chi)
    near = near_threshold(s_theta, s2.sum(-1), thr2, chi)
    checked = lambda_check(lam, exact, near, 1e-5)
    assert checked.lam_ok and checked.mask_ok, checked


def test_fused_schedule_follows_the_home():
    """K4 rotates in the block-cyclic order on its cluster home and in the
    ring order elsewhere; the CPU twin takes the H100's rule."""
    cpu = torch.device("cpu")
    got = {chi: tfp.fused_schedule(chi, cpu) for chi in (8, 64, 80, 88, 96, 100, 112, 128, 136)}
    assert got == {8: "ring", 64: "ring", 80: "ring", 88: "block", 96: "block", 100: "block", 112: "block",
                   128: "block", 136: "ring"}
    assert all((got[chi] == "block") == (tfp.fused_plane_home(chi, tfp.H100_MAX_SMEM) == "cluster") for chi in got)


def test_fused_reference_takes_the_blocked_twin_on_the_cluster_home(monkeypatch):
    """At chi = 96 (a cluster-home shape: 192 rows, 6 CTAs of two 16-row
    blocks) the twin rotates in the block order, one sweep here."""
    calls = []
    real = tfp.block_jacobi_rows_reference

    def spy(w_re, *args, **kwargs):
        calls.append(tuple(w_re.shape))
        return real(w_re, *args, **kwargs)

    monkeypatch.setattr(tfp, "block_jacobi_rows_reference", spy)
    t_in, _ = _planes(_pair_inputs(7, 1, 96, "graded"), 96)
    ut_re, _, _, _, lam, sweeps = tfp.fused_pair(*t_in, 1e-12, 1)
    assert calls == [(1, 192, 192)] and sweeps.tolist() == [1]
    assert ut_re.shape == (1, 96, 192) and bool(torch.isfinite(lam).all()) and float(lam[0, 0]) > 0


def test_fused_twin_zero_weight_keeps_nothing():
    """An all-zero θ (a padded batch slot): no 0/0, nothing kept."""
    z = torch.zeros((2, 2, 8, 8))
    ut_re, ut_im, vh_re, vh_im, lam, sweeps = tfp.fused_pair(torch.zeros((2, 32)), z, z, z, z, 1e-12)
    for t in (ut_re, ut_im, vh_re, vh_im, lam):
        assert bool(torch.isfinite(t).all()) and float(t.abs().max()) == 0.0
    assert sweeps.tolist() == [1, 1]


# -----------------------------------------------------------------------------
# fused_pair_update and its dispatch.
# -----------------------------------------------------------------------------


def _reconstruct(ll, lr, g1, g2, lam, chi):
    """The physical two-site tensor u diag(lam) vh the factors encode (the
    Vidal gauge scalings undone), as in tests/test_fused_rand.py."""
    b = lam.shape[0]
    u = (np.asarray(g1) * np.asarray(ll)[:, None, :, None]).reshape(b, 2 * chi, chi)
    vh = np.swapaxes(np.asarray(g2) * np.asarray(lr)[:, None, None, :], 1, 2).reshape(b, chi, 2 * chi)
    return np.einsum("bik,bk,bkj->bij", u, np.asarray(lam), vh)


@pytest.mark.parametrize(
    "seed,batch,chi,trunc_thr,kind",
    [(0, 3, 8, 1e-5, "random"), (3, 4, 16, 1e-3, "graded"), (4, 2, 8, 1e-5, "boundary"), (2, 1, 16, 1e-5, "random")],
    ids=["random", "graded", "boundary", "single"],
)
def test_fused_pair_update_matches_jax_and_native(seed, batch, chi, trunc_thr, kind):
    ins = _pair_inputs(seed, batch, chi, kind)
    jgot = jfp.fused_pair_update(*(jnp.asarray(x) for x in ins), chi, trunc_thr, jnp.complex64, jnp.float32, 12)
    tins = [torch.tensor(x) for x in ins]
    tgot = tfp.fused_pair_update(*tins, chi, trunc_thr, torch.complex64, torch.float32, 12)
    with config.svd_impl_override("native"):
        ngot = tm._pair_update(*tins, chi, trunc_thr, torch.complex64, torch.float32)
    config.set_fused_pair(False)
    try:
        with config.svd_impl_override("jacobi"):  # the unfused jacobi route
            ugot = tm._pair_update(*tins, chi, trunc_thr, torch.complex64, torch.float32)
    finally:
        config.set_fused_pair(None)
    jg1, jg2, jlam = (np.asarray(x) for x in jgot)
    ll, _, lr = ins[:3]
    th_j = _reconstruct(ll, lr, jg1, jg2, jlam, chi)
    scale = max(float(np.abs(th_j).max()), 1e-30)
    for got in (tgot, ngot, ugot):
        tg1, tg2, tlam = (x.numpy() for x in got)
        assert tg1.shape == jg1.shape and tg2.shape == jg2.shape and tlam.shape == jlam.shape
        assert tlam.dtype == np.float32
        assert np.abs(_reconstruct(ll, lr, tg1, tg2, tlam, chi) - th_j).max() <= 3e-5 * scale
        np.testing.assert_allclose(tlam, jlam, atol=3e-5 * float(jlam.max()))


def test_fused_pair_update_keeps_batch_axes():
    chi = 8
    ll, lc, lr, g1, g2, g4 = (torch.tensor(x) for x in _pair_inputs(5, 6, chi, "random"))
    shaped = [x.reshape((2, 3) + tuple(x.shape[1:])) for x in (ll, lc, lr, g1, g2)]
    got = tfp.fused_pair_update(*shaped, g4[:3], chi, 1e-5, torch.complex64, torch.float32)
    flat = tfp.fused_pair_update(ll, lc, lr, g1, g2, g4[:3].repeat(2, 1, 1), chi, 1e-5,
                                 torch.complex64, torch.float32)
    assert got[0].shape == (2, 3, 2, chi, chi) and got[2].shape == (2, 3, chi)
    for g, f in zip(got, flat):
        assert torch.allclose(g.reshape(f.shape), f, atol=1e-5)


@pytest.mark.parametrize(
    "planes,gate,why",
    [
        ((3, 2, 8, 8), (3, 32), None),
        ((3, 2, 8, 9), (3, 32), r"fused_pair takes four \(B, 2, chi, chi\)"),
        ((3, 2, 8, 8), (3, 16), r"fused_pair takes a \(B, 32\)"),
    ],
)
def test_fused_argument_checks(planes, gate, why):
    p, g = torch.zeros(planes), torch.zeros(gate)
    if why is None:
        tfp.check_theta_args(g, p, p, p, p, name="fused_pair")
        return
    with pytest.raises(ValueError, match=why):
        tfp.check_theta_args(g, p, p, p, p, name="fused_pair")


def test_fused_checks_dtype_and_device():
    gate, plane = torch.zeros((2, 32)), torch.zeros((2, 2, 8, 8))
    with pytest.raises(ValueError, match="fused_pair takes float32"):
        tfp.check_theta_args(gate, plane.double(), plane, plane, plane, name="fused_pair")
    meta = torch.empty((2, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="fused_pair: unsupported device"):
        tfp.fused_pair(gate.to("meta"), meta, meta, meta, meta, 1e-12)


@pytest.mark.parametrize(
    "chi,max_smem,home",
    [(8, 232448, "shared"), (64, 232448, "shared"), (80, 232448, "shared"), (96, 232448, "cluster"),
     (100, 232448, "cluster"), (112, 232448, "cluster"), (128, 232448, "cluster"), (136, 232448, "global"),
     (64, 101376, "cluster"), (128, 60000, "global")],
)
def test_fused_plane_home(chi, max_smem, home):
    """K4's working planes stay in one block's shared memory up to 2chi =
    160 on an H100 (232,448 B per block), in the distributed shared memory
    of a cluster up to 2chi = 256 (and below it on a card with less shared
    memory per block), in device memory beyond (and where a cluster's CTA
    does not fit either)."""
    assert tfp.fused_plane_home(chi, max_smem) == home


@pytest.mark.parametrize("chi", [96, 100, 112, 128])
def test_fused_cluster_shape(chi):
    """The cluster path at every chi it takes on the 28q path and a ragged
    one: ceil(2chi / 32) CTAs of two 16-row blocks hold all 2chi rows (zero
    rows pad the rest, less than one CTA's share), a warp per row of a
    block fills the kernel's 512 threads (two tile groups), and a CTA's
    shared memory, with its three block buffers, fits an H100 block's
    232,448 B (96 KB of blocks at chi = 128)."""
    n = 2 * chi
    ctas = tfp.fused_cluster_size(chi)
    assert n <= tfp.FUSED_CLUSTER_MAX_ROWS and ctas <= 8
    assert 32 * ctas >= n > 32 * (ctas - 1)  # every CTA holds rows of θ
    assert tfp.FUSED_CLUSTER_THREADS == 512 == 32 * tfp.BLOCK_ROWS
    smem = tfp.fused_cluster_smem_bytes(chi)
    assert smem + tfp._FUSED_STATIC_SMEM <= tfp.H100_MAX_SMEM == 232448
    assert smem >= 4 * 2 * 3 * 16 * n  # three block buffers, re and im
    if chi == 128:
        assert ctas == 8 and 4 * 2 * 3 * 16 * n == 96 * 1024


@pytest.mark.parametrize(
    "batch,chi,edge",
    [(14, 128, 32), (10, 64, 16), (1, 128, 16), (14, 100, 32), (10, 100, 32), (3, 8, 16), (10, 20, 16),
     (64, 64, 32)],
)
def test_theta_tile_edge(batch, chi, edge):
    """K2's tile edge: 32 where the batch's 32x32 tiles outnumber the H100's
    132 SMs, else 16; both path shapes put more than 132 blocks on the card,
    and small or ragged chi (ceil division) takes one zero-filled tile."""
    got = tfp.theta_tile_edge(batch, chi, 132)
    assert got == edge
    blocks = batch * (-(-chi // got)) ** 2
    if (batch, chi) in ((14, 128), (10, 64)):
        assert blocks > 132


@pytest.mark.parametrize(
    "route,fused,chi,dtype,takes",
    [
        ("jacobi", True, 16, torch.complex64, True),
        ("jacobi", True, 4, torch.complex64, False),  # chi < 8: the heads' spec path
        ("jacobi", True, 16, torch.complex128, False),
        ("jacobi", False, 16, torch.complex64, False),
        ("jacobi", None, 16, torch.complex64, False),  # auto: off for CPU tensors
        ("rand", True, 16, torch.complex64, False),  # never on the rand route
    ],
)
def test_pair_update_dispatch(monkeypatch, route, fused, chi, dtype, takes):
    calls = []
    real = tm.fused_pair_update

    def spy(*args, **kwargs):
        calls.append(args[6])
        return real(*args, **kwargs)

    monkeypatch.setattr(tm, "fused_pair_update", spy)
    ins = [torch.tensor(x) for x in _pair_inputs(1, 2, chi, "random")]
    ins[3], ins[4], ins[5] = ins[3].to(dtype), ins[4].to(dtype), ins[5].to(dtype)
    config.set_fused_pair(fused)
    try:
        with config.svd_impl_override(route):
            tm._pair_update(*ins, chi, 1e-5, dtype, config.real_of(dtype))
    finally:
        config.set_fused_pair(None)
    assert calls == ([chi] if takes else [])


def test_fused_pair_auto_rule_per_device(monkeypatch):
    """The JAX rule per device: K4 on CUDA tensors at chi >= 96, never on
    CPU tensors; set_fused_pair and AQC_TORCH_FUSED_PAIR override it."""
    config.set_fused_pair(None)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert [config.fused_pair_enabled(chi, cuda) for chi in (64, 96, 128)] == [False, True, True]
    assert [config.fused_pair_enabled(chi, cpu) for chi in (64, 96, 128)] == [False, False, False]
    assert not config.fused_pair_enabled(128, torch.zeros(1))
    assert not config.fused_pair_enabled(128)  # the pinned default device
    config.set_fused_pair(False)
    assert not config.fused_pair_enabled(128, cuda)
    config.set_fused_pair(True)
    assert config.fused_pair_enabled(8, cpu)
    config.set_fused_pair(None)
    assert jcfg._FUSED_PAIR_MIN_CHI == config._FUSED_PAIR_MIN_CHI


# -----------------------------------------------------------------------------
# A jacobi horizon with the fused kernel forced on in both packages.
# -----------------------------------------------------------------------------

N_H, CHI_H, LAYERS_H, MAXITER_H, THR_H = 6, 8, 2, 8, 1e-6
BASE_H = tuple(1 if q % 2 == 0 else 0 for q in range(N_H))


def test_fused_jacobi_horizon_matches_jax(monkeypatch):
    calls = []
    real = tfp.fused_pair_reference

    def spy(*args, **kwargs):
        calls.append(args[1].shape[-1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tfp, "fused_pair_reference", spy)
    tja.watchdog_events.clear()
    jja.watchdog_events.clear()
    jc = JTrotterAnsatz.make(N_H, make_trotter_like_circuit(N_H, LAYERS_H), True)
    th = jtrot.init_ansatz_to_trotter(jc, np.zeros(jc.num_thetas), evol_time=1.2, delta=1.0)
    th = (th + 0.05 * np.random.default_rng(5).standard_normal(jc.num_thetas)).astype(np.float32)
    jt = jtrot.Trotter(num_qubits=N_H, evol_time=1.2, num_steps=3, delta=1.0, second_order=True).as_mps(
        jtrot.neel_init_state(N_H), trunc_thr=THR_H, chi_max=CHI_H
    )
    gammas, lambdas = np.asarray(jt.gammas), np.asarray(jt.lambdas)
    jt = jm.MPS(jnp.asarray(gammas.astype(np.complex64)), jnp.asarray(lambdas.astype(np.float32)))
    tt = interop.mps_to_torch(gammas, lambdas, torch.complex64, "cpu")
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    # Both packages on the jacobi route with the fused kernel forced on.
    for cfg in (jcfg, config):
        cfg.set_precision("fast")
        cfg.set_svd_impl("jacobi")
        cfg.set_fused_pair(True)
    jax.clear_caches()
    try:
        jres = jja.optimize_horizon_mps_jit(jc, jnp.asarray(th), jt, base_bits=BASE_H,
                                            trunc_thr=THR_H, maxiter=MAXITER_H)
        tres = tja.optimize_horizon_mps_jit(tc, torch.tensor(th), tt, base_bits=BASE_H,
                                            trunc_thr=THR_H, maxiter=MAXITER_H)
    finally:
        for cfg in (jcfg, config):
            cfg.set_precision("high")
            cfg.set_svd_impl(None)
            cfg.set_fused_pair(None)
        jax.clear_caches()
    assert set(calls) == {8}  # every pair update at full chi; the heads below 8 take the spec
    assert abs(float(tres.fobj) - float(jres.fobj)) <= 1e-4
    assert float(tres.fobj) < 0.01
    assert tja.watchdog_events == [] and jja.watchdog_events == []
