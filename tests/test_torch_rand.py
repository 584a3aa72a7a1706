"""The rand route of the port (ops/rand_svd.py, ops/fused_pair.py,
ops/fused_rand.py, the dispatch in ops/mps.py, the watchdog reference in
models/sp_lhs/jit_asp.py) held against the JAX package on the CPU, with the
Pallas kernels in interpret mode.

torch cannot redraw JAX's sketch, so every comparison that runs the
range-finder hands the JAX sketch to the port.  Tolerances:

* range-finder: singular values of B = Q^H A and the Gram B^H B to 1e-10
  in complex128, 1e-5 relative in complex64 (raw Q and B are not compared:
  Householder phase conventions differ);
* θ build: 1e-5 relative Frobenius per matrix (f32 products, two orders);
* rand tail: λ within 1e-5 * s_max, equal keep masks, kept vh projector
  within 2e-5 (the f32 Jacobi floor, 1e-6 * s_max per entry);
* pair update: the reconstructed two-site tensor within 3e-5, the bar the
  JAX package's own tests/test_fused_rand.py uses;
* horizon: fobj within 1e-4 of JAX's (f32 decompositions along 8 L-BFGS
  iterations), as tests/test_torch_horizon.py holds the jacobi route.

The kernels themselves run only on a CUDA card: tests/test_torch_kernel.py."""

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
from aqc_research_tpu.ops import fused_rand as jfr
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.ops import rand_svd as jrs
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.kernel_checks import near_threshold, padded_pair_batch
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.ops import fused_pair as tfp
from aqc_research_tpu_torch.ops import fused_rand as tfr
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops import rand_svd as trs
from tests import _torch_threads  # noqa: F401

CHI = 16
SMEM_H100 = 232448  # opt-in shared memory of one H100 block


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


def jax_sketch(b: int, n: int, ell: int) -> np.ndarray:
    """The JAX package's sketch of one shape (ops/rand_svd.py:399-400)."""
    key = jax.random.PRNGKey(0x5EED ^ (n << 8) ^ ell)
    return np.asarray(jax.random.normal(key, (b, n, ell), jnp.float32))


@pytest.fixture
def rand_route(monkeypatch):
    """Both packages on the rand route with the fused update at the small
    test shapes: RAND_MIN_N lowered on both sides, the fused update forced
    on for CPU tensors in both (``set_fused_pair(True)``), the JAX sketch
    handed to the port, both Jacobi criteria set to the port's default
    ("hybrid"); restored after."""
    monkeypatch.setattr(jrs, "RAND_MIN_N", 2 * CHI)
    monkeypatch.setattr(trs, "RAND_MIN_N", 2 * CHI)
    monkeypatch.setattr(
        trs, "sketch",
        lambda b, n, ell, dtype, device: torch.tensor(jax_sketch(b, n, ell)).to(dtype).to(device),
    )
    previous = config.jacobi_criterion()
    jcfg.set_svd_impl("rand")
    jcfg.set_fused_pair(True)
    jcfg.set_jacobi_criterion("hybrid")
    config.set_jacobi_criterion("hybrid")
    config.set_svd_impl("rand")
    config.set_fused_pair(True)
    jax.clear_caches()
    yield
    jcfg.set_svd_impl(None)
    jcfg.set_fused_pair(None)
    jcfg.set_jacobi_criterion(None)
    config.set_jacobi_criterion(previous)
    config.set_svd_impl(None)
    config.set_fused_pair(None)
    jax.clear_caches()


def _rand_c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rand_lams(rng, batch, chi, graded=False):
    lam = rng.random((batch, chi)).astype(np.float32) + 0.05
    if graded:
        lam = lam * np.logspace(0, -6, chi, dtype=np.float32)[None, :]
    lam = np.sort(lam, axis=-1)[..., ::-1]
    return lam / np.linalg.norm(lam, axis=-1, keepdims=True)


def _pair_inputs(seed, batch, chi, graded=False, boundary=False):
    """Random pair-update inputs (numpy): lam_l, lam_c, lam_r, g1, g2, gate4."""
    rng = np.random.default_rng(seed)
    g1 = _rand_c64(rng, batch, 2, chi, chi)
    g2 = _rand_c64(rng, batch, 2, chi, chi)
    ll = _rand_lams(rng, batch, chi, graded)
    lc = _rand_lams(rng, batch, chi, graded)
    lr = _rand_lams(rng, batch, chi, graded)
    if boundary:
        ll = np.zeros((batch, chi), np.float32)
        ll[:, 0] = 1.0
        lr = ll.copy()
    g4 = _rand_c64(rng, batch, 4, 4)
    return ll, lc, lr, g1, g2, g4


def _graded_matrices(seed, batch, n, decades):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    u, _, vh = np.linalg.svd(a)
    s = 10.0 ** (-decades * np.arange(n) / (n - 1))
    return (u * s[None, None, :]) @ vh


# -----------------------------------------------------------------------------
# Range-finder, sketch.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10), (np.complex64, 1e-5)])
def test_range_project_matches_jax(dtype, tol):
    n, b = 2 * CHI, 3
    ell = trs.rand_ell(n, CHI)
    assert ell == jrs.rand_ell(n, CHI) == 24
    a = _graded_matrices(7, b, n, decades=3.0).astype(dtype)
    omega = jax_sketch(b, n, ell)
    jb = np.asarray(jrs._range_project(jnp.asarray(a), ell, jrs._POWER_ITERS))
    ta = torch.tensor(a)
    tb = trs._range_project(ta, ell, trs._POWER_ITERS, omega=torch.tensor(omega).to(ta.dtype)).numpy()
    assert tb.shape == jb.shape == (b, ell, n)
    js, ts = np.linalg.svd(jb, compute_uv=False), np.linalg.svd(tb, compute_uv=False)
    scale = js.max()
    assert np.abs(ts - js).max() <= tol * scale
    jg = np.conj(np.swapaxes(jb, -1, -2)) @ jb
    tg = np.conj(np.swapaxes(tb, -1, -2)) @ tb
    assert np.abs(tg - jg).max() <= tol * scale**2


def test_sketch_is_cached_real_gaussian_per_shape():
    trs._SKETCHES.clear()
    first = trs.sketch(2, 32, 24, torch.complex64, "cpu")
    assert first.shape == (2, 32, 24) and first.dtype == torch.complex64
    assert trs.sketch(2, 32, 24, torch.complex64, "cpu") is first
    assert float(first.imag.abs().max()) == 0.0
    assert abs(float(first.real.std()) - 1.0) < 0.1
    assert trs.sketch(3, 32, 24, torch.complex64, "cpu").shape == (3, 32, 24)
    other_n = trs.sketch(2, 16, 24, torch.complex64, "cpu")  # another seed
    assert not torch.equal(other_n, first[:, :16])
    trs._SKETCHES.clear()
    assert torch.equal(trs.sketch(2, 32, 24, torch.complex64, "cpu"), first)


def test_range_project_on_zero_padded_pairs_matches_jax():
    """Pair matrices of rank-2 bonds, zero-padded as θ is (the batch that
    breaks torch's batched CUDA QR): same range and projector as JAX's."""
    n, b = 2 * CHI, 3
    ell = trs.rand_ell(n, CHI)
    a = padded_pair_batch(np.random.default_rng(3), b, n, 2).numpy()
    assert np.count_nonzero(np.abs(a).sum(-1), axis=-1).tolist() == [4] * b
    omega = jax_sketch(b, n, ell)
    jb = np.asarray(jrs._range_project(jnp.asarray(a), ell, jrs._POWER_ITERS))
    tb = trs._range_project(torch.tensor(a), ell, trs._POWER_ITERS, omega=torch.tensor(omega).to(torch.complex64))
    tb = tb.numpy()
    assert np.isfinite(tb).all()
    js, ts = np.linalg.svd(jb, compute_uv=False), np.linalg.svd(tb, compute_uv=False)
    assert np.abs(ts - js).max() <= 1e-5 * js.max()
    jg = np.conj(np.swapaxes(jb, -1, -2)) @ jb
    tg = np.conj(np.swapaxes(tb, -1, -2)) @ tb
    assert np.abs(tg - jg).max() <= 1e-5 * js.max() ** 2


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_range_project_zeroes_rows_below_the_rand_tails_floor(dtype):
    """On zero-padded pairs the basis holds directions A does not reach: in
    complex64 B's rows for them, rounding residue, come out as exact zeros,
    and every other row lies above 32 eps of the largest (the floor of the
    rand tail's hybrid criterion); the rows kept are B's as computed.  In
    complex128 B is left as computed, as the JAX package leaves it."""
    n, b = 2 * CHI, 3
    ell = trs.rand_ell(n, CHI)
    a = padded_pair_batch(np.random.default_rng(4), b, n, 2).to(dtype)
    omega = torch.tensor(jax_sketch(b, n, ell)).to(dtype)
    bm = trs._range_project(a, ell, trs._POWER_ITERS, omega=omega)
    y = trs._orth(torch.matmul(a, omega))  # the same basis, B before the floor
    for _ in range(trs._POWER_ITERS):
        y = trs._orth(torch.matmul(a, trs._orth(torch.matmul(a.mH, y))))
    raw = torch.matmul(y.mH, a)
    if dtype == torch.complex128:
        assert torch.equal(bm, raw)
        return
    rows2 = (bm.real.square() + bm.imag.square()).sum(-1)
    floor2 = (32 * torch.finfo(rows2.dtype).eps) ** 2 * rows2.amax(-1, keepdim=True)
    zero = rows2 == 0
    assert bool(((rows2 > floor2) | zero).all())
    assert int(zero.sum(-1).min()) >= ell - 4  # rank 4: every row past the range is zero
    raw2 = (raw.real.square() + raw.imag.square()).sum(-1)
    assert torch.equal(bm[~zero], raw[~zero]) and bool((raw2[zero] <= floor2.expand_as(raw2)[zero]).all())


def _reconstruct_kept(a, vh, lam):
    """A V^H V over the kept rows of each matrix: the part of A the rand
    tail's factors keep (U diag(lam) V^H, with U = A V^H / lam)."""
    out = []
    for i in range(a.shape[0]):
        v = vh[i, lam[i] > 0]
        out.append(a[i] @ (np.conj(v).T @ v))
    return np.stack(out)


@pytest.mark.parametrize("decades", [8.0, 12.0, 16.0])
@pytest.mark.parametrize("trunc_thr", [1e-7, 1e-3])
def test_range_project_through_the_floor_matches_the_jax_route(rand_route, decades, trunc_thr):
    """Full-rank pair matrices whose spectrum falls through 32 eps (1 ..
    10^-decades over 32 values), in complex64: the floor zeroes B's rows
    below it, which hold real content here and not only rounding residue.
    The port's route (its range-finder, then K3's twin) against the JAX
    package's (its range-finder, then its rand tail): B's singular values
    and Gram within 1e-5 s_max, λ within 1e-5 s_max with the same keep
    masks (K3 keeps nothing below ~7e-6 s_max of its own), and the part of
    A the factors keep, A V^H V, within 3e-5 max |A| (the pair update's
    bar).  The vh rows of values near K3's floor are fixed only to f32
    noise on either route (the route without the floor differs from JAX's
    there by up to 5e-4 a projector entry), so U and V are held through
    A V^H V."""
    n, b = 2 * CHI, 3
    ell = trs.rand_ell(n, CHI)
    a = _graded_matrices(int(decades), b, n, decades).astype(np.complex64)
    omega = jax_sketch(b, n, ell)
    jb = np.asarray(jrs._range_project(jnp.asarray(a), ell, jrs._POWER_ITERS))
    tb = trs._range_project(torch.tensor(a), ell, trs._POWER_ITERS, omega=torch.tensor(omega).to(torch.complex64))
    tb = tb.numpy()
    assert (np.abs(tb).sum(-1) == 0).sum(-1).min() >= 2  # the floor took rows in every matrix
    js, ts = np.linalg.svd(jb, compute_uv=False), np.linalg.svd(tb, compute_uv=False)
    smax = js.max()
    assert np.abs(ts - js).max() <= 1e-5 * smax
    jg = np.conj(np.swapaxes(jb, -1, -2)) @ jb
    tg = np.conj(np.swapaxes(tb, -1, -2)) @ tb
    assert np.abs(tg - jg).max() <= 1e-5 * smax**2
    thr2 = trunc_thr**2
    tot2 = (np.abs(a) ** 2).sum((-2, -1)).astype(np.float32)
    planes = [np.ascontiguousarray(x.astype(np.float32)) for x in (jb.real, -jb.imag, tb.real, -tb.imag)]
    jvh_re, jvh_im, jlam, _ = (
        np.asarray(x)
        for x in jfr._rand_tail_raw(
            jnp.full((1, 1), thr2, jnp.float32), jnp.asarray(tot2[:, None]),
            jnp.asarray(planes[0]), jnp.asarray(planes[1]), CHI, ell, 12, 1,
        )
    )
    jlam = jlam[:, 0]
    vh_re, vh_im, lam, _, _ = tfr.rand_tail(torch.tensor(planes[2]), torch.tensor(planes[3]), torch.tensor(tot2),
                                            thr2, CHI, 12)
    lam = lam.numpy()
    assert np.abs(lam - jlam).max() <= 1e-5 * jlam.max()
    np.testing.assert_array_equal(lam > 0, jlam > 0)
    rec = _reconstruct_kept(a, vh_re.numpy() + 1j * vh_im.numpy(), lam)
    jrec = _reconstruct_kept(a, jvh_re + 1j * jvh_im, jlam)
    assert np.abs(rec - jrec).max() <= 3e-5 * np.abs(a).max()


@pytest.mark.parametrize(
    "trunc_thr,extra,near",
    [
        (1e-2, 0.0, [False] * 5),  # the cut far from every tail
        (1e-6, 10.0, [False, False, False, True, True]),  # remainder inside the rounding budget
        (1e-6, 1e4, [False] * 5),  # remainder far above it: every value kept
    ],
    ids=["coarse", "remainder-in-budget", "remainder-above-budget"],
)
def test_near_threshold_marks_only_doubtful_values(trunc_thr, extra, near):
    """Values whose keep decision f32 rounding may flip, by the rand tail's
    rule: ``extra`` eps of the total weight lies outside the kept values."""
    s = torch.tensor([[1.0, 0.5, 1e-2, 1e-3, 1e-4]], dtype=torch.float64)
    eps = float(np.finfo(np.float32).eps)
    tot2 = (s * s).sum(-1) * (1.0 + extra * eps)
    assert near_threshold(s, tot2, trunc_thr**2, 5)[0].tolist() == near
    # The cut placed on the third value's tail makes it doubtful.
    tail2 = float((s[0, 2:] ** 2).sum())
    at_cut = near_threshold(s, (s * s).sum(-1), tail2 / float((s * s).sum()), 5)
    assert bool(at_cut[0, 2])


def test_rand_ell_matches_jax():
    for n, k in ((16, 8), (32, 16), (128, 64), (192, 96), (256, 128), (10, 5), (8, 8)):
        assert trs.rand_ell(n, k) == jrs.rand_ell(n, k)
    assert (trs._OVERSAMPLE, trs._POWER_ITERS) == (jrs._OVERSAMPLE, jrs._POWER_ITERS)


# -----------------------------------------------------------------------------
# K2: the θ build.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("chi", [8, 16])
def test_theta_twin_matches_pallas_interpret(chi):
    b = 3
    ll, lc, lr, g1, g2, g4 = _pair_inputs(chi, b, chi)
    t_in = [torch.tensor(x) for x in (ll, lc, lr, g1, g2, g4)]
    *_, a_re, a_im, b_re, b_im, gate = tfp._prep_planes(*t_in, chi, torch.complex64)
    j_in = [jnp.asarray(x) for x in (ll, lc, lr, g1, g2, g4)]
    *_, ja_re, ja_im, jb_re, jb_im, jgate = jfp._prep_planes(*j_in, chi, jnp.complex64)
    for t, j in zip((a_re, a_im, b_re, b_im, gate), (ja_re, ja_im, jb_re, jb_im, jgate)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)

    before = tfp.theta_build.launches
    w_re, w_im = tfp.theta_build(gate, a_re, a_im, b_re, b_im)
    assert tfp.theta_build.launches == before  # CPU tensors: the twin
    want_re, want_im = (np.asarray(x) for x in jfp.theta_build_raw(jgate, ja_re, ja_im, jb_re, jb_im, chi, b))
    got = w_re.numpy() + 1j * w_im.numpy()
    want = want_re + 1j * want_im
    rel = np.linalg.norm(got - want, axis=(-2, -1)) / np.linalg.norm(want, axis=(-2, -1))
    assert rel.max() <= 1e-5
    # The port's own two-site tensor, transposed, is the same matrix.
    theta = tm._pair_theta(*t_in[:5], t_in[5], chi, torch.complex64).transpose(-1, -2).numpy()
    rel = np.linalg.norm(got - theta, axis=(-2, -1)) / np.linalg.norm(theta, axis=(-2, -1))
    assert rel.max() <= 1e-5


@pytest.mark.parametrize(
    "shapes,why",
    [
        (((3, 32), (3, 2, 8, 8)), None),
        (((3, 32), (3, 2, 8, 9)), r"\(B, 2, chi, chi\)"),
        (((3, 16), (3, 2, 8, 8)), r"\(B, 32\)"),
        (((0, 32), (0, 2, 8, 8)), "1 to 65535"),
    ],
)
def test_theta_argument_checks(shapes, why):
    gate, plane = (torch.zeros(s) for s in shapes)
    if why is None:
        tfp.check_theta_args(gate, plane, plane, plane, plane)
        return
    with pytest.raises(ValueError, match=why):
        tfp.check_theta_args(gate, plane, plane, plane, plane)


def test_theta_checks_dtype_and_device():
    gate, plane = torch.zeros((2, 32)), torch.zeros((2, 2, 8, 8))
    with pytest.raises(ValueError, match="float32"):
        tfp.check_theta_args(gate, plane.double(), plane, plane, plane)
    meta = torch.empty((2, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfp.theta_build(gate.to("meta"), meta, meta, meta, meta)


# -----------------------------------------------------------------------------
# K3: the rand tail.
# -----------------------------------------------------------------------------


def _tail_inputs(seed, decades):
    """conj(B) planes of three 32x32 matrices projected to l = 24, their
    full weights, from the JAX range-finder (so both sides see one input)."""
    n, b = 2 * CHI, 3
    ell = jrs.rand_ell(n, CHI)
    a = _graded_matrices(seed, b, n, decades).astype(np.complex64)
    bm = np.asarray(jrs._range_project(jnp.asarray(a), ell, jrs._POWER_ITERS))
    m_re = np.ascontiguousarray(bm.real.astype(np.float32))
    m_im = np.ascontiguousarray((-bm.imag).astype(np.float32))
    tot2 = (np.abs(a) ** 2).sum((-2, -1)).astype(np.float32)
    return m_re, m_im, tot2, ell


@pytest.mark.parametrize(
    "decades,trunc_thr,dropped",
    [(1.0, 1e-6, False), (6.0, 1e-3, True)],
    ids=["random", "graded-truncating"],
)
def test_rand_tail_twin_matches_pallas_interpret(rand_route, decades, trunc_thr, dropped):
    m_re, m_im, tot2, ell = _tail_inputs(3, decades)
    thr2 = trunc_thr**2
    jvh_re, jvh_im, jlam, jinv = (
        np.asarray(x)
        for x in jfr._rand_tail_raw(
            jnp.full((1, 1), thr2, jnp.float32), jnp.asarray(tot2[:, None]),
            jnp.asarray(m_re), jnp.asarray(m_im), CHI, ell, 12, 1,
        )
    )
    jlam, jinv = jlam[:, 0], jinv[:, 0]
    before = tfr.rand_tail.launches
    vh_re, vh_im, lam, inv, sweeps = tfr.rand_tail(
        torch.tensor(m_re), torch.tensor(m_im), torch.tensor(tot2), thr2, CHI, 12
    )
    assert tfr.rand_tail.launches == before  # CPU tensors: the twin
    lam, inv = lam.numpy(), inv.numpy()
    assert lam.shape == inv.shape == (3, CHI) and vh_re.shape == (3, CHI, 2 * CHI)
    assert int(sweeps.min()) >= 1
    smax = jlam.max(-1, keepdims=True)
    assert np.abs(lam - jlam).max() <= 1e-5 * smax.max()
    mask = lam > 0
    np.testing.assert_array_equal(mask, jlam > 0)
    assert (not mask.all()) == dropped
    np.testing.assert_array_equal(inv > 0, mask)
    vh = vh_re.numpy() + 1j * vh_im.numpy()
    jvh = jvh_re + 1j * jvh_im
    for i in range(3):
        p = np.conj(vh[i, mask[i]]).T @ vh[i, mask[i]]
        jp = np.conj(jvh[i, mask[i]]).T @ jvh[i, mask[i]]
        assert np.abs(p - jp).max() <= 2e-5


def test_rand_tail_zero_weight_keeps_nothing():
    z = torch.zeros((2, 24, 32))
    vh_re, vh_im, lam, inv, _ = tfr.rand_tail(z, z, torch.zeros(2), 1e-12, CHI)
    assert float(lam.abs().max()) == 0.0 and float(inv.abs().max()) == 0.0
    assert bool(torch.isfinite(vh_re).all()) and float(vh_re.abs().max()) == 0.0


@pytest.mark.parametrize(
    "plane,tot2,chi,why",
    [
        ((10, 72, 128), (10,), 64, None),
        ((10, 104, 192), (10,), 96, None),
        ((2, 24, 32), (3,), 16, r"\(B,\) weights"),
        ((2, 23, 32), (2,), 16, "even l"),
        ((2, 24, 20), (2,), 16, "n >= l"),
        ((2, 24, 32), (2,), 25, "chi <= l"),
    ],
)
def test_rand_tail_argument_checks(plane, tot2, chi, why):
    p, t = torch.zeros(plane), torch.zeros(tot2)
    if why is None:
        tfr.check_tail_args(p, p, t, chi)
        return
    with pytest.raises(ValueError, match=why):
        tfr.check_tail_args(p, p, t, chi)


@pytest.mark.parametrize(
    "ell,n,chi,max_smem,home",
    [
        (72, 128, 64, SMEM_H100, "cluster"),  # the 20q path: 8 CTAs of 5 pairs
        (104, 192, 96, SMEM_H100, "cluster"),
        (120, 224, 112, SMEM_H100, "cluster"),
        (136, 256, 128, SMEM_H100, "cluster"),  # the 28q path: 8 CTAs of 9 pairs, 76,240 B each
        (16, 16, 8, SMEM_H100, "cluster"),  # the heads from CLUSTER_MIN_ROWS rows
        (24, 32, 16, SMEM_H100, "cluster"),
        (40, 64, 32, SMEM_H100, "cluster"),
        (14, 16, 7, SMEM_H100, "shared"),  # below CLUSTER_MIN_ROWS: one block
        (72, 128, 64, 101376, "cluster"),  # a card with less shared memory per block
        (136, 256, 128, 60000, "global"),  # there neither a CTA of the cluster nor one block fits
    ],
)
def test_rand_tail_plane_home(ell, n, chi, max_smem, home):
    """The rand tail's planes live in the shared memory of a thread-block
    cluster from CLUSTER_MIN_ROWS = 16 rows up to chi = 128 (the path
    shapes), with the epilogue's arrays in every CTA; smaller planes in one
    block's; and the kernel takes every shape."""
    assert tfr.tail_plane_home(ell, n, chi, max_smem) == home
    p = torch.zeros((1, ell, n))
    tfr.check_tail_args(p, p, torch.zeros(1), chi)


def test_rand_tail_checks_dtype_and_device():
    p, t = torch.zeros((2, 24, 32)), torch.zeros(2)
    with pytest.raises(ValueError, match="float32"):
        tfr.check_tail_args(p.double(), p, t, CHI)
    meta = torch.empty((2, 24, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfr.rand_tail(meta, meta, t.to("meta"), 1e-12, CHI)
    # One block's planes, the loop's statistics and the epilogue's arrays:
    # 1,148 B at 14 rows of 16 lanes, chi = 7 (below the cluster's rows).
    assert tfr.tail_plane_home(14, 16, 7, 4 * (2 * 14 * 16 + 3 * 14 + 14 + 3 * 7)) == "shared"
    assert tfr.tail_plane_home(14, 16, 7, 4 * (2 * 14 * 16 + 3 * 14 + 14 + 3 * 7) - 1) == "global"
    # A CTA of the cluster at chi = 64 (8 CTAs of 5 pairs): the statistics of
    # four phases and the epilogue's arrays, two seat buffers of both sides,
    # and the go flag: 21,792 B, far below one block's 75,136.
    need = 4 * (4 * 3 * 5 + 72 + 3 * 64 + 8 * 5 * 128) + 16
    assert tfr.tail_plane_home(72, 128, 64, need) == "cluster"
    assert tfr.tail_plane_home(72, 128, 64, need - 1) == "global"


# -----------------------------------------------------------------------------
# The fused pair update and its dispatch.
# -----------------------------------------------------------------------------


def _reconstruct(ll, lr, g1, g2, lam, chi):
    """The physical two-site tensor u diag(lam) vh the factors encode (the
    Vidal gauge scalings undone), as in tests/test_fused_rand.py."""
    b = lam.shape[0]
    u = (np.asarray(g1) * np.asarray(ll)[:, None, :, None]).reshape(b, 2 * chi, chi)
    vh = np.swapaxes(np.asarray(g2) * np.asarray(lr)[:, None, None, :], 1, 2).reshape(b, chi, 2 * chi)
    return np.einsum("bik,bk,bkj->bij", u, np.asarray(lam), vh)


@pytest.mark.parametrize(
    "seed,batch,trunc_thr,kind",
    [(0, 3, 1e-5, "random"), (3, 4, 1e-3, "graded"), (4, 2, 1e-5, "boundary"), (2, 1, 1e-5, "single")],
)
def test_fused_rand_pair_update_matches_jax(rand_route, seed, batch, trunc_thr, kind):
    ins = _pair_inputs(seed, batch, CHI, graded=kind == "graded", boundary=kind == "boundary")
    jgot = jm._pair_update(*(jnp.asarray(x) for x in ins), CHI, trunc_thr, jnp.complex64, jnp.float32)
    assert tm._fused_rand_eligible(CHI, torch.complex64)
    tins = [torch.tensor(x) for x in ins]
    tgot = tm._pair_update(*tins, CHI, trunc_thr, torch.complex64, torch.float32)
    jg1, jg2, jlam = (np.asarray(x) for x in jgot)
    tg1, tg2, tlam = (x.numpy() for x in tgot)
    assert tg1.shape == jg1.shape and tg2.shape == jg2.shape and tlam.shape == jlam.shape
    assert tlam.dtype == np.float32
    ll, _, lr = ins[:3]
    th_j = _reconstruct(ll, lr, jg1, jg2, jlam, CHI)
    th_t = _reconstruct(ll, lr, tg1, tg2, tlam, CHI)
    scale = max(float(np.abs(th_j).max()), 1e-30)
    assert np.abs(th_t - th_j).max() <= 3e-5 * scale
    np.testing.assert_allclose(tlam, jlam, atol=3e-5 * float(jlam.max()))


def test_fused_rand_pair_update_keeps_batch_axes(rand_route):
    ll, lc, lr, g1, g2, g4 = (torch.tensor(x) for x in _pair_inputs(5, 6, CHI))
    shaped = [x.reshape((2, 3) + tuple(x.shape[1:])) for x in (ll, lc, lr, g1, g2)]
    # One gate per pair, broadcast over the leading (layer) axis.
    got = tm._pair_update(*shaped, g4[:3], CHI, 1e-5, torch.complex64, torch.float32)
    flat = tm._pair_update(
        ll, lc, lr, g1, g2, g4[:3].repeat(2, 1, 1), CHI, 1e-5, torch.complex64, torch.float32
    )
    assert got[0].shape == (2, 3, 2, CHI, CHI) and got[2].shape == (2, 3, CHI)
    for g, f in zip(got, flat):
        assert torch.allclose(g.reshape(f.shape), f, atol=1e-5)


@pytest.mark.parametrize(
    "chi,dtype,min_n,on_cpu",
    [(16, torch.complex64, 128, "jacobi"), (12, torch.complex64, 16, "unfused"),
     (16, torch.complex128, 32, "unfused")],
    ids=["below-min-n", "chi-not-multiple-of-8", "complex128"],
)
def test_rand_route_falls_back_to_jacobi(monkeypatch, chi, dtype, min_n, on_cpu):
    """Outside the fused update's guards the rand route is the jacobi route
    on CUDA tensors (K1, the JAX package's fallback on its accelerator).  On
    CPU tensors it is the jacobi route bit for bit below RAND_MIN_N (the
    twin of the JAX package's test_below_min_n_falls_back_to_plain_jacobi)
    and the unfused rand SVD from it, as the JAX package decides off its
    accelerator (tests/test_torch_dispatch.py holds that against JAX)."""
    monkeypatch.setattr(trs, "RAND_MIN_N", min_n)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused rand update must not run here")

    monkeypatch.setattr(tm, "fused_rand_pair_update", refuse)
    unfused = []
    real = trs.rand_svd_top_k
    monkeypatch.setattr(trs, "rand_svd_top_k", lambda *a, **k: unfused.append(a[1]) or real(*a, **k))
    assert not tm._fused_rand_eligible(chi, dtype)
    assert tm._rand_route_update(chi, dtype, torch.device("cuda")) == "jacobi"
    assert tm._rand_route_update(chi, dtype, torch.device("cpu")) == on_cpu
    ins = [torch.tensor(x) for x in _pair_inputs(9, 3, chi)]
    ins[3], ins[4], ins[5] = ins[3].to(dtype), ins[4].to(dtype), ins[5].to(dtype)
    rdtype = config.real_of(dtype)
    out = {}
    for route in ("rand", "jacobi"):
        with config.svd_impl_override(route):
            out[route] = tm._pair_update(*ins, chi, 1e-5, dtype, rdtype)
    assert unfused == ([chi] if on_cpu == "unfused" else [])
    if on_cpu == "jacobi":
        for r, j in zip(out["rand"], out["jacobi"]):
            assert torch.equal(r, j)


def test_rand_route_takes_the_fused_update_when_eligible(rand_route, monkeypatch):
    calls = []
    real = tm.fused_rand_pair_update

    def spy(*args, **kwargs):
        calls.append(args[6])
        return real(*args, **kwargs)

    monkeypatch.setattr(tm, "fused_rand_pair_update", spy)
    ins = [torch.tensor(x) for x in _pair_inputs(1, 2, CHI)]
    tm._pair_update(*ins, CHI, 1e-5, torch.complex64, torch.float32)
    assert calls == [CHI]


# -----------------------------------------------------------------------------
# A rand-route horizon, the configuration rules.
# -----------------------------------------------------------------------------

N_H, LAYERS_H, MAXITER_H, THR_H = 6, 2, 8, 1e-6
BASE_H = tuple(1 if q % 2 == 0 else 0 for q in range(N_H))


def test_rand_horizon_matches_jax(rand_route):
    jcfg.set_precision("fast")
    config.set_precision("fast")
    tja.watchdog_events.clear()
    jja.watchdog_events.clear()
    try:
        jc = JTrotterAnsatz.make(N_H, make_trotter_like_circuit(N_H, LAYERS_H), True)
        th = jtrot.init_ansatz_to_trotter(jc, np.zeros(jc.num_thetas), evol_time=1.2, delta=1.0)
        th = (th + 0.05 * np.random.default_rng(5).standard_normal(jc.num_thetas)).astype(np.float32)
        jt = jtrot.Trotter(num_qubits=N_H, evol_time=1.2, num_steps=3, delta=1.0, second_order=True).as_mps(
            jtrot.neel_init_state(N_H), trunc_thr=THR_H, chi_max=CHI
        )
        gammas, lambdas = np.asarray(jt.gammas), np.asarray(jt.lambdas)
        jt = jm.MPS(jnp.asarray(gammas.astype(np.complex64)), jnp.asarray(lambdas.astype(np.float32)))
        tt = interop.mps_to_torch(gammas, lambdas, torch.complex64, "cpu")
        tc = interop.ansatz_from_args(interop.ansatz_args(jc))
        jres = jja.optimize_horizon_mps_jit(jc, jnp.asarray(th), jt, base_bits=BASE_H,
                                            trunc_thr=THR_H, maxiter=MAXITER_H)
        tres = tja.optimize_horizon_mps_jit(tc, torch.tensor(th), tt, base_bits=BASE_H,
                                            trunc_thr=THR_H, maxiter=MAXITER_H)
    finally:
        jcfg.set_precision("high")
        config.set_precision("high")
    assert config.svd_impl(tt.device) == "rand"
    assert abs(float(tres.fobj) - float(jres.fobj)) <= 1e-4
    assert float(tres.fobj) < 0.01
    assert tja.watchdog_events == [] and jja.watchdog_events == []


def test_auto_route_per_device():
    config.set_svd_impl(None)
    assert config.svd_impl(torch.device("cuda")) == "rand"
    assert config.svd_impl(torch.device("cpu")) == "native"
    assert config.svd_impl(torch.zeros(1)) == "native"
    assert config.svd_impl(None) == "native"  # the pinned default device


def test_device_raises_without_card_unless_the_cpu_was_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(config, "_DEVICE", None)
    with pytest.raises(RuntimeError, match=r'set_device\("cpu"\)') as err:
        config.device()
    assert "AQC_TORCH_DEVICE=cpu" in str(err.value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.svd_impl(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.mps_zero(4, 2)
    config.set_device("cpu")
    assert config.device() == torch.device("cpu")
    assert tm.mps_zero(4, 2).device.type == "cpu"


def test_watchdog_reference_per_device():
    """The JAX rule: the Jacobi kernel is trusted on the accelerator, LAPACK
    elsewhere — so on CUDA a rand horizon is re-checked under K1."""
    assert tja._watchdog_reference_impl(torch.device("cuda")) == "jacobi"
    assert tja._watchdog_reference_impl(torch.device("cpu")) == "native"
    assert tja._watchdog_reference_impl(torch.zeros(1)) == "native"
    config.set_svd_impl(None)
    cuda = torch.device("cuda")
    assert config.svd_impl(cuda) != tja._watchdog_reference_impl(cuda)
