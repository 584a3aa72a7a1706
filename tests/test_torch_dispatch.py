"""The rand route's dispatch (config.fused_rand_enabled, ops/mps.py
``_rand_route_update``) and the unfused ``rand_svd.rand_svd_top_k`` held
against the JAX package on the CPU.

* ``fused_rand_enabled`` equals the JAX one for the override None, True and
  False; with None the answer depends on the device: on for CUDA tensors
  (the JAX package: on for its accelerator), off for CPU tensors.
* Which update a pair update runs — fused, unfused ``rand_svd_top_k`` or
  the Jacobi route (K1's twin, or the spec below 8 columns) — is the same
  in both packages on the CPU (counters on the entry points); on CUDA
  tensors the port's choice is the JAX package's on its accelerator: K1
  where the fused update does not run, never the unfused rand SVD.  λ of
  the two packages' updates within 3e-5 * λ_max (f32 decompositions, the
  JAX sketch handed to the port).
* ``rand_svd_top_k`` at n in {16, 64}, k = n/2, complex64, on graded
  matrices from a numpy seed and on zero-padded pair matrices
  (``kernel_checks.padded_pair_batch``), with the JAX sketch handed in:
  singular values within 1e-5 * s_max, equal noise-guard masks, and the
  spanned subspace (the projector onto the kept vh rows) within 1e-4 in
  the spectral norm.  Raw factors are not compared: QR phase conventions
  differ.

The kernels themselves run only on a CUDA card: tests/test_torch_kernel.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.ops import fused_rand as jfr
from aqc_research_tpu.ops import jacobi_svd as jjs
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.ops import pallas_jacobi as jpj
from aqc_research_tpu.ops import rand_svd as jrs
from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.kernel_checks import padded_pair_batch
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops import rand_svd as trs

MIN_N = 24  # RAND_MIN_N of both packages in these tests: chi 12 and 16 reach it, chi 8 does not
TOL_S = 1e-5
TOL_SUBSPACE = 1e-4
TOL_LAM = 3e-5


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
def fused_override():
    """Sets both packages' fused-pair override; restores auto after."""

    def set_both(value):
        config.set_fused_pair(value)
        jcfg.set_fused_pair(value)

    yield set_both
    set_both(None)


# -----------------------------------------------------------------------------
# config.fused_rand_enabled
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("override", [None, True, False])
@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
def test_fused_rand_enabled_matches_jax(monkeypatch, fused_override, override, on_card):
    """The port on CUDA (CPU) tensors against the JAX package on (off) its
    accelerator."""
    fused_override(override)
    monkeypatch.setattr(jcfg, "is_tpu", lambda: on_card)
    dev = torch.device("cuda" if on_card else "cpu")
    for chi in (4, 8, 16, 64, 128):
        assert config.fused_rand_enabled(chi, dev) == jcfg.fused_rand_enabled(chi), chi
    want = override if override is not None else on_card
    assert config.fused_rand_enabled(64, dev) is want
    assert config.fused_rand_enabled(64, torch.zeros(1)) is (override if override is not None else False)


def test_fused_rand_enabled_raises_without_a_device(monkeypatch):
    """Auto on the default device: the CPU must have been asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(config, "_DEVICE", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.fused_rand_enabled(64)


# -----------------------------------------------------------------------------
# Which update runs.
# -----------------------------------------------------------------------------


def _pair_inputs(seed, batch, chi, dtype):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    def lams():
        lam = np.sort(rng.random((batch, chi)) + 0.05, axis=-1)[..., ::-1]
        return (lam / np.linalg.norm(lam, axis=-1, keepdims=True)).astype(np.float32)

    ll, lc, lr = lams(), lams(), lams()
    return ll, lc, lr, c(batch, 2, chi, chi).astype(dtype), c(batch, 2, chi, chi).astype(dtype), c(batch, 4, 4).astype(dtype)


def _spy(monkeypatch, counts, module, name, kind):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        counts.append(kind)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize(
    "override,chi,dtype,on_cpu,on_card",
    [
        (None, 16, np.complex64, "unfused", "fused"),
        (True, 16, np.complex64, "fused", "fused"),
        (False, 16, np.complex64, "unfused", "jacobi"),
        (None, 12, np.complex64, "unfused", "jacobi"),  # chi % 8 != 0: not eligible for the fused update
        (True, 12, np.complex64, "unfused", "jacobi"),
        (None, 16, np.complex128, "unfused", "jacobi"),  # the fused update is complex64 only
        (None, 8, np.complex64, "jacobi", "jacobi"),  # 2 chi < RAND_MIN_N
        (None, 2, np.complex64, "jacobi", "jacobi"),  # a chi-growth head: the spec below 8 columns
    ],
    ids=["auto", "fused-on", "fused-off", "chi12-auto", "chi12-on", "c128", "below-min-n", "head"],
)
def test_rand_route_runs_what_jax_runs(monkeypatch, fused_override, override, chi, dtype, on_cpu, on_card):
    monkeypatch.setattr(jrs, "RAND_MIN_N", MIN_N)
    monkeypatch.setattr(trs, "RAND_MIN_N", MIN_N)
    monkeypatch.setattr(
        trs, "sketch", lambda b, n, ell, dt, dev: torch.tensor(jax_sketch(b, n, ell)).to(dt).to(dev)
    )
    jax_runs, port_runs = [], []
    _spy(monkeypatch, jax_runs, jfr, "fused_rand_pair_update", "fused")
    _spy(monkeypatch, jax_runs, jrs, "rand_svd_top_k", "unfused")
    _spy(monkeypatch, jax_runs, jpj, "jacobi_svd_pallas_top_k", "jacobi")
    _spy(monkeypatch, jax_runs, jjs, "jacobi_svd_top_k", "jacobi")
    _spy(monkeypatch, port_runs, tm, "fused_rand_pair_update", "fused")
    _spy(monkeypatch, port_runs, trs, "rand_svd_top_k", "unfused")
    _spy(monkeypatch, port_runs, tm, "jacobi_svd_kernel_top_k", "jacobi")
    _spy(monkeypatch, port_runs, tm, "jacobi_svd_top_k", "jacobi")
    fused_override(override)
    jcfg.set_svd_impl("rand")
    config.set_svd_impl("rand")
    previous = config.jacobi_criterion()
    jcfg.set_jacobi_criterion("hybrid")
    config.set_jacobi_criterion("hybrid")
    jax.clear_caches()
    ins = _pair_inputs(7, 3, chi, dtype)
    rdtype = np.float32 if dtype == np.complex64 else np.float64
    try:
        jout = jm._pair_update(*(jnp.asarray(x) for x in ins), chi, 1e-5, jnp.dtype(dtype), jnp.dtype(rdtype))
        tdtype = torch.complex64 if dtype == np.complex64 else torch.complex128
        tout = tm._pair_update(*(torch.tensor(x) for x in ins), chi, 1e-5, tdtype, config.real_of(tdtype))
    finally:
        jcfg.set_svd_impl(None)
        config.set_svd_impl(None)
        jcfg.set_jacobi_criterion(None)
        config.set_jacobi_criterion(previous)
        jax.clear_caches()
    assert set(port_runs) == set(jax_runs) == {on_cpu}
    assert tm._rand_route_update(chi, torch.complex64 if dtype == np.complex64 else torch.complex128,
                                 torch.device("cuda")) == on_card
    jlam, tlam = np.asarray(jout[2]), tout[2].numpy()
    assert tlam.dtype == jlam.dtype
    np.testing.assert_allclose(tlam, jlam, atol=TOL_LAM * float(jlam.max()), rtol=0)


def test_card_never_takes_the_unfused_rand_svd(fused_override):
    """On CUDA tensors the rand route takes the fused update or K1, at every
    override, bond dimension and dtype."""
    cuda = torch.device("cuda")
    for override in (None, True, False):
        fused_override(override)
        for chi in (2, 8, 12, 16, 64, 96, 128):
            for dtype in (torch.complex64, torch.complex128):
                assert tm._rand_route_update(chi, dtype, cuda) in ("fused", "jacobi")


# -----------------------------------------------------------------------------
# rand_svd_top_k
# -----------------------------------------------------------------------------


def _graded(seed, batch, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    u, _, vh = np.linalg.svd(a)
    s = 10.0 ** (-2.0 * np.arange(n) / (n - 1))
    return ((u * s[None, None, :]) @ vh).astype(np.complex64)


def _projector(vh, keep):
    rows = vh * keep[..., :, None]
    return np.conj(np.swapaxes(rows, -1, -2)) @ rows


@pytest.mark.parametrize(
    "n,kind",
    [(16, "graded"), (64, "graded"), (64, "padded")],
)
def test_rand_svd_top_k_matches_jax(n, kind):
    batch, k = 3, n // 2
    ell = trs.rand_ell(n, k)
    assert ell == jrs.rand_ell(n, k)
    if kind == "graded":
        m = _graded(11, batch, n)
    else:
        m = padded_pair_batch(np.random.default_rng(12), batch, n, 6).numpy()
    previous = config.jacobi_criterion()
    jcfg.set_jacobi_criterion("hybrid")
    config.set_jacobi_criterion("hybrid")
    jax.clear_caches()
    try:
        ju, js, jvh = (np.asarray(x) for x in jrs.rand_svd_top_k(jnp.asarray(m), k))
        omega = torch.tensor(jax_sketch(batch, n, ell)).to(torch.complex64)
        tu, ts, tvh = (x.numpy() for x in trs.rand_svd_top_k(torch.tensor(m), k, omega=omega))
    finally:
        jcfg.set_jacobi_criterion(None)
        config.set_jacobi_criterion(previous)
        jax.clear_caches()
    assert tu.shape == ju.shape == (batch, n, k) and tvh.shape == jvh.shape == (batch, k, n)
    assert ts.dtype == js.dtype == np.float32
    smax = js[:, :1]
    assert np.abs(ts - js).max() <= TOL_S * smax.max()
    keep = js > 0
    np.testing.assert_array_equal(ts > 0, keep)
    if kind == "padded":
        assert keep.sum(-1).max() <= 12  # two blocks of rank 6
    d = _projector(tvh, keep) - _projector(jvh, keep)
    assert max(np.linalg.norm(x, 2) for x in d) <= TOL_SUBSPACE
    # u = A vh^H diag(1/s): the left factor of the same decomposition.
    rec = np.einsum("bik,bk,bkj->bij", tu, ts, tvh)
    rec_j = np.einsum("bik,bk,bkj->bij", ju, js, jvh)
    assert np.abs(rec - rec_j).max() <= TOL_SUBSPACE * smax.max()


def test_rand_svd_top_k_keeps_batch_axes_and_checks_shape():
    m = torch.tensor(_graded(3, 4, 16)).reshape(2, 2, 16, 16)
    u, s, vh = trs.rand_svd_top_k(m, 8)
    assert u.shape == (2, 2, 16, 8) and s.shape == (2, 2, 8) and vh.shape == (2, 2, 8, 16)
    flat = trs.rand_svd_top_k(m.reshape(4, 16, 16), 8)[1]
    assert torch.equal(s.reshape(4, 8), flat)
    with pytest.raises(ValueError, match="square even-sized"):
        trs.rand_svd_top_k(torch.zeros(2, 15, 15, dtype=torch.complex64), 4)
