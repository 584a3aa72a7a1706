"""The range-finder's LU path and knobs, the unfused-rand opt-in, and the
leftover parameters of the one-lane L-BFGS and the Jacobi spec, held against
the JAX package on the CPU.

* ``rand_svd._lu_stab`` against the JAX ``_lu_stab`` on zero-padded pair
  samples (``kernel_checks.padded_pair_batch``) and on graded full-rank
  samples: finite; entries within the partial-pivot bound |l| <= sqrt(2)
  (complex pivoting compares |re| + |im|, tests/test_rand_svd.py:163); y's numerical
  range inside span(P L); span(P L) of the two packages within 1e-4 (c64;
  graded inputs in c128 within 1e-8).  Raw factors are not compared.
* ``rand_svd_top_k(intermediate="lu", oversample=16, power_iters=2)``
  against the JAX call with the JAX sketch handed in: singular values
  within 1e-5 * s_max, equal noise-guard masks, and the discarded weight
  within 1.05x the optimal rank-k one (tests/test_rand_svd.py:171-201);
  ``_range_project(intermediate="lu")`` against JAX's within 1e-5 * s_max.
* The modes the JAX package measured unsafe (qrlite, colnorm, cholqr,
  final cholqrK) raise and name ROADMAP's "Not to port" entry.
* The ``AQC_TORCH_RAND_*`` knobs reach the module attributes, and an
  ``AQC_TORCH_RAND_INTERMEDIATE=lu`` process runs the fused route's
  range-finder on LU (subprocess).
* ``AQC_TORCH_ALLOW_UNFUSED_RAND=1`` sends a CUDA pair update that the fused
  route does not take to the unfused rand SVD from ``RAND_MIN_N`` on
  (decided on the host: no card needed).
* The one-lane ``minimize_lbfgs_compact`` with ``batch_linesearch`` /
  ``fuse_linesearch_grad`` against JAX's on Rosenbrock (1e-10, the same
  iterations), and a stateful objective on the grid.
* ``jacobi_svd(sort=False)`` against JAX's (1e-10, c128)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.ops import jacobi_svd as jjs
from aqc_research_tpu.ops import rand_svd as jrs
from aqc_research_tpu.optim import lbfgs as jlbfgs
from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.kernel_checks import padded_pair_batch
from aqc_research_tpu_torch.ops import jacobi_svd as tjs
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops import rand_svd as trs
from aqc_research_tpu_torch.optim import lbfgs as tlbfgs
from tests import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_S = 1e-5
TOL_SPAN = 1e-4  # projector difference, complex64 inputs
TOL_DW = 1.05  # discarded weight over the optimal rank-k one


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


def _graded(seed: int, batch: int, n: int, rate: float) -> np.ndarray:
    """Graded singular spectra exp(-rate k), the pair-matrix class."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    u, _, vh = np.linalg.svd(a)
    return (u * np.exp(-rate * np.arange(n))[None, None, :]) @ vh


def _basis(y: np.ndarray) -> np.ndarray:
    return np.linalg.qr(y.astype(np.complex128))[0]


def _span_gap(y1: np.ndarray, y2: np.ndarray) -> float:
    """Largest entry of the difference of the projectors onto the column
    spans of y1 and y2."""
    q1, q2 = _basis(y1), _basis(y2)
    d = q1 @ np.conj(np.swapaxes(q1, -1, -2)) - q2 @ np.conj(np.swapaxes(q2, -1, -2))
    return float(np.abs(d).max())


def _range_residual(y: np.ndarray, pl: np.ndarray, rel: float = 1e-5) -> float:
    """How far y's numerical range (left singular vectors above ``rel`` of
    its largest value) sticks out of span(pl)."""
    u, s, _ = np.linalg.svd(y.astype(np.complex128), full_matrices=False)
    q = _basis(pl)
    worst = 0.0
    for ub, sb, qb in zip(u, s, q):
        ur = ub[:, sb > rel * sb[0]]
        worst = max(worst, float(np.abs(ur - qb @ (np.conj(qb.T) @ ur)).max()))
    return worst


def _padded_samples(n: int, batch: int, rank: int) -> np.ndarray:
    a = padded_pair_batch(np.random.default_rng(n + rank), batch, n, rank).numpy()
    ell = trs.rand_ell(n, n // 2)
    return a @ jax_sketch(batch, n, ell).astype(np.complex64)


@pytest.mark.parametrize("n, rank", [(32, 3), (64, 5)])
def test_lu_stab_on_padded_pair_samples_matches_jax(n, rank):
    """Samples of zero-padded pair matrices: rank 2 * rank of l columns, so
    LU meets exact zero pivots past the rank; P L stays finite and full
    rank (a zero pivot leaves a unit column), keeps y's range, and spans
    what the JAX package's P L spans."""
    y = _padded_samples(n, 4, rank)
    got = trs._lu_stab(torch.tensor(y)).numpy()
    want = np.asarray(jrs._lu_stab(jnp.asarray(y)))
    assert got.shape == y.shape and np.isfinite(got).all()
    assert float(np.abs(got).max()) <= np.sqrt(2.0) + 1e-6
    assert min(np.linalg.matrix_rank(g) for g in got) == y.shape[-1]
    assert _range_residual(y, got) <= TOL_SPAN
    assert _span_gap(got, want) <= TOL_SPAN


@pytest.mark.parametrize("dtype, tol", [(np.complex64, TOL_SPAN), (np.complex128, 1e-8)])
def test_lu_stab_on_graded_samples_matches_jax(dtype, tol):
    """Full-rank samples graded over six decades (the z-leg's squared
    spectrum): span(P L) = span(y), O(1) conditioning, and the JAX span."""
    rng = np.random.default_rng(6)
    y = ((rng.standard_normal((3, 64, 24)) + 1j * rng.standard_normal((3, 64, 24)))
         * np.logspace(0, -6, 24)[None, None, :]).astype(dtype)
    got = trs._lu_stab(torch.tensor(y)).numpy()
    want = np.asarray(jrs._lu_stab(jnp.asarray(y)))
    assert float(np.abs(got).max()) <= np.sqrt(2.0) + 1e-6
    assert float(np.max(np.linalg.cond(got))) < 50.0
    if dtype == np.complex128:
        assert _span_gap(got, y) <= tol
    assert _span_gap(got, want) <= tol


def _discarded(m: np.ndarray, u, s, vh) -> np.ndarray:
    return np.linalg.norm(m - (u * s[..., None, :]) @ vh, axis=(-2, -1))


@pytest.mark.parametrize("kind", ["graded", "padded"])
def test_rand_svd_top_k_lu_matches_jax(kind):
    """``rand_svd_top_k(intermediate="lu", oversample=16, power_iters=2)``
    with the JAX sketch handed in: σ, masks and discarded weight."""
    n, k, batch = 64, 32, 3
    if kind == "graded":
        m = _graded(7, batch, n, 0.05).astype(np.complex64)
    else:
        m = padded_pair_batch(np.random.default_rng(8), batch, n, 6).numpy()
    ell = trs.rand_ell(n, k, 16)
    assert ell == jrs.rand_ell(n, k, 16) == 48
    previous = config.jacobi_criterion()
    jcfg.set_jacobi_criterion("hybrid")
    config.set_jacobi_criterion("hybrid")
    jax.clear_caches()
    try:
        ju, js, jvh = (np.asarray(x) for x in jrs.rand_svd_top_k(jnp.asarray(m), k, 12, 16, 2, "lu", "qr"))
        omega = torch.tensor(jax_sketch(batch, n, ell)).to(torch.complex64)
        tu, ts, tvh = (x.numpy() for x in trs.rand_svd_top_k(
            torch.tensor(m), k, 12, oversample=16, power_iters=2, intermediate="lu", final="qr", omega=omega))
    finally:
        jcfg.set_jacobi_criterion(None)
        config.set_jacobi_criterion(previous)
        jax.clear_caches()
    assert np.abs(ts - js).max() <= TOL_S * js[:, :1].max()
    np.testing.assert_array_equal(ts > 0, js > 0)
    u, s, vh = np.linalg.svd(m.astype(np.complex128))
    best = _discarded(m, u[..., :k], s[..., :k], vh[..., :k, :])
    for factors in ((tu, ts, tvh), (ju, js, jvh)):
        dw = _discarded(m, *factors)
        if kind == "graded":
            assert float(np.max(dw / best)) <= TOL_DW
        else:  # rank 12 <= k: nothing to discard but f32 rounding
            assert float(dw.max()) <= 1e-5


def test_range_project_lu_matches_jax():
    """The projection B = Q^H A with LU between the power legs."""
    n, batch = 32, 3
    a = _graded(9, batch, n, 0.1).astype(np.complex64)
    ell = trs.rand_ell(n, n // 2)
    jb = np.asarray(jrs._range_project(jnp.asarray(a), ell, 2, "lu", "qr"))
    tb = trs._range_project(torch.tensor(a), ell, 2, torch.tensor(jax_sketch(batch, n, ell)).to(torch.complex64),
                            "lu", "qr").numpy()
    js, ts = np.linalg.svd(jb, compute_uv=False), np.linalg.svd(tb, compute_uv=False)
    assert np.abs(ts - js).max() <= TOL_S * js.max()


@pytest.mark.parametrize("kw", [{"intermediate": "qrlite"}, {"intermediate": "colnorm"},
                                {"intermediate": "cholqr"}, {"final": "cholqr2"}, {"final": "cholqr3"}])
def test_unsafe_modes_raise(kw):
    a = torch.tensor(_graded(1, 2, 16, 0.1).astype(np.complex64))
    with pytest.raises(ValueError, match="Not to port"):
        trs._range_project(a, 12, 1, **kw)
    with pytest.raises(ValueError, match="Not to port"):
        trs.rand_svd_top_k(a, 8, **kw)
    with pytest.raises(ValueError, match="unknown"):
        trs._range_project(a, 12, 1, intermediate="householder")


def test_range_project_q0_and_default_intermediate():
    """q_iters = 0 takes the final basis at once (no power leg), whatever
    the intermediate; the default intermediate is "qr"."""
    a = torch.tensor(_graded(2, 2, 16, 0.1).astype(np.complex64))
    om = trs.sketch(2, 16, 12, a.dtype, "cpu")
    assert trs._INTERMEDIATE == "qr"
    assert torch.equal(trs._range_project(a, 12, 0, om, "lu"), trs._range_project(a, 12, 0, om, "qr"))
    assert torch.equal(trs._range_project(a, 12, 1, om), trs._range_project(a, 12, 1, om, "qr"))


KNOB_SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from aqc_research_tpu_torch.ops import rand_svd as r
print(json.dumps([r._OVERSAMPLE, r._POWER_ITERS, r.RAND_MIN_N, r._INTERMEDIATE]))
"""


@pytest.mark.parametrize("env, want", [
    ({}, [8, 1, 128, "qr"]),
    ({"AQC_TORCH_RAND_OVERSAMPLE": "16", "AQC_TORCH_RAND_POWER_ITERS": "2", "AQC_TORCH_RAND_MIN_N": "64",
      "AQC_TORCH_RAND_INTERMEDIATE": "lu"}, [16, 2, 64, "lu"]),
])
def test_env_knobs_reach_the_module(env, want):
    base = {k: v for k, v in os.environ.items() if not k.startswith("AQC_TORCH_RAND_")}
    out = subprocess.run([sys.executable, "-c", KNOB_SCRIPT.format(root=ROOT)], env={**base, **env},
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == str(want).replace("'", '"')


def test_fused_route_takes_the_module_intermediate(monkeypatch):
    """With ``_INTERMEDIATE = "lu"`` the fused rand update's range-finder
    factors its power legs by LU (a spy counts torch.linalg.lu calls)."""
    from aqc_research_tpu_torch.ops import fused_rand as tfr

    calls = []
    real_lu = torch.linalg.lu
    monkeypatch.setattr(torch.linalg, "lu", lambda *a, **k: calls.append(1) or real_lu(*a, **k))
    monkeypatch.setattr(trs, "_INTERMEDIATE", "lu")
    monkeypatch.setattr(trs, "RAND_MIN_N", 16)
    chi = 8
    rng = np.random.default_rng(4)
    lam = lambda: torch.tensor(np.sort(rng.random((2, chi)))[:, ::-1].copy(), dtype=torch.float32)  # noqa: E731
    g = lambda: torch.tensor(rng.standard_normal((2, 2, chi, chi)) + 1j * rng.standard_normal((2, 2, chi, chi)),  # noqa: E731
                             dtype=torch.complex64)
    gate = torch.tensor(np.linalg.qr(rng.standard_normal((2, 4, 4)) + 1j * rng.standard_normal((2, 4, 4)))[0],
                        dtype=torch.complex64)
    out = tfr.fused_rand_pair_update(lam(), lam(), lam(), g(), g(), gate, chi, 1e-6, torch.complex64, torch.float32)
    assert len(calls) == 2 * trs._POWER_ITERS and all(bool(torch.isfinite(torch.view_as_real(t)).all())
                                                      for t in out[:2])


@pytest.mark.parametrize("opt_in, want", [("", "jacobi"), ("1", "unfused"), ("0", "jacobi")])
def test_unfused_rand_opt_in_on_cuda(monkeypatch, opt_in, want):
    """A CUDA pair update the fused route does not take (fused updates off)
    runs K1 by default and the unfused rand SVD with the opt-in, from
    RAND_MIN_N on; below it K1 either way.  CPU tensors take the unfused
    SVD without the opt-in, as in the JAX package off its accelerator."""
    monkeypatch.setenv("AQC_TORCH_ALLOW_UNFUSED_RAND", opt_in)
    fused = config._FUSED_PAIR
    config.set_fused_pair(False)
    try:
        assert config.allow_unfused_rand() == (opt_in == "1")
        assert tm._rand_route_update(64, torch.complex64, "cuda") == want
        assert tm._rand_route_update(32, torch.complex64, "cuda") == "jacobi"
        assert tm._rand_route_update(64, torch.complex64, "cpu") == "unfused"
    finally:
        config.set_fused_pair(fused)


def rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def rosen_t(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


@pytest.mark.parametrize("batch_ls, fuse", [(12, False), (12, True), (16, False), (16, True)])
def test_one_lane_grid_linesearch_matches_jax(batch_ls, fuse):
    x0 = np.random.default_rng(0).uniform(-2.0, 2.0, 4)
    jres = jlbfgs.minimize_lbfgs_compact(rosen_j, jnp.asarray(x0), maxiter=60, batch_linesearch=batch_ls,
                                         fuse_linesearch_grad=fuse)
    tres = tlbfgs.minimize_lbfgs_compact(rosen_t, torch.tensor(x0), maxiter=60, batch_linesearch=batch_ls,
                                         fuse_linesearch_grad=fuse)
    assert tres.num_iters == int(jres.num_iters) > 1
    assert tres.converged == bool(jres.converged)
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(tres.fobj), float(jres.fobj), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="batch_linesearch"):
        tlbfgs.minimize_lbfgs_compact(rosen_t, torch.tensor(x0), maxiter=2, fuse_linesearch_grad=True)


@pytest.mark.parametrize("fuse", [False, True])
def test_one_lane_grid_linesearch_threads_the_state(fuse):
    """A stateful objective (a running sum of the values it saw) on the
    grid: the state ticks once per linesearch with the accepted trial's
    state, as under the JAX loop's vmap."""
    x0 = np.random.default_rng(1).uniform(-1.5, 1.5, 3)

    def j_val(x, st):
        f = rosen_j(x)
        return f, st + f

    def j_vg(x, st):
        f, g = jax.value_and_grad(rosen_j)(x)
        return f, g, st + 2.0 * f

    def t_val(x, st):
        f = rosen_t(x)
        return f, st + f

    def t_vg(x, st):
        f, g = tlbfgs.autograd_value_and_grad(rosen_t)(x)
        return f, g, st + 2.0 * f

    jres, jst = jlbfgs.minimize_lbfgs_compact_stateful(j_val, j_vg, jnp.asarray(x0), jnp.asarray(0.0), maxiter=25,
                                                       batch_linesearch=8, fuse_linesearch_grad=fuse)
    tres, tst = tlbfgs.minimize_lbfgs_compact_stateful(t_val, t_vg, torch.tensor(x0), torch.tensor(0.0), maxiter=25,
                                                       batch_linesearch=8, fuse_linesearch_grad=fuse)
    assert tres.num_iters == int(jres.num_iters)
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(tst), float(jst), rtol=1e-12, atol=0)


@pytest.mark.parametrize("sort", [False, True])
def test_jacobi_svd_sort_matches_jax(sort):
    rng = np.random.default_rng(3)
    m = rng.standard_normal((2, 8, 8)) + 1j * rng.standard_normal((2, 8, 8))
    ju, js, jvh = (np.asarray(x) for x in jjs.jacobi_svd(jnp.asarray(m), 12, sort))
    tu, ts, tvh = (x.resolve_conj().numpy() for x in tjs.jacobi_svd(torch.tensor(m), 12, sort=sort))
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-10)
    np.testing.assert_allclose((tu * ts[..., None, :]) @ tvh, m, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.abs(tu), np.abs(ju), rtol=0, atol=1e-10)
    assert sort == bool(np.all(np.diff(ts, axis=-1) <= 0))
