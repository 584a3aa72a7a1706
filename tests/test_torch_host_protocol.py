"""The port's host protocol held against the JAX package on the CPU: the
stoppers, the optimizer loop with its stop and timeout exceptions, the
numpy Adam against optax, and the flip-state handlers.

* every stopper class on the same call sequences: the same returns, raises
  and ``optim_results``; ``GradientAmplifier`` scales within 1e-15;
* ``AqcOptimizer`` with lbfgs, adam, cobyla and bobyqa on the quadratic of
  tests/test_optim.py: the same ``x`` within 1e-10 and the same counts;
* the numpy Adam against ``optax.adam`` over 50 steps within 1e-12;
* the early-stop, stall and timeout paths through ``SpService``: the same
  result dicts;
* the three state handlers at 5 qubits: states and dots within 1e-12."""

import itertools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.models.sp_lhs import objective_base as job
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.optim import optimizer as jopt
from aqc_research_tpu.optim import stoppers as jst
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.circuit.ansatz import Ansatz
from aqc_research_tpu_torch.models.sp_lhs import objective_base as tob
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.optim import optimizer as topt
from aqc_research_tpu_torch.optim import stoppers as tst
from aqc_research_tpu_torch.targets import trotter as ttrot
from tests import _torch_threads  # noqa: F401

TOL_SCALE = 1e-15
TOL_X = 1e-10
TOL_ADAM = 1e-12
TOL_STATE = 1e-12
PACKAGES = ((jst, jopt, JAnsatz, job), (tst, topt, Ansatz, tob))


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


class _FakeClock:
    """perf_counter stand-in: advances ``step`` seconds per reading."""

    def __init__(self, step: float):
        self.now, self.step = 0.0, step

    def __call__(self):
        self.now += self.step
        return self.now


def _outcome(fn):
    """(value or None, exception type name or None, message)."""
    try:
        return fn(), None, ""
    except (StopIteration, TimeoutError, jst.StagnantOptimizationWarning, tst.StagnantOptimizationWarning) as ex:
        return None, type(ex).__name__, str(ex)


def _same_dict(got: dict, want: dict, tol: float = 0.0):
    """Equal keys and values; float arrays and floats within ``tol``."""
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(np.asarray(g), w, atol=tol, rtol=0, err_msg=key)
        elif isinstance(w, dict):
            _same_dict(g, w, tol)
        elif isinstance(w, float):
            assert abs(g - w) <= tol, key
        else:
            assert g == w, key


# -----------------------------------------------------------------------------
# Stoppers.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("raise_ex", [True, False])
def test_not_improve_stopper(raise_ex):
    fobjs = [1.0, 0.9, 0.95, 0.93, 0.92, 0.91, 0.94, 0.89, 0.9, 0.9, 0.9, 0.9, 0.9]
    runs = []
    for st, *_ in PACKAGES:
        s = st.NotImproveStopper(num_iters=3, raise_ex=raise_ex)
        out = [_outcome(lambda: s.check(f, i)) for i, f in enumerate(fobjs)]
        s.reset()
        out.append(_outcome(lambda: s.check(2.0, 0)))
        s.disable()
        out += [_outcome(lambda: s.check(2.0, i)) for i in range(1, 8)]
        runs.append(out)
    assert runs[0] == runs[1]
    assert any(o[1] for o in runs[1]) == raise_ex


def test_small_objective_and_timeout_stoppers(monkeypatch):
    runs = []
    for st, *_ in PACKAGES:
        s = st.SmallObjectiveStopper(fobj_thr=0.1)
        out = [_outcome(lambda: s.check(f)) for f in (0.5, 0.1, 0.0999)]
        monkeypatch.setattr(st, "perf_counter", _FakeClock(0.4))
        for limit in (0, 1):
            t = st.TimeoutStopper(time_limit=limit)
            out += [_outcome(t.check) for _ in range(4)]
        runs.append(out)
    assert runs[0] == runs[1]
    assert [o[1] for o in runs[1]][:3] == [None, None, "StopIteration"]
    assert "TimeoutError" in [o[1] for o in runs[1]]


@pytest.mark.parametrize("limit,start", [(2, True), ({"timeout": 2}, False), (-1, True)])
def test_timeout_checker(monkeypatch, limit, start):
    runs = []
    for st, *_ in PACKAGES:
        monkeypatch.setattr(st, "perf_counter", _FakeClock(0.5))
        tc = st.TimeoutChecker(time_limit=limit, start_immediately=start)
        if not start:
            tc.start()
        out = [_outcome(lambda: tc.check(0.3 - 0.01 * i, np.full(3, i), lambda f, th: {"cost": f, "th": th}))
               for i in range(6)]
        runs.append((out, tc.optim_results))
    (o_j, r_j), (o_t, r_t) = runs
    assert o_j == o_t
    _same_dict(r_t, r_j)
    assert ("TimeoutError" in [o[1] for o in o_t]) == (limit != -1)


@pytest.mark.parametrize(
    "kwargs,fobjs,fids",
    [
        ({"fobj_thr": 0.2}, [0.5, 0.4, 0.19], [None] * 3),
        ({"fidelity_thr": 0.99}, [0.5, 0.3, 0.2], [0.5, 0.7, 0.995]),
        ({"num_iters": 2}, [0.5, 0.3, 0.4, 0.35, 0.32, 0.31], [None] * 6),
        ({}, [0.5, 0.3], [0.999, 1.0]),
    ],
    ids=["objective", "fidelity", "stall", "none"],
)
def test_early_stopper(kwargs, fobjs, fids):
    runs = []
    for st, *_ in PACKAGES:
        s = st.EarlyStopper(**kwargs)
        out = [
            _outcome(lambda: s.check(f, fid, np.full(2, i, float), i, lambda fo, th: {"cost": fo, "thetas": th}))
            for i, (f, fid) in enumerate(zip(fobjs, fids))
        ]
        runs.append((out, s.optim_results))
    (o_j, r_j), (o_t, r_t) = runs
    assert o_j == o_t
    _same_dict(r_t, r_j)
    if kwargs.get("num_iters"):
        assert r_t["cost"] == 0.3 and np.all(r_t["thetas"] == 1.0)  # the running minimum
    for st, *_ in PACKAGES:
        with pytest.raises(ValueError):
            st.EarlyStopper(fidelity_thr=1.5)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("history", [3, 5])
def test_gradient_amplifier(strong, history):
    fobjs = list(np.linspace(0.5, 0.4, 6)) + [0.3999999] * 12 + list(np.geomspace(0.3, 1e-3, 6))
    scales = []
    for st, *_ in PACKAGES:
        g = st.GradientAmplifier(history=history, strong=strong)
        scales.append(np.array([g.estimate(f) for f in fobjs]))
    np.testing.assert_allclose(scales[1], scales[0], atol=TOL_SCALE, rtol=0)
    assert scales[1][: history - 1].tolist() == [1.0] * (history - 1) and scales[1].max() > 1.5
    for st, *_ in PACKAGES:
        with pytest.raises(ValueError):
            st.GradientAmplifier(history=2)


# -----------------------------------------------------------------------------
# The optimizer loop.
# -----------------------------------------------------------------------------


class _Quadratic:
    """tests/test_optim.py's objective, with an SpService of either package
    so that the stop checks of the host protocol run in ``gradient``."""

    def __init__(self, ob, circ, fidelity_of=None):
        self.service = ob.SpService({"maxiter": 50}, circ, 3)
        self.fidelity_of = fidelity_of
        self.fobj = 1.0

    def objective(self, th):
        self.fobj = float(np.sum((th - 1.5) ** 2))
        self.service.on_end_objective()
        return self.fobj

    def gradient(self, th):
        fid = None if self.fidelity_of is None else self.fidelity_of(self.fobj)
        self.service.on_begin_gradient(self.fobj, th, fid)
        grad = 2.0 * (np.asarray(th) - 1.5)
        self.service.on_end_gradient(self.fobj, -1.0, grad, np.zeros(3), 1.0)
        return grad

    def set_status_trackers(self, timeout=None, stopper=None):
        self.service.set_status_trackers(timeout, stopper)


def _optimize(pkg, name, maxiter=200, stopper_kw=None, timeout=None, fidelity_of=None):
    st, opt, ansatz, ob = pkg
    circ = ansatz.make(2, "cx", np.array([[0], [1]]))
    objv = _Quadratic(ob, circ, fidelity_of)
    stopper = None if stopper_kw is None else st.EarlyStopper(**stopper_kw)
    tc = None if timeout is None else st.TimeoutChecker(time_limit=timeout)
    x0 = np.linspace(-0.3, 0.4, circ.num_thetas)
    res = opt.AqcOptimizer(optimizer_name=name, maxiter=maxiter, learn_rate=0.2).optimize(
        objv, circ, x0, stopper=stopper, timeout=tc
    )
    return res


@pytest.mark.parametrize("name", ["lbfgs", "adam", "cobyla", "bobyqa"])
def test_optimizer_backends_match_jax(name):
    want = _optimize(PACKAGES[0], name)
    got = _optimize(PACKAGES[1], name)
    np.testing.assert_allclose(got["thetas"], want["thetas"], atol=TOL_X, rtol=0)
    for key in ("num_iters", "num_fun_ev", "num_grad_ev", "is_timeout", "entangler"):
        assert got[key] == want[key], key
    assert abs(got["cost"] - want["cost"]) <= TOL_X and got["cost"] < 1e-2


@pytest.mark.parametrize(
    "stopper_kw,fidelity_of",
    [({"fobj_thr": 0.05}, None), ({"fidelity_thr": 0.9}, lambda f: 1.0 - f), ({"num_iters": 1}, None)],
    ids=["objective", "fidelity", "stall"],
)
def test_early_stop_results_match_jax(stopper_kw, fidelity_of):
    want = _optimize(PACKAGES[0], "adam", stopper_kw=stopper_kw, fidelity_of=fidelity_of)
    got = _optimize(PACKAGES[1], "adam", stopper_kw=stopper_kw, fidelity_of=fidelity_of)
    _same_dict(got, want, TOL_ADAM)  # numpy's Adam against optax's
    assert got["num_iters"] < 200 and not got["is_timeout"]


def test_timeout_results_match_jax(monkeypatch):
    runs = []
    for pkg in PACKAGES:
        monkeypatch.setattr(pkg[0], "perf_counter", _FakeClock(1.0))
        runs.append(_optimize(pkg, "lbfgs", timeout=1))
    _same_dict(runs[1], runs[0])
    assert runs[1]["is_timeout"] and runs[1]["num_iters"] >= 1


def test_numpy_adam_matches_optax():
    """Rosenbrock gradients (not a quadratic: every moment differs), 50
    steps: the numpy update rule gives optax.adam's iterates."""

    def grad(x):
        g = np.zeros_like(x)
        g[:-1] = -400.0 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2.0 * (1 - x[:-1])
        g[1:] += 200.0 * (x[1:] - x[:-1] ** 2)
        return g

    x0 = np.linspace(-1.2, 0.8, 5)
    opt = optax.adam(learning_rate=0.01)
    x = jnp.asarray(x0)
    state = opt.init(x)
    trail = []
    for _ in range(50):
        updates, state = opt.update(jnp.asarray(grad(np.asarray(x))), state, x)
        x = optax.apply_updates(x, updates)
        trail.append(np.asarray(x))
    seen = []
    res = topt._adam_minimize(lambda th: seen.append(np.array(th)) or 0.0, grad, x0, 50, 0.01)
    assert res.nit == 50 and res.nfev == 51
    np.testing.assert_allclose(np.stack(seen[1:]), np.stack(trail), atol=TOL_ADAM, rtol=0)
    np.testing.assert_allclose(res.x, trail[-1], atol=TOL_ADAM, rtol=0)


# -----------------------------------------------------------------------------
# State handlers.
# -----------------------------------------------------------------------------

N = 5


def test_thin_state_handler_matches_jax():
    rng = np.random.default_rng(11)
    vec = rng.standard_normal(2**N) + 1j * rng.standard_normal(2**N)
    jh, th = job.ThinStateHandler(N, 2), tob.ThinStateHandler(N, 2)
    assert th.num_states == jh.num_states == 1 + N + N * (N - 1) // 2
    assert th.flip_qubit_positions == jh.flip_qubit_positions
    np.testing.assert_array_equal(th.state_indices, jh.state_indices)
    tvec = torch.tensor(vec)
    for i in range(th.num_states):
        np.testing.assert_array_equal(th.init_state(i).numpy(), jh.init_state(i))
        assert abs(th.state_dot_vector(i, tvec) - jh.state_dot_vector(i, vec)) <= TOL_STATE
    for no_zero in (True, False):
        k = th.num_states - (1 if no_zero else 0)
        coefs = rng.standard_normal(k) + 1j * rng.standard_normal(k)
        coefs /= np.linalg.norm(coefs)
        init = "init_composite_state_no_zero" if no_zero else "init_composite_state"
        dot = "composite_state_dot_vector_no_zero" if no_zero else "composite_state_dot_vector"
        np.testing.assert_allclose(getattr(th, init)(coefs).numpy(), getattr(jh, init)(coefs), atol=TOL_STATE)
        assert abs(getattr(th, dot)(coefs, tvec) - getattr(jh, dot)(coefs, vec)) <= TOL_STATE


def test_generic_state_handler_matches_jax():
    rng = np.random.default_rng(12)
    vec = rng.standard_normal(2**N) + 1j * rng.standard_normal(2**N)
    jh = job.GenericStateHandler(N, 1, jtrot.neel_init_state)
    th = tob.GenericStateHandler(N, 1, ttrot.neel_init_state)
    assert th.num_states == jh.num_states == N + 1
    np.testing.assert_allclose(th.states_matrix.numpy(), np.asarray(jh.states_matrix), atol=TOL_STATE)
    for i in range(N + 1):
        assert abs(th.state_dot_vector(i, torch.tensor(vec)) - jh.state_dot_vector(i, vec)) <= TOL_STATE
    with pytest.raises(NotImplementedError):
        th.init_composite_state(np.ones(N + 1))
    with pytest.raises(ValueError):
        tob.GenericStateHandler(N, 2)


def test_mps_state_handler_matches_jax():
    rng = np.random.default_rng(13)
    vec = rng.standard_normal(2**N) + 1j * rng.standard_normal(2**N)
    vec /= np.linalg.norm(vec)
    jh = job.MpsStateHandler(N, 1, jtrot.neel_init_state, chi_max=8)
    th = tob.MpsStateHandler(N, 1, ttrot.neel_init_state, chi_max=8)
    jv, tv = jm.mps_from_dense(vec, 32), tm.mps_from_dense(vec, 32)
    assert th.num_states == jh.num_states == N + 1 and th.state0.chi == 8
    for i in range(N + 1):
        np.testing.assert_allclose(
            tm.mps_to_vector(th.init_state(i)).numpy(), np.asarray(jm.mps_to_vector(jh.init_state(i))),
            atol=TOL_STATE,
        )
        assert abs(th.state_dot_vector(i, tv) - jh.state_dot_vector(i, jv)) <= TOL_STATE
    # A flip state from JAX, carried over, is the port's.
    carried = interop.mps_to_torch(np.asarray(jh.init_state(2).gammas), np.asarray(jh.init_state(2).lambdas),
                                   torch.complex128, "cpu")
    assert abs(float(tm.mps_dot(carried, th.init_state(2)).abs()) - 1.0) <= TOL_STATE


@pytest.mark.parametrize("n,max_flips", list(itertools.product((2, 4), (0, 1, 2))))
def test_thin_handler_counts(n, max_flips):
    assert tob.ThinStateHandler(n, max_flips).num_states == job.ThinStateHandler(n, max_flips).num_states
