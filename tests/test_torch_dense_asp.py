"""The port's dense ASP path held against the JAX package on the CPU in
complex128 / float64: the dense Trotter targets, the surrogate objectives,
the stateful L-BFGS, the horizon optimizers and the driver with
``objective="sur_max"``.

* ``Trotter.as_vector`` within 1e-12 of JAX, and of ``exact_evolution``
  (global phase compensated) at dt = 0.01.
* ``make_surrogate_loss`` (value and autograd gradient) and
  ``make_surrogate_stateful`` over a sequence of 8 evaluations carrying the
  state (a hysteresis switch and the weight EMA included) within 1e-10.
* ``minimize_lbfgs_compact_stateful`` on a toy objective whose state counts
  the evaluations: the same iterates and final state as JAX.
* ``optimize_horizon_jit`` (autograd gradient) and
  ``optimize_horizon_surrogate_jit`` (co-sweep, hysteresis, EMA) at 6
  qubits: the same ``num_iters``, θ within 1e-8.
* the timed surrogate runner equals the one run at chunks of 1, 3 and 25,
  and stops on an expired clock; an 8-qubit flagship-shaped run reaches
  infidelity 1e-3.
* ``run_simulation(objective="sur_max")`` at 6 qubits, two horizons: per
  horizon within 1e-8 of the JAX driver, on targets the port generated and
  on the JAX driver's targets carried over (``interop``) into the port's
  target cache.

The JAX package compiles one program per horizon shape; the surrogate
optimizer's parity case reuses the driver's first-horizon program."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.models.sp_lhs import evol_utils as jev
from aqc_research_tpu.models.sp_lhs import jit_asp as jja
from aqc_research_tpu.models.sp_lhs import time_evol as jte
from aqc_research_tpu.models.sp_lhs.user_options import UserOptions as JUserOptions
from aqc_research_tpu.optim import lbfgs as jlbfgs
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.circuit import program as tprog
from aqc_research_tpu_torch.models.sp_lhs import evol_utils as tev
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.models.sp_lhs import target_states as tts
from aqc_research_tpu_torch.models.sp_lhs import time_evol as tte
from aqc_research_tpu_torch.models.sp_lhs.user_options import UserOptions
from aqc_research_tpu_torch.optim import lbfgs as tlbfgs
from aqc_research_tpu_torch.targets import trotter as ttrot
from tests import _torch_threads  # noqa: F401

TOL = 1e-10  # single evaluations
TOL_RUN = 1e-8  # after an L-BFGS run
N = 6
FIDS = ("fid_a1_vs_gt", "fid_t1_vs_gt", "fid_a1_vs_t1")
# The stateful surrogate runs start 0.05 rad from the perfect init: from
# bench.py's 0.2 rad the leading flip state moves and the linesearch fails
# after 3 iterations (in both packages), too short a run to compare.
SUR_PERTURBATION = 0.05


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


def _flagship(n, layers=2, perturbation=0.2, seed=12345):
    """bench.py's setup at ``n`` qubits: the perturbed perfect init, the
    Trotter(1.2, 30 steps) Neel target (numpy c128), the flip indices."""
    jc = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), True)
    th = jtrot.init_ansatz_to_trotter(jc, np.zeros(jc.num_thetas), evol_time=1.2, delta=1.0)
    th = th + perturbation * np.random.default_rng(seed).standard_normal(th.shape)
    target = np.asarray(jtrot.Trotter(num_qubits=n, evol_time=1.2, num_steps=30, delta=1.0,
                                      second_order=True).as_vector(jtrot.neel_init_state(n)))
    idx = jja.flip_state_indices(n, jtrot.neel_init_state(n))
    return jc, interop.ansatz_from_args(interop.ansatz_args(jc)), th, target, idx


# -----------------------------------------------------------------------------
# Dense Trotter targets.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("second_order", [False, True], ids=["1st", "2nd"])
def test_trotter_as_vector(second_order):
    n = 5
    kw = dict(num_qubits=n, evol_time=0.5, num_steps=50, delta=1.0, second_order=second_order)
    want = np.asarray(jtrot.Trotter(**kw).as_vector(jtrot.neel_init_state(n)))
    got = ttrot.Trotter(**kw).as_vector(ttrot.neel_init_state(n))
    assert got.dtype == torch.complex128 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    # Against the exact evolution at dt = 0.01, global phase compensated,
    # the evolution run as two halves from a tensor (the JAX package's test).
    ham = ttrot.make_hamiltonian(n, 1.0)
    np.testing.assert_array_equal(ham, jtrot.make_hamiltonian(n, 1.0))
    phase = ttrot.trotter_global_phase(n, 50, second_order)
    assert phase == jtrot.trotter_global_phase(n, 50, second_order)
    exact = ttrot.exact_evolution(ham, ttrot.neel_init_state(n), 0.5) * np.exp(-1j * phase)
    half = ttrot.Trotter(**dict(kw, evol_time=0.25, num_steps=25))
    twice = half.as_vector(half.as_vector(ttrot.neel_init_state(n)))
    assert ttrot.state_difference(twice, exact) < (1e-4 if second_order else 1e-2)
    assert ttrot.fidelity(got, exact) > 1 - (1e-9 if second_order else 1e-5)
    # The gate-program form, and trotter_circuit, give the same state.
    prog = ttrot.Trotter(**kw).as_program(ttrot.neel_init_state(n))
    assert prog == ttrot.trotter_circuit(n, dt=0.01, delta=1.0, num_trotter_steps=50, second_order=second_order,
                                         ini_state=ttrot.neel_init_state(n))
    via = tprog.program_to_state(prog, n)
    np.testing.assert_allclose(via.numpy(), want, atol=1e-12, rtol=0)
    # Other preps.
    assert tprog.program_to_state(ttrot.identity_circuit(n), n)[0] == 1
    assert int(torch.argmax(tprog.program_to_state(ttrot.half_zero_circuit(n), n).abs())) == 0b11100


# -----------------------------------------------------------------------------
# Surrogate objectives.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("weight", [0.0, 0.3])
def test_surrogate_loss_matches_jax(weight):
    jc, tc, th, target, idx = _flagship(N)
    jloss = jja.make_surrogate_loss(jc, idx, weight)
    tloss = tja.make_surrogate_loss(tc, idx, weight)
    jf, jg = jax.value_and_grad(lambda x: jloss(x, jnp.asarray(target)))(jnp.asarray(th))
    tf, tg = tlbfgs.autograd_value_and_grad(lambda x: tloss(x, torch.tensor(target)))(torch.tensor(th))
    assert abs(float(tf) - float(jf)) <= TOL
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL, rtol=0)


def test_surrogate_stateful_sequence_matches_jax():
    """Eight evaluations (value and value_and_grad alternating) along a path
    that moves the leading flip state: the state, fobj and gradients stay
    within 1e-10 of JAX's at every step (4 qubits; the JAX pair jitted)."""
    jc, tc, th, target, idx = _flagship(4)
    jvalue, jvgrad = (jax.jit(f) for f in jja.make_surrogate_stateful(jc, idx, 0.1))
    tvalue, tvgrad = tja.make_surrogate_stateful(tc, idx, 0.1)
    jst = jja.SurrogateState(jnp.asarray(0, jnp.int32), jnp.asarray(1.0), jnp.asarray(0.0), jnp.asarray(jnp.inf))
    tst = tja.SurrogateState(0, torch.tensor(1.0, dtype=torch.float64), torch.tensor(0.0, dtype=torch.float64),
                             torch.tensor(float("inf"), dtype=torch.float64))
    direction = np.random.default_rng(3).standard_normal(th.shape)
    jt = jnp.asarray(target)
    seen = []
    for k in range(8):
        x = th + 0.35 * k * direction
        if k % 2:
            jf, jg, jst = jvgrad(jnp.asarray(x), jst, jt)
            tf, tg, tst = tvgrad(torch.tensor(x), tst, torch.tensor(target))
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL, rtol=0)
        else:
            jf, jst = jvalue(jnp.asarray(x), jst, jt)
            tf, tst = tvalue(torch.tensor(x), tst, torch.tensor(target))
        assert tst.max_no == int(jst.max_no)
        for got, want in ((tf, jf), (tst.weight, jst.weight), (tst.fidelity, jst.fidelity), (tst.fobj, jst.fobj)):
            assert abs(float(got) - float(want)) <= TOL
        seen.append(tst.max_no)
    assert len(set(seen)) > 1, f"the path never switched the leading flip state: {seen}"
    assert float(tst.weight) != 1.0  # the EMA moved


# -----------------------------------------------------------------------------
# The stateful loop and the horizon optimizers.
# -----------------------------------------------------------------------------


def _counting_rosenbrock(xp):
    """Rosenbrock whose state counts (value calls, value+grad calls) and
    whose stop_fn fires after 40 evaluations in all."""

    def f(x):
        return ((1 - x[:-1]) ** 2).sum() + 10.0 * ((x[1:] - x[:-1] ** 2) ** 2).sum()

    def grad(x):
        lo = -2 * (1 - x[:-1]) - 40.0 * x[:-1] * (x[1:] - x[:-1] ** 2)
        hi = 20.0 * (x[1:] - x[:-1] ** 2)
        return xp.concatenate([lo, xp.zeros_like(x[:1])]) + xp.concatenate([xp.zeros_like(x[:1]), hi])

    value = lambda x, st: (f(x), (st[0] + 1, st[1]))  # noqa: E731
    vgrad = lambda x, st: (f(x), grad(x), (st[0], st[1] + 1))  # noqa: E731
    stop = lambda st: st[0] + st[1] >= 40  # noqa: E731
    return value, vgrad, stop


def test_stateful_lbfgs_matches_jax():
    x0 = np.random.default_rng(1).uniform(-1.5, 1.5, 6)
    jv, jvg, jstop = _counting_rosenbrock(jnp)
    tv, tvg, tstop = _counting_rosenbrock(torch)
    jres, jst = jlbfgs.minimize_lbfgs_compact_stateful(jv, jvg, jnp.asarray(x0), (jnp.asarray(0), jnp.asarray(0)),
                                                       maxiter=100, stop_fn=jstop)
    tres, tst = tlbfgs.minimize_lbfgs_compact_stateful(tv, tvg, torch.tensor(x0), (0, 0), maxiter=100, stop_fn=tstop)
    assert tres.num_iters == int(jres.num_iters) < 100 and tres.converged == bool(jres.converged)
    assert tst == (int(jst[0]), int(jst[1])) and sum(tst) >= 40
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), atol=TOL, rtol=0)
    # The chunked runner returns the state too.
    programs = tlbfgs.lbfgs_chunk_programs(tv, tvg, maxiter=100, stop_fn=tstop)
    res, st, timed_out = tlbfgs.run_lbfgs_chunked(programs, torch.tensor(x0), (0, 0), maxiter=100, chunk_iters=7)
    assert st == tst and not timed_out and torch.equal(res.thetas, tres.thetas)


def test_optimize_horizon_jit_matches_jax():
    """bench.py's optimization at 6 qubits: the autograd gradient against
    jax.value_and_grad, the same iterations."""
    jc, tc, th, target, idx = _flagship(N)
    kw = dict(state_idx=idx, fidelity_thr=1 - 1e-3, maxiter=300)
    jres = jja.optimize_horizon_jit(jc, jnp.asarray(th), jnp.asarray(target), **kw)
    tres = tja.optimize_horizon_jit(tc, th, torch.tensor(target), **kw)
    assert tres.num_iters == int(jres.num_iters) and tres.converged == bool(jres.converged)
    assert float(tres.fobj) <= 1e-3
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), atol=TOL_RUN, rtol=0)
    assert abs(float(tres.fidelity) - float(jres.fidelity)) <= TOL_RUN
    # optax's L-BFGS with the zoom linesearch (ported in optim/lbfgs.py):
    # the same iterations and result as the JAX package's.
    jzoom = jja.optimize_horizon_jit(jc, jnp.asarray(th), jnp.asarray(target), solver="zoom", **kw)
    tzoom = tja.optimize_horizon_jit(tc, th, torch.tensor(target), solver="zoom", **kw)
    assert tzoom.num_iters == int(jzoom.num_iters) and tzoom.converged == bool(jzoom.converged)
    assert abs(float(tzoom.fobj) - float(jzoom.fobj)) <= TOL_RUN
    with pytest.raises(ValueError, match="unknown solver"):
        tja.optimize_horizon_jit(tc, th, torch.tensor(target), solver="bfgs", **kw)


def test_flagship_8q_reaches_1e3():
    _, tc, th, target, idx = _flagship(8)
    res = tja.optimize_horizon_jit(tc, th, torch.tensor(target), state_idx=idx, fidelity_thr=1 - 1e-3, maxiter=300)
    assert res.converged and float(res.fobj) <= 1e-3 and 20 <= res.num_iters <= 100
    assert abs(float(res.fidelity) - (1 - float(res.fobj))) <= 1e-12


@pytest.mark.parametrize("chunk_iters", [1, 3, 25])
def test_surrogate_timed_without_clock_is_the_one_run(chunk_iters):
    _, tc, th, target, idx = _flagship(N, perturbation=SUR_PERTURBATION)
    kw = dict(state_idx=idx, maxiter=9)
    one = tja.optimize_horizon_surrogate_jit(tc, th, torch.tensor(target), **kw)
    timed, timed_out = tja.optimize_horizon_surrogate_timed(tc, th, torch.tensor(target), time_limit=None,
                                                            chunk_iters=chunk_iters, **kw)
    assert not timed_out and timed.num_iters == one.num_iters == 9
    assert torch.equal(timed.thetas, one.thetas) and torch.equal(timed.weight, one.weight)
    assert timed.max_no == one.max_no


def test_surrogate_timed_expired_clock():
    _, tc, th, target, idx = _flagship(N, perturbation=SUR_PERTURBATION)
    res, timed_out = tja.optimize_horizon_surrogate_timed(tc, th, torch.tensor(target), state_idx=idx, maxiter=50,
                                                          time_limit=1e-9, chunk_iters=3)
    assert timed_out and res.num_iters == 3
    # A stop condition before the clock is not a timeout.
    res, timed_out = tja.optimize_horizon_surrogate_timed(tc, th, torch.tensor(target), state_idx=idx, maxiter=50,
                                                          fidelity_thr=1e-3, time_limit=1e-9, chunk_iters=3)
    assert not timed_out and res.num_iters == 0


# -----------------------------------------------------------------------------
# The driver with objective="sur_max".
# -----------------------------------------------------------------------------


def _dense_opts(cls, result_dir):
    """6 qubits, horizons t = 1.2 and 2.4 of 2 and 4 layers, 12 iterations,
    a fidelity bar neither reaches."""
    opts = cls()
    opts.num_qubits = N
    opts.result_dir = str(result_dir)
    opts.objective = "sur_max"
    opts.maxiter = 12
    opts.verbose = False
    step_range = 1 + np.arange(2)
    opts.trotter_steps = step_range * 3
    opts.evol_times = np.round(step_range * 1.2, 3)
    opts.num_layers_inc = 2
    opts.fidelity_thr = 0.9999999  # unreachable: every horizon runs maxiter
    opts.use_jit_lbfgs = True
    return opts


def _archive(output_dir):
    with open(os.path.join(output_dir, "all_results.pkl"), "rb") as fld:
        return pickle.load(fld)


@pytest.fixture(scope="module")
def jax_dense_run(tmp_path_factory):
    """One JAX run of the dense schedule: (its results, its result_dir)."""
    result_dir = tmp_path_factory.mktemp("jax_dense")
    out = jte.run_simulation(_dense_opts(JUserOptions, result_dir))
    return _archive(out), result_dir


def _same_horizons(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g["num_layers"], g["num_iters"], g["evol_time1"]) == (w["num_layers"], w["num_iters"], w["evol_time1"])
        assert not g["use_mps"] and g["stats"]["use_jit_lbfgs"] and not g["is_timeout"]
        for key in FIDS:
            assert abs(g[key] - w[key]) <= TOL_RUN, key
        assert abs(g["stats"]["weight"] - w["stats"]["weight"]) <= TOL_RUN
        np.testing.assert_allclose(g["thetas"], w["thetas"], atol=TOL_RUN, rtol=0)
        assert g["ini_state_func"] is ttrot.neel_init_state


def test_run_simulation_sur_max_matches_jax(jax_dense_run, tmp_path, monkeypatch):
    """Fresh port run: its own targets (within 1e-12 of JAX's), the horizons
    within 1e-8; a second run loads the target cache (numpy in the pickle)."""
    want, jax_dir = jax_dense_run
    opts = _dense_opts(UserOptions, tmp_path)
    _same_horizons(_archive(tte.run_simulation(opts)), want)
    cache = os.path.join(tmp_path, f"target_classic_states_n{N}.pkl")
    with open(cache, "rb") as fld:
        raw = fld.read()
    assert b"_rebuild_tensor" not in raw and b"aqc_research_tpu." not in raw
    with open(os.path.join(jax_dir, f"target_classic_states_n{N}.pkl"), "rb") as fld:
        jax_targets = pickle.load(fld)
    made = []
    real = tts.generate_classic_target
    monkeypatch.setattr(tts, "generate_classic_target", lambda **kw: made.append(kw["my_id"]) or real(**kw))
    loaded = tts.get_target_states(opts)
    assert made == [] and len(loaded) == 2
    for t, j in zip(loaded, jax_targets):
        assert t.t1_gt.dtype == torch.complex128 and t.t1.device.type == "cpu"
        np.testing.assert_allclose(t.t1_gt.numpy(), j.t1_gt, atol=1e-12, rtol=0)
        np.testing.assert_allclose(t.t1.numpy(), j.t1, atol=1e-12, rtol=0)
    opts.delta = 0.9  # stale cache: regenerates
    assert tts.get_target_states(opts)[0].delta == 0.9 and made == [0, 1]


def test_run_simulation_sur_max_on_jax_targets(jax_dense_run, tmp_path, monkeypatch):
    """The JAX driver's targets carried over into the port's cache: the port
    computes on the same inputs and loads them instead of generating."""
    want, jax_dir = jax_dense_run
    opts = _dense_opts(UserOptions, tmp_path)
    with open(os.path.join(jax_dir, f"target_classic_states_n{N}.pkl"), "rb") as fld:
        carried = interop.classic_targets_from_jax(pickle.load(fld), opts)
    assert tts.TargetClassicState.check_cached_data(opts, N, carried)
    with open(os.path.join(tmp_path, f"target_classic_states_n{N}.pkl"), "wb") as fld:
        pickle.dump(carried, fld)
    monkeypatch.setattr(tts, "generate_classic_target", lambda **kw: pytest.fail("the target cache missed"))
    _same_horizons(_archive(tte.run_simulation(opts)), want)


def test_optimize_horizon_surrogate_jit_matches_jax(jax_dense_run):
    """From bench.py's perturbed start, with the driver's first-horizon
    settings (the JAX program is the driver's, already compiled)."""
    jc, tc, th, target, idx = _flagship(N, perturbation=SUR_PERTURBATION)
    kw = dict(state_idx=idx, fidelity_thr=0.9999999, maxiter=12)
    jres = jja.optimize_horizon_surrogate_jit(jc, jnp.asarray(th), jnp.asarray(target), **kw)
    tres = tja.optimize_horizon_surrogate_jit(tc, th, torch.tensor(target), **kw)
    assert tres.num_iters == int(jres.num_iters) == 12
    assert tres.max_no == int(jres.max_no)
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), atol=TOL_RUN, rtol=0)
    for got, want in ((tres.fobj, jres.fobj), (tres.fidelity, jres.fidelity), (tres.weight, jres.weight)):
        assert abs(float(got) - float(want)) <= TOL_RUN


def test_dense_results_and_solution_interop(jax_dense_run, tmp_path):
    """JAX dense results cross over (no JAX reference left in the pickle);
    the port's solution state equals the JAX one; a dense target saves as
    numpy."""
    want, _ = jax_dense_run
    got = interop.results_from_jax(want)
    assert not got[0]["use_mps"] and isinstance(got[0]["stats"]["weight"], float)
    assert got[0]["ini_state_func"] is ttrot.neel_init_state
    assert b"aqc_research_tpu." not in pickle.dumps(got)
    res = dict(want[0], cost=0.0, second_order_trotter=True)
    jopts, topts = _dense_opts(JUserOptions, tmp_path), _dense_opts(UserOptions, tmp_path)
    jsol = np.asarray(jev.get_solution_from_optim_result(jopts, res, True, jtrot.neel_init_state))
    tsol = tev.get_solution_from_optim_result(topts, dict(got[0], cost=0.0, second_order_trotter=True), True,
                                              ttrot.neel_init_state)
    assert isinstance(tsol, torch.Tensor) and tsol.dtype == torch.complex128
    np.testing.assert_allclose(tsol.numpy(), jsol, atol=TOL, rtol=0)
    tev.save_optim_results(str(tmp_path), [dict(got[0], cost=0.0)], tsol, "dense")
    (saved,) = [f for f in os.listdir(tmp_path) if f.startswith("trotter_dense")]
    with open(os.path.join(tmp_path, saved), "rb") as fld:
        data = pickle.load(fld)
    assert isinstance(data["target"], np.ndarray)
    np.testing.assert_array_equal(data["target"], tsol.numpy())


def test_flip_state_indices():
    prep = ttrot.neel_init_state(4)
    np.testing.assert_array_equal(tja.flip_state_indices(4, prep), jja.flip_state_indices(4, jtrot.neel_init_state(4)))
    np.testing.assert_array_equal(tja.flip_state_indices(3), [0, 1, 2, 4])
    with pytest.raises(ValueError, match="X-layer"):
        tja.flip_state_indices(3, ttrot.trotter_circuit(3, dt=0.1, delta=1.0, num_trotter_steps=1,
                                                        second_order=False))

