"""The port's ASP driver (models/sp_lhs/time_evol.run_simulation and the
modules under it) held against the JAX package on the CPU.

* ``run_simulation``: 4 qubits, χ=8, two horizons of 2 and 4 layers, the
  MPS objective, the L-BFGS loop on the tensors' device
  (``use_jit_lbfgs=True``), precision "high" and route "native" on both
  sides, a fidelity bar neither reaches (every horizon runs all 8
  iterations): per horizon the three fidelities and the thetas within
  1e-8, equal layer and iteration counts.  The same loop at one layer per
  horizon step (one horizon of 1 layer: no layer cache, the uncached
  co-sweep) within 1e-8 of the JAX loop.
* the host protocol (``use_jit_lbfgs=False``: SciPy's L-BFGS-B over the
  host-protocol objectives), both objectives, one layer per horizon step
  (horizons of 1 and 2 layers), the same settings: per horizon within 1e-8
  of the JAX driver's host path, equal iteration counts.
* resuming a port run from the JAX run's first horizon
  (``interop.results_from_jax``): the second horizon within 1e-8.
* targets: ``generate_all_mps_targets`` at 6 qubits, χ=16, 3 horizons,
  held on the overlap |<t_jax|t_port>|^2 >= 1 - 1e-10 and on the bond
  spectra within 1e-10 (not on raw Γ).
* ``v_mul_mps`` at no truncation within 1e-10 as dense vectors;
  ``_warm_start_thetas`` within 1e-14.
* the port alone: the target cache, resume, the chunked runner, the
  options' auto rule, the host-protocol branch, the launcher's ``--cpu``,
  the plot without matplotlib.

One JAX ``run_simulation`` per loop and objective (each compiles its
programs)."""

import glob
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.models.sp_lhs import target_states as jts
from aqc_research_tpu.models.sp_lhs import time_evol as jte
from aqc_research_tpu.models.sp_lhs.user_options import UserOptions as JUserOptions
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
from aqc_research_tpu_torch.models.sp_lhs import evol_utils as tev
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.models.sp_lhs import plots as tplots
from aqc_research_tpu_torch.models.sp_lhs import target_states as tts
from aqc_research_tpu_torch.models.sp_lhs import time_evol as tte
from aqc_research_tpu_torch.models.sp_lhs.user_options import UserOptions
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.optim import lbfgs as tlbfgs
from aqc_research_tpu_torch.targets import trotter as ttrot
from tests import _torch_threads  # noqa: F401

TOL_RUN = 1e-8  # fidelities and thetas after 8 L-BFGS iterations in c128
TOL_EXACT = 1e-10  # targets and states at no truncation in c128
FIDS = ("fid_a1_vs_gt", "fid_t1_vs_gt", "fid_a1_vs_t1")


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after;
    both packages on "native" in c128."""
    previous = config._DEVICE
    config.set_device("cpu")
    config.set_svd_impl("native")
    jcfg.set_svd_impl("native")
    yield
    config.set_svd_impl(None)
    jcfg.set_svd_impl(None)
    config.set_device(previous)


def _mini_opts(cls, result_dir, num_qubits=4, num_horizons=2):
    """The JAX package's tests/test_time_evol.py shape, 2 layers per step."""
    opts = cls()
    opts.num_qubits = num_qubits
    opts.result_dir = str(result_dir)
    opts.objective = "sur_fast_mps_trotter"
    opts.maxiter = 8
    opts.verbose = False
    opts.chi_max = 8
    step_range = 1 + np.arange(num_horizons)
    opts.trotter_steps = step_range * 3
    opts.evol_times = np.round(step_range * 1.2, 3)
    opts.num_layers_inc = 2
    opts.fidelity_thr = 0.9999999  # unreachable: every horizon runs maxiter
    opts.seed = 7
    opts.use_jit_lbfgs = True
    return opts


def _archive(output_dir):
    with open(os.path.join(output_dir, "all_results.pkl"), "rb") as fld:
        return pickle.load(fld)


def _same_horizon(got, want):
    assert got["num_layers"] == want["num_layers"]
    assert got["num_iters"] == want["num_iters"]
    assert got["evol_time1"] == want["evol_time1"]
    for key in FIDS:
        assert abs(got[key] - want[key]) <= TOL_RUN, key
    np.testing.assert_allclose(got["thetas"], want["thetas"], atol=TOL_RUN, rtol=0)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX run of the mini schedule: (its results, its folder)."""
    out = jte.run_simulation(_mini_opts(JUserOptions, tmp_path_factory.mktemp("jax")))
    return _archive(out), out


def test_run_simulation_matches_jax(jax_run, tmp_path):
    want, _ = jax_run
    out = tte.run_simulation(_mini_opts(UserOptions, tmp_path))
    got = _archive(out)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same_horizon(g, w)
        assert g["stats"]["use_jit_lbfgs"] and not g["is_timeout"]
        assert g["ini_state_func"] is ttrot.neel_init_state
    assert [r["num_layers"] for r in got] == [2, 4]
    assert os.path.isfile(os.path.join(out, tte._CHECKPOINT_FILE))
    assert os.path.isfile(os.path.join(out, "fidelity_profiles_n4_rep3.png"))


def test_resume_from_jax_horizons(jax_run, tmp_path, monkeypatch):
    """The port resumes from the JAX run's first horizon and computes only
    the second, as the JAX run did."""
    want, _ = jax_run
    opts = _mini_opts(UserOptions, tmp_path)
    out = tev.prepare_output_folder(opts, tte.__file__)
    tte._save_horizon_checkpoint(out, opts, interop.results_from_jax(want[:1]), None)
    calls = []
    real = tte._time_evolution
    monkeypatch.setattr(tte, "_time_evolution", lambda **kw: calls.append(kw["target"].my_id) or real(**kw))
    opts.resume_dir = out
    assert tte.run_simulation(opts) == out
    assert calls == [1]
    got = _archive(out)
    assert len(got) == 2
    _same_horizon(got[1], want[1])
    np.testing.assert_array_equal(got[0]["thetas"], want[0]["thetas"])


def test_results_from_jax_need_no_jax_package(jax_run):
    want, _ = jax_run
    got = interop.results_from_jax(want)
    assert got[0]["ini_state_func"] is ttrot.neel_init_state
    assert got[0]["thetas"].dtype == np.float64
    assert b"aqc_research_tpu." not in pickle.dumps(got)


# -----------------------------------------------------------------------------
# Targets, states, warm start.
# -----------------------------------------------------------------------------


def _target_opts(cls, result_dir):
    opts = _mini_opts(cls, result_dir, num_qubits=6, num_horizons=3)
    opts.chi_max = 16
    return opts


def test_targets_match_jax(tmp_path):
    jt = jts.generate_all_mps_targets(opts=_target_opts(JUserOptions, tmp_path), num_qubits=6, second_order=True)
    tt = tts.generate_all_mps_targets(opts=_target_opts(UserOptions, tmp_path), num_qubits=6, second_order=True)
    assert len(jt) == len(tt) == 3
    for j, t in zip(jt, tt):
        assert (t.num_trot_steps, t.evol_time, t.my_id, t.chi_max) == (j.num_trot_steps, j.evol_time, j.my_id, 16)
        for key in ("t1_gt", "t1"):
            jmps = getattr(j, key)
            theirs = interop.mps_to_torch(np.asarray(jmps.gammas), np.asarray(jmps.lambdas), torch.complex128, "cpu")
            ours = getattr(t, key)
            assert float(tm.mps_dot(theirs, ours).abs() ** 2) >= 1 - TOL_EXACT
            np.testing.assert_allclose(ours.lambdas.numpy(), np.asarray(jmps.lambdas), atol=TOL_EXACT, rtol=0)
        assert abs(ttrot.fidelity(t.t1, t.t1_gt) - float(jtrot.fidelity(j.t1, j.t1_gt))) <= TOL_EXACT


def test_first_horizon_target_is_the_schedule_head(tmp_path):
    opts = _target_opts(UserOptions, tmp_path)
    head = tts.generate_all_mps_targets(opts=opts, num_qubits=6, second_order=True)[0]
    one = tts.first_horizon_mps_target(
        num_qubits=6, evol_time=1.2, num_trot_steps=3, delta=1.0, chi_max=16,
        trunc_thr=opts.trunc_thr_target, second_order=True,
    )
    assert torch.equal(one.t1_gt.gammas, head.t1_gt.gammas) and torch.equal(one.t1.lambdas, head.t1.lambdas)


def test_v_mul_mps_matches_jax():
    n, layers = 5, 2
    jc = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), True)
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    th = np.random.default_rng(3).uniform(-np.pi, np.pi, jc.num_thetas)
    prep = jtrot.neel_init_state(n)
    want = jm.v_mul_mps(jc, jnp.asarray(th), jm.mps_from_program(prep, n, chi_max=8))
    ini = tm.mps_from_program(ttrot.neel_init_state(n), n, chi_max=8)
    got = tm.v_mul_mps(tc, torch.tensor(th), ini)
    np.testing.assert_allclose(tm.mps_to_vector(got).numpy(), np.asarray(jm.mps_to_vector(want)), atol=TOL_EXACT)
    # V† undoes V.
    back = tm.v_dagger_mul_mps(tc, torch.tensor(th), got)
    assert float(tm.mps_dot(back, ini).abs()) >= 1 - TOL_EXACT
    assert abs(float(tm.mps_norm(got)) - 1.0) <= TOL_EXACT


def test_check_mps():
    good = tm.mps_from_program(ttrot.neel_init_state(4), 4, chi_max=4)
    assert tm.check_mps(good)
    assert not tm.check_mps(tm.MPS(good.gammas, good.lambdas.flip(-1)))  # ascending
    assert not tm.check_mps(tm.MPS(good.gammas, -good.lambdas))
    assert not tm.check_mps(tm.MPS(good.gammas[:3], good.lambdas))
    assert not tm.check_mps("not an MPS")


@pytest.mark.parametrize(
    "prev_layers,prev_time,prev_n,equal",
    [(2, 1.2, 5, True), (4, 1.2, 5, None), (2, 2.4, 5, None), (2, 1.2, 6, None)],
    ids=["perfect-prev", "same-layers", "same-time", "other-qubits"],
)
def test_warm_start_thetas_match_jax(prev_layers, prev_time, prev_n, equal):
    """The port's warm start equals the JAX one (None where the JAX one
    refuses); from a perfect previous horizon it is the cold perfect init."""
    n = 5
    prev_c = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, prev_layers), True)
    th1 = jtrot.init_ansatz_to_trotter(prev_c, np.zeros(prev_c.num_thetas), evol_time=prev_time, delta=1.0)
    prev = {"thetas": th1, "num_layers": prev_layers, "evol_time": prev_time, "num_qubits": prev_n}
    jc = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, 4), True)
    tc = TrotterAnsatz.make(n, make_trotter_like_circuit(n, 4), True)
    want = jte._warm_start_thetas(jc, JUserOptions(), 2.4, dict(prev))
    got = tte._warm_start_thetas(tc, UserOptions(), 2.4, dict(prev))
    if equal is None:
        assert want is None and got is None
        return
    np.testing.assert_allclose(got, want, atol=1e-14, rtol=0)
    cold = ttrot.init_ansatz_to_trotter(tc, np.zeros(tc.num_thetas), evol_time=2.4, delta=1.0)
    np.testing.assert_allclose(got, cold, atol=1e-14, rtol=0)


# -----------------------------------------------------------------------------
# The port alone: cache, resume, chunked runner, options, unported branches.
# -----------------------------------------------------------------------------


def test_target_cache_roundtrip_and_stale(tmp_path, monkeypatch):
    """The second call loads the cache (numpy in the pickle, tensors on the
    default device after it); a changed option regenerates."""
    opts = _mini_opts(UserOptions, tmp_path, num_horizons=1)
    made = []
    real = tts.generate_all_mps_targets
    monkeypatch.setattr(tts, "generate_all_mps_targets", lambda **kw: made.append(kw["opts"].chi_max) or real(**kw))
    first = tts.get_target_states(opts)
    second = tts.get_target_states(opts)
    assert made == [8]
    assert torch.equal(first[0].t1_gt.gammas, second[0].t1_gt.gammas)
    assert second[0].t1.gammas.device.type == "cpu" and second[0].t1.gammas.dtype == torch.complex128
    with open(os.path.join(tmp_path, "target_mps_states_n4.pkl"), "rb") as fld:
        raw = fld.read()
    assert b"_rebuild_tensor" not in raw  # numpy arrays, no tensors
    opts.chi_max = 16
    third = tts.get_target_states(opts)
    assert made == [8, 16] and third[0].chi_max == 16
    assert not tts.TargetMpsState.check_cached_data(opts, 4, first)


def _crashed_run(tmp_path, monkeypatch):
    """A 2-horizon run that crashes entering horizon 2; returns (opts, its
    folder with a 1-horizon checkpoint)."""
    opts = _mini_opts(UserOptions, tmp_path)
    opts.maxiter = 4
    real = tte._time_evolution
    calls = {"n": 0}

    def crash_on_second(**kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real(**kw)

    monkeypatch.setattr(tte, "_time_evolution", crash_on_second)
    with pytest.raises(RuntimeError, match="simulated crash"):
        tte.run_simulation(opts)
    monkeypatch.setattr(tte, "_time_evolution", real)
    dirs = glob.glob(os.path.join(str(tmp_path), "4qubits", "*"))
    assert len(dirs) == 1 and os.path.isfile(os.path.join(dirs[0], tte._CHECKPOINT_FILE))
    return opts, dirs[0]


def test_resume_completes_schedule(tmp_path, monkeypatch):
    opts, out = _crashed_run(tmp_path, monkeypatch)
    calls = []
    real = tte._time_evolution
    monkeypatch.setattr(tte, "_time_evolution", lambda **kw: calls.append(1) or real(**kw))
    opts.resume_dir = out
    assert tte.run_simulation(opts) == out
    assert calls == [1]  # only the missing horizon
    results = _archive(out)
    assert [r["evol_time1"] for r in results] == list(opts.evol_times)
    assert all(r["fid_a1_vs_gt"] > 0.99 for r in results)


def test_resume_refuses_schedule_mismatch(tmp_path, monkeypatch):
    opts, out = _crashed_run(tmp_path, monkeypatch)
    opts.resume_dir = out
    opts.trunc_thr = 1e-8
    with pytest.raises(ValueError, match="resume refused"):
        tte.run_simulation(opts)


def test_resume_refuses_missing_dir(tmp_path):
    opts = _mini_opts(UserOptions, tmp_path)
    opts.resume_dir = str(tmp_path / "no_such_dir")
    with pytest.raises(ValueError, match="resume_dir does not exist"):
        tte.run_simulation(opts)


def test_time_limit_stops_after_one_chunk(tmp_path):
    """An expired clock stops every horizon after one chunk of
    ``jit_chunk_iters`` iterations, flagged is_timeout (the JAX package's
    test_jit_lbfgs_time_limit)."""
    opts = _mini_opts(UserOptions, tmp_path, num_horizons=1)
    opts.maxiter = 500
    opts.time_limit = 1e-9
    opts.jit_chunk_iters = 2
    results = _archive(tte.run_simulation(opts))
    assert results[0]["is_timeout"] and results[0]["num_iters"] == 2


def _horizon_case():
    n = 4
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, 2), True)
    th = ttrot.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=1.2, delta=1.0)
    th = th + 0.05 * np.random.default_rng(5).standard_normal(circ.num_thetas)
    target = tts.first_horizon_mps_target(
        num_qubits=n, evol_time=1.2, num_trot_steps=3, delta=1.0, chi_max=8, trunc_thr=1e-16, second_order=True
    ).t1_gt
    return circ, torch.tensor(th), target, (1, 0, 1, 0)


@pytest.mark.parametrize("chunk_iters", [1, 3, 25])
def test_chunked_runner_without_clock_is_the_one_run(chunk_iters):
    circ, x0, target, bits = _horizon_case()
    kw = dict(base_bits=bits, trunc_thr=1e-6, maxiter=7)
    one = tja.optimize_horizon_mps_jit(circ, x0, target, **kw)
    timed, timed_out = tja.optimize_horizon_mps_timed(circ, x0, target, time_limit=None, chunk_iters=chunk_iters, **kw)
    assert not timed_out and timed.num_iters == one.num_iters == 7
    assert torch.equal(timed.thetas, one.thetas) and torch.equal(timed.fobj, one.fobj)


def test_chunked_runner_expired_clock():
    circ, x0, target, bits = _horizon_case()
    res, timed_out = tja.optimize_horizon_mps_timed(
        circ, x0, target, base_bits=bits, maxiter=50, time_limit=1e-9, chunk_iters=3
    )
    assert timed_out and res.num_iters == 3
    # A stop condition before the clock is not a timeout.
    res, timed_out = tja.optimize_horizon_mps_timed(
        circ, x0, target, base_bits=bits, maxiter=50, fidelity_thr=0.5, time_limit=1e-9, chunk_iters=3
    )
    assert not timed_out and res.num_iters == 0
    with pytest.raises(ValueError, match="chunk_iters"):
        tlbfgs.run_lbfgs_chunked(tlbfgs.lbfgs_chunk_programs(None, lambda x: x, maxiter=2), x0, maxiter=2,
                                 chunk_iters=0)


def test_use_jit_lbfgs_auto_rule(monkeypatch):
    """None resolves to the default device: on with the CUDA card, off on
    the CPU; an explicit setting wins."""
    opts = UserOptions()
    assert opts.use_jit_lbfgs is None
    monkeypatch.setattr(config, "device", lambda: torch.device("cuda"))
    assert opts.resolve_use_jit_lbfgs() is True
    monkeypatch.setattr(config, "device", lambda: torch.device("cpu"))
    assert opts.resolve_use_jit_lbfgs() is False
    opts.use_jit_lbfgs = False
    monkeypatch.setattr(config, "device", lambda: torch.device("cuda"))
    assert opts.resolve_use_jit_lbfgs() is False
    opts.use_jit_lbfgs = True
    assert opts.resolve_use_jit_lbfgs() is True


def test_unported_branches_raise(tmp_path):
    """The host-protocol branch, which raised before it was ported, runs for
    either objective: SciPy's counters and the objective's statistics in
    the result, no device loop."""
    for objective in ("sur_fast_mps_trotter", "sur_max"):
        opts = _mini_opts(UserOptions, tmp_path, num_horizons=1)
        opts.objective = objective
        opts.use_jit_lbfgs = False
        opts.maxiter = 3
        results = _archive(tte.run_simulation(opts))
        assert len(results) == 1 and results[0]["num_iters"] == 3 and not results[0]["is_timeout"]
        stats = results[0]["stats"]
        assert "use_jit_lbfgs" not in stats and stats["num_grad_ev"] >= 3
        assert stats["hs2"].shape == (stats["num_grad_ev"], 5)  # |0> and 4 flip states


def _host_opts(cls, result_dir, objective):
    """The host protocol at one layer per horizon step: horizons of 1 and 2
    layers."""
    opts = _mini_opts(cls, result_dir)
    opts.objective = objective
    opts.num_layers_inc = 1
    opts.use_jit_lbfgs = False
    return opts


@pytest.fixture(scope="module", params=["sur_fast_mps_trotter", "sur_max"])
def jax_host_run(request, tmp_path_factory):
    """One JAX host-protocol run per objective: (objective, its results)."""
    out = jte.run_simulation(_host_opts(JUserOptions, tmp_path_factory.mktemp("jax_host"), request.param))
    return request.param, _archive(out)


def test_host_protocol_matches_jax(jax_host_run, tmp_path):
    objective, want = jax_host_run
    got = _archive(tte.run_simulation(_host_opts(UserOptions, tmp_path, objective)))
    assert [r["num_layers"] for r in got] == [r["num_layers"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        _same_horizon(g, w)
        assert not g["is_timeout"] and g["num_iters"] > 0
        np.testing.assert_allclose(g["stats"]["weight"], w["stats"]["weight"], atol=1e-3, rtol=0)  # float16


def test_jit_loop_one_layer_matches_jax(tmp_path):
    """The device loop at one layer: the uncached value_and_grad branch."""
    runs = []
    for cls, run, sub in ((JUserOptions, jte.run_simulation, "jax"), (UserOptions, tte.run_simulation, "port")):
        opts = _mini_opts(cls, tmp_path / sub, num_horizons=1)
        opts.num_layers_inc = 1
        runs.append(_archive(run(opts)))
    want, got = runs
    assert got[0]["num_layers"] == 1 and got[0]["stats"]["use_jit_lbfgs"]
    _same_horizon(got[0], want[0])


def test_launcher_cpu_takes_the_host_path(monkeypatch):
    """``run_time_evol --cpu``, as the JAX launcher: the CPU in f64 and
    ``use_jit_lbfgs`` left to resolve to the host protocol."""
    from aqc_research_tpu_torch.models.sp_lhs import run_time_evol

    seen = []
    monkeypatch.setattr(run_time_evol, "run_simulation", lambda opts: seen.append(
        (opts.use_jit_lbfgs, opts.resolve_use_jit_lbfgs(), config.device().type, config.precision())))
    monkeypatch.setattr(sys, "argv", ["run_time_evol", "-n", "4", "--cpu"])
    previous = (config._DEVICE, config.precision())
    try:
        run_time_evol.main()
    finally:
        config.set_device(previous[0])
        config.set_precision(previous[1])
    assert seen == [(None, False, "cpu", "high")]


def test_result_dir_default_is_the_ports_own():
    assert UserOptions().result_dir.endswith(os.path.join("results", "trotter_evol_torch"))
    assert JUserOptions().result_dir.endswith(os.path.join("results", "trotter_evol"))


def test_plot_without_matplotlib(monkeypatch, tmp_path):
    results = [{"evol_time1": 1.2, "fid_a1_vs_gt": 0.99, "fid_t1_vs_gt": 0.98, "fid_a1_vs_t1": 0.97,
                "num_layers": 2, "num_trotter_steps": 3, "num_qubits": 4}]
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the import raises ImportError
    assert tplots.plot_fidelity_profiles(results=results, output_dir=str(tmp_path)) == []
    assert os.listdir(tmp_path) == []
