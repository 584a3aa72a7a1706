"""The port's approximate-quantum-compiling path held against the JAX
package on the CPU in float64 / complex128, with the same numpy-seeded
inputs:

* every ``make_target_matrix`` family and ``make_su_matrix`` within 1e-12,
  the target-state families and the random helpers of ``utils``;
* each sketching-vector generator gives the same X and Y under the same
  seed, and the sketching objective and gradient agree within 1e-10 at
  3–4 qubits for each generator type;
* ``coord_descent_single_sweep`` and ``coord_descent_run`` within 1e-10
  (3 qubits, cx), the cp entangler refused;
* ``run_jobs``: seeding, failure capture, cache resume and a changed-config
  rejection (the JAX package's tests/test_parallel.py cases, on the port);
* the three drivers at the sizes of tests/test_sketching_drivers.py:
  per-lane and per-restart costs within 1e-8 of JAX, the same payload
  keys, ``qcircuit.qasm`` (the JAX text of the best circuit, gate for gate
  the JAX driver's), the time-limit contract and the resume.
"""

import importlib
import os
import pickle

import numpy as np
import pytest
import torch

from aqc_research_tpu import utils as jutils
from aqc_research_tpu.circuit import qasm as jqasm
from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.models.sketching import aqc_coordinate_descent as j_coord
from aqc_research_tpu.models.sketching import sk_core as jsk
from aqc_research_tpu.ops import coord_descent as jcd
from aqc_research_tpu.targets import generator as jgen
from aqc_research_tpu_torch import config
from aqc_research_tpu_torch import utils as tutils
from aqc_research_tpu_torch.circuit.ansatz import Ansatz
from aqc_research_tpu_torch.models.sketching import aqc_coordinate_descent as t_coord
from aqc_research_tpu_torch.models.sketching import sk_core as tsk
from aqc_research_tpu_torch.ops import coord_descent as tcd
from aqc_research_tpu_torch.parallel.executor import run_jobs
from aqc_research_tpu_torch.targets import generator as tgen
from tests import _torch_threads  # noqa: F401

j_sketching = importlib.import_module("aqc_research_tpu.models.sketching.aqc_sketching").aqc_sketching
t_sketching = importlib.import_module("aqc_research_tpu_torch.models.sketching.aqc_sketching").aqc_sketching

TOL = 1e-12  # host numpy on both sides
TOL_EVAL = 1e-10  # one objective / gradient / sweep
TOL_RUN = 1e-8  # after an optimization


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


def _twice(seed, fn_j, fn_t):
    np.random.seed(seed)
    a = fn_j()
    np.random.seed(seed)
    return a, fn_t()


@pytest.mark.parametrize("family", jgen.available_target_matrix_types())
def test_target_matrix_families(family):
    assert tgen.available_target_matrix_types() == jgen.available_target_matrix_types()
    u_j, u_t = _twice(11, lambda: jgen.make_target_matrix(family, 5), lambda: tgen.make_target_matrix(family, 5))
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(tgen.make_su_matrix(u_t), jgen.make_su_matrix(u_j), rtol=0, atol=TOL)


def test_unknown_target_families_raise():
    with pytest.raises(ValueError):
        tgen.make_target_matrix("nope", 3)
    with pytest.raises(ValueError):
        tgen.make_target_state("nope", 3)


@pytest.mark.parametrize("family", ["parametric", "bare", "random"])
def test_target_state_families(family):
    assert tgen.available_target_state_types() == jgen.available_target_state_types()
    s_j, s_t = _twice(5, lambda: np.asarray(jgen.make_target_state(family, 4)),
                      lambda: tgen.make_target_state(family, 4))
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=TOL_EVAL)


def test_random_helpers_replay_numpy():
    for fn in ("rand_circuit", "rand_thetas", "rand_state", "zero_state"):
        args = {"rand_circuit": (4, 6), "rand_thetas": (9,), "rand_state": (3,), "zero_state": (3,)}[fn]
        a, b = _twice(3, lambda: getattr(jutils, fn)(*args), lambda: getattr(tutils, fn)(*args))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert tutils.num_cpus() == jutils.num_cpus()
    g = tutils.rand_thetas_gen(torch.Generator().manual_seed(1), 50)
    assert g.shape == (50,) and bool((g.abs() < np.pi).all())


def _circuits(n=3, depth=6, entangler="cx", seed=2):
    np.random.seed(seed)
    blocks = jutils.rand_circuit(n, depth)
    return JAnsatz.make(n, entangler, blocks), Ansatz.make(n, entangler, blocks)


@pytest.mark.parametrize("kind", ["full", "rand", "alt", "eigen"])
def test_sketching_generators_replay(kind):
    n = 4
    jc, tc = _circuits(n)
    np.random.seed(7)
    u = jgen.make_target_matrix("random", n)
    thetas = jutils.rand_thetas(jc.num_thetas)
    m = 16 if kind == "full" else 4

    def draws(mod, circ):
        gen = mod.skvecs_generator(kind, m, u)
        return [gen.generate(circ, thetas) for _ in range(3)]

    got_j, got_t = _twice(9, lambda: draws(jsk, jc), lambda: draws(tsk, tc))
    for (xj, yj), (xt, yt) in zip(got_j, got_t):
        np.testing.assert_allclose(xt, np.asarray(xj), rtol=0, atol=TOL_EVAL)
        np.testing.assert_allclose(yt, np.asarray(yj), rtol=0, atol=TOL_EVAL)


@pytest.mark.parametrize("kind, n", [("full", 3), ("rand", 4), ("alt", 4), ("eigen", 3)])
def test_sketching_objective_and_gradient(kind, n):
    jc, tc = _circuits(n, depth=8)
    np.random.seed(4)
    u = jgen.make_su_matrix(jgen.make_target_matrix("random", n))
    m = 2**n if kind == "full" else 4
    thetas = [jutils.rand_thetas(jc.num_thetas) for _ in range(3)]

    def evaluate(mod, circ):
        objv = mod.SketchingObjectiveEx(circ, mod.skvecs_generator(kind, m, u), enable_stats=True)
        return [objv.objective_and_gradient(th) for th in thetas], objv

    (got_j, oj), (got_t, ot) = _twice(6, lambda: evaluate(jsk, jc), lambda: evaluate(tsk, tc))
    for (fj, gj), (ft, gt) in zip(got_j, got_t):
        assert abs(ft - fj) <= TOL_EVAL
        np.testing.assert_allclose(gt, gj, rtol=0, atol=TOL_EVAL)
    assert ot.optim_results.keys() == oj.optim_results.keys()
    assert abs(ot.optim_results["cost"] - oj.optim_results["cost"]) <= TOL_EVAL
    np.testing.assert_allclose(ot.statistics["convergence_profile"], oj.statistics["convergence_profile"])


def test_coord_descent_sweep_and_run():
    jc, tc = _circuits(3, depth=5)
    np.random.seed(8)
    u = jgen.make_target_matrix("random", 3)
    th0 = jutils.rand_thetas(jc.num_thetas)
    th_j, f_j = jcd.coord_descent_single_sweep(jc, th0, u)
    th_t, f_t = tcd.coord_descent_single_sweep(tc, th0, u)
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=0, atol=TOL_EVAL)
    assert abs(float(f_t) - float(f_j)) <= TOL_EVAL

    run_j, _ = jcd.coord_descent_run(jc, th0, u, maxiter=12, fobj_thr=1e-3)
    run_t, timed_out = tcd.coord_descent_run(tc, th0, u, maxiter=12, fobj_thr=1e-3, chunk_sweeps=5)
    assert not timed_out
    assert run_t.num_sweeps == int(run_j.num_sweeps) and run_t.converged == bool(run_j.converged)
    np.testing.assert_allclose(run_t.thetas.numpy(), np.asarray(run_j.thetas), rtol=0, atol=TOL_EVAL)
    np.testing.assert_allclose(run_t.profile.numpy(), np.asarray(run_j.profile), rtol=0, atol=TOL_EVAL)
    _, timed_out = tcd.coord_descent_run(tc, th0, u, maxiter=500, time_limit=1e-9, chunk_sweeps=2)
    assert timed_out

    _, tcp = _circuits(3, depth=5, entangler="cp")
    with pytest.raises(NotImplementedError):
        tcd.coord_descent_single_sweep(tcp, np.zeros(tcp.num_thetas), u)


def test_run_jobs_seeding_and_failure():
    def job(idx, config):
        if idx == 1:
            raise RuntimeError("boom")
        return {"cost": float(np.random.rand()), "idx": idx}

    results = run_jobs([{}, {}, {}], seed=42, job_function=job, tolerate_failure=True)
    assert len(results) == 2  # the failed job filtered out
    assert all(r["status"] == "ok" for r in results)
    assert results[0]["seed"] == 42 + 7  # the reference's seeding convention
    np.random.seed(42 + 7)
    assert results[0]["cost"] == float(np.random.rand())
    threaded = run_jobs([{}, {}, {}], seed=42, job_function=job, tolerate_failure=True, num_jobs=2)
    assert [r["seed"] for r in threaded] == [r["seed"] for r in results]
    with pytest.raises(RuntimeError):
        run_jobs([{}], seed=0, job_function=lambda i, c: 1 / 0)


def test_run_jobs_cache_resume(tmp_path):
    """Completed jobs persist and are reused on a re-run; failed jobs are
    retried; another base seed recomputes."""
    cache = str(tmp_path / "jobs")
    calls = {"n": 0}
    fail_once = {1: True}

    def job(idx, config):
        calls["n"] += 1
        if fail_once.pop(idx, False):
            raise RuntimeError("transient")
        return {"cost": float(np.random.rand()), "idx": idx}

    results = run_jobs([{}] * 3, seed=42, job_function=job, tolerate_failure=True, cache_dir=cache)
    assert len(results) == 2 and calls["n"] == 3
    first_costs = {r["idx"]: r["cost"] for r in results}
    results = run_jobs([{}] * 3, seed=42, job_function=job, tolerate_failure=True, cache_dir=cache)
    assert calls["n"] == 4 and len(results) == 3
    by_idx = {r["idx"]: r for r in results}
    for i in (0, 2):
        assert by_idx[i]["cached"] is True and by_idx[i]["cost"] == first_costs[i]
    assert "cached" not in by_idx[1]
    results = run_jobs([{}] * 3, seed=43, job_function=job, tolerate_failure=True, cache_dir=cache)
    assert calls["n"] == 7 and all("cached" not in r for r in results)


def test_run_jobs_cache_rejects_changed_config(tmp_path):
    cache = str(tmp_path / "jobs")
    calls = {"n": 0}

    def job(idx, config):
        calls["n"] += 1
        return {"cost": float(config["target"].sum()) + config["maxiter"]}

    cfg = {"target": np.eye(2), "maxiter": 10}
    run_jobs([cfg], seed=1, job_function=job, cache_dir=cache)
    res = run_jobs([cfg], seed=1, job_function=job, cache_dir=cache)
    assert calls["n"] == 1 and res[0]["cached"] is True
    res = run_jobs([{"target": np.eye(2), "maxiter": 20}], seed=1, job_function=job, cache_dir=cache)
    assert calls["n"] == 2 and "cached" not in res[0]
    res = run_jobs([{"target": 2.0 * np.eye(2), "maxiter": 20}], seed=1, job_function=job, cache_dir=cache)
    assert calls["n"] == 3 and "cached" not in res[0]


def _payload(out):
    with open(os.path.join(out, "simulation_results.pkl"), "rb") as fld:
        return pickle.load(fld)


def _same_results(pj, pt, tol=TOL_RUN):
    assert pt.keys() == pj.keys() and pt["best_result"].keys() == pj["best_result"].keys()
    assert pt["best_result"]["accuracy_metrics"].keys() == pj["best_result"]["accuracy_metrics"].keys()
    rj, rt = pj["sorted_results"], pt["sorted_results"]
    assert len(rt) == len(rj)
    for a, b in zip(rj, rt):
        assert set(b) == set(a)
        assert abs(b["cost"] - a["cost"]) <= tol and b["nit"] == a["nit"]
        assert b["exit_status"] == a["exit_status"] and b["seed"] == a["seed"]
        np.testing.assert_allclose(b["ini_thetas"], a["ini_thetas"], rtol=0, atol=TOL)
    np.testing.assert_allclose(pt["target_matrix"], pj["target_matrix"], rtol=0, atol=TOL)
    for key, val in pj["best_result"]["accuracy_metrics"].items():
        assert abs(pt["best_result"]["accuracy_metrics"][key] - val) <= 1e-6


DRIVER_CASES = {
    "full": (j_sketching, t_sketching, dict(
        num_qubits=2, num_layers=4, num_skvecs=4, circ_layout="spin", maxiter=120, learn_rate=0.1,
        skvecs_type="full", target_name_or_func="random", seed=11, num_simulations=2)),
    "sketched": (j_sketching, t_sketching, dict(
        num_qubits=3, num_layers=3, num_skvecs=2, circ_layout="spin", maxiter=30, learn_rate=0.1,
        skvecs_type="alt", target_name_or_func="shift1", seed=3)),
    "coord": (j_coord, t_coord, dict(
        num_qubits=2, num_layers=4, circ_layout="spin", maxiter=40, target_name_or_func="random", seed=5)),
}


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_drivers_match_jax(case, tmp_path):
    fn_j, fn_t, kw = DRIVER_CASES[case]
    out_j = fn_j(result_folder=str(tmp_path / "jax"), **kw)
    pj = _payload(out_j)
    out = fn_t(result_folder=str(tmp_path / "torch"), **kw)
    pt = _payload(out)
    _same_results(pj, pt)
    assert os.path.isfile(os.path.join(out, "qcircuit.pkl"))
    # qcircuit.qasm: the JAX package's text of the port's best circuit, and
    # the JAX driver's circuit gate for gate (angles to the runs' agreement).
    with open(os.path.join(out, "qcircuit.qasm")) as fh:
        text = fh.read()
    assert text == jqasm.program_to_qasm3(pt["best_result"]["program"], kw["num_qubits"])
    with open(os.path.join(out_j, "qcircuit.qasm")) as fh:
        want, _ = jqasm.program_from_qasm3(fh.read())
    got, _ = jqasm.program_from_qasm3(text)
    assert [(g.name, g.qubits) for g in got] == [(g.name, g.qubits) for g in want]
    np.testing.assert_allclose([g.param or 0.0 for g in got], [g.param or 0.0 for g in want], rtol=0, atol=1e-5)
    if case == "full":
        assert all(r["stats"]["fleet"] for r in pt["sorted_results"])
        assert pt["best_result"]["accuracy_metrics"]["fidelity"] > 0.9


def test_sketched_resume_reuses_persisted_seed(tmp_path):
    """A resume without a seed reuses the first run's persisted base seed,
    so the cached restarts hit; the costs equal the JAX driver's."""
    kw = dict(num_qubits=2, num_layers=2, num_skvecs=2, circ_layout="spin", maxiter=6, learn_rate=0.1,
              skvecs_type="alt", target_name_or_func="shift1", num_simulations=2,
              job_cache_dir=str(tmp_path / "cache"))
    res1 = _payload(t_sketching(result_folder=str(tmp_path / "r1"), **kw))["sorted_results"]
    res2 = _payload(t_sketching(result_folder=str(tmp_path / "r2"), **kw))["sorted_results"]
    assert all(r.get("cached") for r in res2), "the resume must hit the cache"
    assert [r["cost"] for r in res2] == [r["cost"] for r in res1]
    with open(os.path.join(str(tmp_path / "cache"), "base_seed.txt")) as fld:
        seed = int(fld.read())
    kw_j = dict(kw, seed=seed, job_cache_dir=None)
    res_j = _payload(j_sketching(result_folder=str(tmp_path / "j"), **kw_j))["sorted_results"]
    np.testing.assert_allclose([r["cost"] for r in res1], [r["cost"] for r in res_j], rtol=0, atol=TOL_RUN)


@pytest.mark.parametrize("driver", ["coord", "full"])
def test_time_limit_contract(driver, tmp_path):
    """An expired clock ends the run between chunks: fewer iterations than
    maxiter and a "timeout" (or "early") exit."""
    kw = dict(num_qubits=2, num_layers=4, circ_layout="spin", maxiter=5000, target_name_or_func="random",
              result_folder=str(tmp_path), seed=5, time_limit=1)
    if driver == "coord":
        out = t_coord(**kw)
    else:
        out = t_sketching(num_skvecs=4, learn_rate=0.1, skvecs_type="full", num_simulations=2,
                          **dict(kw, time_limit=1e-9))
    res = _payload(out)["sorted_results"][0]
    assert res["exit_status"] in ("timeout", "early")
    assert res["nit"] < 5000
