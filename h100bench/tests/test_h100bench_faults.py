"""A run of the harness on the CPU at a small size (8 qubits, chi 8), past
its look for a card, through the cells' runner (``runners/horizon_mps.py``)
with the timed path broken underneath: ``correct`` comes out false for
each fault the cells can have, and true without one.  The one-card cells
exchange nothing between chips, so that fault has no case."""

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import cell, check, spec  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _restore_config():
    """A run's set-up pins the precision and the pair-update route for the
    whole process; later tests get the defaults back."""
    from aqc_research_tpu_torch import config

    precision = config.precision()
    yield
    config.set_svd_impl(None)
    config.set_precision(precision)


def _spec():
    cfg = spec.load_json(spec.HERE / "tests" / "tiny_asp8.json")
    trf = spec.load_json(spec.HERE / "traffic" / "restarts_jacobi.json")
    limits = spec.load_json(spec.HERE / "limits" / "asp20-jacobi-restarts.json")
    return spec.CellSpec("tiny", 1, cfg, trf, limits, [], [], spec.runner("horizon_mps"))


def _numbers(seed=7, after_setup=None, control=False):
    s = _spec()
    state = s.runner.setup(s, CPU)
    try:
        if after_setup is not None:
            after_setup()
        run = cell.Run(s, seed, CPU)
        cell.window(run, state, 0.0, False, int(s.traffic["sample"]))
        s.runner.outputs(state, run)
    finally:
        s.runner.release(state)
    return s.runner.readings(run, CPU, control), s.limits, cell.failed(run)


def _correct(numbers, limits):
    return check.verdict(numbers, limits)[0]


def test_sound_run_is_correct():
    numbers, limits, failed = _numbers()
    assert _correct(numbers, limits), numbers
    assert failed == 0


def test_control_is_not_correct():
    numbers, limits, _ = _numbers(control=True)
    assert not _correct(numbers, limits), numbers


@pytest.fixture
def jit_asp():
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp as module

    return module


def test_horizon_returns_its_start(monkeypatch, jit_asp):
    def patch():
        def unchanged(circ, thetas0, target, *, base_bits, trunc_thr=1e-6, fidelity_thr=None, maxiter=100,
                      no_improve_iters=None):
            value = jit_asp._mps_value_program(circ, tuple(base_bits), float(trunc_thr), "jacobi")
            f = value(thetas0, target)
            return jit_asp.JitHorizonResult(thetas0.clone(), f, 1.0 - f, maxiter, False)

        monkeypatch.setattr(jit_asp, "optimize_horizon_mps_jit", unchanged)

    numbers, limits, failed = _numbers(after_setup=patch)
    assert not _correct(numbers, limits), numbers
    assert failed == 3


def test_objective_altered_where_produced(monkeypatch, jit_asp):
    real = jit_asp.optimize_horizon_mps_jit

    def patch():
        def altered(*args, **kwargs):
            res = real(*args, **kwargs)
            return res._replace(fobj=res.fobj * 0.5)

        monkeypatch.setattr(jit_asp, "optimize_horizon_mps_jit", altered)

    numbers, limits, _ = _numbers(after_setup=patch)
    assert not _correct(numbers, limits), numbers
    assert numbers["fobj_gap"] > limits["fobj_gap"]


def test_half_of_each_pair_batch_left_out(monkeypatch):
    from aqc_research_tpu_torch.ops import mps

    real = mps._pair_update

    def half(lam_l, lam_c, lam_r, g1, g2, *rest):
        new_g1, new_g2, new_lam = real(lam_l, lam_c, lam_r, g1, g2, *rest)
        b = g1.shape[-4]
        if b > 1:   # the second half of the batch keeps its old tensors
            keep = torch.arange(b) >= (b + 1) // 2
            new_g1 = torch.where(keep[:, None, None, None], g1, new_g1)
            new_g2 = torch.where(keep[:, None, None, None], g2, new_g2)
            new_lam = torch.where(keep[:, None], lam_c.to(new_lam.dtype), new_lam)
        return new_g1, new_g2, new_lam

    monkeypatch.setattr(mps, "_pair_update", half)
    numbers, limits, _ = _numbers()
    assert not _correct(numbers, limits), numbers


def test_gradient_half_left_out(monkeypatch, jit_asp):
    real = jit_asp._mps_value_fns

    def fns(*args):
        value, value_and_grad = real(*args)

        def halved(th, tgt):
            f, g = value_and_grad(th, tgt)
            return f, torch.where(torch.arange(g.shape[-1]) % 2 == 0, g, torch.zeros_like(g))

        return value, halved

    monkeypatch.setattr(jit_asp, "_mps_value_fns", fns)
    numbers, limits, _ = _numbers()
    assert not _correct(numbers, limits), numbers
    assert numbers["grad_gap"] > limits["grad_gap"]


FLEET_RUNNER = '''"""Two lanes of the MPS horizon in lock step (the port's multi-start fleet,
``jit_asp.optimize_horizon_mps_multistart``): request k runs lanes from the
seed's start points 2k and 2k + 1.  Set-up, outputs and the check are the
one-lane runner's: each lane against the same MPS reference."""

import numpy as np
import torch

from harness import traffic as T
from harness.cell import Horizon
from harness.spec import runner

LANES = 2
ONE = runner("horizon_mps")
REQUEST, setup, outputs, readings, release = ONE.REQUEST, ONE.setup, ONE.outputs, ONE.readings, ONE.release


def request(state, seed, k):
    trf = state["traffic"]
    starts = [T.start_point(state["trotter_point"], trf, seed, LANES * k + i) for i in range(LANES)]
    x0 = torch.as_tensor(np.stack(starts), dtype=state["dtype"], device=state["device"])
    res = state["jit_asp"].optimize_horizon_mps_multistart(
        state["circ"], x0, state["target"], base_bits=state["base"], trunc_thr=state["thr"],
        fidelity_thr=float(trf["fidelity_thr"]), maxiter=int(trf["maxiter"]))
    return [Horizon(starts[i], res.thetas[i], float(res.fobj[i]), int(res.num_iters[i]), 0) for i in range(LANES)]


def replays(state):
    return {}   # the fleet runs eagerly: no captured program


def programs(state):
    return {}


def work(spec):
    return {kind: (LANES * f, LANES * b) for kind, (f, b) in ONE.work(spec).items()}
'''


def test_a_new_runner_is_a_new_file(tmp_path, monkeypatch, jit_asp):
    """A configuration that drives another entry point of the program is new
    files: its runner, its config naming it, its cell's entry and limits.
    The harness runs it and the check holds each lane to the reference; one
    lane's objective altered where the fleet produces it fails.  No file of
    the harness changes."""
    (tmp_path / "runners").mkdir()
    (tmp_path / "runners" / "fleet2.py").write_text(FLEET_RUNNER)
    cfg = dict(spec.load_json(spec.HERE / "tests" / "tiny_asp8.json"), name="tiny_fleet2", runner="fleet2")
    (tmp_path / "tiny_fleet2.json").write_text(json.dumps(cfg))
    (tmp_path / "limits").mkdir()
    (tmp_path / "limits" / "tiny-fleet2.json").write_text(
        (spec.HERE / "limits" / "asp20-jacobi-restarts.json").read_text())
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    bench["configs"] = [dict(bench["configs"][0], name="tiny_fleet2", file=str(tmp_path / "tiny_fleet2.json"))]
    bench["workloads"] = [{"name": "tiny-fleet2", "config": "tiny_fleet2", "traffic": "restarts_jacobi", "chips": 1,
                           "why": "two lanes in lock step"}]
    bench["per_layer"] = [dict(m, workloads=["tiny-fleet2"]) for m in bench["per_layer"] if "workloads" not in m]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    s = spec.cell_spec("tiny-fleet2", bench_path=tmp_path / "BENCHMARK.json", folders=(tmp_path, spec.HERE))
    assert s.runner.LANES == 2 and s.runner.REQUEST == "asp.horizon"

    run = cell.execute(s, 7, 0.0, False, CPU)
    numbers = s.runner.readings(run, CPU)
    assert len(run.horizons) == 2 and run.sample == [0, 1] and cell.failed(run) == 0
    assert check.verdict(numbers, s.limits)[0], numbers
    assert run.work["obj_grad"][0] == 2 * s.runner.ONE.work(s)["obj_grad"][0]

    real = jit_asp.optimize_horizon_mps_multistart

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        return res._replace(fobj=res.fobj * torch.tensor([1.0, 0.5], dtype=res.fobj.dtype))

    monkeypatch.setattr(jit_asp, "optimize_horizon_mps_multistart", altered)
    run = cell.execute(s, 7, 0.0, False, CPU)
    numbers = s.runner.readings(run, CPU)
    assert not check.verdict(numbers, s.limits)[0], numbers
    assert numbers["fobj_gap"] > s.limits["fobj_gap"]
