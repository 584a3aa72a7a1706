"""The fleet's runner (``runners/mps_fleet.py``) and its metric
(``metrics/lane_fill_pct.py``): its work at both configurations' widths,
its contract on the CPU at a small size (8 qubits, chi 8, 3 lanes), and on
the card one 28-qubit request graphed against the same request eager.

    python -m pytest h100bench/tests/test_h100bench_fleet.py -q
    python -m pytest --noconftest -m cuda h100bench/tests/test_h100bench_fleet.py -q   (on the card)
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import cell, check, spec  # noqa: E402
from harness import spans as S  # noqa: E402
from harness import traffic as T  # noqa: E402
from work import census as W  # noqa: E402

CPU = torch.device("cpu")
CELL = "asp28-rand-fleet4"


@pytest.fixture
def _restore_config():
    """A run's set-up pins the precision and the route for the process."""
    from aqc_research_tpu_torch import config

    precision = config.precision()
    yield
    config.set_svd_impl(None)
    config.set_precision(precision)


class _Program:
    def __init__(self, name, replays):
        self.name, self.replays = name, replays


@pytest.mark.parametrize("config", ["asp28_chi128", "asp20_chi64"])
def test_fleet_work_is_the_census_times_the_lanes(config):
    """A replay of the program of L' running lanes counts L' evaluations of
    its kind, each charged one lane's census work, at every lane count of
    the fleet: L' times the census a replay."""
    cfg = dict(spec.load_json(spec.HERE / "configs" / f"{config}.json"), runner="mps_fleet", lanes=4)
    fleet = spec.runner("mps_fleet")
    work = fleet.work(spec.CellSpec(config, 1, cfg, {}, None, [], [], fleet))
    census = W.evaluation_work(W.decomposition_census(cfg["num_qubits"], cfg["num_layers"], cfg["chi"],
                                                      cfg["second_order"]))
    assert work == census and set(work) == {"value", "obj_grad"}
    p = cfg["num_thetas"]
    programs = [((n, p), _Program(name, 1)) for n in (1, 2, 3, 4) for name in ("mps value", "mps obj+grad")]
    jit_asp = type("jit_asp", (), {"mps_program_shapes": staticmethod(lambda: programs)})
    evals = fleet.replays({"jit_asp": jit_asp})
    for (shape, prog) in programs:
        kind, n = evals[id(prog)]
        assert n == shape[0] and kind == ("obj_grad" if prog.name.endswith("obj+grad") else "value")
        assert tuple(n * w for w in work[kind]) == (shape[0] * census[kind][0], shape[0] * census[kind][1])
    one = _Program("mps value", 5)
    jit_asp.mps_program_shapes = staticmethod(lambda: [((p,), one)])
    assert fleet.replays({"jit_asp": jit_asp}) == {id(one): ("value", 5)}


def test_the_cells_config_is_the_one_lane_config_with_lanes():
    one = spec.load_json(spec.HERE / "configs" / "asp28_chi128.json")
    fleet = spec.load_json(spec.HERE / "configs" / "asp28_chi128_fleet4.json")
    assert {k: v for k, v in fleet.items() if k not in one} == {"runner": "mps_fleet", "lanes": 4}
    assert all(fleet[k] == one[k] for k in one if k not in ("name", "source", "assumed"))
    s = spec.cell_spec(CELL)
    assert s.runner.REQUEST == "asp.horizon" and s.runner.lanes_of(s) == 4 and s.chips == 1
    assert s.limits is not None and set(s.limits) == set(check.NUMBERS)
    assert "lane_fill_pct" in {m.name for m in s.per_layer}
    assert "range_finder_ms_per_iter" not in {m.name for m in s.per_layer}


def test_the_added_entries_keep_the_contract():
    """The fleet's three entries of ``BENCHMARK.json``, each the last of its
    list, keep the contract the accepted entries keep."""
    import test_h100bench_harness as H

    bench = H._bench()
    configs = [c for c in bench["configs"] if c["name"] == "asp28_chi128_fleet4"]
    cells = [w for w in bench["workloads"] if w["name"] == CELL]
    metrics = [m for m in bench["per_layer"] if m["name"] == "lane_fill_pct"]
    assert len(configs) == len(cells) == len(metrics) == 1
    assert (bench["configs"][-1], bench["workloads"][-1], bench["per_layer"][-1]) == (configs[0], cells[0], metrics[0])
    (c,), (w,), (m,) = configs, cells, metrics
    assert set(c) == {"name", "source", "file", "reduced", "why"} and c["reduced"] == []
    assert spec.load_json(spec.ROOT / c["file"])["name"] == c["name"] and len(c["source"]) <= 200
    assert w == {"name": CELL, "config": c["name"], "traffic": "fleet4_rand", "chips": 1, "why": w["why"]}
    assert len(w["why"]) <= 200 and (spec.HERE / "limits" / f"{CELL}.json").exists()
    assert m == {"name": "lane_fill_pct", "unit": "%", "better": "higher", "source": "program_counter",
                 "layer": "fleet", "moves": "iter_s", "workloads": [CELL]}
    assert (spec.HERE / "metrics" / "lane_fill_pct.py").exists()
    with open(spec.ROOT / "PERF.md") as fh:
        assert "| fleet |" in fh.read()
    for name in (c["name"], w["name"], w["traffic"], m["name"]):
        assert H.NAME.match(name), name
    assert H.UNIT.match(m["unit"])


def _tiny(lanes=3):
    cfg = dict(spec.load_json(spec.HERE / "tests" / "tiny_asp8.json"), runner="mps_fleet", lanes=lanes)
    trf = dict(spec.load_json(spec.HERE / "traffic" / "fleet4_rand.json"), lanes=lanes, maxiter=3, warm_iters=1)
    limits = spec.load_json(spec.HERE / "limits" / "asp20-jacobi-restarts.json")
    return spec.CellSpec("tiny-fleet", 1, cfg, trf, limits, [], [], spec.runner("mps_fleet"))


def test_the_runners_contract_on_the_cpu(_restore_config, monkeypatch):
    """L horizons a request, lane i of request k from the seed's start
    point L k + i (the same on every run of the seed); the programs'
    kinds are the work's; the check holds each sampled lane to the
    reference, its gradient taken from the obj+grad of its request's L
    starts; ``lane_fill_pct`` reads a share in (0, 100] from a traced
    run's untraced steps, and the span readers count lane iterations."""
    s = _tiny()
    lanes, seed = 3, 2**31 + 4321
    base = T.trotter_point(s.config)
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp

    seen, real = [], jit_asp._mps_value_and_grad_program

    class Spied:
        def __init__(self, *args):
            self.program = real(*args)

        def __call__(self, th, tgt):
            seen.append(th.detach().clone())
            return self.program(th, tgt)

        def __getattr__(self, name):
            return getattr(self.program, name)

    monkeypatch.setattr(jit_asp, "_mps_value_and_grad_program", Spied)
    run = cell.execute(s, seed, 0.0, True, CPU)
    monkeypatch.undo()
    first = run.sample[0] - run.sample[0] % lanes
    starts = np.stack([h.x0 for h in run.horizons[first:first + lanes]])
    assert torch.equal(seen[-1], torch.as_tensor(starts, dtype=seen[-1].dtype))
    assert len(run.horizons) >= 2 * lanes and len(run.horizons) % lanes == 0
    for j, h in enumerate(run.horizons):
        np.testing.assert_array_equal(h.x0, T.start_point(base, s.traffic, seed, j))
        assert h.watchdog == 0 and math.isfinite(h.fobj) and h.f0 > h.fobj and 1 <= h.iters <= 3
    assert cell.failed(run) == 0 and {p["kind"] for p in run.programs} == set(run.work) == {"value", "obj_grad"}
    assert len(run.programs) == 2 * lanes + 1  # and the watchdog's reference value at L lanes
    numbers = s.runner.readings(run, CPU)
    assert check.verdict(numbers, s.limits)[0], numbers
    fill = spec.reader("lane_fill_pct")(run)
    assert fill is not None and 0 < fill <= 100
    snap = S.recorded(run)
    fleets = S.untraced_requests(run, snap)
    assert fleets and all(r["attrs"] == {"lanes": lanes} for r in fleets)
    its = S.iterations(snap, fleets)
    steps = [i for i in its if "fleet_steps" in i["counts"]]
    assert len(its) == sum(i["counts"]["fleet_lanes"] for i in steps) == run.untraced_iters
    assert all(S.wall_ns(i) == 0 and i["attrs"]["lane"] > 0 for i in its if i not in steps)
    assert S.untraced_split(run, snap)["iterations"] == run.untraced_iters
    assert fill == pytest.approx(100 * run.untraced_iters / (lanes * len(steps)))
    again = cell.execute(s, seed, 0.0, False, CPU)
    for a, b in zip(again.horizons, run.horizons):
        np.testing.assert_array_equal(a.x0, b.x0)


def test_lane_fill_reads_nothing_without_a_fleet():
    run = cell.Run(_tiny(), 1, CPU)
    assert spec.reader("lane_fill_pct")(run) is None
    run.window_start_ns, run.untraced_start_ns, run.window_end_ns = 0, 0, 10**9
    one = {"id": 1, "parent": None, "request": 1, "name": "asp.horizon", "start_ns": 1, "end_ns": 9, "attrs": {},
           "counts": {}, "device_ms": None}
    step = dict(one, id=2, parent=1, name="lbfgs.iteration", counts={"fleet_steps": 1, "fleet_lanes": 1})
    run.spans = {"spans": [one, step], "counters": {}}
    assert spec.reader("lane_fill_pct")(run) is None
    run.spans["spans"][0] = dict(one, attrs={"lanes": 4})
    assert spec.reader("lane_fill_pct")(run) == pytest.approx(25.0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_graphed_fleet_equals_eager_on_a_28q_request():
    """One request of the cell: every evaluation of the graphed fleet is the
    replay of a program captured in set-up, and the same fleet run eagerly
    (the same programs, op by op) gives every lane's iterations, objective
    and angles bit for bit."""
    _need_card()
    from aqc_research_tpu_torch.ops import cuda_graphs as cg

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    s = spec.cell_spec(CELL)
    runner = s.runner
    cell.kernel_library(dev)
    state = runner.setup(s, dev)
    try:
        lanes, trf = state["lanes"], state["traffic"]
        starts = [T.start_point(state["trotter_point"], trf, 2**31 + 99, i) for i in range(lanes)]
        x0 = torch.as_tensor(np.stack(starts), dtype=state["dtype"], device=dev)
        calls = []
        real = cg.GraphProgram.__call__

        def counted(self, *tensors):
            calls.append(self)
            return real(self, *tensors)

        programs = {id(p) for p in state["jit_asp"].mps_programs()}
        before = {id(p): p.replays for p in state["jit_asp"].mps_programs()}
        captured = sum(cg.captured.values())
        cg.GraphProgram.__call__ = counted
        try:
            graphed = runner.fleet(state, x0, int(trf["maxiter"]), float(trf["fidelity_thr"]))
            torch.cuda.synchronize(dev)
        finally:
            cg.GraphProgram.__call__ = real
        after = {id(p): p.replays for p in state["jit_asp"].mps_programs()}
        assert calls and {id(p) for p in calls} <= programs == set(after)
        assert sum(after[k] - before[k] for k in after) == len(calls) and sum(cg.captured.values()) == captured
        with cg.eager():
            eager = runner.fleet(state, x0, int(trf["maxiter"]), float(trf["fidelity_thr"]))
        np.testing.assert_array_equal(graphed.num_iters, eager.num_iters)
        assert torch.equal(graphed.thetas, eager.thetas) and torch.equal(graphed.fobj, eager.fobj)
        assert graphed.num_iters.min() >= 1 and bool((graphed.fobj < 1).all())
    finally:
        runner.release(state)
