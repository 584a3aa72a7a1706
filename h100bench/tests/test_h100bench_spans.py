"""The span readers and ``harness/spans.py`` on the CPU: the six readers on
a recorded run with hand-computed values, the readers of the earlier
metrics unchanged by a run's spans, nothing read where the program recorded
nothing, ``cell.execute`` switching the recorder on for a traced run only,
and a small run of the harness with spans on."""

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import cell, spec  # noqa: E402
from harness import spans as S  # noqa: E402
from harness.tracetab import TraceTable  # noqa: E402

MS = 1_000_000
NEW = ("linesearch_ms_per_iter", "grad_ms_per_iter", "boundary_ms_per_iter", "host_loop_ms_per_iter",
       "host_reads_per_iter", "target_s")
OLD = ("pair_kernels_ms_per_iter", "range_finder_ms_per_iter", "engine_ms_per_iter", "idle_pct", "sweep_roofline_pct",
       "evals_per_iter", "capture_s", "setup_s", "iter_s")


def _span(i, name, parent, request, start_ms, end_ms, base, device_ms=None, reads=0, **attrs):
    return {"id": i, "parent": parent, "request": request, "name": name, "start_ns": base + int(start_ms * MS),
            "end_ns": base + int(end_ms * MS), "attrs": attrs, "counts": {"host_reads": reads} if reads else {},
            "device_ms": device_ms}


def _snapshot():
    """Set-up (the target, a warm horizon), one traced horizon of one
    iteration, one untraced horizon of two."""
    a, b = 10 * 10**9, 20 * 10**9
    spans = [
        _span(1, "target.generate", None, None, 0, 5000, 0),
        _span(2, "target.t1_gt", 1, None, 1000, 3000, 0),
        _span(4, "target.t1", 1, None, 3000, 4500, 0),
        _span(3, "asp.horizon", None, 3, 6000, 7000, 0),
        # The traced horizon.
        _span(10, "asp.horizon", None, 10, 0, 1000, a),
        _span(11, "lbfgs.iteration", 10, 10, 100, 900, a),
        _span(12, "program.replay", 11, 10, 200, 300, a, device_ms=90.0, program="mps obj+grad"),
        # The untraced horizon: 100 ms, its iterations 40 + 30 ms.
        _span(20, "asp.horizon", None, 20, 0, 100, b),
        _span(21, "lbfgs.init", 20, 20, 0, 10, b),
        _span(22, "program.replay", 21, 20, 1, 9, b, device_ms=8.0),
        _span(23, "host.read", 21, 20, 9, 10, b, reads=1),
        _span(24, "lbfgs.iteration", 20, 20, 10, 50, b),
        _span(25, "lbfgs.linesearch", 24, 20, 11, 30, b),
        _span(26, "program.replay", 25, 20, 11, 20, b, device_ms=12.0),
        _span(27, "host.read", 25, 20, 20, 22, b, reads=1),
        _span(28, "program.replay", 25, 20, 22, 28, b, device_ms=5.0),
        _span(29, "host.read", 25, 20, 28, 30, b, reads=1),
        _span(30, "lbfgs.grad", 24, 20, 31, 45, b),
        _span(31, "program.replay", 30, 20, 31, 45, b, device_ms=10.0),
        _span(32, "host.read", 24, 20, 46, 49, b, reads=1),
        _span(33, "lbfgs.iteration", 20, 20, 50, 80, b),
        _span(34, "lbfgs.linesearch", 33, 20, 50, 60, b),
        _span(35, "program.replay", 34, 20, 50, 58, b, device_ms=6.0),
        _span(36, "host.read", 34, 20, 58, 60, b, reads=1),
        _span(37, "lbfgs.grad", 33, 20, 60, 75, b),
        _span(38, "program.replay", 37, 20, 60, 75, b, device_ms=12.0),
        _span(39, "host.read", 33, 20, 76, 79, b, reads=1),
        _span(40, "asp.watchdog", 20, 20, 82, 95, b),
        _span(41, "program.replay", 40, 20, 82, 90, b, device_ms=4.0),
        _span(42, "host.read", 40, 20, 90, 95, b, reads=2),
        # The check's replay, after the window.
        _span(50, "program.replay", None, None, 0, 5, 30 * 10**9, device_ms=4.0),
    ]
    return {"spans": spans, "counters": {"host_reads": 10}}


def _run(with_spans=True):
    cfg = spec.load_json(spec.ROOT / "h100bench/configs/asp28_chi128.json")
    trf = spec.load_json(spec.HERE / "traffic/restarts_rand.json")
    s = spec.CellSpec("asp28-rand-restarts", 1, cfg, trf, None, [], [], spec.runner("horizon_mps"))
    run = cell.Run(s, 1, None)
    run.work = s.runner.work(s)
    # The window from 9 s (after the warm horizon), untraced from 15 s, to
    # 25 s (before the check's replay).
    run.window_start_ns, run.untraced_start_ns, run.window_end_ns = 9 * 10**9, 15 * 10**9, 25 * 10**9
    # The traced window (1 s from 10 s - 0.1 ms on the spans' clock): busy
    # but for 0.19-0.31 s, where the traced horizon's replay was open.
    dev = [("void fused_pair_cluster_kernel(float const*, int)", 0.0, 0.19),
           ("void geqr2_smem<float2, float, 8, 5>(int, float2*)", 0.31, 1.0)]
    host = [("cudaGraphLaunch", 0.2001, 0.2002), ("aten::item", 0.19, 0.31)]
    run.trace = TraceTable.from_rows(json.loads(json.dumps(TraceTable(dev, host, 1.0).to_rows())))
    run.traced_iters, run.traced_evals = 1, {"value": 0, "obj_grad": 1}
    run.window_s, run.setup_s = 1.2, 12.0
    run.untraced_s, run.untraced_iters = 0.1, 2
    run.untraced_evals = {"value": 3, "obj_grad": 3}
    run.horizons = [cell.Horizon(None, None, 0.004, it, 0) for it in (1, 2)]
    run.programs = [{"name": "mps value", "kind": "value", "warmup_s": 0.5, "capture_s": 1.0, "instantiate_s": 0.25,
                     "window_replays": 4},
                    {"name": "mps obj+grad", "kind": "obj_grad", "warmup_s": 1.0, "capture_s": 2.0,
                     "instantiate_s": 0.5, "window_replays": 4}]
    if with_spans:
        run.spans = _snapshot()
    return run


def test_span_readers_on_a_recorded_run():
    run = _run()
    read = {name: spec.reader(name)(run) for name in NEW}
    assert read["linesearch_ms_per_iter"] == pytest.approx((12 + 5 + 6) / 2)
    assert read["grad_ms_per_iter"] == pytest.approx((10 + 12) / 2)
    assert read["boundary_ms_per_iter"] == pytest.approx((100 - 40 - 30) / 2)
    assert read["host_loop_ms_per_iter"] == pytest.approx(((40 - 12 - 5 - 10) + (30 - 6 - 12)) / 2)
    assert read["host_reads_per_iter"] == pytest.approx(8 / 2)
    # The two evolutions, not the initial states before them.
    assert read["target_s"] == pytest.approx(2.0 + 1.5)
    # The four parts make the untraced wall per iteration.
    parts = sum(read[n] for n in NEW[:4])
    assert parts == pytest.approx(1e3 * run.untraced_s / run.untraced_iters)


def test_span_arithmetic():
    snap = _snapshot()
    run = _run()
    assert [h["id"] for h in S.untraced_requests(run, snap)] == [20]
    assert [h["id"] for h in S.traced_requests(run, snap)] == [10]
    # A run without a trace: the whole window is untraced.
    run.untraced_start_ns = run.window_start_ns
    assert [h["id"] for h in S.untraced_requests(run, snap)] == [10, 20] and S.traced_requests(run, snap) == []
    run = _run()
    by_id = {s["id"]: s for s in snap["spans"]}
    h, its = by_id[20], [by_id[24], by_id[33]]
    assert S.cover_ns(h, its) == 70 * MS and S.self_ns(h, its) == 30 * MS
    # Overlapping and outlying children count once, clipped to the parent.
    kids = [dict(by_id[24], start_ns=by_id[24]["start_ns"] - 50 * MS), dict(by_id[25]), dict(by_id[33])]
    assert S.cover_ns(h, kids) == (50 + 30) * MS
    assert S.innermost_at(snap["spans"], by_id[27]["start_ns"] + MS)["id"] == 27
    assert S.innermost_at(snap["spans"], by_id[24]["start_ns"] + MS // 2)["id"] == 24
    assert S.innermost_at(snap["spans"], by_id[20]["end_ns"] + MS) is None
    assert S.replay_ms(S.of_requests(snap, [h])) == pytest.approx(8 + 12 + 5 + 10 + 6 + 12 + 4)
    assert S.trace_origin_ns(run, snap) == pytest.approx(10 * 10**9 + 200 * MS - 0.2001e9)
    assert S.idle_gaps_by_span(run, snap) == [["program.replay (mps obj+grad) in lbfgs.iteration",
                                                  pytest.approx(0.12)]]
    notes = S.checks(run, snap)
    assert "sum 50.0 against the wall 50.0" in notes[0] and "device ms/iter 28.5" in notes[1]


def test_earlier_readers_do_not_change_with_spans():
    for name in OLD:
        assert spec.reader(name)(_run(False)) == spec.reader(name)(_run(True)), name


def test_nothing_read_without_spans():
    run = _run(False)
    for name in NEW:
        assert spec.reader(name)(run) is None, name
    run.spans = {"spans": [], "counters": {}}
    for name in NEW:
        assert spec.reader(name)(run) is None, name


def _tiny(**traffic):
    cfg = spec.load_json(spec.HERE / "tests" / "tiny_asp8.json")
    trf = dict(spec.load_json(spec.HERE / "traffic" / "restarts_jacobi.json"), **traffic)
    return spec.CellSpec("tiny", 1, cfg, trf, None, [], [], spec.runner("horizon_mps"))


@pytest.fixture
def _restore_config():
    """A run's set-up pins the precision and the route for the process."""
    from aqc_research_tpu_torch import config

    precision = config.precision()
    yield
    config.set_svd_impl(None)
    config.set_precision(precision)


def test_execute_switches_spans_on(_restore_config):
    """``cell.execute`` records spans in a traced run, from the set-up's
    target to the window's close, and turns the recorder off again; a run
    without a trace records none.  The traced and untraced requests are
    the window's, split where the profiler stopped."""
    from aqc_research_tpu_torch.utils import profiling

    cpu = torch.device("cpu")
    short = _tiny(maxiter=2, warm_iters=1)   # the profiler slows the CPU's many small ops
    run = cell.execute(short, 11, 0.0, True, cpu)
    assert not profiling.spans_on()
    snap = S.recorded(run)
    assert snap is not None and run.trace is not None and run.trace.window_s >= cell.TRACE_MIN_S
    traced, untraced = S.traced_requests(run, snap), S.untraced_requests(run, snap)
    assert len(traced) >= 1 and len(untraced) >= 1 and len(traced) + len(untraced) == len(run.horizons)
    assert len(S.iterations(snap, untraced)) == run.untraced_iters > 0
    assert spec.reader("target_s")(run) > 0 and spec.reader("boundary_ms_per_iter")(run) > 0
    assert any(n.startswith("spans: untraced ms/iter") for n in run.notes)
    assert cell.execute(short, 12, 0.0, False, cpu).spans is None
    assert not profiling.spans_on()


def test_a_small_run_with_spans_on(_restore_config):
    """The tiny cell on the CPU with the recorder on: every span reader but
    the device-timed ones reads, and the warm horizon and the check stay
    out of the window's requests."""
    from aqc_research_tpu_torch.utils import profiling

    s = _tiny()
    cpu = torch.device("cpu")
    profiling.enable_spans()
    try:
        state = s.runner.setup(s, cpu)
        run = cell.Run(s, 5, cpu)
        cell.window(run, state, 0.0, False, 2)
        s.runner.outputs(state, run)
        s.runner.release(state)
        read = {name: spec.reader(name)(run) for name in NEW}
    finally:
        profiling.disable_spans()
        profiling.reset_spans()
    iters = sum(h.iters for h in run.horizons)
    assert len(S.untraced_requests(run, run.spans)) == len(run.horizons) == 2
    assert len(S.iterations(run.spans, S.untraced_requests(run, run.spans))) == iters > 0
    assert read["boundary_ms_per_iter"] > 0 and read["target_s"] > 0
    assert read["host_reads_per_iter"] >= 2
    # The CPU has no device time.
    assert read["linesearch_ms_per_iter"] is read["grad_ms_per_iter"] is read["host_loop_ms_per_iter"] is None
