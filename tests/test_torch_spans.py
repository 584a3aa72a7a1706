"""The span recorder of ``utils/profiling.py`` and the spans the program
records, on the CPU:

* off (the default), a horizon leaves the recorder empty and makes no span,
  no timing event and no counter entry;
* nesting: parent ids, request ids (the enclosing ``request``), counts on
  the innermost span, attributes, snapshot and reset; an ``instant``, a
  span of no wall;
* the clock: under ``torch.profiler`` a span around ``torch.mm``, carried to
  the profiler's clock by ``snapshot``, holds the ``aten::mm`` event;
* the L-BFGS loop on a quadratic: one ``lbfgs.iteration`` per iteration, each
  with one ``lbfgs.linesearch`` and one ``lbfgs.grad``; an MPS horizon under
  the watchdog: ``host_reads`` is the loop's mask reads plus the watchdog's
  two, and the horizon's spans share its request id;
* a program on the CPU: a ``program.replay`` span per call, without device
  time;
* target generation: ``target.generate`` over ``target.t1_gt`` and
  ``target.t1``, the log line with the spans' timings."""

import time
import tracemalloc

import numpy as np
import pytest
import torch

from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu_torch.models.sp_lhs import jit_asp
from aqc_research_tpu_torch.models.sp_lhs import target_states as ts
from aqc_research_tpu_torch.ops import cuda_graphs as cg
from aqc_research_tpu_torch.optim import lbfgs
from aqc_research_tpu_torch.utils import profiling
from tests import _torch_threads  # noqa: F401

N, CHI, THR = 4, 4, 1e-6
BITS = tuple(1 if q % 2 == 0 else 0 for q in range(N))


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


@pytest.fixture(autouse=True)
def _spans_off_after():
    profiling.disable_spans()
    profiling.reset_spans()
    yield
    profiling.disable_spans()
    profiling.reset_spans()


def _target():
    return ts.first_horizon_mps_target(num_qubits=N, evol_time=0.4, num_trot_steps=1, delta=1.0, chi_max=CHI,
                                       trunc_thr=THR, second_order=True, device="cpu").t1


def _horizon(target, maxiter=3, route="native"):
    circ = TrotterAnsatz.make(N, make_trotter_like_circuit(N, 2), True)
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(-0.3, 0.3, circ.num_thetas), dtype=torch.float64)
    with config.svd_impl_override(route):
        return jit_asp.optimize_horizon_mps_jit(circ, x0, target, base_bits=BITS, trunc_thr=THR,
                                                fidelity_thr=0.9999, maxiter=maxiter)


def _by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_spans_off_record_and_allocate_nothing(monkeypatch):
    target = _target()
    assert not profiling.spans_on()

    def refuse(*args, **kwargs):
        raise AssertionError("the recorder made something while spans were off")

    monkeypatch.setattr(profiling, "_Span", refuse)
    monkeypatch.setattr(profiling, "_event", refuse)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        _horizon(target)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename") if d.size_diff > 0
             and d.traceback[0].filename == profiling.__file__]
    assert grown == []
    rec = profiling._REC
    assert rec.closed == [] and rec.stack == [] and not rec.counters and rec.events == []
    assert profiling.snapshot() == {"spans": [], "counters": {}}
    assert profiling.span("x") is profiling.span("y", a=1) is profiling.request("z")


def test_nesting_parents_requests_and_counts():
    profiling.enable_spans()
    with profiling.span("outside"):
        profiling.count("reads")
    with profiling.request("asp.horizon", route="jacobi") as h:
        with profiling.span("lbfgs.iteration") as it:
            with profiling.span("host.read"):
                profiling.count("reads", 2)
        with profiling.span("asp.watchdog") as wd:
            pass
    with profiling.request("asp.horizon") as h2:
        with profiling.span("lbfgs.init") as init:
            pass
    snap = profiling.snapshot()
    spans = {s["name"] + str(s["request"]): s for s in snap["spans"]}
    assert [s["id"] for s in snap["spans"]] == sorted(s["id"] for s in snap["spans"])
    out = spans["outsideNone"]
    assert out["parent"] is None and out["request"] is None and out["counts"] == {"reads": 1}
    assert spans[f"asp.horizon{h.id}"]["attrs"] == {"route": "jacobi"}
    assert spans[f"asp.horizon{h.id}"]["parent"] is None
    assert spans[f"lbfgs.iteration{h.id}"]["parent"] == h.id
    assert spans[f"lbfgs.iteration{h.id}"]["attrs"] == {}
    assert spans[f"host.read{h.id}"]["parent"] == it.id and spans[f"host.read{h.id}"]["counts"] == {"reads": 2}
    assert spans[f"asp.watchdog{h.id}"]["parent"] == h.id and wd.request == h.id
    assert spans[f"lbfgs.init{h2.id}"]["parent"] == h2.id and init.request == h2.id != h.id
    assert snap["counters"] == {"reads": 3}
    for s in snap["spans"]:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
    child = spans[f"host.read{h.id}"]
    parent = spans[f"lbfgs.iteration{h.id}"]
    assert parent["start_ns"] <= child["start_ns"] <= child["end_ns"] <= parent["end_ns"]
    # A snapshot hands the spans over; a reset drops them.
    assert profiling.snapshot() == {"spans": [], "counters": {}}
    with profiling.span("again"):
        profiling.count("reads")
    profiling.reset_spans()
    assert profiling.snapshot() == {"spans": [], "counters": {}}
    profiling.disable_spans()
    with profiling.span("off") as off:
        profiling.count("reads")
    assert off is None and profiling.snapshot() == {"spans": [], "counters": {}}


def test_an_instant_is_a_span_of_no_wall():
    profiling.instant("lbfgs.iteration", lane=1)
    assert profiling.snapshot() == {"spans": [], "counters": {}}
    profiling.enable_spans()
    with profiling.request("asp.horizon") as h:
        with profiling.span("lbfgs.iteration"):
            profiling.count("fleet_lanes", 2)
        profiling.instant("lbfgs.iteration", lane=1)
    req, step, mark = profiling.snapshot()["spans"]
    assert (req["name"], step["name"], mark["name"]) == ("asp.horizon", "lbfgs.iteration", "lbfgs.iteration")
    assert mark["parent"] == mark["request"] == h.id and mark["attrs"] == {"lane": 1} and mark["counts"] == {}
    assert step["end_ns"] <= mark["start_ns"] == mark["end_ns"] <= req["end_ns"]
    assert profiling._REC.stack == []


def test_spans_sit_on_the_profilers_clock():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    profiling.enable_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("before"):
            time.sleep(0.002)
        with profiling.span("mm"):
            torch.mm(a, b)
        with profiling.span("after"):
            time.sleep(0.002)
    snap = profiling.snapshot()
    (before,), (mm,), (after,) = (_by_name(snap, n) for n in ("before", "mm", "after"))
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(events) == 1
    slack = 50_000
    start, end = events[0].start_ns(), events[0].start_ns() + events[0].duration_ns()
    assert mm["start_ns"] - slack <= start <= end <= mm["end_ns"] + slack
    # ...and outside the spans around it.
    assert before["end_ns"] - slack <= start and end <= after["start_ns"] + slack


def test_iterations_split_into_linesearch_and_gradient(monkeypatch):
    """A quadratic through the one-lane loop: one ``lbfgs.iteration`` per
    iteration run, each holding one line search and one gradient, the
    ``host_reads`` counter equal to the loop's mask reads."""
    reads = []
    real = lbfgs._read_mask
    monkeypatch.setattr(lbfgs, "_read_mask", lambda m: reads.append(1) or real(m))
    scale = torch.linspace(1.0, 5.0, 6, dtype=torch.float64)
    fun = lambda x: (scale * x * x).sum()  # noqa: E731
    vgrad = lambda x: (fun(x), 2 * scale * x)  # noqa: E731
    profiling.enable_spans()
    res = lbfgs.minimize_lbfgs_compact(fun, torch.ones(6, dtype=torch.float64), maxiter=7,
                                       value_and_grad_fn=vgrad)
    snap = profiling.snapshot()
    iters = _by_name(snap, "lbfgs.iteration")
    assert res.num_iters == 7 and len(iters) == 7
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(iters, iters[1:]))
    for it in iters:
        kids = [s["name"] for s in snap["spans"] if s["parent"] == it["id"]]
        assert kids.count("lbfgs.linesearch") == 1 and kids.count("lbfgs.grad") == 1, kids
        # The stop-mask read that ends the iteration lies inside its span.
        assert kids.count("host.read") == 1 and kids[-1] == "host.read", kids
    (init,) = _by_name(snap, "lbfgs.init")
    assert init["end_ns"] <= iters[0]["start_ns"]
    assert snap["counters"]["host_reads"] == len(reads) == len(_by_name(snap, "host.read"))


def test_a_horizon_under_the_watchdog(monkeypatch):
    """An MPS horizon on the "jacobi" route (the CPU's watchdog checks it
    under "native"): its spans carry the horizon's request id, and
    ``host_reads`` is the loop's mask reads plus the watchdog's two."""
    target = _target()
    reads = []
    real = lbfgs._read_mask
    monkeypatch.setattr(lbfgs, "_read_mask", lambda m: reads.append(1) or real(m))
    profiling.enable_spans()
    res = _horizon(target, maxiter=3, route="jacobi")
    snap = profiling.snapshot()
    (h,) = _by_name(snap, "asp.horizon")
    assert h["attrs"] == {} and h["request"] == h["id"]
    inside = [s for s in snap["spans"] if s["request"] == h["id"]]
    assert all(h["start_ns"] <= s["start_ns"] <= s["end_ns"] <= h["end_ns"] for s in inside)
    names = [s["name"] for s in inside]
    assert names.count("lbfgs.iteration") == res.num_iters > 0
    assert names.count("lbfgs.init") == names.count("asp.watchdog") == 1
    (wd,) = _by_name(snap, "asp.watchdog")
    assert wd["parent"] == h["id"]
    assert snap["counters"]["host_reads"] == len(reads) + 2
    assert sum(s["counts"].get("host_reads", 0) for s in inside) == len(reads) + 2
    # Every evaluation is a program call; on the CPU it has no device time.
    replays = _by_name(snap, "program.replay")
    assert replays and all(s["device_ms"] is None and s["request"] == h["id"] for s in replays)
    under = {s["id"]: s["name"] for s in inside}
    assert {under[s["parent"]] for s in replays} <= {"lbfgs.init", "lbfgs.linesearch", "lbfgs.grad",
                                                      "asp.watchdog"}


def test_a_program_on_the_cpu_records_a_replay_per_call():
    prog = cg.GraphProgram(lambda x: x * 2, "double")
    x = torch.ones(3)
    profiling.enable_spans()
    for _ in range(3):
        prog(x)
    snap = profiling.snapshot()
    replays = _by_name(snap, "program.replay")
    assert len(replays) == 3 and prog.replays == 0
    assert all(s["attrs"] == {"program": "double"} and s["device_ms"] is None for s in replays)


def test_target_generation_spans(monkeypatch):
    lines = []
    monkeypatch.setattr(ts._logger, "info", lambda msg, *args: lines.append(msg % args))
    profiling.enable_spans()
    _target()
    snap = profiling.snapshot()
    (gen,) = _by_name(snap, "target.generate")
    (gt,) = _by_name(snap, "target.t1_gt")
    (t1,) = _by_name(snap, "target.t1")
    assert gt["parent"] == t1["parent"] == gen["id"] and gt["end_ns"] <= t1["start_ns"]
    assert gen["parent"] is None and [s["name"] for s in snap["spans"]] == ["target.generate", "target.t1_gt",
                                                                            "target.t1"]
    assert "timings: |t1_gt>" in lines[-1]
    profiling.disable_spans()
    _target()
    assert "fid(|t1>, |t1_gt>)" in lines[-1] and "timings" not in lines[-1]
