"""The program's spans in a run (the recorder of
``aqc_research_tpu_torch/utils/profiling.py``) and the arithmetic the span
readers share: the window's untraced horizons, the spans under a span,
cover and self time, the innermost span at an instant.

The span readers are the first of the benchmark's code that a run executes
(``spec.cell_spec`` loads every reader before the set-up starts), so the
recorder is switched on here, when this module is imported, in a traced run
of ``run.py`` (``--trace 1``) and in no other process: a ``--trace 0`` run,
a test or another script that imports it records nothing.  This is a
stopgap until ``cell.execute``, which owns the run's ``trace``, switches the
recorder on itself and snapshots it after the window's final sync; until
then spans stay on for the whole process (set-up, window and check), the
readers find the window's horizons by counting, and a traced run started
other than as ``run.py`` reads no span.  A program that has no recorder
records nothing either, and the span readers then return None.

Span times are nanoseconds on the profiler's clock (``time.time_ns()``)."""

from __future__ import annotations

import os
import statistics
import sys
import time
from typing import Dict, List, Optional

HORIZON, ITERATION, REPLAY = "asp.horizon", "lbfgs.iteration", "program.replay"


def _profiling():
    """The program's ``utils.profiling`` if it has the span recorder."""
    try:
        from aqc_research_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "snapshot") else None


def traced_benchmark_run(argv: List[str]) -> bool:
    """True for the arguments of a ``run.py`` process with ``--trace 1``."""
    if not argv or os.path.basename(argv[0]) != "run.py":
        return False
    for i, arg in enumerate(argv[1:], 1):
        value = arg.split("=", 1)[1] if arg.startswith("--trace=") else (
            argv[i + 1] if arg == "--trace" and i + 1 < len(argv) else None)
        if value is not None:
            return value.strip().isdigit() and int(value) == 1
    return False


if traced_benchmark_run(sys.argv) and _profiling() is not None:
    _profiling().enable_spans()


def recorded(run) -> Optional[dict]:
    """The program's spans of this run: the recorder's snapshot, taken at the
    first reader that asks (after the window and the check's replays) and
    kept as ``run.spans``; None where nothing was recorded."""
    snap = getattr(run, "spans", None)
    if snap is None:
        prof = _profiling()
        if prof is None or not prof.spans_on():
            return None
        tic = time.perf_counter()
        snap = prof.snapshot()
        run.spans = snap
        run.notes.append(f"spans: {len(snap['spans'])} spans, snapshot in {time.perf_counter() - tic:.4f} s")
        if snap["spans"]:
            run.notes.extend(checks(run, snap))
    return snap if snap and snap["spans"] else None


def wall_ns(s: dict) -> int:
    return s["end_ns"] - s["start_ns"]


def window_horizons(run, snap: dict) -> List[dict]:
    """The window's horizon spans, in order: the last ``len(run.horizons)``
    top-level ``asp.horizon`` spans (the set-up's warm horizon comes
    before them; the check runs no horizon)."""
    tops = [s for s in snap["spans"] if s["name"] == HORIZON and s["parent"] is None]
    n = len(run.horizons)
    return tops[len(tops) - n:] if n and len(tops) >= n else []


def _traced_count(run) -> int:
    """How many of the window's horizons the profiler recorded."""
    if run.trace is None:
        return 0
    done = k = 0
    while k < len(run.horizons) and done < run.traced_iters:
        done += run.horizons[k].iters
        k += 1
    return k


def untraced_horizons(run, snap: dict) -> List[dict]:
    """The horizon spans of the window's untraced part (all of the window
    in a run without a trace)."""
    return window_horizons(run, snap)[_traced_count(run):]


def traced_horizons(run, snap: dict) -> List[dict]:
    return window_horizons(run, snap)[:_traced_count(run)]


def of_requests(snap: dict, horizons: List[dict]) -> List[dict]:
    """Every span recorded inside the given horizons (their request ids)."""
    ids = {h["id"] for h in horizons}
    return [s for s in snap["spans"] if s["request"] in ids]


def iterations(snap: dict, horizons: List[dict]) -> List[dict]:
    """The L-BFGS iterations the horizons ran themselves (a watchdog's
    re-run, inside ``asp.watchdog``, is the horizon's boundary)."""
    ids = {h["id"] for h in horizons}
    return [s for s in snap["spans"] if s["name"] == ITERATION and s["parent"] in ids]


def has_ancestor(s: dict, name: str, by_id: Dict[int, dict]) -> bool:
    parent = by_id.get(s["parent"])
    while parent is not None:
        if parent["name"] == name:
            return True
        parent = by_id.get(parent["parent"])
    return False


def replay_ms(spans: List[dict], under: Optional[str] = None, within: Optional[dict] = None) -> Optional[float]:
    """Device milliseconds of the ``program.replay`` spans among ``spans``:
    those under a span named ``under``, or those inside the span ``within``
    (None where a replay has no device time)."""
    by_id = {s["id"]: s for s in spans}
    total = 0.0
    for s in spans:
        if s["name"] != REPLAY:
            continue
        if under is not None and not has_ancestor(s, under, by_id):
            continue
        if within is not None and not (within["start_ns"] <= s["start_ns"] and s["end_ns"] <= within["end_ns"]):
            continue
        if s["device_ms"] is None:
            return None
        total += s["device_ms"]
    return total


def cover_ns(parent: dict, children: List[dict]) -> int:
    """The part of ``parent``'s interval that the children's intervals
    cover (their union, clipped to the parent)."""
    cut = sorted((max(c["start_ns"], parent["start_ns"]), min(c["end_ns"], parent["end_ns"])) for c in children)
    total, end = 0, None
    for a, b in cut:
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def self_ns(parent: dict, children: List[dict]) -> int:
    """A span's self time: its wall minus its children's cover."""
    return wall_ns(parent) - cover_ns(parent, children)


def innermost_at(spans: List[dict], t_ns: float) -> Optional[dict]:
    """The innermost span open at ``t_ns`` (spans nest, so the one of the
    latest start among those that hold the instant)."""
    best = None
    for s in spans:
        if s["start_ns"] <= t_ns <= s["end_ns"] and (best is None or s["start_ns"] >= best["start_ns"]):
            best = s
    return best


def untraced_split(run, snap: dict) -> Optional[dict]:
    """The untraced iterations' time in ms per iteration, by part: replays'
    device time under the line search and under the gradient, the
    horizons' boundary (their wall outside their iterations), and the host
    loop (the iterations' wall outside their replays' device time)."""
    horizons = untraced_horizons(run, snap)
    spans = of_requests(snap, horizons)
    its = iterations(snap, horizons)
    if not its:
        return None
    n = len(its)
    ls, grad = replay_ms(spans, under="lbfgs.linesearch"), replay_ms(spans, under="lbfgs.grad")
    boundary = sum(self_ns(h, [i for i in its if i["parent"] == h["id"]]) for h in horizons) * 1e-6
    host = None
    inside = [replay_ms(spans, within=i) for i in its]
    if None not in inside:
        host = sum(wall_ns(i) * 1e-6 - d for i, d in zip(its, inside))
    per = {"iterations": n, "boundary": boundary / n,
           "host_reads": sum(s["counts"].get("host_reads", 0) for s in spans) / n}
    per["linesearch"] = None if ls is None else ls / n
    per["grad"] = None if grad is None else grad / n
    per["host_loop"] = None if host is None else host / n
    return per


def trace_origin_ns(run, snap: dict) -> Optional[float]:
    """Where the traced window's zero sits on the spans' clock: the
    profiler's ``cudaGraphLaunch`` calls paired in order with the traced
    horizons' replay spans (the median of the differences; each replay's
    launch follows its span's start by its input copies)."""
    if run.trace is None:
        return None
    spans = of_requests(snap, traced_horizons(run, snap))
    starts = sorted(s["start_ns"] for s in spans if s["name"] == REPLAY)
    launches = sorted(t for n, t in zip(run.trace.host_names, run.trace.host_start.tolist())
                      if n == "cudaGraphLaunch")
    pairs = list(zip(starts, launches))
    if not pairs:
        return None
    if len(starts) != len(launches):
        pairs = pairs[:1]
    return statistics.median(s - t * 1e9 for s, t in pairs)


def idle_gaps_by_span(run, snap: dict, count: int = 10) -> List[list]:
    """The traced window's longest device-idle gaps, each named by the
    innermost program span open at its middle (a replay with its program's
    name) and that span's parent."""
    origin = trace_origin_ns(run, snap)
    if origin is None:
        return []
    busy = run.trace.busy_intervals()
    edges = [0.0] + [x for ab in busy for x in ab] + [run.trace.window_s]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:count]
    spans = of_requests(snap, traced_horizons(run, snap))
    by_id = {s["id"]: s for s in spans}
    out = []
    for length, start in gaps:
        s = innermost_at(spans, origin + (start + length / 2) * 1e9)
        parent = by_id.get(s["parent"]) if s is not None else None
        name = None if s is None else (
            f"{s['name']} ({s['attrs']['program']})" if "program" in s["attrs"] else s["name"])
        label = "outside the horizons" if s is None else (
            name if parent is None else f"{name} in {parent['name']}")
        out.append([label, length])
    return out


def checks(run, snap: dict) -> List[str]:
    """Notes for the run's standard error: the untraced split against the
    untraced wall per iteration, the replays' device time per iteration
    against the traced busy time, and the traced idle gaps by span."""
    notes = []
    split = untraced_split(run, snap)
    if split is not None:
        parts = [split[k] for k in ("linesearch", "grad", "boundary", "host_loop")]
        total = sum(parts) if None not in parts else None
        wall = 1e3 * run.untraced_s / run.untraced_iters if run.untraced_iters else (
            1e3 * run.window_s / max(sum(h.iters for h in run.horizons), 1))
        notes.append(f"spans: untraced ms/iter over {split['iterations']} iterations: line search "
                     f"{split['linesearch']}, gradient {split['grad']}, boundary {split['boundary']}, host loop "
                     f"{split['host_loop']}; sum {total} against the wall {wall}")
        spans = of_requests(snap, untraced_horizons(run, snap))
        dev = replay_ms(spans)
        if dev is not None and run.trace is not None and run.traced_iters:
            notes.append(f"spans: replays' device ms/iter {dev / split['iterations']} against the traced busy "
                         f"ms/iter {1e3 * run.trace.busy_s() / run.traced_iters}")
    gaps = idle_gaps_by_span(run, snap)
    if gaps:
        notes.append(f"spans: traced idle gaps by span {gaps}")
    return notes
