"""The program's spans in a run (the recorder of
``aqc_research_tpu_torch/utils/profiling.py``) and the arithmetic the span
readers share: the window's traced and untraced requests, the spans under
a span, cover and self time, the innermost span at an instant.

A traced run records spans from before the kernel library loads until the
window has closed (``cell.execute``), and the window keeps the recorder's
snapshot as ``run.spans``.  The window's requests are the top-level spans
named by the runner's ``REQUEST`` that lie between the times the window
records: its start, the start of its untraced part and its end.  Where
nothing was recorded, the span readers return None.

Span times are nanoseconds on the profiler's clock (``time.time_ns()``)."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

ITERATION, REPLAY = "lbfgs.iteration", "program.replay"


def recorded(run) -> Optional[dict]:
    """The program's spans of this run, or None where none was recorded."""
    snap = run.spans
    return snap if snap and snap["spans"] else None


def wall_ns(s: dict) -> int:
    return s["end_ns"] - s["start_ns"]


def _requests(run, snap: dict, start_ns: int, end_ns: int) -> List[dict]:
    name = run.spec.runner.REQUEST
    return [s for s in snap["spans"] if s["name"] == name and s["parent"] is None
            and start_ns <= s["start_ns"] and s["end_ns"] <= end_ns]


def traced_requests(run, snap: dict) -> List[dict]:
    """The request spans of the window's traced part, in order."""
    return _requests(run, snap, run.window_start_ns, run.untraced_start_ns)


def untraced_requests(run, snap: dict) -> List[dict]:
    """The request spans of the window's untraced part (all of the window
    in a run without a trace), in order."""
    return _requests(run, snap, run.untraced_start_ns, run.window_end_ns)


def of_requests(snap: dict, requests: List[dict]) -> List[dict]:
    """Every span recorded inside the given requests (their request ids)."""
    ids = {r["id"] for r in requests}
    return [s for s in snap["spans"] if s["request"] in ids]


def iterations(snap: dict, requests: List[dict]) -> List[dict]:
    """The L-BFGS iterations the requests ran themselves (a watchdog's
    re-run, inside ``asp.watchdog``, is the horizon's boundary)."""
    ids = {r["id"] for r in requests}
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
    requests' boundary (their wall outside their iterations), and the host
    loop (the iterations' wall outside their replays' device time)."""
    requests = untraced_requests(run, snap)
    spans = of_requests(snap, requests)
    its = iterations(snap, requests)
    if not its:
        return None
    n = len(its)
    ls, grad = replay_ms(spans, under="lbfgs.linesearch"), replay_ms(spans, under="lbfgs.grad")
    boundary = sum(self_ns(r, [i for i in its if i["parent"] == r["id"]]) for r in requests) * 1e-6
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
    requests' replay spans (the median of the differences; each replay's
    launch follows its span's start by its input copies)."""
    if run.trace is None:
        return None
    spans = of_requests(snap, traced_requests(run, snap))
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
    spans = of_requests(snap, traced_requests(run, snap))
    by_id = {s["id"]: s for s in spans}
    out = []
    for length, start in gaps:
        s = innermost_at(spans, origin + (start + length / 2) * 1e9)
        parent = by_id.get(s["parent"]) if s is not None else None
        name = None if s is None else (
            f"{s['name']} ({s['attrs']['program']})" if "program" in s["attrs"] else s["name"])
        label = "outside the requests" if s is None else (
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
        spans = of_requests(snap, untraced_requests(run, snap))
        dev = replay_ms(spans)
        if dev is not None and run.trace is not None and run.traced_iters:
            notes.append(f"spans: replays' device ms/iter {dev / split['iterations']} against the traced busy "
                         f"ms/iter {1e3 * run.trace.busy_s() / run.traced_iters}")
    gaps = idle_gaps_by_span(run, snap)
    if gaps:
        notes.append(f"spans: traced idle gaps by span {gaps}")
    return notes
