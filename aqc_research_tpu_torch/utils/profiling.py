"""Profiling of the port (twin of ``aqc_research_tpu/utils/profiling.py``).

A host clock alone measures the enqueue on a GPU (PyTorch returns before the
device finishes), so:

* :func:`trace` — a ``torch.profiler`` window (CPU and, where present, CUDA
  activity) written as a Chrome / Perfetto trace, with its
  ``key_averages()`` table kept;
* the span recorder — named intervals and counters at the program's layer
  boundaries (the horizon, the L-BFGS iteration, its line search and
  gradient, host reads, program replays, target generation).

The recorder is off by default and switched by a call
(:func:`enable_spans`, :func:`disable_spans`, :func:`spans_on`).  Off,
:func:`span` returns one shared no-op context after a single check and
:func:`count` returns at once: nothing is recorded or kept.  On, a span
records its name, an id, its parent's id (the innermost span open when it
opened), its request id (the id of the innermost enclosing
:func:`request` span: the horizon it belongs to), ``perf_counter_ns`` at
its start and end, and its attributes (an :func:`instant` is a span of
no wall); a counter's increment is added to the process's total and to
the innermost open span's ``counts``.  A
:func:`device_span` on a CUDA device also records a pair of timing events
on the current stream (from a pool), which :func:`snapshot` resolves to
device milliseconds once the caller has synchronised: nothing waits on the
device while spans record.  The recorder serves one thread.

:func:`snapshot` hands the closed spans and the counters over and drops
them, with every time on the profiler's clock (``time.time_ns()``, the
clock ``torch.profiler`` stamps its events with): the offset between the
two clocks is taken once, at :func:`enable_spans`.  No span belongs inside
a function that a device program captures (``ops/cuda_graphs``): it would
run at the capture, not at the replays.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter
from time import perf_counter_ns
from typing import List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("traces/run") as prof: ...`` records a profiler trace of
    the block into ``log_dir/trace.json`` (Chrome / Perfetto) and leaves the
    profiler (``prof.key_averages()``) for the caller."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# -----------------------------------------------------------------------------
# The span recorder.
# -----------------------------------------------------------------------------

_ON = False


class _Recorder:
    """The spans and counters of this process: the open spans (a stack),
    the closed ones, the counters' totals, the free timing events and the
    offset of the profiler's clock."""

    def __init__(self):
        self.stack: List["_Span"] = []
        self.closed: List["_Span"] = []
        self.counters: Counter = Counter()
        self.events: list = []
        self.next_id = 1
        self.offset_ns = 0


_REC = _Recorder()


class _NoSpan:
    """The context :func:`span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "is_request", "device", "id", "parent", "request", "start", "end", "counts",
                 "events")

    def __init__(self, name: str, attrs: dict, is_request: bool = False, device=None):
        self.name = name
        self.attrs = attrs
        self.is_request = is_request
        self.device = device
        self.counts = None
        self.events = None

    def __enter__(self) -> "_Span":
        rec = _REC
        outer = rec.stack[-1] if rec.stack else None
        self.id = rec.next_id
        rec.next_id += 1
        self.parent = outer.id if outer is not None else None
        self.request = self.id if self.is_request else (outer.request if outer is not None else None)
        rec.stack.append(self)
        if self.device is not None:
            self.events = (_event(), _event())
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        rec = _REC
        rec.stack.remove(self)
        rec.closed.append(self)
        return False

    @property
    def seconds(self) -> float:
        """The span's wall time (once closed)."""
        return (self.end - self.start) * 1e-9


def _event():
    pool = _REC.events
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


def enable_spans() -> None:
    """Spans and counters record from here on; takes the offset of the
    profiler's clock."""
    global _ON
    _REC.offset_ns = time.time_ns() - perf_counter_ns()
    _ON = True


def disable_spans() -> None:
    """Nothing records from here on; what was recorded stays until
    :func:`snapshot` or :func:`reset_spans`."""
    global _ON
    _ON = False


def spans_on() -> bool:
    return _ON


def span(name: str, **attrs):
    """``with span("lbfgs.grad"): ...`` records the block as a span (the
    ``as`` target is the span, or None while spans are off)."""
    if not _ON:
        return _NO_SPAN
    return _Span(name, attrs)


def request(name: str, **attrs):
    """A span that opens a request: the spans inside it carry its id as
    their request id."""
    if not _ON:
        return _NO_SPAN
    return _Span(name, attrs, is_request=True)


def instant(name: str, **attrs) -> None:
    """Records a span of no wall at this instant, inside the innermost open
    span, while spans are on: an event that a reader counts among the spans
    of its name and that adds nothing to any wall."""
    if not _ON:
        return
    sp = _Span(name, attrs)
    with sp:
        pass
    sp.end = sp.start


def device_span(name: str, device: torch.device, **attrs):
    """A span that, on a CUDA ``device``, also records a timing event on the
    current stream when it opens and when it closes: :func:`snapshot` gives
    its device milliseconds.  Elsewhere a plain span."""
    if not _ON:
        return _NO_SPAN
    return _Span(name, attrs, device=device if device.type == "cuda" else None)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` (and to the innermost open span's
    ``counts``) while spans are on."""
    if not _ON:
        return
    _REC.counters[name] += n
    stack = _REC.stack
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n


def settle(device) -> None:
    """While spans are on, waits for a CUDA ``device``, so that the open
    spans' walls hold its work; off, returns at once."""
    if _ON and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def snapshot() -> dict:
    """The closed spans (ordered by id) and the counters recorded since the
    last snapshot or reset, as plain data; drops them from the recorder.

    ``{"spans": [{"id", "parent", "request", "name", "start_ns", "end_ns",
    "attrs", "counts", "device_ms"}], "counters": {name: n}}``, times on the
    profiler's clock.  ``device_ms`` is None for a span without timing
    events; resolving the others waits for their closing events."""
    rec = _REC
    off = rec.offset_ns
    out = []
    for sp in sorted(rec.closed, key=lambda s: s.id):
        ms: Optional[float] = None
        if sp.events is not None:
            start, end = sp.events
            end.synchronize()
            ms = start.elapsed_time(end)
            rec.events.extend(sp.events)
        out.append({"id": sp.id, "parent": sp.parent, "request": sp.request, "name": sp.name,
                    "start_ns": sp.start + off, "end_ns": sp.end + off, "attrs": dict(sp.attrs),
                    "counts": dict(sp.counts or {}), "device_ms": ms})
    counters = dict(rec.counters)
    rec.closed = []
    rec.counters = Counter()
    return {"spans": out, "counters": counters}


def reset_spans() -> None:
    """Drops every closed span and counter (open spans stay open)."""
    for sp in _REC.closed:
        if sp.events is not None:
            _REC.events.extend(sp.events)
    _REC.closed = []
    _REC.counters = Counter()
