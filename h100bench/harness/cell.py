"""One run of one cell: set-up, the measured window, the traced window,
and what the program produced, handed to the check and the readers.

The cell's runner (``runners/<runner>.py``, found by ``spec.cell_spec``)
knows the program; this module knows only what every runner shares: the
window runs the runner's requests back to back, request k from the seed's
start k, none started once ``seconds`` have passed.  In a traced run the
program's span recorder is on from before the kernel library loads until
the window has closed.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import spans as S
from . import traffic as T
from .spec import CellSpec
from .tracetab import TraceTable

TRACE_MIN_S = 3.0   # the traced window: whole requests from the window's start, at least this long


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Horizon:
    x0: np.ndarray
    thetas: np.ndarray   # a runner may hand a device tensor; the window moves it to the host once closed
    fobj: float
    iters: int
    watchdog: int
    f0: float = math.nan   # the program's value at the start point


@dataclasses.dataclass
class Run:
    spec: CellSpec
    seed: int
    device: torch.device
    setup_s: float = math.nan
    window_s: float = math.nan
    horizons: List[Horizon] = dataclasses.field(default_factory=list)   # every lane of every request, in order
    programs: List[dict] = dataclasses.field(default_factory=list)
    work: dict = dataclasses.field(default_factory=dict)   # (flops, bytes) of one evaluation, by kind
    built_kernels: bool = False   # this run built the kernel library (a checkout's first run)
    library_s: float = 0.0        # the library's load, its build included
    trace: Optional[TraceTable] = None
    traced_iters: int = 0
    traced_evals: dict = dataclasses.field(default_factory=dict)
    # The part of a traced run's window after the profiler has stopped.
    untraced_s: float = 0.0
    untraced_iters: int = 0
    untraced_evals: dict = dataclasses.field(default_factory=dict)
    # The window's start, the untraced part's start (the window's start in a
    # run without a trace) and the window's end, on the spans' clock.
    window_start_ns: int = 0
    untraced_start_ns: int = 0
    window_end_ns: int = 0
    spans: Optional[dict] = None   # the program's spans and counters, where the recorder was on
    memory_peak_bytes: int = 0
    outputs: dict = dataclasses.field(default_factory=dict)   # what the runner's readings compare
    sample: List[int] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)   # printed on standard error


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _evals(before: dict, after: dict) -> dict:
    out = {}
    for key, (kind, n) in after.items():
        out[kind] = out.get(kind, 0) + n - before.get(key, (kind, 0))[1]
    return out


def kernel_library(device: torch.device) -> Tuple[bool, float]:
    """Loads the program's kernel library from its build cache in the
    checkout; returns whether this run had to build it, and the seconds the
    load (and the build) took."""
    if device.type != "cuda":
        return False, 0.0
    from aqc_research_tpu_torch.ops import cuda_build

    before = set(cuda_build.BUILD_DIR.glob("*.so"))
    tic = time.perf_counter()
    cuda_build.load()
    return set(cuda_build.BUILD_DIR.glob("*.so")) != before, time.perf_counter() - tic


def window(run: Run, state, seconds: float, trace: bool, min_requests: int = 1) -> None:
    """The measured window: the runner's requests back to back, request k
    from the seed's start point k, at least ``min_requests``, none started
    once ``seconds`` have passed.  With ``trace`` the profiler records the
    first requests (at least ``TRACE_MIN_S``) and at least one request
    follows untraced.  Where the span recorder is on, its snapshot is taken
    once the window has closed."""
    runner, dev = run.spec.runner, run.device
    reps0 = runner.replays(state)
    prof = tr0_ns = tr1_ns = None
    tail = None   # (clock, replays, requests) where the untraced part of a traced window starts
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        tr0_ns = time.time_ns()
    requests: List[List[Horizon]] = []
    run.window_start_ns = run.untraced_start_ns = time.time_ns()
    t0 = time.perf_counter()

    def more() -> bool:
        if len(requests) < min_requests or time.perf_counter() - t0 < seconds:
            return True
        return prof is not None and (tail is None or tail[2] == len(requests))

    while more():
        requests.append(runner.request(state, run.seed, len(requests)))
        if prof is not None and tail is None and time.perf_counter() - t0 >= TRACE_MIN_S:
            sync(dev)
            tr1_ns = time.time_ns()
            prof.__exit__(None, None, None)
            run.traced_iters = sum(h.iters for r in requests for h in r)
            run.traced_evals = _evals(reps0, runner.replays(state))
            run.untraced_start_ns = time.time_ns()
            tail = (time.perf_counter(), runner.replays(state), len(requests))
    sync(dev)
    t1 = time.perf_counter()
    run.window_end_ns = time.time_ns()
    run.window_s = t1 - t0
    reps1 = runner.replays(state)
    if prof is not None:
        run.trace = TraceTable.from_profiler(prof, tr0_ns, tr1_ns)
        run.untraced_s = t1 - tail[0]
        run.untraced_iters = sum(h.iters for r in requests[tail[2]:] for h in r)
        run.untraced_evals = _evals(tail[1], reps1)
    run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    stats = runner.programs(state)
    run.programs = [dict(stats.get(key, {}), kind=kind, window_replays=n - reps0.get(key, (kind, 0))[1])
                    for key, (kind, n) in reps1.items()]
    run.horizons = [h for r in requests for h in r]
    for h in run.horizons:
        if isinstance(h.thetas, torch.Tensor):
            h.thetas = h.thetas.detach().double().cpu().numpy()
    run.sample = T.check_sample(len(run.horizons), [h.iters for h in run.horizons], run.spec.traffic, run.seed)
    _snapshot_spans(run)


def _snapshot_spans(run: Run) -> None:
    from aqc_research_tpu_torch.utils import profiling

    if not profiling.spans_on():
        return
    tic = time.perf_counter()
    run.spans = profiling.snapshot()
    run.notes.append(f"spans: {len(run.spans['spans'])} spans, snapshot in {time.perf_counter() - tic:.4f} s")
    if run.spans["spans"]:
        run.notes.extend(S.checks(run, run.spans))


def failed(run: Run) -> int:
    bad = 0
    for h in run.horizons:
        finite = math.isfinite(h.fobj) and bool(np.all(np.isfinite(h.thetas)))
        bad += int(not finite or not h.fobj < h.f0 or h.watchdog > 0)
    return bad


def execute(spec: CellSpec, seed: int, seconds: float, trace: bool, device: torch.device) -> Run:
    """Set-up, window, the program's outputs; the program's state is freed
    at the end.  A traced run records the program's spans from before the
    kernel library loads until the window has closed."""
    run = Run(spec, int(seed), device)
    runner = spec.runner
    profiling = None
    if trace:
        from aqc_research_tpu_torch.utils import profiling

        profiling.enable_spans()
    try:
        run.built_kernels, run.library_s = kernel_library(device)
        state = runner.setup(spec, device)
        run.setup_s = process_age_s()
        window(run, state, seconds, trace)
    finally:
        if profiling is not None:
            profiling.disable_spans()
            profiling.reset_spans()
    run.work = runner.work(spec)
    runner.outputs(state, run)
    runner.release(state)
    return run
