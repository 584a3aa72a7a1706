"""Profiling helpers (twin of ``aqc_research_tpu/utils/profiling.py``).

A host clock alone measures the enqueue on a GPU (PyTorch returns before the
device finishes), so:

* :func:`trace` — a ``torch.profiler`` window (CPU and, where present, CUDA
  activity) written as a Chrome / Perfetto trace, with its
  ``key_averages()`` table kept;
* :func:`device_timer` — wall time of a block that ends in
  ``torch.cuda.synchronize`` on the device of the tensors it produced;
* :func:`time_jitted` — steady-state seconds per call of a callable (warm-up
  calls first, then repeats, synchronised at both ends).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from time import perf_counter
from typing import Any, Callable, Tuple

import torch


def _devices(tree: Any):
    """The CUDA devices of the tensors in a result (nested lists, tuples,
    dicts and dataclasses such as an MPS)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_devices(leaf) for leaf in tree))
    return set()


def _block(tree: Any) -> None:
    for dev in _devices(tree):
        torch.cuda.synchronize(dev)


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


@contextlib.contextmanager
def device_timer(label: str, results: dict):
    """Times a block and waits for the device of ``results['out']`` (set
    inside the block); the seconds land in ``results[label]``."""
    tic = perf_counter()
    try:
        yield results
    finally:
        _block(results.get("out"))
        results[label] = perf_counter() - tic


def time_jitted(fn: Callable, *args, repeats: int = 10, warmup: int = 1) -> Tuple[float, Any]:
    """Returns (seconds per call in steady state, last result)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _block(out)
    tic = perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    _block(out)
    return (perf_counter() - tic) / repeats, out
