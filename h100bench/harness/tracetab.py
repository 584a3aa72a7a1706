"""The traced window as a table: device intervals (kernels, copies, sets)
and host intervals from ``torch.profiler``, and the reductions the readers
use.  Times are in seconds from the window's start."""

from __future__ import annotations

import re
from typing import Callable, List, Tuple

import numpy as np


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    if len(name) > 96 and "<" in name:   # long template arguments collapse
        name = name[: name.index("<")] + "<...>"
    return name


class TraceTable:
    def __init__(self, dev: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]], window_s: float):
        self.window_s = float(window_s)
        raw = [n for n, _, _ in dev]
        uniq = {n: i for i, n in enumerate(dict.fromkeys(raw))}
        self.names = [short_name(n) for n in uniq]          # per distinct kernel
        self.name_ids = np.asarray([uniq[n] for n in raw], dtype=np.int64)
        self.dev_start = np.asarray([s for _, s, _ in dev], dtype=np.float64)
        self.dev_end = np.asarray([e for _, _, e in dev], dtype=np.float64)
        self._busy = None
        self.host_names = [n for n, _, _ in host]
        self.host_start = np.asarray([s for _, s, _ in host], dtype=np.float64)
        self.host_end = np.asarray([e for _, _, e in host], dtype=np.float64)

    @classmethod
    def from_profiler(cls, prof, t0_ns: int, t1_ns: int) -> "TraceTable":
        """From a stopped ``torch.profiler.profile`` whose window ran from
        ``t0_ns`` to ``t1_ns`` (``time.time_ns()``, the profiler's clock)."""
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            start = (e.start_ns() - t0_ns) * 1e-9
            row = (e.name(), start, start + e.duration_ns() * 1e-9)
            (dev if "CUDA" in str(e.device_type()) else host).append(row)
        return cls(dev, host, (t1_ns - t0_ns) * 1e-9)

    def to_rows(self) -> dict:
        """The table as plain lists (to record it, and for the tests)."""
        return {"window_s": self.window_s,
                "device": [[self.names[i], float(s), float(e)]
                           for i, s, e in zip(self.name_ids, self.dev_start, self.dev_end)],
                "host": [[n, float(s), float(e)] for n, s, e in zip(self.host_names, self.host_start, self.host_end)]}

    @classmethod
    def from_rows(cls, rows: dict) -> "TraceTable":
        return cls([tuple(r) for r in rows["device"]], [tuple(r) for r in rows["host"]], rows["window_s"])

    def _durations(self) -> np.ndarray:
        return np.clip(self.dev_end, 0.0, self.window_s) - np.clip(self.dev_start, 0.0, self.window_s)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals inside the window."""
        if self._busy is None:
            s = np.clip(self.dev_start, 0.0, self.window_s)
            e = np.clip(self.dev_end, 0.0, self.window_s)
            order = np.argsort(s, kind="stable")
            out: List[Tuple[float, float]] = []
            for a, b in zip(s[order].tolist(), e[order].tolist()):
                if b <= a:
                    continue
                if out and a <= out[-1][1]:
                    if b > out[-1][1]:
                        out[-1] = (out[-1][0], b)
                else:
                    out.append((a, b))
            self._busy = out
        return self._busy

    def busy_s(self) -> float:
        return float(sum(b - a for a, b in self.busy_intervals()))

    def _by_name(self) -> np.ndarray:
        return np.bincount(self.name_ids, weights=self._durations(), minlength=len(self.names))

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose short name matches."""
        keep = np.asarray([match(n) for n in self.names], dtype=bool)
        return float(self._by_name()[keep].sum()) if keep.size else 0.0

    def top_ops(self, count: int = 10) -> List[List]:
        """The device operations that took most time, summed by name."""
        totals: dict = {}
        for n, t in zip(self.names, self._by_name().tolist()):
            totals[n] = totals.get(n, 0.0) + t
        return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> List[List]:
        """The longest stretches with nothing on the device, each named by
        the host operation that overlaps it most."""
        busy = self.busy_intervals()
        edges = [0.0] + [x for ab in busy for x in ab] + [self.window_s]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:count]
        out = []
        for length, start in gaps:
            end = start + length
            overlap = np.minimum(self.host_end, end) - np.maximum(self.host_start, start)
            label = "host"
            if overlap.size and overlap.max() > 0:
                label = self.host_names[int(np.argmax(overlap))]
            out.append([label, float(length)])
        return out


def matcher(*patterns: str) -> Callable[[str], bool]:
    rx = re.compile("|".join(patterns))
    return lambda name: rx.search(name) is not None
