"""Device programs: a function of tensors captured once as a CUDA graph and
replayed, the port's counterpart of the JAX package's ``jax.jit``.

A :class:`GraphProgram` holds one function at one signature (the shapes,
dtypes and device of its tensor arguments).  On CUDA its first call warms
the function up on a side stream (which fills every table the function
builds from host data: index tensors, gate constants, the rand route's
sketch), then captures one call into a ``torch.cuda.CUDAGraph`` with a
memory pool of its own and instantiates it; every call copies its tensors
into the graph's static inputs, replays the graph and returns clones of
the static outputs, since the next replay overwrites them.  A failed
capture or replay raises: a program never carries on eagerly by itself.
On the CPU a program is its function, called eagerly.  Inside
:func:`eager` programs call their functions eagerly on CUDA too (the
comparisons against the graphs; the counterpart of ``jax.disable_jit``).

While a program's function runs (warm-up, capture, or an eager call),
:func:`tracing` is True: code on the path then reads no device value and
leaves its once-per-program checks to where the program is built, as the
JAX package's code does under tracing.

:class:`ProgramCache` keys programs by signature and a caller's key, as
``jax.jit`` retraces per shape.  The hand-written kernels' wrappers count a
launch when they are called, so inside a graph they count at capture, not
at replay: a program records the launches its capture made
(:data:`captured`), and every replay adds them to :data:`replayed`, the
ledger ``chip_smoke.py`` adds to the wrappers' counts.

While spans are on (``utils/profiling``), every call of a program is a
``program.replay`` span timed on the device by a pair of CUDA events (input
copies, replay and output clones; an eager call on the CPU has no device
time).  A capture is timed by :meth:`GraphProgram.stats`.

:func:`device_table` holds host data (index lists, gate constants) as
tensors built once per (values, dtype, device): a captured region may not
copy from the host.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from collections import Counter
from typing import Callable, Hashable, Optional, Sequence, Tuple

import torch

from ..utils import profiling

_TRACING = 0
_EAGER = 0

#: Kernel launches recorded into graphs at capture (they run only on
#: replay), keyed ``(wrapper,)``, ``(wrapper, "at", n)``, ``(wrapper,
#: "home", home)`` and ``(wrapper, "schedule", schedule)`` like the
#: wrappers' ``launches``, ``launches_at``, ``launches_home`` and
#: ``launches_by_schedule``.
captured: Counter = Counter()
#: Kernel launches made by graph replays, keyed as :data:`captured`.
replayed: Counter = Counter()

_TABLES: dict = {}


def tracing() -> bool:
    """True while a program's function runs (its warm-up, its capture or
    an eager call): no device read, checks left to the program's build."""
    return _TRACING > 0


@contextlib.contextmanager
def _traced():
    global _TRACING
    _TRACING += 1
    try:
        yield
    finally:
        _TRACING -= 1


@contextlib.contextmanager
def eager():
    """Programs called inside run their functions eagerly on CUDA too."""
    global _EAGER
    _EAGER += 1
    try:
        yield
    finally:
        _EAGER -= 1


def device_table(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype, device)`` built once per (values,
    dtype, device) and shared by every caller, which must not write to it.
    ``values``: a (nested) tuple of numbers."""
    device = torch.device(device)
    key = (values, dtype, device)
    table = _TABLES.get(key)
    if table is None:
        table = torch.tensor(values, dtype=dtype, device=device)
        _TABLES[key] = table
    return table


def reset_launch_ledger() -> None:
    captured.clear()
    replayed.clear()


def _kernel_wrappers() -> dict:
    from .fused_pair import fused_pair, theta_build
    from .fused_rand import rand_tail
    from .householder_qr import householder_qr
    from .jacobi_kernel import jacobi_rows

    return {"jacobi_rows": jacobi_rows, "theta_build": theta_build, "rand_tail": rand_tail,
            "fused_pair": fused_pair, "householder_qr": householder_qr}


def _launch_snapshot() -> Counter:
    snap = Counter()
    for name, fn in _kernel_wrappers().items():
        snap[(name,)] = fn.launches
        for n, count in getattr(fn, "launches_at", {}).items():
            snap[(name, "at", n)] = count
        for home, count in getattr(fn, "launches_home", {}).items():
            snap[(name, "home", home)] = count
        for schedule, count in getattr(fn, "launches_by_schedule", {}).items():
            snap[(name, "schedule", schedule)] = count
    return snap


def kernel_launches(counts: Counter) -> dict:
    """Launches per kernel wrapper from a ledger's keys."""
    return {key[0]: n for key, n in counts.items() if len(key) == 1 and n}


@contextlib.contextmanager
def _cusolver():
    """cuSOLVER for torch.linalg inside a capture: MAGMA's hybrid
    factorizations do host work that a graph cannot hold."""
    previous = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(previous)


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a captured graph (the driver's ``cuGraphGetNodes``)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return int(count.value)


def _pool_bytes(pool) -> int:
    """Bytes the caching allocator holds for one graph memory pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _signature(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def _outputs(out) -> Tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


class GraphProgram:
    """``fn(*tensors) -> tensor or tuple of tensors`` at one signature: a
    CUDA graph on CUDA tensors (captured at the first call), the function
    itself on the CPU or inside :func:`eager`.  After the capture the
    program knows its ``nodes``, ``warmup_s``, ``capture_s``,
    ``instantiate_s``, ``pool_bytes`` and per-call ``launches``; ``replays``
    counts its calls."""

    def __init__(self, fn: Callable, name: str = "program"):
        self.fn = fn
        self.name = name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pool = None
        self.static_in: Tuple[torch.Tensor, ...] = ()
        self.static_out: Tuple[torch.Tensor, ...] = ()
        self.single = True
        self.launches: Counter = Counter()
        self.replays = 0
        self.nodes = self.capture_s = self.instantiate_s = self.warmup_s = self.pool_bytes = None

    def __call__(self, *tensors: torch.Tensor):
        dev = tensors[0].device
        graphed = dev.type == "cuda" and not _EAGER
        if graphed and self.graph is None:
            self.capture(tensors)
        with profiling.device_span("program.replay", dev, program=self.name):
            if not graphed:
                with _traced():
                    return self.fn(*tensors)
            for static, t in zip(self.static_in, tensors):
                static.copy_(t)
            self.graph.replay()
            self.replays += 1
            replayed.update(self.launches)
            outs = tuple(o.clone() for o in self.static_out)
            return outs[0] if self.single else outs

    def capture(self, tensors: Sequence[torch.Tensor]) -> None:
        """Warm-up on a side stream, capture into a pool of the program's
        own, instantiate; raises if any step fails."""
        dev = tensors[0].device
        with torch.cuda.device(dev):
            self.static_in = tuple(t.detach().clone() for t in tensors)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            tic = time.perf_counter()
            with _traced(), _cusolver(), torch.cuda.stream(side):
                self.fn(*self.static_in)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            self.warmup_s = time.perf_counter() - tic
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            self.pool = torch.cuda.graph_pool_handle()
            before = _launch_snapshot()
            tic = time.perf_counter()
            try:
                with _traced(), _cusolver(), torch.cuda.graph(graph, pool=self.pool):
                    out = self.fn(*self.static_in)
            except Exception as err:
                raise RuntimeError(f"{self.name}: CUDA graph capture failed: {err}") from err
            self.capture_s = time.perf_counter() - tic
            self.launches = _launch_snapshot() - before
            captured.update(self.launches)
            self.single = not isinstance(out, tuple)
            self.static_out = _outputs(out)
            self.nodes = _graph_nodes(graph)
            tic = time.perf_counter()
            graph.instantiate()
            torch.cuda.synchronize(dev)
            self.instantiate_s = time.perf_counter() - tic
            self.graph = graph
            self.pool_bytes = _pool_bytes(self.pool)

    def stats(self) -> dict:
        return {"name": self.name, "nodes": self.nodes, "warmup_s": self.warmup_s, "capture_s": self.capture_s,
                "instantiate_s": self.instantiate_s, "pool_bytes": self.pool_bytes, "replays": self.replays,
                "launches": kernel_launches(self.launches)}

    def release(self) -> None:
        """Frees the graph and its static tensors (the pool goes with them)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.pool = None
        self.static_in = self.static_out = ()


class ProgramCache:
    """One function, a :class:`GraphProgram` per signature and caller key
    (``jax.jit``'s cache)."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self.programs: dict = {}

    def entry(self, tensors: Sequence[torch.Tensor], key: Hashable = ()) -> GraphProgram:
        sig = (_signature(tensors), key)
        prog = self.programs.get(sig)
        if prog is None:
            prog = self.programs[sig] = GraphProgram(self.fn, self.name)
        return prog

    def release(self) -> None:
        for prog in self.programs.values():
            prog.release()
        self.programs.clear()
