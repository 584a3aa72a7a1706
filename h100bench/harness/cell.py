"""One run of one cell: set-up, the measured window, the traced window,
and what the program produced, handed to the check and the readers.

The window drives the program's main path,
``models.sp_lhs.jit_asp.optimize_horizon_mps_jit`` (compact L-BFGS over the
MPS fidelity objective and its co-sweep gradient, replayed as CUDA graphs,
the collapse watchdog at each horizon's end): horizons back to back, each
from a start point of its own, none started once ``seconds`` have passed.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from reference.circuit import neel_bits

from . import traffic as T
from .spec import CellSpec
from .tracetab import TraceTable

TRACE_MIN_S = 3.0   # the traced window: whole horizons from the window's start, at least this long


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
    thetas: np.ndarray
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
    horizons: List[Horizon] = dataclasses.field(default_factory=list)
    programs: List[dict] = dataclasses.field(default_factory=list)
    built_kernels: bool = False   # this run built the kernel library (a checkout's first run)
    library_s: float = 0.0        # the library's load, its build included
    trace: Optional[TraceTable] = None
    traced_iters: int = 0
    traced_evals: dict = dataclasses.field(default_factory=dict)
    # The part of a traced run's window after the profiler has stopped.
    untraced_s: float = 0.0
    untraced_iters: int = 0
    untraced_evals: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    port_target: tuple = ()
    port_grad: Optional[tuple] = None   # (fobj, grad) of the program's obj+grad at the first sampled start
    sample: List[int] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)   # printed on standard error


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kind(prog) -> str:
    return "obj_grad" if prog.name.endswith("obj+grad") else "value"


def _replays(jit_asp) -> dict:
    return {id(p): (p, p.replays) for p in jit_asp.mps_programs()}


def _evals(before: dict, after: dict) -> dict:
    out = {"value": 0, "obj_grad": 0}
    for key, (prog, n) in after.items():
        out[_kind(prog)] += n - before.get(key, (prog, 0))[1]
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


def setup(spec: CellSpec, device: torch.device):
    """The program, its target and its captured programs for this cell."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.models.sp_lhs.target_states import first_horizon_mps_target

    cfg, trf = spec.config, spec.traffic
    if device.type == "cpu":
        config.set_device("cpu")
    config.set_precision(cfg["precision"])
    config.require_full_f32_matmul()
    n, tgt = int(cfg["num_qubits"]), cfg["target"]
    config.set_svd_impl(tgt["route"])
    target = first_horizon_mps_target(
        num_qubits=n, evol_time=float(tgt["evol_time"]), num_trot_steps=int(tgt["trotter_steps"]),
        delta=float(tgt["delta"]), chi_max=int(cfg["chi"]), trunc_thr=float(cfg["trunc_thr"]),
        second_order=bool(cfg["second_order"]), device=device,
    ).t1
    config.set_svd_impl(trf["route"])
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, int(cfg["num_layers"])), bool(cfg["second_order"]))
    base = neel_bits(n)
    prog = {"circ": circ, "target": target, "base": base, "thr": float(cfg["trunc_thr"]),
            "route": trf["route"], "jit_asp": jit_asp, "dtype": config.real_dtype(),
            "trotter_point": T.trotter_point(cfg)}
    x = torch.as_tensor(prog["trotter_point"], dtype=prog["dtype"], device=device)
    jit_asp._mps_value_and_grad_program(circ, base, prog["thr"], prog["route"])(x, target)
    jit_asp._mps_value_program(circ, base, prog["thr"], prog["route"])(x, target)
    horizon(prog, x, trf, maxiter=int(trf["warm_iters"]))
    _sync(device)
    return prog


def horizon(prog, x0: torch.Tensor, trf: dict, maxiter: int):
    return prog["jit_asp"].optimize_horizon_mps_jit(
        prog["circ"], x0, prog["target"], base_bits=prog["base"], trunc_thr=prog["thr"],
        fidelity_thr=float(trf["fidelity_thr"]), maxiter=maxiter,
    )


def window(run: Run, prog, seconds: float, trace: bool, min_horizons: int = 1) -> list:
    """The measured window: horizons back to back, horizon k from the
    seed's start point k, at least ``min_horizons``, none started once
    ``seconds`` have passed.  With ``trace`` the profiler records the first
    horizons (at least ``TRACE_MIN_S``) and at least one horizon follows
    untraced.  Returns each horizon's start point on the device."""
    jit_asp, dev, trf = prog["jit_asp"], run.device, run.spec.traffic
    maxiter = int(trf["maxiter"])
    reps0 = _replays(jit_asp)
    prof = tr0_ns = tr1_ns = None
    tail = None   # (clock, replays, horizons) where the untraced part of a traced window starts
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        tr0_ns = time.time_ns()
    results = []
    t0 = time.perf_counter()

    def more() -> bool:
        if len(results) < min_horizons or time.perf_counter() - t0 < seconds:
            return True
        return prof is not None and (tail is None or tail[2] == len(results))

    while more():
        x0_np = T.start_point(prog["trotter_point"], trf, run.seed, len(results))
        x0 = torch.as_tensor(x0_np, dtype=prog["dtype"], device=dev)
        flagged = len(jit_asp.watchdog_events)
        res = horizon(prog, x0, trf, maxiter)
        fobj = float(res.fobj)
        results.append((x0_np, x0, res, fobj, len(jit_asp.watchdog_events) - flagged))
        if prof is not None and tail is None and time.perf_counter() - t0 >= TRACE_MIN_S:
            _sync(dev)
            tr1_ns = time.time_ns()
            prof.__exit__(None, None, None)
            run.traced_iters = sum(int(r[2].num_iters) for r in results)
            run.traced_evals = _evals(reps0, _replays(jit_asp))
            tail = (time.perf_counter(), _replays(jit_asp), len(results))
    _sync(dev)
    t1 = time.perf_counter()
    run.window_s = t1 - t0
    reps1 = _replays(jit_asp)
    if prof is not None:
        run.trace = TraceTable.from_profiler(prof, tr0_ns, tr1_ns)
        run.untraced_s = t1 - tail[0]
        run.untraced_iters = sum(int(r[2].num_iters) for r in results[tail[2]:])
        run.untraced_evals = _evals(tail[1], reps1)
    run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    run.programs = [dict(p.stats(), kind=_kind(p), window_replays=n - reps0.get(key, (p, 0))[1])
                    for key, (p, n) in reps1.items()]
    run.horizons = [Horizon(x0_np, res.thetas.detach().double().cpu().numpy(), fobj, int(res.num_iters), flag)
                    for x0_np, _, res, fobj, flag in results]
    return [r[1] for r in results]


def program_outputs(run: Run, prog, x0_dev: list) -> None:
    """What the check reads from the program after the window: its value at
    every start point (``failed`` counts a horizon that ended no lower), its
    objective and gradient at the start point of the first sampled horizon,
    and its target.  The same captured programs the window replayed."""
    jit_asp = prog["jit_asp"]
    value = jit_asp._mps_value_program(prog["circ"], prog["base"], prog["thr"], prog["route"])
    og = jit_asp._mps_value_and_grad_program(prog["circ"], prog["base"], prog["thr"], prog["route"])
    for h, x0 in zip(run.horizons, x0_dev):
        h.f0 = float(value(x0, prog["target"]))
    run.sample = T.check_sample(len(run.horizons), [h.iters for h in run.horizons], run.spec.traffic, run.seed)
    if run.sample:
        f, g = og(x0_dev[run.sample[0]], prog["target"])
        run.port_grad = (float(f), g.detach().double().cpu().numpy())
    t = prog["target"]
    run.port_target = (t.gammas.detach().cpu(), t.lambdas.detach().cpu())


def release(prog) -> None:
    prog["jit_asp"].release_mps_programs()
    prog.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def failed(run: Run) -> int:
    bad = 0
    for h in run.horizons:
        finite = math.isfinite(h.fobj) and bool(np.all(np.isfinite(h.thetas)))
        bad += int(not finite or not h.fobj < h.f0 or h.watchdog > 0)
    return bad


def execute(spec: CellSpec, seed: int, seconds: float, trace: bool, device: torch.device) -> Run:
    """Set-up, window, the program's outputs; the program's state is freed
    at the end."""
    run = Run(spec, int(seed), device)
    run.built_kernels, run.library_s = kernel_library(device)
    prog = setup(spec, device)
    run.setup_s = process_age_s()
    x0_dev = window(run, prog, seconds, trace)
    program_outputs(run, prog, x0_dev)
    release(prog)
    return run
