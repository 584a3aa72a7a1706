"""The one-lane MPS ASP horizon: the runner of every configuration that
names none.

Each request is one horizon of the port's main path,
``models.sp_lhs.jit_asp.optimize_horizon_mps_jit`` (compact L-BFGS over the
MPS fidelity objective and its co-sweep gradient, replayed as CUDA graphs,
the collapse watchdog at the horizon's end), from a start point of its own.

**What a runner provides.**  A runner is the module ``runners/<name>.py``
that a configuration names under ``runner``; ``harness/cell.py`` drives it
and knows nothing of the program:

* ``REQUEST`` -- the name of the program's span that one request opens; the
  span readers take the window's requests by this name and by the times the
  window records;
* ``setup(spec, device) -> state`` -- the program, its target, its captured
  programs and the warm request: everything a request needs;
* ``request(state, seed, k) -> [Horizon]`` -- request k of a run with this
  seed, one ``Horizon`` per lane; the angles may stay on the device until
  the window has closed;
* ``replays(state) -> {key: (kind, n)}`` -- how many evaluations each of
  its programs has run so far, by kind; read at the window's start, at the
  end of its traced part and at its end, so it stays cheap;
* ``programs(state) -> {key: stats}`` -- each program's capture figures
  (``warmup_s``, ``capture_s``, ``instantiate_s``), read once after the
  window;
* ``work(spec) -> {kind: (flops, bytes)}`` -- the work of one evaluation of
  each kind, from ``work/census.py``; ``idle_pct`` and
  ``sweep_roofline_pct`` multiply it by the replays;
* ``outputs(state, run)`` -- after the window: the program's value at each
  horizon's start (``Horizon.f0``), and in ``run.outputs`` what
  ``readings`` compares besides the horizons (the harness has drawn
  ``run.sample`` from the seed by then);
* ``readings(run, device, control=False) -> {name: float}`` -- the numbers
  of ``check.NUMBERS`` against the runner's reference, run once the
  program's state is freed; ``control`` puts the reference, computed in the
  precision below the configuration's, in the program's place;
* ``release(state)`` -- frees the program's state.

**How the queued runners fit.**

* The multi-start fleet (``jit_asp.optimize_horizon_mps_multistart``): one
  request runs L lanes in lock step and returns L ``Horizon``s, lane i of
  request k from the start point ``L k + i`` of the seed.  The check's
  sample draws among the window's lanes, and ``readings`` is this module's:
  each lane against the same MPS reference.  One evaluation does L lanes'
  work, so its ``work`` is this one's times L.  The per-iteration metrics
  count lane iterations.
* The horizon schedule (``time_evol._optimize_jit``): one request spans
  several horizons, each with a target and a recapture of its own.  Each
  horizon opens an ``asp.horizon`` span, so its ``REQUEST`` stays this one
  and the readers take every horizon inside the window.  Its kinds carry the
  horizon's depth (``value.L4``, say), so that ``work`` holds each; its
  outputs keep each horizon's target, and ``readings`` compares each sampled
  horizon with the reference's target at that time.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List

import numpy as np
import torch

from harness import traffic as T
from harness.cell import Horizon, sync
from reference import mps as R
from reference.circuit import neel_bits
from work import census as W

REQUEST = "asp.horizon"


def setup(spec, device: torch.device) -> dict:
    """The program, its target and its captured programs for this cell,
    then a warm horizon of ``warm_iters`` from the Trotter point."""
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
            "trotter_point": T.trotter_point(cfg), "traffic": trf, "device": device}
    x = torch.as_tensor(prog["trotter_point"], dtype=prog["dtype"], device=device)
    jit_asp._mps_value_and_grad_program(circ, base, prog["thr"], prog["route"])(x, target)
    jit_asp._mps_value_program(circ, base, prog["thr"], prog["route"])(x, target)
    horizon(prog, x, maxiter=int(trf["warm_iters"]))
    sync(device)
    return prog


def horizon(prog: dict, x0: torch.Tensor, maxiter: int):
    return prog["jit_asp"].optimize_horizon_mps_jit(
        prog["circ"], x0, prog["target"], base_bits=prog["base"], trunc_thr=prog["thr"],
        fidelity_thr=float(prog["traffic"]["fidelity_thr"]), maxiter=maxiter,
    )


def request(prog: dict, seed: int, k: int) -> List[Horizon]:
    """Horizon k of the seed, from the seed's start point k."""
    jit_asp = prog["jit_asp"]
    x0_np = T.start_point(prog["trotter_point"], prog["traffic"], seed, k)
    x0 = torch.as_tensor(x0_np, dtype=prog["dtype"], device=prog["device"])
    flagged = len(jit_asp.watchdog_events)
    res = horizon(prog, x0, int(prog["traffic"]["maxiter"]))
    fobj = float(res.fobj)
    return [Horizon(x0_np, res.thetas, fobj, int(res.num_iters), len(jit_asp.watchdog_events) - flagged)]


def _kind(p) -> str:
    return "obj_grad" if p.name.endswith("obj+grad") else "value"


def replays(prog: dict) -> dict:
    return {id(p): (_kind(p), p.replays) for p in prog["jit_asp"].mps_programs()}


def programs(prog: dict) -> dict:
    return {id(p): p.stats() for p in prog["jit_asp"].mps_programs()}


def work(spec) -> Dict[str, tuple]:
    """(flops, bytes) of one value and one obj+grad evaluation: the frozen
    census at the configuration's circuit and chi."""
    cfg = spec.config
    return W.evaluation_work(W.decomposition_census(int(cfg["num_qubits"]), int(cfg["num_layers"]),
                                                    int(cfg["chi"]), bool(cfg["second_order"])))


def outputs(prog: dict, run) -> None:
    """The program's value at every start point (``failed`` counts a horizon
    that ended no lower), its objective and gradient at the start point of
    the first sampled horizon, and its target.  The same captured programs
    the window replayed."""
    jit_asp, target = prog["jit_asp"], prog["target"]
    value = jit_asp._mps_value_program(prog["circ"], prog["base"], prog["thr"], prog["route"])
    og = jit_asp._mps_value_and_grad_program(prog["circ"], prog["base"], prog["thr"], prog["route"])
    starts = [torch.as_tensor(h.x0, dtype=prog["dtype"], device=prog["device"]) for h in run.horizons]
    for h, x0 in zip(run.horizons, starts):
        h.f0 = float(value(x0, target))
    if run.sample:
        f, g = og(starts[run.sample[0]], target)
        run.outputs["grad"] = (float(f), g.detach().double().cpu().numpy())
    run.outputs["target"] = (target.gammas.detach().cpu(), target.lambdas.detach().cpu())


def release(prog: dict) -> None:
    prog["jit_asp"].release_mps_programs()
    prog.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(run, device, control: bool = False) -> Dict[str, float]:
    """The numbers of a run, judged by the plain reference in complex128
    (``reference/mps.py``).  ``control`` puts the reference, computed in
    TF32 (the step below the configuration's float32 with TF32 off), in the
    program's place."""
    prec = R.TF32 if control else R.EXACT
    wl = R.Workload.from_config(run.spec.config)
    ref_target = R.target_state(wl, R.EXACT, device)
    if control:
        answer_target = R.target_state(wl, prec, device)
    else:
        gammas, lambdas = run.outputs["target"]
        answer_target = R.from_vidal(gammas.to(device), lambdas.to(device))
    out = {"target_infid": R.infidelity(answer_target, ref_target)}
    gaps, descent = [], []
    for i, k in enumerate(run.sample):
        h = run.horizons[k]
        if i == 0:
            f0_ref, g_ref = R.objective_and_gradient(wl, h.x0, ref_target)
            if control:
                f_c, g_c = R.objective_and_gradient(wl, h.x0, answer_target, prec)
            else:
                f_c, g_c = run.outputs["grad"]
            out["grad_gap"] = float(np.linalg.norm(g_c - g_ref) / np.linalg.norm(g_ref))
            gaps.append(abs(f_c - f0_ref))
        else:
            f0_ref = R.objective(wl, h.x0, ref_target)
        f_ref = R.objective(wl, h.thetas, ref_target)
        if control:
            f_fin = R.objective(wl, h.thetas, answer_target, prec)
            f_start = f_c if i == 0 else R.objective(wl, h.x0, answer_target, prec)
        else:
            f_fin, f_start = h.fobj, h.f0
        gaps += [abs(f_fin - f_ref), abs(f_start - f0_ref)]
        descent.append(f_ref / f0_ref)
    out["fobj_gap"] = max(gaps) if gaps else math.nan
    out["descent"] = max(descent) if descent else math.nan
    return out
