"""The multi-start MPS ASP horizon: L lanes in lock step as one fleet, the
runner of a configuration that names ``"runner": "mps_fleet"`` and gives
its ``lanes``.

Each request is one fleet of the port's main path,
``models.sp_lhs.jit_asp.optimize_horizon_mps_multistart``: compact L-BFGS
over L start points at once, the lanes folded into the batch of every pair
update, each evaluation the replay of the CUDA graph of its running-lane
count, and the collapse watchdog per lane at the fleet's end.  Lane i of
request k starts from the seed's start point ``L k + i``, drawn as
``harness/traffic.py`` draws a one-lane horizon's, and returns a
``Horizon`` of its own: the window's iterations are lane iterations, and
the check's sample draws among the window's lanes.

What a runner provides is set out in ``runners/horizon_mps.py``.  Here:

* ``setup`` builds the target as the one-lane runner does, captures the
  value and obj+grad programs of every running-lane count 1..L and the
  watchdog's reference value at L lanes (``jit_asp.capture_mps_fleet``),
  then runs a warm fleet of ``warm_iters`` in which one lane stops at its
  start and the others run on, so that the gathers of a partial fleet have
  run before the window;
* ``replays`` counts lane evaluations: a replay of the program of L'
  running lanes is L' evaluations of its kind, so that ``evals_per_iter``
  reads per lane iteration as ``iter_s`` does, and ``work`` is one lane's
  census per evaluation (``horizon_mps.work``), L' times one lane's a
  replay;
* ``outputs`` takes the first sampled lane's objective and gradient from
  its row of one obj+grad at its request's L starts, the folded batch the
  window runs most;
* ``readings`` is the one-lane runner's: each sampled lane against the same
  MPS reference, on the same numbers.

The span readers divide by ``lbfgs.iteration`` spans, which a fleet
records one per lane iteration (``optim/lbfgs.py``), so they too read per
lane iteration.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from harness import traffic as T
from harness.cell import Horizon, sync
from harness.spec import runner
from reference.circuit import neel_bits

ONE = runner("horizon_mps")
REQUEST = ONE.REQUEST
readings, release, work, programs = ONE.readings, ONE.release, ONE.work, ONE.programs


def lanes_of(spec) -> int:
    """The fleet's lanes, from the configuration (the traffic's ``lanes``
    describes them)."""
    return int(spec.config["lanes"])


def setup(spec, device: torch.device) -> dict:
    """The program, its target and the fleet's programs for this cell,
    then a warm fleet."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.models.sp_lhs.jit_asp import capture_mps_fleet
    from aqc_research_tpu_torch.models.sp_lhs.target_states import first_horizon_mps_target

    cfg, trf = spec.config, spec.traffic
    lanes = lanes_of(spec)
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
    prog = {"circ": circ, "target": target, "base": neel_bits(n), "thr": float(cfg["trunc_thr"]),
            "route": trf["route"], "jit_asp": jit_asp, "dtype": config.real_dtype(), "lanes": lanes,
            "trotter_point": T.trotter_point(cfg), "traffic": trf, "device": device}
    # The warm fleet: lane 0 at the Trotter point, the others from seed 0's
    # first start points; its threshold lies just above the best start's
    # objective, so that lane stops at once and the others run on.
    base = prog["trotter_point"]
    starts = [base] + [T.start_point(base, trf, 0, i) for i in range(lanes - 1)]
    x = torch.as_tensor(np.stack(starts), dtype=prog["dtype"], device=device)
    capture_mps_fleet(circ, x, target, base_bits=prog["base"], trunc_thr=prog["thr"])
    f0 = jit_asp._mps_value_program(circ, prog["base"], prog["thr"], prog["route"])(x, target).tolist()
    fleet(prog, x, maxiter=int(trf["warm_iters"]), fidelity_thr=1.0 - min(f0) * (1.0 + 1e-3))
    sync(device)
    return prog


def fleet(prog: dict, x0: torch.Tensor, maxiter: int, fidelity_thr: float):
    return prog["jit_asp"].optimize_horizon_mps_multistart(
        prog["circ"], x0, prog["target"], base_bits=prog["base"], trunc_thr=prog["thr"],
        fidelity_thr=fidelity_thr, maxiter=maxiter,
    )


def request(prog: dict, seed: int, k: int) -> List[Horizon]:
    """Request k of the seed: lane i from the seed's start point L k + i."""
    jit_asp, lanes, trf = prog["jit_asp"], prog["lanes"], prog["traffic"]
    starts = [T.start_point(prog["trotter_point"], trf, seed, lanes * k + i) for i in range(lanes)]
    x0 = torch.as_tensor(np.stack(starts), dtype=prog["dtype"], device=prog["device"])
    flagged = len(jit_asp.watchdog_events)
    res = fleet(prog, x0, int(trf["maxiter"]), float(trf["fidelity_thr"]))
    fobj = res.fobj.tolist()
    events = jit_asp.watchdog_events[flagged:]
    return [Horizon(starts[i], res.thetas[i], fobj[i], int(res.num_iters[i]), sum(e.get("lane") == i for e in events))
            for i in range(lanes)]


def replays(prog: dict) -> dict:
    """Each program's kind and its lane evaluations: its replays times the
    rows of its θ (one for a one-lane θ of shape (P,))."""
    return {id(p): (ONE._kind(p), (shape[0] if len(shape) == 2 else 1) * p.replays)
            for shape, p in prog["jit_asp"].mps_program_shapes()}


def outputs(prog: dict, run) -> None:
    """The program's value at every lane's start (each request's starts in
    one evaluation of its L lanes), its objective and gradient at the start
    point of the first sampled lane (its row of one obj+grad evaluation of
    its request's L starts, the folded batch the window runs most), and its
    target: programs the window replayed."""
    jit_asp, target, lanes = prog["jit_asp"], prog["target"], prog["lanes"]
    value = jit_asp._mps_value_program(prog["circ"], prog["base"], prog["thr"], prog["route"])
    og = jit_asp._mps_value_and_grad_program(prog["circ"], prog["base"], prog["thr"], prog["route"])

    def rows(horizons):
        return torch.as_tensor(np.stack([h.x0 for h in horizons]), dtype=prog["dtype"], device=prog["device"])

    for r in range(0, len(run.horizons), lanes):
        group = run.horizons[r:r + lanes]
        for h, f0 in zip(group, value(rows(group), target).tolist()):
            h.f0 = f0
    if run.sample:
        first, row = divmod(run.sample[0], lanes)
        f, g = og(rows(run.horizons[first * lanes:(first + 1) * lanes]), target)
        run.outputs["grad"] = (float(f[row]), g[row].detach().double().cpu().numpy())
    run.outputs["target"] = (target.gammas.detach().cpu(), target.lambdas.detach().cpu())
