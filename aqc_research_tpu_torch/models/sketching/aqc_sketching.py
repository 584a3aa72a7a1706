"""Full and sketched AQC driver with multi-start restarts (twin of
``aqc_research_tpu/models/sketching/aqc_sketching.py``).

* **Full AQC** (the sketching vectors span the whole space, X = I): all
  restarts run as ONE lane-batched compact L-BFGS (optim/lbfgs.py's fleet):
  every evaluation is one batched pass of the fused objective and co-sweep
  gradient over the running restarts (``torch.func.vmap``).  The wall-clock
  limit is checked between chunks of 25 iterations; the small-objective
  stop (1e-2) is per lane.
* **Sketched AQC** (random / alternating / eigen sketching vectors): every
  evaluation redraws its sketch from numpy's stream on the host, so these
  restarts run Adam through the executor, with stagnation-triggered
  learning-rate decay (halve on a plateau, at most 5 times, then run the
  rest of the budget undisturbed).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from ... import checking as chk
from ...config import real_of
from ...ops.gradients import grad_of_matrix_dot_product
from ...ops.statevector import v_dagger_mul_mat
from ...optim import optimizer as aqcopt_optimizer
from ...optim import stoppers as aqcopt
from ...optim.lbfgs import lbfgs_fleet_programs, run_lbfgs_chunked, stateless_lanes
from ...parallel.executor import run_jobs
from ...utils import create_logger
from . import sk_core as skc
from . import sk_utils as sku

_SMALL_FOBJ = 1e-2  # SmallObjectiveStopper bar shared by both branches
_MAX_LR_DECAYS = 5
_STAGNATION_WINDOW = 40  # Adam iterations without improvement -> decay


# -----------------------------------------------------------------------------
# Full AQC: the lane fleet.
# -----------------------------------------------------------------------------


def fleet_objective(circ, x: torch.Tensor, y: torch.Tensor):
    """The lane objective of the full-AQC fleet, ``(value, value_and_grad)``
    over Θ rows ``(L, P)``: ``fobj = 1 - Re tr(X† V† Y) / m`` and the
    analytic matrix co-sweep gradient, one batched pass (``torch.func.vmap``
    over the one-lane computation) for all lanes."""
    m = x.shape[-1]

    def one_value(th):
        return (1.0 - torch.vdot(x.reshape(-1), v_dagger_mul_mat(circ, th, y).reshape(-1)).real / m).to(th.dtype)

    def one_fused(th):
        vh_y = v_dagger_mul_mat(circ, th, y)
        fobj = 1.0 - torch.vdot(x.reshape(-1), vh_y.reshape(-1)).real / m
        grad = grad_of_matrix_dot_product(circ, th, x, vh_y)
        return fobj.to(th.dtype), (-grad.real / m).to(th.dtype)

    value, fused = torch.func.vmap(one_value), torch.func.vmap(one_fused)
    return value, fused


def _fleet_full_aqc(
    *,
    circ,
    skvecs: skc.SketchingVectorsBase,
    start_batch: np.ndarray,
    maxiter: int,
    time_limit: float,
    seeds: list,
    logger: Optional[logging.Logger],
    chunk_iters: int = 25,
) -> list:
    """Optimizes every restart at once (one lane each, on the default
    device); returns per-restart result dicts in the executor schema
    (postprocess consumes them unchanged)."""
    x, y = skc.sketch_tensors(*skvecs.generate())
    start = torch.as_tensor(np.asarray(start_batch, np.float64), device=x.device).to(real_of(x.dtype))
    programs = lbfgs_fleet_programs(
        *stateless_lanes(*fleet_objective(circ, x, y)), maxiter=int(maxiter), fobj_thr=_SMALL_FOBJ,
    )
    tic = time.perf_counter()
    res, _, timed_out = run_lbfgs_chunked(
        programs, start, maxiter=int(maxiter), time_limit=float(time_limit), chunk_iters=int(chunk_iters),
    )
    fleet_seconds = time.perf_counter() - tic

    fobj = res.fobj.cpu().numpy().astype(np.float64)
    thetas = res.thetas.cpu().numpy().astype(np.float64)
    iters = np.asarray(res.num_iters, np.int64)
    stopped = np.asarray(res.converged, bool)
    if logger:
        logger.info(
            "full-AQC fleet: %d restarts x %d iters in %0.2f s (best fobj %0.5f)",
            len(fobj), int(iters.max(initial=0)), fleet_seconds, float(fobj.min()),
        )

    results = []
    for lane in range(thetas.shape[0]):
        if timed_out and not stopped[lane]:
            outcome = "timeout"
        elif stopped[lane] and fobj[lane] < _SMALL_FOBJ:
            outcome = "early"
        else:
            outcome = "normal"
        n_it = int(iters[lane])
        results.append(
            {
                "cost": float(fobj[lane]),
                "thetas": thetas[lane],
                "ini_thetas": np.asarray(start_batch[lane], np.float64),
                "nit": n_it,
                "num_fun_ev": n_it,
                "num_grad_ev": n_it,
                "num_iters": n_it,
                "exit_status": outcome,
                "entangler": circ.entangler,
                "blocks": circ.blocks.copy(),
                "fidelity": sku.fidelity(sku.circuit_matrix(circ, thetas[lane]), skvecs.target_matrix),
                "stats": {
                    "convergence_profile": np.zeros(0, np.float32),
                    "nit": n_it,
                    "fleet": True,
                },
                # Lock-step fleet: the wall time is shared by every lane.
                "time": fleet_seconds,
                "status": "ok",
                "job_index": lane,
                "seed": int(seeds[lane]),
            }
        )
    return results


# -----------------------------------------------------------------------------
# Sketched AQC: host Adam with plateau-triggered learning-rate decay.
# -----------------------------------------------------------------------------


def _adam_with_lr_decay(
    *,
    objv: skc.SketchingObjectiveEx,
    start_angles: np.ndarray,
    total_iters: int,
    learn_rate: float,
    plateau: aqcopt.NotImproveStopper,
    logger: Optional[logging.Logger],
) -> dict:
    """Adam legs separated by learning-rate halvings: a plateau (no
    improvement over the stopper window) ends a leg, the next leg restarts
    from the best angles at half the rate; after ``_MAX_LR_DECAYS`` plateaus
    the stopper is disarmed and the remaining budget runs undisturbed."""
    angles = np.asarray(start_angles, np.float64).copy()
    rate = float(learn_rate)
    outcome, decays = "exhausted", 0
    while objv.num_iterations < total_iters:
        budget = total_iters - objv.num_iterations
        if logger:
            logger.info(
                "Adam leg %d: rate %0.5g, budget %d", decays, rate, budget
            )
        try:
            aqcopt_optimizer._adam_minimize(
                objv.objective, objv.gradient, angles, budget, rate
            )
            outcome = "normal"
            break
        except aqcopt.StagnantOptimizationWarning:
            decays += 1
            if decays >= _MAX_LR_DECAYS:
                plateau.disable()
            else:
                rate *= 0.5
                plateau.reset()
            angles = np.asarray(objv.optim_results["thetas"]).copy()
        except StopIteration:
            outcome = "early"
            break
        except TimeoutError:
            outcome = "timeout"
            break

    result = objv.optim_results
    result["exit_status"] = outcome
    result["cost"] = float(result["cost"])
    return result


def _sketched_restart(job_index: int, config: dict) -> dict:
    """One sketched-AQC restart under the executor (host RNG seeded there)."""
    from scipy.stats import truncnorm

    logger = create_logger("job_0") if job_index == 0 else None
    circ = sku.create_ansatz(
        num_qubits=config["num_qubits"],
        num_layers=config["num_layers"],
        circuit_layout=config["circuit_layout"],
        logger=logger,
    )
    start_angles = np.asarray(
        truncnorm.rvs(a=-1, b=1, size=circ.num_thetas) * np.pi
    )
    skvecs = skc.skvecs_generator(
        str(config["skvecs_type"]), int(config["num_skvecs"]), config["su_target"]
    )
    plateau = aqcopt.NotImproveStopper(num_iters=_STAGNATION_WINDOW)
    objv = skc.SketchingObjectiveEx(
        circ=circ,
        skvecs=skvecs,
        enable_stats=True,
        stop_timeout=aqcopt.TimeoutStopper(time_limit=config["time_limit"]),
        stop_stagnant=plateau,
        stop_small_fobj=aqcopt.SmallObjectiveStopper(fobj_thr=_SMALL_FOBJ),
        logger=logger,
    )
    result = _adam_with_lr_decay(
        objv=objv,
        start_angles=start_angles,
        total_iters=int(config["maxiter"]),
        learn_rate=float(config["learn_rate"]),
        plateau=plateau,
        logger=logger,
    )
    result["fidelity"] = sku.fidelity(sku.circuit_matrix(circ, result["thetas"]), config["su_target"])
    result["nit"] = result["num_iters"]
    result["ini_thetas"] = start_angles
    result["stats"] = objv.statistics
    return result


# -----------------------------------------------------------------------------
# Entry point.
# -----------------------------------------------------------------------------


def aqc_sketching(
    *,
    num_qubits: int,
    num_layers: int,
    num_skvecs: int,
    circ_layout: str,
    maxiter: int,
    learn_rate: float,
    skvecs_type: str,
    target_name_or_func: Union[str, Callable[[int], np.ndarray]],
    result_folder: str,
    parametric_depth: int = 3,
    seed: Optional[int] = None,
    time_limit: int = -1,
    num_simulations: int = 1,
    num_jobs: int = 1,
    tag: str = "",
    job_cache_dir: Optional[str] = None,
    logger: Optional[logging.Logger] = None,
) -> str:
    """Runs multi-start AQC-sketching simulations; returns the results folder.

    Full-range sketching (``skvecs_type="full"`` or ``num_skvecs == dim``)
    runs the lane fleet; everything else fans restarts out through the
    executor.  ``job_cache_dir`` enables per-restart crash-resume for the
    sketched branch — pin ``seed``, or the persisted base seed of the first
    run is reused automatically (sk_utils.resolve_base_seed).
    """
    assert chk.is_int(num_qubits, num_qubits >= 2)
    assert chk.is_int(num_skvecs, num_skvecs > 0)
    assert circ_layout in sku.supported_layouts()
    assert chk.is_int(maxiter, maxiter > 0)
    assert chk.is_float(learn_rate, 0 < learn_rate < 1)

    opt_echo = dict(vars())
    logger, seed, out_dir, target_mat, su_target = sku.experiment_prologue(
        num_qubits=num_qubits,
        circ_layout=circ_layout,
        parametric_depth=parametric_depth,
        target_name_or_func=target_name_or_func,
        result_folder=result_folder,
        tag=tag,
        seed=seed,
        job_cache_dir=job_cache_dir,
        script_file=__file__,
        options=opt_echo,
        logger=logger,
    )
    restart_config = dict(
        num_qubits=int(num_qubits),
        num_layers=int(num_layers),
        num_skvecs=int(num_skvecs),
        circuit_layout=circ_layout,
        maxiter=int(maxiter),
        learn_rate=float(learn_rate),
        skvecs_type=str(skvecs_type),
        time_limit=int(time_limit),
        su_target=su_target,
    )

    dim = int(su_target.shape[0])
    full_range = str(skvecs_type) == "full" or int(num_skvecs) >= dim
    if full_range:
        # The fleet replaces the per-restart host loops; restart seeding
        # mirrors the executor convention so the initial angles of restart
        # i are identical across both branches.
        from scipy.stats import truncnorm

        circ = sku.create_ansatz(
            num_qubits=num_qubits,
            num_layers=num_layers,
            circuit_layout=circ_layout,
            logger=logger,
        )
        seeds, starts = [], []
        for lane in range(int(num_simulations)):
            lane_seed = seed + 7 * (lane + 1)
            seeds.append(lane_seed)
            np.random.seed(lane_seed)
            starts.append(truncnorm.rvs(a=-1, b=1, size=circ.num_thetas) * np.pi)
        results = _fleet_full_aqc(
            circ=circ,
            skvecs=skc.skvecs_generator("full", dim, su_target),
            start_batch=np.stack(starts),
            maxiter=int(maxiter),
            time_limit=float(time_limit),
            seeds=seeds,
            logger=logger,
        )
    else:
        results = run_jobs(
            configs=[restart_config] * num_simulations,
            seed=seed,
            job_function=_sketched_restart,
            tolerate_failure=True,
            num_jobs=num_jobs,
            cache_dir=job_cache_dir,
        )
    return sku.experiment_epilogue(
        num_qubits=num_qubits,
        results=results,
        target_mat=target_mat,
        su_target=su_target,
        output_dir=out_dir,
        logger=logger,
    )
