"""Coordinate-descent driver for full AQC (twin of
``aqc_research_tpu/models/sketching/aqc_coord_descent.py``): each restart
runs the multi-sweep descent of ops/coord_descent.py on the default device
— per-sweep stop tests (angle-change floor, small-objective threshold), the
wall-clock limit checked between chunks of sweeps, the per-sweep
convergence profile returned as one array — and the restarts go through
the executor.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Union

import numpy as np

from ... import checking as chk
from ...ops.coord_descent import coord_descent_run
from ...parallel.executor import run_jobs
from ...utils import create_logger
from . import sk_utils as sku

# Stop criteria of the descent: no angle moved more than this in a sweep,
# or the objective is already small (the SmallObjectiveStopper default).
_ANGLE_CHANGE_FLOOR = 1e-8
_SMALL_FOBJ = 1e-2


def _descend_from_random_start(job_index: int, config: dict) -> dict:
    """One restart: seed angles, run the on-device multi-sweep descent,
    package the result in the executor/postprocess schema."""
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

    run, timed_out = coord_descent_run(
        circ,
        start_angles,
        config["su_target"],
        maxiter=int(config["maxiter"]),
        thetas_tol=_ANGLE_CHANGE_FLOOR,
        fobj_thr=_SMALL_FOBJ,
        time_limit=float(config["time_limit"]),
    )
    sweeps_done = int(run.num_sweeps)
    profile = run.profile.cpu().numpy().astype(np.float32)[:sweeps_done]
    best_angles = run.thetas.cpu().numpy().astype(np.float64)
    if logger:
        for k, fobj_k in enumerate(profile):
            logger.info("sweep %4d: fobj %0.4f", k + 1, float(fobj_k))

    if timed_out:
        outcome = "timeout"
    elif run.converged:
        outcome = "early"  # a stop criterion fired before maxiter
    else:
        outcome = "normal"
    return {
        "cost": float(run.fobj),
        "nit": sweeps_done,
        "num_fun_ev": sweeps_done,
        "num_grad_ev": sweeps_done,
        "num_iters": sweeps_done,
        "exit_status": outcome,
        "ini_thetas": start_angles,
        "thetas": best_angles,
        "entangler": circ.entangler,
        "blocks": circ.blocks,
        "fidelity": sku.fidelity(sku.circuit_matrix(circ, best_angles), config["su_target"]),
        "stats": {"convergence_profile": profile, "nit": sweeps_done},
    }


def aqc_coordinate_descent(
    *,
    num_qubits: int,
    num_layers: int,
    circ_layout: str,
    maxiter: int,
    target_name_or_func: Union[str, Callable[[int], np.ndarray]],
    result_folder: str,
    parametric_depth: int = 3,
    seed: Optional[int] = None,
    time_limit: int = 0,
    num_simulations: int = 1,
    num_jobs: int = 1,
    tag: str = "",
    job_cache_dir: Optional[str] = None,
    logger: Optional[logging.Logger] = None,
) -> str:
    """Multi-start coordinate-descent AQC; returns the results folder.

    ``job_cache_dir`` enables per-restart
    crash-resume (parallel.executor.run_jobs) — pin ``seed`` when using it,
    or the persisted base seed of the first run is reused automatically.
    """
    assert chk.is_int(num_qubits, num_qubits >= 2)
    assert circ_layout in sku.supported_layouts()
    assert chk.is_int(maxiter, maxiter > 0)

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
        circuit_layout=circ_layout,
        maxiter=int(maxiter),
        time_limit=int(time_limit),
        su_target=su_target,
    )
    results = run_jobs(
        configs=[restart_config] * num_simulations,
        seed=seed,
        job_function=_descend_from_random_start,
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
