"""ASP time-evolution driver: Trotter big steps + shallow-ansatz compression
(twin of ``aqc_research_tpu/models/sp_lhs/time_evol.py``).

Per time horizon: build a Trotter-like ansatz with the 'perfect'
initialization, optimize, expand the circuit when the fidelity falls short,
re-evaluate an MPS solution without truncation, checkpoint, and finally
persist and plot.  Two optimizer protocols (``UserOptions.
resolve_use_jit_lbfgs``): the L-BFGS loop of models/sp_lhs/jit_asp.py on the
tensors' device — the MPS fidelity objective (``sur_fast_mps_trotter``) or
the dense max-projection surrogate (``sur_max``) — or SciPy's L-BFGS-B on
the host over the host-protocol surrogates of sur_fast_mps.py and
sur_max.py (``_create_objective``), whose evaluations run on the device.
"""

from __future__ import annotations

import os
import pickle
import time
from pprint import pformat
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ... import checking as chk
from ... import config
from ...circuit.ansatz import TrotterAnsatz, first_layer_included, layer_to_block_range
from ...circuit.structures import make_trotter_like_circuit
from ...ops.mps import MPS, no_truncation_threshold
from ...optim import optimizer as optim
from ...optim.stoppers import EarlyStopper, GradientAmplifier, TimeoutChecker
from ...targets import trotter as trotop
from ...targets.trotter import fidelity
from ...utils import UserExit, create_logger, print_options
from . import evol_utils as trot_utils
from . import jit_asp
from .objective_base import SpLHSObjectiveBase
from .plots import plot_fidelity_profiles
from .sur_fast_mps import SpSurrogateObjectiveFastMpsTrotter
from .sur_max import SpSurrogateObjectiveMax
from .target_states import TargetClassicState, TargetMpsState, get_target_states
from .user_options import UserOptions

_logger = create_logger(__file__)

# Per-horizon progress checkpoint (enables ``opts.resume_dir``): written
# atomically after every completed horizon, consumed by a later run with
# the same schedule.
_CHECKPOINT_FILE = "horizon_checkpoint.pkl"


def _schedule_fingerprint(opts: UserOptions) -> dict:
    """The options that define the horizon schedule and its physics; a
    resumed run must match them exactly (plain scalars/lists so equality
    is well-defined across pickle round trips)."""
    return {
        "num_qubits": int(opts.num_qubits),
        "objective": str(opts.objective),
        "delta": float(opts.delta),
        "trunc_thr": float(opts.trunc_thr),
        "chi_max": int(opts.chi_max),
        "evol_times": [float(t) for t in np.asarray(opts.evol_times).ravel()],
        "trotter_steps": [int(s) for s in np.asarray(opts.trotter_steps).ravel()],
        "second_order_trotter": bool(opts.second_order_trotter),
        # Options that shape per-horizon RESULTS (not just the schedule): a
        # resume under a different threshold / layer schedule / iteration
        # budget would silently mix horizons computed under different
        # settings into one archive.
        "fidelity_thr": (
            None if opts.fidelity_thr is None else float(opts.fidelity_thr)
        ),
        "maxiter": int(opts.maxiter),
        "num_expansions": int(getattr(opts, "num_expansions", 0)),
        "num_layers_inc": int(opts.num_layers_inc),
        "manual_num_layers": (
            None
            if getattr(opts, "manual_num_layers", None) is None
            else [int(v) for v in opts.manual_num_layers]
        ),
    }


def _save_horizon_checkpoint(
    output_dir: str, opts: UserOptions, all_results: list, prev_solution
) -> None:
    """Atomic write (tmp + rename): a crash mid-dump never corrupts the
    previously saved checkpoint."""
    path = os.path.join(output_dir, _CHECKPOINT_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fld:
        pickle.dump(
            {
                "fingerprint": _schedule_fingerprint(opts),
                "all_results": all_results,
                "prev_solution": prev_solution,
            },
            fld,
        )
    os.replace(tmp, path)


def _load_horizon_checkpoint(output_dir: str, opts: UserOptions):
    """Returns (all_results, prev_solution) of the completed horizons; an
    empty list when no checkpoint exists.  Refuses a schedule mismatch —
    silently mixing horizons of two different configurations would corrupt
    the result archive."""
    path = os.path.join(output_dir, _CHECKPOINT_FILE)
    if not os.path.isfile(path):
        return [], None
    with open(path, "rb") as fld:
        data = pickle.load(fld)
    want = _schedule_fingerprint(opts)
    have = data.get("fingerprint")
    if have != want:
        raise ValueError(
            "resume refused: the checkpoint in "
            f"{output_dir!r} was written under a different schedule "
            f"(saved {have!r}, requested {want!r})"
        )
    return list(data["all_results"]), data.get("prev_solution")


def _create_objective(
    *,
    opts: UserOptions,
    circ: TrotterAnsatz,
    target: Union[MPS, torch.Tensor],
    layer_range: Union[Tuple[int, int], None],
) -> SpLHSObjectiveBase:
    """The host-protocol objective of ``opts.objective`` over ``layer_range``
    with the gradient amplifier where ``opts.enable_grad_scaling``."""
    params = {
        "job_index": 0,
        "num_qubits": circ.num_qubits,
        "max_flips": 1,
        "maxiter": opts.maxiter,
        "verbose": opts.verbose,
        "enable_optim_stats": True,
        "num_simulations": 1,
        "trunc_thr": opts.trunc_thr,
        "chi_max": opts.chi_max,
        "state_prep_func": opts.ini_state_func[0],
    }
    grad_scaler = None
    if opts.enable_grad_scaling:
        grad_scaler = GradientAmplifier(history=5, strong=False, verbose=opts.verbose)
    if opts.objective == "sur_max":
        objv = SpSurrogateObjectiveMax(
            user_parameters=params,
            circ=circ,
            block_range=layer_to_block_range(circ, layer_range),
            front_layer=first_layer_included(circ, layer_range),
            verbose=opts.verbose,
            grad_scaler=grad_scaler,
        )
    elif opts.objective == "sur_fast_mps_trotter":
        objv = SpSurrogateObjectiveFastMpsTrotter(
            user_parameters=params,
            circ=circ,
            layer_range=layer_range,
            alt_layers=False,
            verbose=opts.verbose,
            grad_scaler=grad_scaler,
        )
    else:
        raise ValueError(f"no such objective {opts.objective!r} (sur_max | sur_fast_mps_trotter)")
    objv.set_target(target)
    return objv


def _calc_fidelity_threshold(
    target: Union[TargetClassicState, TargetMpsState],
    fidelity_thr: Optional[float] = None,
) -> Tuple[float, float]:
    """Threshold = max(user thr, fidelity(t1, t1_gt)); automatic selection is
    1.03x the reference fidelity."""
    fid_t1_vs_gt = fidelity(target.t1, target.t1_gt)
    if fidelity_thr is not None:
        assert chk.is_float(fidelity_thr, 0 < fidelity_thr <= 1)
        fid_thr = max(fid_t1_vs_gt, fidelity_thr)
    else:
        fid_thr = 1.03 * fid_t1_vs_gt
    _logger.info("horizon fidelity bar: %0.4f", fid_thr)
    return fid_thr, fid_t1_vs_gt


def _warm_start_thetas(
    circ: TrotterAnsatz,
    opts: UserOptions,
    evol_time: float,
    prev: dict,
) -> Optional[np.ndarray]:
    """Initial angles from the PREVIOUS horizon's solution: first L_prev
    layers copy the optimized angles (V_prev ~ U(t_prev)); the appended
    layers take the perfect Trotter init for the remaining time
    t - t_prev, so V_init ~ Trotter(t - t_prev) V_prev ~ U(t).  Returns
    None when shapes don't line up (falls back to the cold perfect init)."""
    prev_layers = int(prev["num_layers"])
    n = circ.num_qubits
    if (
        prev.get("num_qubits") != n
        or prev_layers >= circ.num_layers
        or float(prev["evol_time"]) >= evol_time
        or np.asarray(prev["thetas"]).size != 3 * n + circ.tpb * prev_layers * circ.bpl
    ):
        return None
    prev_thetas = np.asarray(prev["thetas"], dtype=float)
    thetas = np.zeros(circ.num_thetas)
    thetas[: 3 * n] = prev_thetas[: 3 * n]
    th2q = circ.subset2q(thetas)
    th2q[: prev_layers * circ.bpl] = prev_thetas[3 * n :].reshape(-1, circ.tpb)
    trotop.init_ansatz_to_trotter(
        circ,
        thetas,
        evol_time=evol_time - float(prev["evol_time"]),
        delta=opts.delta,
        layer_range=(prev_layers, circ.num_layers),
    )
    return thetas


def _model_function(
    *,
    opts: UserOptions,
    num_layers: int,
    evol_time: float,
    target: Union[MPS, torch.Tensor],
    fid_thr: float,
    prev_solution: Optional[dict] = None,
) -> dict:
    """Builds the ansatz with the perfect Trotter initialization (or the
    previous horizon's warm start) and runs L-BFGS: the device loop, or
    SciPy's on the host (``opts.resolve_use_jit_lbfgs()``)."""
    tic = time.perf_counter()
    assert num_layers >= 1 and 0 < fid_thr <= 1
    _logger.info("#layers: %d, evol.time: %0.3f", num_layers, evol_time)

    blocks = make_trotter_like_circuit(
        num_qubits=opts.num_qubits,
        num_layers=num_layers,
        connectivity="full",
        verbose=bool(opts.verbose),
    )
    circ = TrotterAnsatz.make(opts.num_qubits, blocks, opts.second_order_trotter)
    thetas_0 = None
    if prev_solution is not None and getattr(opts, "warm_start_horizons", False):
        thetas_0 = _warm_start_thetas(circ, opts, evol_time, prev_solution)
        if thetas_0 is not None:
            _logger.info(
                "warm start from the previous horizon (%d layers)",
                int(prev_solution["num_layers"]),
            )
    if thetas_0 is None:
        thetas_0 = trotop.init_ansatz_to_trotter(
            circ,
            np.zeros(circ.num_thetas),
            evol_time=evol_time,
            delta=opts.delta,
            layer_range=(0, num_layers),
        )
    if opts.resolve_use_jit_lbfgs():
        result = _optimize_jit(opts=opts, circ=circ, thetas_0=thetas_0, target=target, fid_thr=fid_thr)
    else:
        objv = _create_objective(opts=opts, circ=circ, target=target, layer_range=(0, num_layers))
        optimizer = optim.AqcOptimizer(optimizer_name="lbfgs", maxiter=int(opts.maxiter), verbose=opts.verbose)
        result = optimizer.optimize(
            objv,
            circ,
            thetas_0,
            stopper=EarlyStopper(fidelity_thr=fid_thr),
            timeout=TimeoutChecker(time_limit=opts.time_limit),
        )
    result.update(
        {
            "num_qubits": circ.num_qubits,
            "num_layers": num_layers,
            "entangler": circ.entangler,
            "time": time.perf_counter() - tic,
        }
    )
    _logger.info("optimization finished at fobj = %0.6f", float(result["cost"]))
    return result


def _optimize_jit(
    *,
    opts: UserOptions,
    circ: TrotterAnsatz,
    thetas_0: np.ndarray,
    target: Union[MPS, torch.Tensor],
    fid_thr: float,
) -> dict:
    """One horizon's optimization on the target's device
    (``opts.use_jit_lbfgs``): the MPS fidelity objective, or the dense
    surrogate with its hysteresis and weight EMA, and the L-BFGS loop of
    jit_asp.py, the thetas in ``config.real_dtype()``.  ``time_limit > 0``
    runs the loop in chunks of ``jit_chunk_iters`` iterations with the clock
    checked between them; otherwise in one run.  Returns the result dict of
    the JAX package's driver."""
    x0 = torch.tensor(np.asarray(thetas_0), dtype=config.real_dtype(), device=target.device)
    time_limit = float(getattr(opts, "time_limit", -1) or -1)
    prep = opts.ini_state_func[0](circ.num_qubits)
    timed = dict(time_limit=time_limit, chunk_iters=int(getattr(opts, "jit_chunk_iters", 25)))
    timed_out = False
    if opts.use_mps:
        base = 0
        for gate in prep:
            assert gate.name == "x", "the MPS path expects an X-layer prep"
            base ^= 1 << gate.qubits[0]
        kw = dict(
            base_bits=tuple((base >> k) & 1 for k in range(circ.num_qubits)),
            trunc_thr=float(opts.trunc_thr),
            fidelity_thr=fid_thr,
            maxiter=int(opts.maxiter),
        )
        # Each horizon's circuit is new, so are its device programs: the
        # previous horizon's graphs and memory pools go first.
        freed = jit_asp.release_mps_programs()
        if time_limit > 0:
            res, timed_out = jit_asp.optimize_horizon_mps_timed(circ, x0, target, **timed, **kw)
        else:
            res = jit_asp.optimize_horizon_mps_jit(circ, x0, target, **kw)
        if target.device.type == "cuda":
            pools = sum(p.pool_bytes or 0 for p in jit_asp.mps_programs())
            _logger.info(
                "device programs: %d graphs, pools %0.1f MiB (%0.1f MiB freed before the horizon), "
                "peak allocated %0.1f MiB", len(jit_asp.mps_programs()), pools / 2**20, freed / 2**20,
                torch.cuda.max_memory_allocated(target.device) / 2**20,
            )
        weight = 0.0
    else:
        kw = dict(
            state_idx=jit_asp.flip_state_indices(circ.num_qubits, prep),
            fidelity_thr=fid_thr,
            maxiter=int(opts.maxiter),
        )
        if time_limit > 0:
            res, timed_out = jit_asp.optimize_horizon_surrogate_timed(circ, x0, target, **timed, **kw)
        else:
            res = jit_asp.optimize_horizon_surrogate_jit(circ, x0, target, **kw)
        weight = float(res.weight)
    num_iters = int(res.num_iters)
    return {
        "cost": float(res.fobj),
        "num_iters": num_iters,
        "num_fun_ev": num_iters,
        "num_grad_ev": num_iters,
        "ini_thetas": x0.cpu().numpy().copy(),
        "thetas": res.thetas.detach().cpu().numpy().astype(np.float64),
        "blocks": circ.blocks.copy(),
        "entangler": circ.entangler,
        "stats": {"weight": weight, "use_jit_lbfgs": True},
        "is_timeout": bool(timed_out),
        "fidelity": float(res.fidelity),
    }


def _time_evolution(
    *,
    opts: UserOptions,
    num_layers: int,
    num_expansions: int,
    target: Union[TargetClassicState, TargetMpsState],
    output_dir: str,
    prev_solution: Optional[dict] = None,
) -> dict:
    """One time horizon: optimize, expand when the fidelity falls short,
    re-evaluate an MPS solution without truncation at the end."""
    assert chk.is_int(num_layers, num_layers >= 1)
    assert chk.is_int(num_expansions, num_expansions >= 0)
    _logger.info("\n%s\nEvolution time: %f\n%s", "&" * 60, target.evol_time, "&" * 60)
    assert target.num_trot_steps == opts.trotter_steps[target.my_id]

    fidelity_thr, fid_t1_vs_gt = _calc_fidelity_threshold(
        target=target, fidelity_thr=opts.fidelity_thr
    )

    attempt = 0
    while True:
        _logger.info("\n%s\nNumber of layers: %d\n%s", "=" * 40, num_layers, "=" * 40)
        tic = time.perf_counter()
        a_state_result = _model_function(
            opts=opts,
            num_layers=num_layers,
            evol_time=target.evol_time,
            target=target.t1_gt,
            fid_thr=fidelity_thr,
            prev_solution=prev_solution,
        )
        _logger.info("|a1> optimization took %0.3f s", time.perf_counter() - tic)
        a_state_result["second_order_trotter"] = opts.second_order_trotter
        trot_utils.verify_and_print_summary(opts.num_qubits, [a_state_result])

        if opts.save_intermediate_results:
            tag = f"t1_{target.evol_time:0.3f}__nl{num_layers}"
            trot_utils.save_optim_results(output_dir, [a_state_result], target.t1_gt, tag)

        a1 = trot_utils.get_solution_from_optim_result(
            opts=opts,
            result=a_state_result,
            trotterized=True,
            state_prep_func=opts.ini_state_func[0],
        )
        fid_a1_vs_gt = fidelity(a1, target.t1_gt)
        if max(fid_a1_vs_gt, a_state_result.get("fidelity", 0.0)) > fidelity_thr:
            break
        if attempt >= num_expansions:
            break
        attempt += 1
        num_layers += 1
        _logger.info("fidelity below the bar — expanding the ansatz by one layer")

    if opts.use_mps:
        _logger.info("re-evaluating the solution at the no-truncation threshold ...")
        a1 = trot_utils.get_solution_from_optim_result(
            opts=opts,
            result=a_state_result,
            trotterized=True,
            state_prep_func=opts.ini_state_func[0],
            trunc_thr=no_truncation_threshold(),
        )
        fid_a1_vs_gt = fidelity(a1, target.t1_gt)

    assert num_layers == a_state_result["num_layers"]
    res = {
        "fid_a1_vs_gt": fid_a1_vs_gt,
        "fid_t1_vs_gt": fid_t1_vs_gt,
        "fid_a1_vs_t1": fidelity(a1, target.t1),
        "num_qubits": opts.num_qubits,
        "num_layers": num_layers,
        "block_reps": 3,
        "entangler": str(a_state_result["entangler"]),
        "num_trotter_steps": target.num_trot_steps,
        "evol_time1": target.evol_time,
        "thetas": np.asarray(a_state_result["thetas"]).copy(),
        "blocks": np.asarray(a_state_result["blocks"]).copy(),
        "use_mps": bool(opts.use_mps),
        "second_order_trotter": bool(opts.second_order_trotter),
        "ini_state_func": opts.ini_state_func[0],
        "stats": a_state_result.get("stats", None),
        "is_timeout": bool(a_state_result.get("is_timeout", False)),
        "num_iters": int(a_state_result.get("num_iters", -1)),
    }
    fids = pformat({k: f"{v:0.6f}" for k, v in res.items() if k.startswith("fid_")})
    _logger.info("\n%s\n%s", fids, "-" * 80)
    return res


def run_simulation(opts: UserOptions) -> str:
    """Top entry point: per-horizon simulations, persistence, plots.
    Returns the results folder."""
    print_options(opts.__dict__, _logger)
    resume_dir = str(getattr(opts, "resume_dir", "") or "")
    if resume_dir:
        if not os.path.isdir(resume_dir):
            raise ValueError(f"resume_dir does not exist: {resume_dir!r}")
        output_dir = resume_dir
        all_results, prev_solution = _load_horizon_checkpoint(output_dir, opts)
        _logger.info(
            "resuming into %s after %d completed horizon(s)",
            output_dir,
            len(all_results),
        )
    else:
        output_dir = trot_utils.prepare_output_folder(opts, __file__)
        all_results, prev_solution = [], None
    targets = get_target_states(opts)
    if opts.target_only:
        return output_dir

    targets = targets[0 : min(len(targets), len(opts.trotter_steps))]
    user_exit = UserExit(True)

    for idx, targ in enumerate(targets):
        if idx < len(all_results):
            continue  # restored from the horizon checkpoint
        if user_exit.terminate():
            break
        if chk.is_list(opts.manual_num_layers) and len(opts.manual_num_layers) > idx:
            num_layers = int(opts.manual_num_layers[idx])
        else:
            num_layers = int(opts.num_layers_inc * (idx + 1))

        res = _time_evolution(
            opts=opts,
            num_layers=num_layers,
            num_expansions=int(getattr(opts, "num_expansions", 0)),
            target=targ,
            output_dir=output_dir,
            prev_solution=prev_solution,
        )
        all_results.append(res)
        if getattr(opts, "warm_start_horizons", False):
            prev_solution = {
                "thetas": np.asarray(res["thetas"]),
                "num_layers": int(res["num_layers"]),
                "evol_time": float(res["evol_time1"]),
                "num_qubits": int(res["num_qubits"]),
            }
        _save_horizon_checkpoint(output_dir, opts, all_results, prev_solution)

    with open(os.path.join(output_dir, "all_results.pkl"), "wb") as fld:
        pickle.dump(all_results, fld)

    plot_fidelity_profiles(
        results=all_results, output_dir=output_dir, no_print_block_rep=True
    )
    _logger.info("results folder: %s", output_dir)
    return output_dir
