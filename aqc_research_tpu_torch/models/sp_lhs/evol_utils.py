"""Utilities of the ASP time-evolution driver (twin of
``aqc_research_tpu/models/sp_lhs/evol_utils.py``): result archives, the
solution state (MPS or dense), persistence, command-line arguments and
timestamped output folders.  Results hold numpy ``float64`` thetas, and
targets are saved as numpy, so the pickles need neither framework.
"""

from __future__ import annotations

import datetime
import os
import pickle
from argparse import ArgumentParser
from pprint import pprint
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ... import checking as chk
from ... import config
from ...circuit.ansatz import Ansatz, TrotterAnsatz
from ...circuit.export import ansatz_to_program
from ...circuit.program import GateProgram, program_to_state
from ...ops import mps as mpsop
from ...ops.statevector import v_mul_vec
from ...utils import copy_file_to_folder, create_logger
from .user_options import UserOptions

_logger = create_logger(__file__)


def load_results_from_archive(filename: str) -> List[Dict]:
    """Reads simulation results from a pickle archive (can be huge at large n)."""
    with open(filename, "rb") as fld:
        data = pickle.load(fld)
    assert isinstance(data, list), "the archive must hold a list of result dicts"
    horizons = [r["evol_time1"] for r in data]
    print(f"{len(horizons)} time horizon(s) in the archive")
    pprint(f"horizon times: {horizons}")
    return data


def program_from_result(result: dict, tol: float = 0.0) -> GateProgram:
    """The solution's gate program from an optimization result (a CX
    Trotter ansatz); gates within ``tol`` of angle 0 are left out."""
    assert isinstance(result, dict)
    assert result["entangler"] == "cx"
    circ = TrotterAnsatz.make(
        result["num_qubits"], np.asarray(result["blocks"]), bool(result["second_order_trotter"])
    )
    return ansatz_to_program(circ, np.asarray(result["thetas"]), tol=tol)


# The reference's name ("qcircuit" is a GateProgram here).
qcircuit_from_result = program_from_result


def get_solution_from_optim_result(
    opts: UserOptions,
    result: dict,
    trotterized: bool,
    state_prep_func: Optional[Callable[[int], GateProgram]] = None,
    trunc_thr: Optional[float] = None,
) -> Union[mpsop.MPS, torch.Tensor]:
    """Rebuilds the solution state ``V(Θ) S |0>`` — an MPS, or a dense
    vector when ``opts.use_mps`` is off — on ``config.device()`` in the
    precision in effect (``trunc_thr``: MPS only)."""
    num_qubits = result["num_qubits"]
    if trotterized:
        circ = TrotterAnsatz.make(num_qubits, np.asarray(result["blocks"]), opts.second_order_trotter)
    else:
        circ = Ansatz.make(num_qubits, result["entangler"], np.asarray(result["blocks"]))
    if not opts.use_mps:
        if state_prep_func is not None:
            state = program_to_state(state_prep_func(num_qubits), num_qubits)
        else:
            state = program_to_state((), num_qubits)
        return v_mul_vec(circ, np.asarray(result["thetas"]), state)
    if trunc_thr is None:
        trunc_thr = opts.trunc_thr
    if state_prep_func is not None:
        ini = mpsop.mps_from_program(
            state_prep_func(num_qubits), num_qubits, chi_max=opts.chi_max, trunc_thr=trunc_thr
        )
    else:
        ini = mpsop.mps_zero(num_qubits, opts.chi_max)
    thetas = torch.tensor(
        np.asarray(result["thetas"]), dtype=config.real_of(ini.gammas.dtype), device=ini.device
    )
    return mpsop.v_mul_mps(circ, thetas, ini, trunc_thr=trunc_thr)


def save_optim_results(
    output_dir: str,
    results: List[Dict],
    target: Optional[Union[mpsop.MPS, torch.Tensor]] = None,
    tag: str = "",
) -> None:
    """Pickles sorted optimization results; the target (an MPS or a dense
    vector) as numpy arrays."""
    assert chk.is_str(output_dir)
    assert all(results[0]["cost"] <= r["cost"] for r in results)
    tag = "" if len(tag) == 0 else ("_" + tag)
    best_cost = f"{results[0]['cost']:0.8f}"
    filename = f"trotter{tag}_n{results[0]['num_qubits']}__c{best_cost}.pkl"
    if isinstance(target, mpsop.MPS):
        target = (target.gammas.detach().cpu().numpy(), target.lambdas.detach().cpu().numpy())
    elif isinstance(target, torch.Tensor):
        target = target.detach().cpu().numpy()
    with open(os.path.join(output_dir, filename), "wb") as fld:
        pickle.dump({"results": results, "target": target}, fld)
        _logger.info("saved optimization results to %s", fld.name)


def get_commandline_args(parser: ArgumentParser) -> Any:
    """The driver's command line."""
    assert isinstance(parser, ArgumentParser)
    parser.add_argument("-n", "--num_qubits", default=5, type=int, metavar="",
                        help="number of qubits")
    parser.add_argument("-t", "--target_only", action="store_true",
                        help="only precompute the target states, then exit")
    parser.add_argument("-g", "--tag", default="", type=str, metavar="",
                        help="suffix appended to the results folder name")
    parser.add_argument("-f", "--targets_file", default="", type=str, metavar="",
                        help="load precomputed target states from this file")
    parser.add_argument("--cpu", action="store_true",
                        help="flag: run on the CPU (f64 precision)")
    parser.add_argument("--resume", default="", type=str, metavar="",
                        help="results folder of an interrupted run to resume")
    params = parser.parse_args()
    if params.num_qubits < 2:
        parser.error("--num_qubits must be at least 2")
    _logger.info("Command-line arguments: %s", params.__dict__)
    return params


def prepare_output_folder(opts: UserOptions, script_path: str) -> str:
    """Timestamped results folder, a copy of the script and the pickled
    options."""
    now = str(datetime.datetime.now().replace(microsecond=0))
    now = now.replace(":", ".").replace(" ", "_")
    output_dir = os.path.join(opts.result_dir, f"{opts.num_qubits}qubits", now)
    if isinstance(opts.tag, str) and len(opts.tag) > 0:
        output_dir = output_dir + "_" + opts.tag
    os.makedirs(output_dir, exist_ok=True)
    if os.path.isfile(script_path):
        copy_file_to_folder(output_dir, script_path)
    with open(os.path.join(output_dir, "user_options.pkl"), "wb") as fld:
        pickle.dump({k: v for k, v in opts.__dict__.items() if not callable(v)}, fld)
    return output_dir


def verify_and_print_summary(num_qubits: int, results: List[Dict]) -> None:
    """Checks the sorting by cost and logs a summary table (plain text:
    pandas is not a dependency of the port)."""
    n = len(results)
    if not all(results[i]["cost"] <= results[i + 1]["cost"] for i in range(n - 1)):
        raise ValueError("result list must be sorted ascending by 'cost'")
    best = results[0]
    assert chk.float_1d(np.asarray(best["thetas"]))
    assert chk.block_structure(num_qubits, np.asarray(best["blocks"]))
    cols = ("cost", "fidelity", "num_iters", "time")
    rows = [f"{'':>4} " + " ".join(f"{c:>14}" for c in cols)]
    for i, r in enumerate(results):
        rows.append(f"{i:>4} " + " ".join(f"{r.get(c, float('nan')):>14.6g}" for c in cols))
    _logger.info("\n%s\nSorted valid results:\n%s\n", "-" * 24, "\n".join(rows))


def print_results(results: List[Dict], result_no: Optional[int] = None) -> None:
    """Prints all or one selected horizon result."""
    if result_no is not None and not 0 <= result_no < len(results):
        raise IndexError("'result_no' is out of range")
    for idx, res in enumerate(results):
        if result_no is None or result_no == idx:
            print(f"\n{'&' * 80}\nHorizon no. {idx}\n{'&' * 80}\n")
            pprint(res)
