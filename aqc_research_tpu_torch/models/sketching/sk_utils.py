"""Sketching-model utilities (twin of
``aqc_research_tpu/models/sketching/sk_utils.py``): the drivers' prologue
and epilogue, accuracy metrics, persistence, ansatz and target factories,
CLI arguments.  The top singular values come from SciPy's sparse SVD on the
host; circuit matrices are computed on the default device and scored on the
host in float64.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from argparse import ArgumentParser
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ... import checking as chk
from ...circuit.ansatz import Ansatz
from ...circuit.export import ansatz_to_program
from ...circuit.qasm import save_qasm3
from ...circuit.structures import create_ansatz_structure, num_blocks_per_layer
from ...config import device
from ...ops.statevector import v_mul_mat
from ...targets import generator as targen
from ...utils import create_logger, logi, num_cpus


def circuit_matrix(circ: Ansatz, thetas) -> np.ndarray:
    """V(Θ) as a complex128 numpy matrix, computed in complex128 on the
    default device whatever the precision in effect: the scores are float64
    (a complex64 matrix of a 5-qubit, 160-block circuit already moves the
    fidelity by ~1e-5)."""
    eye = torch.eye(circ.dimension, dtype=torch.complex128, device=device())
    th = torch.as_tensor(np.asarray(thetas, np.float64), device=eye.device)
    return v_mul_mat(circ, th, eye).cpu().numpy()


_logger = create_logger(__file__)


def resolve_base_seed(
    seed: Optional[int],
    job_cache_dir: Optional[str],
    logger: Optional[logging.Logger] = None,
) -> int:
    """Resolves the driver's base PRNG seed, keeping crash-resume honest.

    Per-restart results cached under ``job_cache_dir`` are keyed by seeds
    derived from the base seed, so a resume that silently picks a NEW base
    seed (the old wall-clock default) invalidates every cache entry and the
    resume no-ops.  Rules:

    * explicit ``seed``: used verbatim and persisted next to the cache,
    * no seed + a cache dir holding a persisted seed: that seed is REUSED
      (logged) so resumes work without pinning,
    * no seed otherwise: derived from the wall clock (and persisted when a
      cache dir is given, arming future resumes).
    """
    marker = (
        os.path.join(job_cache_dir, "base_seed.txt") if job_cache_dir else None
    )
    if seed is None and marker and os.path.isfile(marker):
        with open(marker) as fld:
            seed = int(fld.read().strip())
        logi(
            logger,
            f"reusing the persisted base seed {seed} from {job_cache_dir!r} "
            "(pass seed= explicitly to override; a different seed ignores "
            "the cached restarts)",
        )
        return seed
    if seed is None:
        seed = int(round(time.time()))
    if marker:
        os.makedirs(job_cache_dir, exist_ok=True)
        if not os.path.isfile(marker):
            with open(marker, "w") as fld:
                fld.write(str(int(seed)))
    return int(seed)


def experiment_prologue(
    *,
    num_qubits: int,
    circ_layout: str,
    parametric_depth: int,
    target_name_or_func: Union[str, Callable[[int], np.ndarray]],
    result_folder: str,
    tag: str,
    seed: Optional[int],
    job_cache_dir: Optional[str],
    script_file: str,
    options: dict,
    logger: Optional[logging.Logger],
):
    """Shared driver prologue: logger, base seed (resume-aware), output
    folder, option echo, and the (U, SU) target pair.  Returns
    ``(logger, seed, output_folder, target_mat, su_target)``."""
    if logger is None:
        logger = create_logger(script_file)
    seed = resolve_base_seed(seed, job_cache_dir, logger)
    np.random.seed(seed)
    from ...utils import prepare_output_folder, print_options

    out = prepare_output_folder(result_folder, num_qubits, script_file, tag)
    print_options(options, logger, numeric_or_str=True)
    target_mat, su_target = create_target_matrix(
        num_qubits=num_qubits,
        target_name_or_func=target_name_or_func,
        num_layers=parametric_depth,
        circuit_layout=circ_layout,
        logger=logger,
    )
    return logger, seed, out, target_mat, su_target


def experiment_epilogue(
    *,
    num_qubits: int,
    results: List[Dict],
    target_mat: np.ndarray,
    su_target: np.ndarray,
    output_dir: str,
    logger: logging.Logger,
) -> str:
    """Shared driver epilogue: sort, score, persist; returns the folder."""
    postprocess_and_save_results(
        num_qubits=num_qubits,
        results=results,
        target_mat=target_mat,
        su_target=su_target,
        output_dir=output_dir,
        logger=logger,
    )
    return output_dir


def top_singular_values(mat: np.ndarray, k: int = 10) -> np.ndarray:
    """Largest ``k`` singular values via randomized SVD (SciPy)."""
    from scipy.sparse.linalg import svds

    k = min(k, min(mat.shape) - 1)
    if k < 1:
        return np.linalg.svd(mat, compute_uv=False)
    try:
        s = svds(mat, k=k, return_singular_vectors=False)
        return np.sort(s)[::-1]
    except Exception:  # small/degenerate cases — fall back to dense SVD
        return np.linalg.svd(mat, compute_uv=False)[:k]


def _approximation_accuracy(
    target: np.ndarray, circ_matrix: np.ndarray, logger: logging.Logger
) -> dict:
    """HS-cost, fidelity, top singular values of (V - U), Frobenius."""
    tic = time.perf_counter()
    logi(logger, "scoring the approximation (HS cost / fidelity / spectrum) ...")

    dim = target.shape[0]
    hsp = np.vdot(circ_matrix, target)  # Tr(V† U)
    hs_cost = 1.0 - np.abs(hsp) / dim
    fidelity_ = (1.0 + np.abs(hsp) ** 2 / dim) / (dim + 1)
    diff = circ_matrix - target
    diag = top_singular_values(diff, 10)
    max_sing = float(np.amax(diag))
    frob = (np.linalg.norm(diff, "fro") ** 2) / (2 * dim)

    logi(logger, f"accuracy metrics took {time.perf_counter() - tic:0.4f} s")
    logi(logger, f"HS cost 1 - |<V,U>|/dim = {hs_cost:0.8f}")
    logi(logger, f"fidelity = {fidelity_:0.8f}")
    logi(logger, f"sigma_max(V - U) = {max_sing:0.8f}")
    logi(logger, f"Frobenius: (|V - U|^2_F)/(2*dim): {frob:0.8f}")

    return {
        "hs_cost": hs_cost,
        "fidelity": fidelity_,
        "max_singular": max_sing,
        "frobenius": frob,
    }


def _circuit_from_best_result(
    num_qubits: int,
    best_result: dict,
    target: np.ndarray,
    su_target: np.ndarray,
    logger: logging.Logger,
):
    """Rebuilds ansatz + gate program + matrix from the best result and
    recovers the global phase that maps SU back to U."""
    circ = Ansatz.make(
        num_qubits, best_result["entangler"], np.asarray(best_result["blocks"])
    )
    thetas = np.asarray(best_result["thetas"])
    program = ansatz_to_program(circ, thetas)
    circ_matrix = circuit_matrix(circ, thetas)

    global_phase = 0.0
    tol = float(np.sqrt(np.finfo(np.float64).eps))
    if not np.allclose(target, su_target, atol=tol, rtol=tol):
        global_phase = float(np.angle(np.vdot(circ_matrix, target)))
        circ_matrix = circ_matrix * np.exp(1j * global_phase)
        logi(logger, f"global phase factor (angle): {global_phase:0.6f}")

    return program, circ, circ_matrix, global_phase


def fidelity(circuit_mat: np.ndarray, target_mat: np.ndarray) -> float:
    """``(1 + |Tr(V† U)|^2 / 2^n) / (2^n + 1)`` — average gate fidelity."""
    assert chk.complex_2d_square(circuit_mat) and chk.complex_2d_square(target_mat)
    assert circuit_mat.shape == target_mat.shape
    dim = circuit_mat.shape[0]
    return float(
        (1 + np.abs(np.vdot(circuit_mat, target_mat)) ** 2 / dim) / (dim + 1)
    )


def postprocess_and_save_results(
    *,
    num_qubits: int,
    results: List[Dict],
    target_mat: np.ndarray,
    su_target: np.ndarray,
    output_dir: str,
    logger: logging.Logger,
) -> dict:
    """Sorts results, rebuilds the best circuit, computes accuracy metrics and
    pickles everything: ``simulation_results.pkl`` and ``qcircuit.pkl``
    (the JAX package's payloads and keys), and the circuit as OpenQASM 3
    text, ``qcircuit.qasm`` (the JAX package's text)."""
    import pandas as pd

    results.sort(key=lambda x: x["cost"])
    columns = ["cost", "fidelity", "nit", "time", "exit_status", "status"]
    if results[0].get("fidelity", None) is None:
        columns.pop(1)
    summary = pd.DataFrame(results, columns=columns)
    pd.set_option("display.max_rows", None)
    logi(logger, f"\n{'-' * 24}\nSorted valid results:\n{summary}\n")

    best_result = results[0]
    program, circ, circ_matrix, global_phase = _circuit_from_best_result(
        num_qubits, best_result, target_mat, su_target, logger
    )
    acc_metrics = _approximation_accuracy(target_mat, circ_matrix, logger)

    payload = {
        "sorted_results": results,
        "best_result": {
            "program": program,
            "ansatz": circ,
            "thetas": best_result["thetas"],
            "global_phase": global_phase,
            "accuracy_metrics": acc_metrics,
        },
        "target_matrix": target_mat,
    }
    with open(os.path.join(output_dir, "simulation_results.pkl"), "wb") as fld:
        pickle.dump(payload, fld, protocol=4)
    with open(os.path.join(output_dir, "qcircuit.pkl"), "wb") as fld:
        pickle.dump({"program": program, "global_phase": global_phase}, fld, protocol=4)
    save_qasm3(program, num_qubits, os.path.join(output_dir, "qcircuit.qasm"))
    logi(logger, f"simulation results have been stored in the folder: {output_dir}")
    return payload


def create_ansatz(
    *,
    num_qubits: int,
    num_layers: int,
    circuit_layout: str,
    connectivity: str = "full",
    block_repeat: int = 1,
    entangler: str = "cx",
    logger: Optional[logging.Logger] = None,
) -> Ansatz:
    """Regular layered ansatz factory."""
    assert chk.is_int(num_qubits, num_qubits >= 2)
    if not num_layers >= 1:
        raise ValueError("the ansatz needs at least one layer")
    bpl = num_blocks_per_layer(num_qubits, circuit_layout)
    blocks = create_ansatz_structure(
        num_qubits=num_qubits,
        layout=circuit_layout,
        connectivity=connectivity,
        depth=int(max(1, num_layers)) * bpl,
        block_repeat=block_repeat,
        logger=logger,
    )
    circ = Ansatz.make(num_qubits, entangler, blocks)
    if logger:
        logi(
            logger,
            f"built a {circuit_layout!r} ansatz: {circ.num_blocks} blocks, "
            f"{circ.num_thetas} parameters",
        )
    return circ


def create_target_matrix(
    *,
    num_qubits: int,
    target_name_or_func: Union[str, Callable[[int], np.ndarray]],
    num_layers: int,
    circuit_layout: str,
    logger: logging.Logger,
) -> Tuple[np.ndarray, np.ndarray]:
    """Creates (target, SU target) from a name / 'parametric' / user callable."""
    assert chk.is_int(num_qubits, num_qubits >= 2)
    if callable(target_name_or_func):
        logi(logger, "target: caller-provided matrix function")
        target_mat = target_name_or_func(num_qubits)
    elif target_name_or_func == "parametric":
        logi(logger, f"target family: {target_name_or_func}")
        circ = create_ansatz(
            num_qubits=num_qubits,
            num_layers=num_layers,
            circuit_layout=circuit_layout,
            logger=logger,
        )
        target_thetas = np.random.uniform(0, 2 * np.pi, circ.num_thetas)
        target_mat = circuit_matrix(circ, target_thetas)
    else:
        logi(logger, f"target family: {target_name_or_func}")
        target_mat = targen.make_target_matrix(target_name_or_func, num_qubits)

    su_target = targen.make_su_matrix(target_mat)
    return target_mat, su_target


def supported_layouts() -> List[str]:
    return ["spin", "line", "cyclic_spin", "cyclic_line"]


def get_commandline_args(parser: ArgumentParser, logger: logging.Logger) -> Any:
    """CLI arguments of the sketching drivers."""
    assert isinstance(parser, ArgumentParser)
    ncpus = num_cpus()
    targ_types = targen.available_target_matrix_types() + ["parametric"]
    parser.add_argument("-n", "--num_qubits", default=5, type=int, metavar="",
                        help="number of qubits")
    parser.add_argument("-t", "--target", default="parametric", type=str, metavar="",
                        help=f"target-matrix family; choose from {targ_types}")
    parser.add_argument("-s", "--num_simuls", default=ncpus, type=int, metavar="",
                        help="how many random restarts to run")
    parser.add_argument("-j", "--num_jobs", default=ncpus, type=int, metavar="",
                        help="concurrent jobs in the multi-start fan-out")
    parser.add_argument("-o", "--timeout", default=-1, type=int, metavar="",
                        help="timeout in seconds; non-positive implies no timeout")
    parser.add_argument("-g", "--tag", default="", type=str, metavar="",
                        help="suffix appended to the results folder name")
    cargs = parser.parse_args()
    assert 2 <= cargs.num_qubits <= 16
    assert cargs.target in targ_types
    assert 1 <= cargs.num_simuls <= 100 * ncpus
    cargs.num_jobs = min(cargs.num_jobs, cargs.num_simuls)
    logi(logger, f"Command-line arguments: {cargs.__dict__}")
    return cargs
