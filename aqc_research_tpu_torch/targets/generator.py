"""Generators of target states and target unitary matrices (twin of
``aqc_research_tpu/targets/generator.py``), numpy on the host.  Haar-random
unitaries come from SciPy's ``unitary_group``; the random families draw
from numpy's global stream, so the same seed gives the JAX package's
targets.  The "qft" target is built directly from its DFT matrix.
"""

from __future__ import annotations

from time import perf_counter
from typing import List

import numpy as np

from .. import checking as chk
from ..circuit.ansatz import Ansatz
from ..ops.statevector import v_mul_vec
from ..utils import create_logger, rand_circuit, rand_state, rand_thetas, zero_state

_logger = create_logger(__file__)


# -----------------------------------------------------------------------------
# Target states.
# -----------------------------------------------------------------------------


def available_target_state_types() -> List[str]:
    return ["parametric", "bare", "random"]


def make_target_state(target_name: str, num_qubits: int) -> np.ndarray:
    """Generates a normalized target state vector."""
    tic = perf_counter()
    if target_name == "parametric":
        circ = Ansatz.make(
            num_qubits,
            "cx",
            rand_circuit(num_qubits, np.random.randint(2 * num_qubits, 4 * num_qubits + 1)),
        )
        target = target_state_from_circuit(circ, rand_thetas(circ.num_thetas))
    elif target_name == "bare":
        circ = Ansatz.make(
            num_qubits,
            "cx",
            rand_circuit(num_qubits, np.random.randint(2 * num_qubits, 4 * num_qubits + 1)),
        )
        target = target_state_from_circuit(circ, np.zeros(circ.num_thetas))
    elif target_name == "random":
        target = rand_state(num_qubits)
        target /= np.linalg.norm(target)
    else:
        raise ValueError(
            f"no such target-state family; available: "
            f"{available_target_state_types()}, got {target_name}"
        )
    _logger.info("target state prepared in %0.2f secs", perf_counter() - tic)
    return np.asarray(target)


def target_state_from_circuit(circ: Ansatz, thetas: np.ndarray) -> np.ndarray:
    """``V(Θ) |0>`` with normalization check, as a numpy vector (computed on
    the default device)."""
    target = v_mul_vec(circ, thetas, zero_state(circ.num_qubits)).detach().cpu().numpy()
    tol = 3 * float(np.sqrt(np.finfo(np.float64).eps))
    assert np.isclose(np.linalg.norm(target), 1, rtol=tol, atol=tol)
    overlap = abs(target[0])
    if overlap > 0.9:
        _logger.warning("target state nearly equals |0> — the problem is degenerate")
    return target


# -----------------------------------------------------------------------------
# Target unitary matrices.
# -----------------------------------------------------------------------------


def available_target_matrix_types() -> List[str]:
    return [
        "random",
        "random_ps2",
        "random_ps4",
        "random_ps8",
        "random_ps16",
        "random_rank2",
        "random_rank4",
        "random_rank8",
        "random_rank16",
        "mcx",
        "qft",
        "shift1",
        "shift2",
        "shift_half",
        "random_perm",
    ]


def make_target_matrix(target_name: str, num_qubits: int) -> np.ndarray:
    """Generates a target unitary matrix of the requested family."""
    from scipy.linalg import expm
    from scipy.stats import unitary_group

    tic = perf_counter()
    dim = 2**num_qubits

    if target_name == "random":
        target = unitary_group.rvs(dim)

    elif target_name.startswith("random_rank"):
        rank = int("".join(filter(str.isdigit, target_name)))
        assert 0 < rank < dim
        q_mat = np.random.rand(dim, rank) + 1j * np.random.rand(dim, rank)
        q_mat, _ = np.linalg.qr(q_mat)
        target = expm(-0.25j * (q_mat @ np.conj(q_mat.T)))

    elif target_name.startswith("random_ps"):
        nps = int("".join(filter(str.isdigit, target_name)))
        assert 0 < nps < dim
        paulis = np.asarray(
            [
                [[1, 0], [0, 1]],
                [[0, 1], [1, 0]],
                [[0, -1j], [1j, 0]],
                [[1, 0], [0, -1]],
            ]
        )
        target = np.zeros((dim, dim), np.complex128)
        for _ in range(nps):
            pstr = np.ones((1, 1))
            for _ in range(num_qubits):
                pstr = np.kron(pstr, paulis[np.random.randint(0, 4)])
            target += pstr * (0.75 * (1 + np.random.rand()))
        target = expm(-0.25j * target)

    elif target_name == "mcx":
        target = np.eye(dim, dtype=np.complex128)
        half, last = dim // 2 - 1, dim - 1
        target[half, half], target[half, last] = 0, 1
        target[last, half], target[last, last] = 1, 0

    elif target_name == "qft":
        # DFT matrix: QFT|j> = (1/sqrt(d)) Σ_k e^{2 pi i jk/d} |k>.
        j, k = np.meshgrid(np.arange(dim), np.arange(dim), indexing="ij")
        target = np.exp(2j * np.pi * j * k / dim) / np.sqrt(dim)

    elif target_name == "shift1":
        target = np.roll(np.eye(dim, dtype=np.complex128), 1, axis=1)
    elif target_name == "shift2":
        target = np.roll(np.eye(dim, dtype=np.complex128), 2, axis=1)
    elif target_name == "shift_half":
        target = np.roll(np.eye(dim, dtype=np.complex128), dim // 2, axis=1)
    elif target_name == "random_perm":
        target = np.take(
            np.eye(dim, dtype=np.complex128), np.random.permutation(dim), axis=1
        )
    else:
        raise ValueError(
            f"no such target-matrix family; available: "
            f"{available_target_matrix_types()}, got {target_name}"
        )

    if num_qubits <= 8:
        tol = float(np.sqrt(np.finfo(np.float64).eps))
        if not np.allclose(np.vdot(target, target), dim, atol=tol, rtol=tol):
            raise ValueError("the generated target failed the unitarity check")

    _logger.info("Target matrix prepared in %0.2f secs", perf_counter() - tic)
    return np.asarray(target, dtype=np.complex128)


def make_su_matrix(mat: np.ndarray) -> np.ndarray:
    """Rescales a unitary into SU(dim): divides by det^(1/dim)."""
    assert chk.complex_2d(mat)
    tol = float(np.sqrt(np.finfo(float).eps))
    dim = mat.shape[0]
    det = np.linalg.det(mat)
    if not np.isclose(det, 1.0, atol=tol, rtol=tol):
        mat = mat / np.power(det, 1.0 / dim)
        _logger.info("rescaled the target U into SU (det = 1)")
    return mat
