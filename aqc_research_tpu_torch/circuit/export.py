"""Ansatz -> gate program / dense matrix (twin of
``aqc_research_tpu/circuit/export.py``).

An ansatz and its angles expand into an explicit :class:`GateProgram`, which
the statevector appliers and the MPS engine both consume.  The reference's
Qiskit route (``ansatz_to_numpy_by_qiskit``) goes through the gate program
here, as in the JAX package: no Qiskit is involved.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import checking as chk
from .ansatz import Ansatz
from .program import GateProgram, ProgramBuilder


def ansatz_to_program(circ: Ansatz, thetas, *, tol: float = 0.0) -> GateProgram:
    """Expands an ansatz and Θ (numpy or tensor) into a gate program: the
    front Rz/Ry/Rz triplets, then per unit block the entangler, Ry/Rz on the
    control and Ry/Rs on the target, the Trotter ±π/2 framing, the implicit
    trailing half-layer of a 2nd-order Trotter ansatz, ``circuit_power``
    times; gates whose angle is within ``tol`` of 0 are left out."""
    assert isinstance(circ, Ansatz)
    if isinstance(thetas, torch.Tensor):
        thetas = thetas.detach().cpu().numpy()
    thetas = np.asarray(thetas, dtype=np.float64)
    assert chk.float_1d(thetas, thetas.size == circ.num_thetas)

    n = circ.num_qubits
    th1 = circ.subset1q(thetas)
    th2 = circ.subset2q(thetas)
    trotterized = circ.is_trotterized
    half = circ.half_layer_num_blocks if trotterized else 0
    qb = ProgramBuilder(n)

    if circ.entangler == "cp":
        entangler = lambda t, c, tg: qb.cp(t[4], c, tg)  # noqa: E731
        swappable = qb.rz
    elif circ.entangler == "cz":
        entangler = lambda t, c, tg: qb.cz(c, tg)  # noqa: E731
        swappable = qb.rz
    else:
        entangler = lambda t, c, tg: qb.cx(c, tg)  # noqa: E731
        swappable = qb.rx

    for _ in range(circ.circuit_power):
        for q in range(n):
            t = th1[q]
            if abs(t[2]) > tol:
                qb.rz(t[2], q)
            if abs(t[1]) > tol:
                qb.ry(t[1], q)
            if abs(t[0]) > tol:
                qb.rz(t[0], q)

        for k in range(circ.num_blocks + half):
            k_mod = k % circ.num_blocks
            ctrl, targ = int(circ.blocks[0, k_mod]), int(circ.blocks[1, k_mod])
            t = th2[k_mod]
            if trotterized and k % 3 == 0:
                qb.rz(-np.pi / 2, ctrl)
            entangler(t, ctrl, targ)
            if abs(t[0]) > tol:
                qb.ry(t[0], ctrl)
            if abs(t[1]) > tol:
                qb.rz(t[1], ctrl)
            if abs(t[2]) > tol:
                qb.ry(t[2], targ)
            if abs(t[3]) > tol:
                swappable(t[3], targ)
            if trotterized and k % 3 == 2:
                qb.rz(np.pi / 2, targ)

    return qb.build()


ansatz_to_qcircuit = ansatz_to_program


def ansatz_to_numpy_fast(circ: Ansatz, thetas) -> np.ndarray:
    """Dense ansatz matrix from the statevector engine, as numpy."""
    from ..ops.statevector import ansatz_to_matrix

    return ansatz_to_matrix(circ, thetas).cpu().numpy()


def ansatz_to_numpy_trotter(circ: Ansatz, thetas) -> np.ndarray:
    """Dense matrix of a (possibly Trotterized) ansatz: the same engine,
    which handles the Trotter structure."""
    return ansatz_to_numpy_fast(circ, thetas)


def ansatz_to_numpy_by_qiskit(circ: Ansatz, thetas, tol: float = 0.0) -> np.ndarray:
    """Dense matrix through the gate program (the reference's Qiskit route):
    a cross-check of :func:`ansatz_to_numpy_fast`, in the precision in
    effect, as numpy."""
    from .program import program_to_matrix

    dev = thetas.device if isinstance(thetas, torch.Tensor) else None
    return program_to_matrix(ansatz_to_program(circ, thetas, tol=tol), circ.num_qubits, device=dev).cpu().numpy()
