"""Reference-API compatibility layer (twin of ``aqc_research_tpu/compat.py``):
every public symbol of ``qiskit-community/aqc-research`` mapped onto the
port, as thin wrappers over its torch functions where the signatures
translate directly.  Vectors and matrices may be tensors (used as they are)
or numpy arrays (moved to the default device in their own dtype); results
are tensors.

Reference module -> home in the port:

=========================  =============================================
aqc_research.checking       aqc_research_tpu_torch.checking
aqc_research.utils          aqc_research_tpu_torch.utils
parametric_circuit          circuit.ansatz (Ansatz / TrotterAnsatz)
circuit_structures          circuit.structures
elementary_operations       circuit.gates
core_operations             ops.statevector + ops.gradients (+ wrappers here)
core_op_matrix              ops.statevector/gradients via tail + ops.coord_descent
mps_operations              ops.mps
mps_dot_objective           ops.mps_gradient (+ per-gate wrappers here)
circuit_transform           circuit.export + circuit.program + circuit.qasm
target_generator            targets.generator
optimizer                   optim (stoppers, AqcOptimizer) + optim.lbfgs
job_executor                parallel.executor (+ parallel.multistart)
model_sp_lhs.*              models.sp_lhs.*
model_sketching.*           models.sketching.*
=========================  =============================================
"""

from __future__ import annotations

import numpy as np
import torch

from .circuit import gates as G
from .circuit.ansatz import Ansatz
from .circuit.gates import np_gate_on_qubit, np_two_qubit_on
from .ops import mps as mpsop
from .ops.statevector import apply_1q, apply_2q, as_state, pauli_dot

# -----------------------------------------------------------------------------
# core_operations-style per-gate vector kernels (functional: return a new
# tensor).  ``qubit`` is the little-endian Qiskit index.
# -----------------------------------------------------------------------------


def _rot(fn, angle, v: torch.Tensor) -> torch.Tensor:
    return fn(angle, v.dtype, v.device)


def gate2x2_mul_vec(gate2x2, vec, qubit: int):
    """``G_qubit @ vec`` (reference gate2x2_mul_vec)."""
    v = as_state(vec)
    return apply_1q(v, torch.as_tensor(gate2x2, device=v.device), qubit)


def rx_mul_vec(angle, qubit: int, vec):
    v = as_state(vec)
    return apply_1q(v, _rot(G.rx, angle, v), qubit)


def ry_mul_vec(angle, qubit: int, vec):
    v = as_state(vec)
    return apply_1q(v, _rot(G.ry, angle, v), qubit)


def rz_mul_vec(angle, qubit: int, vec):
    v = as_state(vec)
    return apply_1q(v, _rot(G.rz, angle, v), qubit)


def proj00_mul_vec(vec, qubit: int):
    """|0><0| projector at ``qubit``."""
    v = as_state(vec)
    return apply_1q(v, G.proj0(v.dtype, v.device), qubit)


def proj11_mul_vec(vec, qubit: int):
    """|1><1| projector at ``qubit``."""
    v = as_state(vec)
    return apply_1q(v, G.proj1(v.dtype, v.device), qubit)


def cx_mul_vec(ctrl: int, targ: int, vec):
    v = as_state(vec)
    return apply_2q(v, G.controlled(G.x(v.dtype, v.device)), ctrl, targ)


def cz_mul_vec(ctrl: int, targ: int, vec):
    v = as_state(vec)
    return apply_2q(v, G.controlled(G.z(v.dtype, v.device)), ctrl, targ)


def cp_mul_vec(angle, ctrl: int, targ: int, vec):
    v = as_state(vec)
    return apply_2q(v, G.controlled(_rot(G.phase, angle, v)), ctrl, targ)


def block_mul_vec(circ: Ansatz, tht, ctrl: int, targ: int, vec, dagger: bool = False):
    """One fused unit block applied to a vector (reference block_mul_vec:
    five sparse passes there, one 4x4 pass here)."""
    from .ops.statevector import block_gates

    v = as_state(vec)
    th = torch.as_tensor(np.asarray(tht), device=v.device)[None, :]
    return apply_2q(v, block_gates(circ, th, v.dtype, dagger=dagger)[0], ctrl, targ)


def derv_cphase_mul_vec(angle, ctrl: int, targ: int, vec):
    """d/da CPhase(a) applied to a vector."""
    from .config import real_of
    from .ops.gradients import _cp_derv_4x4

    v = as_state(vec)
    return apply_2q(v, _cp_derv_4x4(torch.as_tensor(angle, dtype=real_of(v.dtype), device=v.device), v.dtype),
                    ctrl, targ)


def dot_x(qubit: int, w_vec, z_vec):
    """``0.5j * <X w | z>``."""
    return pauli_dot(as_state(w_vec), as_state(z_vec), "x", qubit)


def dot_y(qubit: int, w_vec, z_vec):
    return pauli_dot(as_state(w_vec), as_state(z_vec), "y", qubit)


def dot_z(qubit: int, w_vec, z_vec):
    return pauli_dot(as_state(w_vec), as_state(z_vec), "z", qubit)


# -----------------------------------------------------------------------------
# core_op_matrix-style kernels: the same entry points on a (2^n, m) matrix.
# -----------------------------------------------------------------------------


def _mat_1q(gate_of, qubit: int, mat):
    m = as_state(mat)
    return apply_1q(m, gate_of(m), qubit, tail=int(m.shape[-1]))


def _mat_2q(gate_of, ctrl: int, targ: int, mat):
    m = as_state(mat)
    return apply_2q(m, gate_of(m), ctrl, targ, tail=int(m.shape[-1]))


def rx_mul_mat(angle, qubit: int, mat):
    return _mat_1q(lambda m: _rot(G.rx, angle, m), qubit, mat)


def ry_mul_mat(angle, qubit: int, mat):
    return _mat_1q(lambda m: _rot(G.ry, angle, m), qubit, mat)


def rz_mul_mat(angle, qubit: int, mat):
    return _mat_1q(lambda m: _rot(G.rz, angle, m), qubit, mat)


def gate2x2_mul_mat(gate2x2, mat, qubit: int):
    return _mat_1q(lambda m: torch.as_tensor(gate2x2, device=m.device), qubit, mat)


def cx_mul_mat(ctrl: int, targ: int, mat):
    return _mat_2q(lambda m: G.controlled(G.x(m.dtype, m.device)), ctrl, targ, mat)


def cz_mul_mat(ctrl: int, targ: int, mat):
    return _mat_2q(lambda m: G.controlled(G.z(m.dtype, m.device)), ctrl, targ, mat)


def cp_mul_mat(angle, ctrl: int, targ: int, mat):
    return _mat_2q(lambda m: G.controlled(_rot(G.phase, angle, m)), ctrl, targ, mat)


def x_dot_mat(qubit: int, w_mat, z_mat):
    m = as_state(w_mat)
    return pauli_dot(m, as_state(z_mat), "x", qubit, tail=int(m.shape[-1]))


def y_dot_mat(qubit: int, w_mat, z_mat):
    m = as_state(w_mat)
    return pauli_dot(m, as_state(z_mat), "y", qubit, tail=int(m.shape[-1]))


def z_dot_mat(qubit: int, w_mat, z_mat):
    m = as_state(w_mat)
    return pauli_dot(m, as_state(z_mat), "z", qubit, tail=int(m.shape[-1]))


# -----------------------------------------------------------------------------
# mps_dot_objective-style per-gate MPS primitives.
# -----------------------------------------------------------------------------


def _mps_gate(fn, mps: mpsop.MPS, *args):
    return fn(*args, mps.gammas.dtype, mps.gammas.device)


def x_mul_mps(qubit: int, mps: mpsop.MPS) -> mpsop.MPS:
    return mpsop.apply_1q_mps(mps, _mps_gate(G.x, mps), qubit)


def y_mul_mps(qubit: int, mps: mpsop.MPS) -> mpsop.MPS:
    return mpsop.apply_1q_mps(mps, _mps_gate(G.y, mps), qubit)


def z_mul_mps(qubit: int, mps: mpsop.MPS) -> mpsop.MPS:
    return mpsop.apply_1q_mps(mps, _mps_gate(G.z, mps), qubit)


def rx_mul_mps(angle, qubit: int, mps: mpsop.MPS) -> mpsop.MPS:
    return mpsop.apply_1q_mps(mps, _mps_gate(G.rx, mps, angle), qubit)


def ry_mul_mps(angle, qubit: int, mps: mpsop.MPS) -> mpsop.MPS:
    return mpsop.apply_1q_mps(mps, _mps_gate(G.ry, mps, angle), qubit)


def rz_mul_mps(angle, qubit: int, mps: mpsop.MPS) -> mpsop.MPS:
    return mpsop.apply_1q_mps(mps, _mps_gate(G.rz, mps, angle), qubit)


def _two_q_mps(mps, gate, ctrl, targ, trunc_thr):
    lo, hi = min(ctrl, targ), max(ctrl, targ)
    mat = gate.reshape(2, 2, 2, 2)
    if ctrl > targ:
        mat = mat.permute(1, 0, 3, 2)
    thr = mpsop.no_truncation_threshold() if trunc_thr is None else trunc_thr
    # Arbitrary site pairs (the reference's Aer handles the swap network
    # internally; here apply_2q_any_mps does).
    return mpsop.apply_2q_any_mps(mps, mat.reshape(4, 4), lo, hi, trunc_thr=thr)


def cx_mul_mps(ctrl: int, targ: int, mps: mpsop.MPS, *, trunc_thr=None) -> mpsop.MPS:
    return _two_q_mps(mps, G.controlled(_mps_gate(G.x, mps)), ctrl, targ, trunc_thr)


def cz_mul_mps(ctrl: int, targ: int, mps: mpsop.MPS, *, trunc_thr=None) -> mpsop.MPS:
    return _two_q_mps(mps, G.controlled(_mps_gate(G.z, mps)), ctrl, targ, trunc_thr)


def cp_mul_mps(angle, ctrl: int, targ: int, mps: mpsop.MPS, *, trunc_thr=None) -> mpsop.MPS:
    return _two_q_mps(mps, G.controlled(_mps_gate(G.phase, mps, angle)), ctrl, targ, trunc_thr)


def mps_dot_x(qubit: int, w: mpsop.MPS, z: mpsop.MPS):
    """``0.5j * <X w | z>`` in MPS form."""
    return 0.5j * mpsop.mps_dot(x_mul_mps(qubit, w), z)


def mps_dot_y(qubit: int, w: mpsop.MPS, z: mpsop.MPS):
    return 0.5j * mpsop.mps_dot(y_mul_mps(qubit, w), z)


def mps_dot_z(qubit: int, w: mpsop.MPS, z: mpsop.MPS):
    return 0.5j * mpsop.mps_dot(z_mul_mps(qubit, w), z)


# -----------------------------------------------------------------------------
# Remaining reference-named entry points.
# -----------------------------------------------------------------------------


def bit2bit_transform(n: int, i: int) -> int:
    """Bit-ordering flip between the reference's MSB-first internal
    positions and Qiskit's little-endian qubit indices; the port is
    little-endian throughout."""
    return n - 1 - int(i)


def derv_cphase(ctrl: int, targ: int, w_mat, z_mat):
    """``d<w|z>/d(angle)`` of the CPhase parameter against matrix states,
    the reference contract: ``w_mat`` already holds the CP(a) gate and the
    result is ``-1j * <P11 w | z>`` with P11 the ctrl=targ=1 projector."""
    w = as_state(w_mat)
    p11 = torch.zeros((4, 4), dtype=w.dtype, device=w.device)
    p11[3, 3] = 1.0
    tail = int(w.shape[-1]) if w.ndim == 2 else 1
    return -1j * torch.sum(apply_2q(w, p11, ctrl, targ, tail=tail).conj() * as_state(z_mat))


def np_block_matrix(n: int, c: int, t: int, c_mat, t_mat, gate_mat) -> np.ndarray:
    """Dense unit-block unitary: controlled-``gate_mat`` entangler at (c, t)
    followed by ``c_mat`` on the control and ``t_mat`` on the target."""
    ent4 = G.controlled(torch.as_tensor(np.asarray(gate_mat))).numpy()
    ent = np_two_qubit_on(ent4, c, t, n)
    mc = np_gate_on_qubit(np.asarray(c_mat), c, n)
    mt = np_gate_on_qubit(np.asarray(t_mat), t, n)
    return mc @ mt @ ent


def np_cx_matrix(n: int, c: int, t: int) -> np.ndarray:
    """Dense CX unitary on ``n`` qubits."""
    return np_two_qubit_on(G.controlled(torch.as_tensor(G.np_x())).numpy(), c, t, n)


def _fill(mat: np.ndarray, out):
    if out is not None:
        np.copyto(out, mat)
        return out
    return mat


def make_rx(phi: float, out=None):
    """Reference out-param constructor (``out`` is filled if given)."""
    return _fill(G.np_rx(phi), out)


def make_ry(phi: float, out=None):
    return _fill(G.np_ry(phi), out)


def make_rz(phi: float, out=None):
    return _fill(G.np_rz(phi), out)


def mps_from_circuit(program, num_qubits: int, *, trunc_thr=None, chi_max: int = 64):
    """MPS of ``program`` applied to |0...0> (the reference's Aer-backed
    entry point, with a GateProgram instead of a QuantumCircuit)."""
    thr = mpsop.no_truncation_threshold() if trunc_thr is None else trunc_thr
    return mpsop.mps_from_program(program, num_qubits, chi_max=chi_max, trunc_thr=thr)


def qcircuit_mul_mps(program, mps: mpsop.MPS, *, trunc_thr=None):
    """Applies a gate program to an existing MPS."""
    thr = mpsop.no_truncation_threshold() if trunc_thr is None else trunc_thr
    return mpsop.apply_program_mps(mps, program, trunc_thr=thr)
