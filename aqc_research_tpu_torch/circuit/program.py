"""Minimal gate-program IR (twin of ``aqc_research_tpu/circuit/program.py``):
a circuit is a hashable tuple of :class:`Gate` records.

Supported gate set: x, y, z, h, rx, ry, rz, p (phase), cx, cz, cp.  Qubit
indices are little-endian (bit q of the basis index).  The dense appliers
(``apply_program``, ``program_to_state``, ``program_to_matrix``) apply a
program gate by gate with the statevector engine's primitives; the MPS
engine applies programs itself (ops/mps.py ``mps_from_program``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Tuple

import torch

from ..config import complex_dtype, device as default_device
from ..ops.statevector import apply_1q, apply_2q
from . import gates as G

_ONE_QUBIT = ("x", "y", "z", "h", "rx", "ry", "rz", "p")
_TWO_QUBIT = ("cx", "cz", "cp")


@dataclasses.dataclass(frozen=True)
class Gate:
    """One gate application: ``name`` on ``qubits`` with optional ``param``."""

    name: str
    qubits: Tuple[int, ...]
    param: Optional[float] = None

    def __post_init__(self):
        want = 1 if self.name in _ONE_QUBIT else 2 if self.name in _TWO_QUBIT else 0
        if want == 0:
            raise ValueError(f"unsupported gate: {self.name}")
        if len(self.qubits) != want:
            raise ValueError(f"{self.name} acts on {want} qubit(s), got {self.qubits}")


GateProgram = Tuple[Gate, ...]


class ProgramBuilder:
    """Convenience builder mirroring the QuantumCircuit mutation API."""

    def __init__(self, num_qubits: int):
        self.num_qubits = int(num_qubits)
        self._gates: list = []

    def _add(self, name, qubits, param=None):
        self._gates.append(Gate(name, tuple(int(q) for q in qubits), param))
        return self

    def x(self, q):
        return self._add("x", (q,))

    def y(self, q):
        return self._add("y", (q,))

    def z(self, q):
        return self._add("z", (q,))

    def h(self, q):
        return self._add("h", (q,))

    def rx(self, angle, q):
        return self._add("rx", (q,), float(angle))

    def ry(self, angle, q):
        return self._add("ry", (q,), float(angle))

    def rz(self, angle, q):
        return self._add("rz", (q,), float(angle))

    def p(self, angle, q):
        return self._add("p", (q,), float(angle))

    def cx(self, ctrl, targ):
        return self._add("cx", (ctrl, targ))

    def cz(self, ctrl, targ):
        return self._add("cz", (ctrl, targ))

    def cp(self, angle, ctrl, targ):
        return self._add("cp", (ctrl, targ), float(angle))

    def extend(self, program: Iterable[Gate]):
        self._gates.extend(program)
        return self

    def build(self) -> GateProgram:
        return tuple(self._gates)


def gate_matrix(gate: Gate, dtype=None, device=None) -> torch.Tensor:
    """Dense 2x2 / 4x4 matrix of one gate (4x4 in (ctrl, targ) order)."""
    dtype = complex_dtype() if dtype is None else dtype
    name, param = gate.name, gate.param
    if name == "x":
        return G.x(dtype, device)
    if name == "y":
        return G.y(dtype, device)
    if name == "z":
        return G.z(dtype, device)
    if name == "h":
        return (G.x(dtype, device) + G.z(dtype, device)) / math.sqrt(2.0)
    if name == "rx":
        return G.rx(param, dtype, device)
    if name == "ry":
        return G.ry(param, dtype, device)
    if name == "rz":
        return G.rz(param, dtype, device)
    if name == "p":
        return G.phase(param, dtype, device)
    if name == "cx":
        return G.controlled(G.x(dtype, device))
    if name == "cz":
        return G.controlled(G.z(dtype, device))
    if name == "cp":
        return G.controlled(G.phase(param, dtype, device))
    raise ValueError(f"unsupported gate: {name}")


def inverse_program(program: GateProgram) -> GateProgram:
    """Adjoint program: reversed order with negated angles (x/y/z/h/cx/cz are
    self-adjoint)."""
    return tuple(
        gate if gate.param is None else Gate(gate.name, gate.qubits, -gate.param)
        for gate in reversed(program)
    )


def apply_program(state: torch.Tensor, program: GateProgram, tail: int = 1) -> torch.Tensor:
    """Applies a gate program to a state (or to matrix columns via ``tail``),
    one pass over the state per gate, in the state's dtype and on its
    device."""
    for gate in program:
        mat = gate_matrix(gate, state.dtype, state.device)
        if len(gate.qubits) == 1:
            state = apply_1q(state, mat, gate.qubits[0], tail)
        else:
            state = apply_2q(state, mat, gate.qubits[0], gate.qubits[1], tail)
    return state


def program_to_state(program: GateProgram, num_qubits: int, dtype=None, device=None) -> torch.Tensor:
    """``program @ |0...0>`` as a dense vector (default: the precision in
    effect, the default device)."""
    dtype = complex_dtype() if dtype is None else dtype
    device = default_device() if device is None else device
    state = torch.zeros(2**num_qubits, dtype=dtype, device=device)
    state[0] = 1
    return apply_program(state, program)


def program_to_matrix(program: GateProgram, num_qubits: int, dtype=None, device=None) -> torch.Tensor:
    """Dense operator of a program.  Exponentially sized — tests/targets
    only."""
    dtype = complex_dtype() if dtype is None else dtype
    device = default_device() if device is None else device
    eye = torch.eye(2**num_qubits, dtype=dtype, device=device)
    return apply_program(eye, program, 2**num_qubits)


def state_preparation_program(
    num_qubits: int,
    *,
    flip_bit: int = -1,
    state_prep_func=None,
) -> GateProgram:
    """Program preparing ``S X_i |0>`` / ``S |0>`` / ``|0>``."""
    qb = ProgramBuilder(num_qubits)
    if flip_bit >= 0:
        qb.x(flip_bit)
    prog = qb.build()
    if callable(state_prep_func):
        prog = prog + tuple(state_prep_func(num_qubits))
    return prog
