"""OpenQASM 3 export and import of :class:`GateProgram` (twin of
``aqc_research_tpu/circuit/qasm.py``): the interoperable-circuit deliverable
without a Qiskit dependency — a text any downstream stack (Qiskit, BQSKit,
tket, cirq) can read.  For the same program the text is the JAX package's,
character for character.

Gate mapping (all in ``stdgates.inc``): x y z h rx ry rz p cx cz cp.
``q[i]`` is qubit i (little-endian bit i of the basis index), Qiskit's
convention, so the emitted circuit's ``Operator`` equals
``program_to_matrix``.  :func:`program_from_qasm3` parses the emitted
subset (and simple hand-written files using it) back into a program.
"""

from __future__ import annotations

import math
import re
from typing import List

from .program import Gate, GateProgram, ProgramBuilder

_HEADER = 'OPENQASM 3.0;\ninclude "stdgates.inc";\n'

# GateProgram name -> (qasm name, has_angle). ``p``/``cp`` are the OpenQASM 3
# phase gates; everything else is name-identical.
_EMIT = {
    "x": ("x", False),
    "y": ("y", False),
    "z": ("z", False),
    "h": ("h", False),
    "rx": ("rx", True),
    "ry": ("ry", True),
    "rz": ("rz", True),
    "p": ("p", True),
    "cx": ("cx", False),
    "cz": ("cz", False),
    "cp": ("cp", True),
}

_PARSE = {qasm: (name, has_angle) for name, (qasm, has_angle) in _EMIT.items()}


def _format_angle(angle: float) -> str:
    """Angles as exact shortest-round-trip decimals; multiples of pi/2 are
    emitted symbolically (the Trotter ±pi/2 framings read naturally)."""
    for k in (-2, -1, 1, 2):
        if angle == k * math.pi / 2:
            num = {-2: "-pi", -1: "-pi/2", 1: "pi/2", 2: "pi"}[k]
            return num
    return repr(float(angle))


def program_to_qasm3(program: GateProgram, num_qubits: int) -> str:
    """Serializes a gate program as an OpenQASM 3 circuit on ``q[num_qubits]``.

    Compile an ansatz with :func:`aqc_research_tpu_torch.circuit.export.ansatz_to_program`
    (optionally with a pruning ``tol``) and emit the result here.
    """
    lines: List[str] = [_HEADER, f"qubit[{int(num_qubits)}] q;\n"]
    for gate in program:
        qasm_name, has_angle = _EMIT[gate.name]
        qubits = ", ".join(f"q[{q}]" for q in gate.qubits)
        if has_angle:
            lines.append(f"{qasm_name}({_format_angle(gate.param)}) {qubits};\n")
        else:
            lines.append(f"{qasm_name} {qubits};\n")
    return "".join(lines)


_GATE_RE = re.compile(
    r"^\s*([a-z]+)\s*(?:\(([^)]*)\))?\s*q\[(\d+)\](?:\s*,\s*q\[(\d+)\])?\s*;\s*$"
)
_QUBIT_RE = re.compile(r"^\s*qubit\[(\d+)\]\s+(\w+)\s*;\s*$")

_PI_CONST = {"pi": math.pi, "-pi": -math.pi, "pi/2": math.pi / 2, "-pi/2": -math.pi / 2}


def _parse_angle(text: str) -> float:
    text = text.strip()
    if text in _PI_CONST:
        return _PI_CONST[text]
    # Simple symbolic forms k*pi and pi/k (hand-written files).
    m = re.fullmatch(r"(-?[\d.]+)\s*\*\s*pi", text)
    if m:
        return float(m.group(1)) * math.pi
    m = re.fullmatch(r"(-?)pi\s*/\s*([\d.]+)", text)
    if m:
        return (-1.0 if m.group(1) else 1.0) * math.pi / float(m.group(2))
    return float(text)


def program_from_qasm3(text: str) -> tuple:
    """Parses an OpenQASM 3 file using the emitted gate subset.

    Returns ``(program, num_qubits)``.  Raises ``ValueError`` on constructs
    outside the subset (measurements, custom gates, expressions beyond the
    simple pi forms) — this is a round-trip validator, not a general QASM
    front end.
    """
    num_qubits = None
    builder: ProgramBuilder | None = None
    gates: List[Gate] = []
    for raw in text.splitlines():
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        if line.startswith("OPENQASM") or line.startswith("include"):
            continue
        m = _QUBIT_RE.match(line)
        if m:
            if num_qubits is not None:
                raise ValueError("multiple qubit registers are outside the subset")
            num_qubits = int(m.group(1))
            builder = ProgramBuilder(num_qubits)
            continue
        m = _GATE_RE.match(line)
        if not m:
            raise ValueError(f"unsupported QASM line: {raw!r}")
        qasm_name, angle_text, q0, q1 = m.groups()
        if qasm_name not in _PARSE:
            raise ValueError(f"unsupported gate {qasm_name!r} in: {raw!r}")
        name, has_angle = _PARSE[qasm_name]
        if has_angle != (angle_text is not None):
            raise ValueError(f"angle mismatch for {qasm_name!r} in: {raw!r}")
        qubits = (int(q0),) if q1 is None else (int(q0), int(q1))
        param = _parse_angle(angle_text) if has_angle else None
        gates.append(Gate(name, qubits, param))
    if num_qubits is None:
        raise ValueError("no qubit register declaration found")
    assert builder is not None
    builder.extend(gates)
    return builder.build(), num_qubits


def save_qasm3(program: GateProgram, num_qubits: int, path) -> None:
    """Writes ``program_to_qasm3`` output to ``path``."""
    with open(path, "w") as fh:
        fh.write(program_to_qasm3(program, num_qubits))
