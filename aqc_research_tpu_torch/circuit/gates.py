"""Elementary 2x2 / 4x4 gate constructors (twin of
``aqc_research_tpu/circuit/gates.py``).

Angles may be Python floats, numpy arrays or tensors; batched angles give
batched gates ``(..., 2, 2)``.  A tensor angle fixes the device; otherwise
``device`` does (default: the config device).

Conventions (identical to the reference / Qiskit):

* ``rx(a) = [[cos a/2, -i sin a/2], [-i sin a/2, cos a/2]]``
* ``ry(a) = [[cos a/2, -sin a/2], [sin a/2, cos a/2]]``
* ``rz(a) = diag(e^{-i a/2}, e^{+i a/2})``
* ``phase(a) = diag(1, e^{i a})``
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype, device as default_device, real_of
from ..ops.cuda_graphs import device_table


def _cdtype(dtype=None) -> torch.dtype:
    return complex_dtype() if dtype is None else dtype


def _dev(device):
    return default_device() if device is None else device


def _angle(angle, dtype, device) -> torch.Tensor:
    """The angle as a real tensor of ``dtype``'s real precision; a scalar
    angle is filled in on the device (no copy from the host)."""
    rdtype = real_of(dtype)
    if isinstance(angle, torch.Tensor):
        return angle.to(rdtype)
    if np.ndim(angle) == 0:
        return torch.full((), float(angle), dtype=rdtype, device=_dev(device))
    return torch.as_tensor(np.asarray(angle, np.float64), dtype=rdtype, device=_dev(device))


def _stack22(a, b, c, d) -> torch.Tensor:
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2)


def rx(angle, dtype=None, device=None) -> torch.Tensor:
    dtype = _cdtype(dtype)
    a = 0.5 * _angle(angle, dtype, device)
    zero = torch.zeros_like(a)
    cs = torch.complex(torch.cos(a), zero)
    sn = torch.complex(zero, -torch.sin(a))
    return _stack22(cs, sn, sn, cs)


def ry(angle, dtype=None, device=None) -> torch.Tensor:
    dtype = _cdtype(dtype)
    a = 0.5 * _angle(angle, dtype, device)
    zero = torch.zeros_like(a)
    cs = torch.complex(torch.cos(a), zero)
    sn = torch.complex(torch.sin(a), zero)
    return _stack22(cs, -sn, sn, cs)


def rz(angle, dtype=None, device=None) -> torch.Tensor:
    dtype = _cdtype(dtype)
    a = 0.5 * _angle(angle, dtype, device)
    c, s = torch.cos(a), torch.sin(a)
    ep = torch.complex(c, s)
    em = torch.complex(c, -s)
    return _stack22(em, torch.zeros_like(ep), torch.zeros_like(ep), ep)


def phase(angle, dtype=None, device=None) -> torch.Tensor:
    dtype = _cdtype(dtype)
    a = _angle(angle, dtype, device)
    e = torch.complex(torch.cos(a), torch.sin(a))
    return _stack22(torch.ones_like(e), torch.zeros_like(e), torch.zeros_like(e), e)


def _const(rows, dtype, device) -> torch.Tensor:
    """A constant gate, built once per (dtype, device) and shared."""
    return device_table(tuple(map(tuple, rows)), _cdtype(dtype), _dev(device))


def x(dtype=None, device=None) -> torch.Tensor:
    return _const([[0, 1], [1, 0]], dtype, device)


def y(dtype=None, device=None) -> torch.Tensor:
    return _const([[0, -1j], [1j, 0]], dtype, device)


def z(dtype=None, device=None) -> torch.Tensor:
    return _const([[1, 0], [0, -1]], dtype, device)


def eye2(dtype=None, device=None) -> torch.Tensor:
    return torch.eye(2, dtype=_cdtype(dtype), device=_dev(device))


def proj0(dtype=None, device=None) -> torch.Tensor:
    return _const([[1, 0], [0, 0]], dtype, device)


def proj1(dtype=None, device=None) -> torch.Tensor:
    return _const([[0, 0], [0, 1]], dtype, device)


def controlled(gate2x2: torch.Tensor, dtype=None) -> torch.Tensor:
    """4x4 controlled gate in (control, target) index order:
    ``|0><0| (x) I + |1><1| (x) G``.  Supports batched (..., 2, 2) gates;
    keeps the gate's dtype unless ``dtype`` is given."""
    g = gate2x2 if dtype is None else gate2x2.to(dtype)
    batch = g.shape[:-2]
    eye = torch.eye(2, dtype=g.dtype, device=g.device).expand(batch + (2, 2))
    zero = torch.zeros(batch + (2, 2), dtype=g.dtype, device=g.device)
    top = torch.cat([eye, zero], dim=-1)
    bot = torch.cat([zero, g], dim=-1)
    return torch.cat([top, bot], dim=-2)


def kron2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kronecker product of two (..., 2, 2) gates -> (..., 4, 4), batched."""
    a, b = torch.broadcast_tensors(a, b) if a.shape[:-2] != b.shape[:-2] else (a, b)
    out = torch.einsum("...ij,...kl->...ikjl", a, b)
    return out.reshape(out.shape[:-4] + (4, 4))


# -----------------------------------------------------------------------------
# NumPy twins — test oracles independent of the torch code they verify.
# -----------------------------------------------------------------------------


def np_rx(angle: float) -> np.ndarray:
    a = 0.5 * float(angle)
    cs, sn = np.cos(a), -1j * np.sin(a)
    return np.array([[cs, sn], [sn, cs]], dtype=np.complex128)


def np_ry(angle: float) -> np.ndarray:
    a = 0.5 * float(angle)
    cs, sn = np.cos(a), np.sin(a)
    return np.array([[cs, -sn], [sn, cs]], dtype=np.complex128)


def np_rz(angle: float) -> np.ndarray:
    e = np.exp(0.5j * float(angle))
    return np.array([[1.0 / e, 0], [0, e]], dtype=np.complex128)


def np_phase(angle: float) -> np.ndarray:
    return np.array([[1, 0], [0, np.exp(1j * float(angle))]], dtype=np.complex128)


def np_x() -> np.ndarray:
    return np.array([[0, 1], [1, 0]], dtype=np.complex128)


def np_y() -> np.ndarray:
    return np.array([[0, -1j], [1j, 0]], dtype=np.complex128)


def np_z() -> np.ndarray:
    return np.array([[1, 0], [0, -1]], dtype=np.complex128)


def np_gate_on_qubit(gate: np.ndarray, qubit: int, num_qubits: int) -> np.ndarray:
    """Expands a 2x2 gate at ``qubit`` (little-endian/Qiskit index) to the
    full ``2^n x 2^n`` operator via Kronecker products.  Oracle-only."""
    eye_hi = np.eye(2 ** (num_qubits - qubit - 1), dtype=np.complex128)
    eye_lo = np.eye(2**qubit, dtype=np.complex128)
    return np.kron(np.kron(eye_hi, gate), eye_lo)


def np_two_qubit_on(gate4x4: np.ndarray, ctrl: int, targ: int, num_qubits: int) -> np.ndarray:
    """Expands a 4x4 gate given in (ctrl, targ) index order to the full
    operator, for arbitrary (possibly non-adjacent) qubits.  Oracle-only."""
    g = np.asarray(gate4x4, dtype=np.complex128).reshape(2, 2, 2, 2)
    full = np.zeros((2**num_qubits, 2**num_qubits), dtype=np.complex128)
    for co in range(2):
        for to in range(2):
            for ci in range(2):
                for ti in range(2):
                    if g[co, to, ci, ti] == 0:
                        continue
                    op_c = np.zeros((2, 2), dtype=np.complex128)
                    op_c[co, ci] = 1
                    op_t = np.zeros((2, 2), dtype=np.complex128)
                    op_t[to, ti] = 1
                    term = np_gate_on_qubit(op_c, ctrl, num_qubits) @ np_gate_on_qubit(
                        op_t, targ, num_qubits
                    )
                    full += g[co, to, ci, ti] * term
    return full
