"""The ASP workload's circuit, written down from its definition: the
4-layer Trotter-like ansatz of the reference project (qiskit-community
aqc-research, ``parametric_circuit.py`` and ``circuit_structures.py``), its
Trotter initial point, and the XXZ Trotter step of the target.

Plain numpy and torch; nothing of the program under test is imported.

Conventions (Qiskit's, little-endian: qubit q is bit q of a basis index):

* ``rx(a) = [[c, -i s], [-i s, c]]``, ``ry(a) = [[c, -s], [s, c]]``,
  ``rz(a) = diag(e^{-i a/2}, e^{i a/2})`` with ``c, s = cos, sin(a/2)``.
* Angles: ``3 n`` front-layer angles (qubit q: ``Rz(t0) Ry(t1) Rz(t2)``)
  then 4 per unit block.  A unit block on (control c, target t) is
  ``(Rz(t1) Ry(t0) on c) (Rx(t3) Ry(t2) on t) CX(c -> t)``.
* Blocks come in triplets on one adjacent pair (k, k+1): (k+1 -> k),
  (k -> k+1), (k+1 -> k); the first block of a triplet is framed by
  ``Rz(-pi/2)`` on its control before it, the last by ``Rz(pi/2)`` on its
  target after it.  A layer is the triplets of the even pairs, then of the
  odd pairs.  Second order adds a trailing half-layer that repeats the
  first ``n // 2`` triplets with their angles.
* A 4x4 two-site matrix is indexed ``2 s_lo + s_hi`` (the lower qubit
  first).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def pair_anchors(num_qubits: int, num_layers: int) -> np.ndarray:
    """The lower qubit of every main triplet, in circuit order."""
    period = np.concatenate([np.arange(0, num_qubits - 1, 2), np.arange(1, num_qubits - 1, 2)])
    return np.resize(period, num_layers * (num_qubits - 1)).astype(int)


def triplet_sequence(num_qubits: int, num_layers: int, second_order: bool) -> List[Tuple[int, int]]:
    """(triplet index, lower qubit) of every triplet application in circuit
    order; the trailing half-layer reuses the first ``n // 2`` triplets."""
    los = pair_anchors(num_qubits, num_layers)
    seq = [(k, int(lo)) for k, lo in enumerate(los)]
    if second_order:
        seq += seq[: num_qubits // 2]
    return seq


def num_thetas(num_qubits: int, num_layers: int) -> int:
    return 3 * num_qubits + 4 * 3 * num_layers * (num_qubits - 1)


def trotter_alphas(dt: float, delta: float) -> np.ndarray:
    """The three angles that make a triplet one XXZ Trotter block of step dt."""
    return np.asarray([np.pi / 2 - 0.5 * delta * dt, 0.5 * dt - np.pi / 2, np.pi / 2 - 0.5 * dt])


def trotter_initial_point(num_qubits: int, num_layers: int, evol_time: float, delta: float,
                          second_order: bool) -> np.ndarray:
    """The angles at which the ansatz is the Trotter circuit of
    ``num_layers`` steps over ``evol_time`` (the reference's "perfect"
    initial guess): per triplet, angles 5, 0 and 6 of its 12 take the block
    angles; the second-order leading half-layer takes those of dt / 2."""
    th = np.zeros(num_thetas(num_qubits, num_layers))
    blocks = th[3 * num_qubits:].reshape(num_layers, num_qubits - 1, 12)
    a = trotter_alphas(evol_time / num_layers, delta)
    blocks[:, :, 5], blocks[:, :, 0], blocks[:, :, 6] = a[0], a[1], a[2]
    if second_order:
        a = trotter_alphas(0.5 * evol_time / num_layers, delta)
        half = num_qubits // 2
        blocks[0, :half, 5], blocks[0, :half, 0], blocks[0, :half, 6] = a[0], a[1], a[2]
    return th


# ---------------------------------------------------------------- gates


def _c(re, im):
    return torch.complex(re, im)


def rx(a):
    c, s = torch.cos(a / 2), torch.sin(a / 2)
    z = torch.zeros_like(c)
    return torch.stack([torch.stack([_c(c, z), _c(z, -s)], -1), torch.stack([_c(z, -s), _c(c, z)], -1)], -2)


def ry(a):
    c, s = torch.cos(a / 2), torch.sin(a / 2)
    z = torch.zeros_like(c)
    return torch.stack([torch.stack([_c(c, z), _c(-s, z)], -1), torch.stack([_c(s, z), _c(c, z)], -1)], -2)


def rz(a):
    c, s = torch.cos(a / 2), torch.sin(a / 2)
    z = torch.zeros_like(c)
    return torch.stack([torch.stack([_c(c, -s), _c(z, z)], -1), torch.stack([_c(z, z), _c(c, s)], -1)], -2)


def _kron(a, b):
    out = torch.einsum("...ij,...kl->...ikjl", a, b)
    return out.reshape(out.shape[:-4] + (4, 4))


def _swap_qubits(g):
    """A 4x4 in (a, b) order as the same operator in (b, a) order."""
    return g.reshape(g.shape[:-2] + (2, 2, 2, 2)).transpose(-4, -3).transpose(-2, -1).reshape(g.shape)


def front_gates(thetas: torch.Tensor, num_qubits: int, dtype) -> torch.Tensor:
    """(n, 2, 2): ``Rz(t0) Ry(t1) Rz(t2)`` per qubit."""
    t = thetas[: 3 * num_qubits].reshape(num_qubits, 3)
    return (rz(t[:, 0]) @ ry(t[:, 1]) @ rz(t[:, 2])).to(dtype)


def triplet_gates(thetas: torch.Tensor, num_qubits: int, num_layers: int, dtype) -> torch.Tensor:
    """(triplets, 4, 4): each triplet's three framed unit blocks multiplied
    into one gate on its pair, in (lo, hi) order."""
    ntrip = num_layers * (num_qubits - 1)
    t = thetas[3 * num_qubits:].reshape(ntrip, 3, 4)
    rdt = t.dtype
    one = torch.ones((), dtype=rdt, device=t.device)
    eye = torch.eye(2, dtype=rz(one).dtype, device=t.device)
    zero2 = torch.zeros(2, 2, dtype=eye.dtype, device=t.device)
    x = torch.tensor([[0, 1], [1, 0]], dtype=eye.dtype, device=t.device)
    cx = torch.cat([torch.cat([eye, zero2], -1), torch.cat([zero2, x], -1)], -2)  # (ctrl, targ)
    frame_in = _kron(rz(-np.pi / 2 * one), eye)   # Rz(-pi/2) on the control
    frame_out = _kron(eye, rz(np.pi / 2 * one))   # Rz(pi/2) on the target
    out = None
    for j in range(3):
        p = t[:, j, :]
        ctrl = rz(p[:, 1]) @ ry(p[:, 0])
        targ = rx(p[:, 3]) @ ry(p[:, 2])
        blk = _kron(ctrl, targ) @ cx
        if j == 0:
            blk = blk @ frame_in
        if j == 2:
            blk = frame_out @ blk
        # Control on the upper qubit for blocks 0 and 2, on the lower for 1.
        blk = _swap_qubits(blk) if j != 1 else blk
        out = blk if out is None else blk @ out
    return out.to(dtype)


def xxz_step(dt: float, delta: float) -> np.ndarray:
    """``exp(-i dt h)`` for one pair, ``h = -(XX + YY + delta ZZ) / 4``."""
    x = np.array([[0, 1], [1, 0]], dtype=complex)
    y = np.array([[0, -1j], [1j, 0]])
    z = np.diag([1.0 + 0j, -1.0])
    h = -0.25 * (np.kron(x, x) + np.kron(y, y) + delta * np.kron(z, z))
    w, v = np.linalg.eigh(h)
    return (v * np.exp(-1j * dt * w)) @ v.conj().T


def trotter_schedule(num_qubits: int, evol_time: float, steps: int, delta: float,
                     second_order: bool) -> List[Tuple[np.ndarray, List[int]]]:
    """Half-layers of the target's Trotter circuit: (4x4 gate, lower qubits).
    Second order: even(dt/2), odd(dt), [even(dt), odd(dt)] x (steps - 1),
    even(dt/2)."""
    dt = evol_time / steps
    even, odd = list(range(0, num_qubits - 1, 2)), list(range(1, num_qubits - 1, 2))
    full, halfstep = xxz_step(dt, delta), xxz_step(dt / 2, delta)
    if not second_order:
        return [(full, even), (full, odd)] * steps
    out = [(halfstep, even), (full, odd)]
    out += [(full, even), (full, odd)] * (steps - 1)
    return out + [(halfstep, even)]


def neel_bits(num_qubits: int) -> Tuple[int, ...]:
    """The Neel preparation: X on every even qubit."""
    return tuple(1 if q % 2 == 0 else 0 for q in range(num_qubits))
