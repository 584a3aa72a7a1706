"""Coordinate-descent sweep for the full-AQC objective (twin of
``aqc_research_tpu/ops/coord_descent.py``).

One sweep walks through all angles in circuit order, carrying ``w =
V_new_prefix @ I`` and ``z = V_old_suffix† @ U``; for each angle it computes
the first and second derivative of ``fobj = 1 - |<V,U>|^2 / dim^2`` from two
inner products, takes a Newton step when f'' > tol (else clipped gradient
descent), applies the *old*-angle gate to ``z`` and the *new*-angle gate to
``w``.  ``w`` and ``z`` stay on the target's device.  The sweep is a host
loop over the angles (the JAX twin scans the periodic block pattern inside
one program; the order of the updates is the same): per angle the device
computes the qubit's 2x2 half-overlaps of ``w`` and ``z``, from which both
inner products follow, the host reads them once and takes the step in
float64, and the device applies the two gates.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..circuit import gates as G
from ..circuit.ansatz import Ansatz
from .statevector import apply_1q, apply_2q, as_state, as_thetas, half_overlaps, v_dagger_mul_mat

_LEARN_RATE = np.pi / 16
_MAX_DELTA_THETA = np.pi / 4


def _delta_theta(prod: complex, grad: complex, dim: int, tol: float) -> float:
    """Newton / clipped-GD angle increment."""
    derv1 = (-2.0 * (np.conj(prod) * grad).real) / (dim**2)
    derv2 = (-2.0 * abs(grad) ** 2 + 0.5 * abs(prod) ** 2) / (dim**2)
    if derv2 < tol:
        dt = -_LEARN_RATE * derv1 / max(abs(derv1), 1.0)
    else:
        dt = -derv1 / derv2
    abs_dt = abs(dt / _MAX_DELTA_THETA)
    return dt if abs_dt <= 1 else dt / abs_dt


def _pauli_dot(p: np.ndarray, pauli: str) -> complex:
    """``0.5j * <P w | z>`` from the 2x2 half-overlaps ``p[i, j] = <w_i | z_j>``."""
    if pauli == "x":
        return 0.5j * (p[1, 0] + p[0, 1])
    if pauli == "y":
        return -0.5 * (p[1, 0] - p[0, 1])
    return 0.5j * (p[0, 0] - p[1, 1])


def _gate(kind: str, angle: float) -> np.ndarray:
    """The 2x2 rotation (circuit/gates.py's conventions) in complex128."""
    c, s = np.cos(0.5 * angle), np.sin(0.5 * angle)
    if kind == "rz":
        return np.array([[c - 1j * s, 0.0], [0.0, c + 1j * s]])
    if kind == "ry":
        return np.array([[c, -s], [s, c]], dtype=np.complex128)
    return np.array([[c, -1j * s], [-1j * s, c]])


def _update_angle(w, z, theta: float, kind: str, pauli: str, qubit: int, tail: int, dim: int, tol: float):
    """One coordinate update: the dots from one read of the half-overlaps,
    the step on the host, the old-angle gate on z and the new one on w."""
    p = half_overlaps(w, z, qubit, tail).cpu().numpy().astype(np.complex128)
    new = theta + _delta_theta(p[0, 0] + p[1, 1], _pauli_dot(p, pauli), dim, tol)
    gates = torch.as_tensor(np.stack([_gate(kind, theta), _gate(kind, new)]), device=w.device).to(w.dtype)
    return apply_1q(w, gates[1], qubit, tail), apply_1q(z, gates[0], qubit, tail), new


def _coord_descent_sweep(circ: Ansatz, thetas: torch.Tensor, target: torch.Tensor):
    """One full sweep; returns (new_thetas, fobj)."""
    if circ.entangler == "cp":
        raise NotImplementedError(
            "coordinate descent does not handle the cp entangler (the reference's contract)"
        )
    dtype, dev = target.dtype, target.device
    dim = circ.dimension
    tail = dim
    tol = float(np.sqrt(np.finfo(np.float64).eps))
    rs, s_char = ("rx", "x") if circ.entangler == "cx" else ("rz", "z")
    ent = G.controlled(G.x(dtype, dev) if circ.entangler == "cx" else G.z(dtype, dev))

    w = torch.eye(dim, dtype=dtype, device=dev)
    z = v_dagger_mul_mat(circ, thetas, target)
    host = thetas.detach().cpu().numpy().astype(np.float64)
    thetas1q = circ.subset1q(host)
    thetas2q = circ.subset2q(host)

    # Front layer of Rz·Ry·Rz: t[2] first (z-dot), then t[1], then t[0].
    new1q = np.zeros_like(thetas1q)
    for q in range(circ.num_qubits):
        for col, kind, pauli in ((2, "rz", "z"), (1, "ry", "y"), (0, "rz", "z")):
            w, z, new1q[q, col] = _update_angle(w, z, thetas1q[q, col], kind, pauli, q, tail, dim, tol)

    new2q = np.zeros_like(thetas2q)
    for k in range(circ.num_blocks):
        c, tg = int(circ.blocks[0, k]), int(circ.blocks[1, k])
        z = apply_2q(z, ent, c, tg, tail)
        w = apply_2q(w, ent, c, tg, tail)
        for col, kind, pauli, qubit in ((0, "ry", "y", c), (1, "rz", "z", c), (2, "ry", "y", tg),
                                        (3, rs, s_char, tg)):
            w, z, new2q[k, col] = _update_angle(w, z, thetas2q[k, col], kind, pauli, qubit, tail, dim, tol)

    new_thetas = torch.as_tensor(np.concatenate([new1q.reshape(-1), new2q.reshape(-1)]), device=dev)
    fobj = 1.0 - torch.abs(torch.vdot(w.reshape(-1), z.reshape(-1)) / dim) ** 2
    return new_thetas.to(thetas.dtype), fobj.real.to(thetas.dtype)


def _sweep_inputs(thetas, target):
    tgt = as_state(target)
    return as_thetas(thetas, tgt).detach().to(tgt.device), tgt


@torch.no_grad()
def coord_descent_single_sweep(circ: Ansatz, thetas, target) -> Tuple[torch.Tensor, torch.Tensor]:
    """One coordinate-descent sweep over all angles: returns ``(new_thetas,
    fobj)`` (functional: Θ is not modified), on the target's device."""
    th, tgt = _sweep_inputs(thetas, target)
    return _coord_descent_sweep(circ, th, tgt)


class CoordDescentRun(NamedTuple):
    thetas: torch.Tensor  # best parameters seen (lowest fobj sweep)
    fobj: torch.Tensor  # best objective value
    num_sweeps: int  # sweeps actually executed
    converged: bool  # True when a stop condition fired before maxiter
    profile: torch.Tensor  # (maxiter,) per-sweep fobj, NaN beyond num_sweeps


@dataclasses.dataclass
class CoordDescentCarry:
    it: int
    stop: bool
    thetas: torch.Tensor
    best_f: torch.Tensor
    best_thetas: torch.Tensor
    profile: torch.Tensor


def coord_descent_programs(circ: Ansatz, maxiter: int, thetas_tol: float = 1e-8, fobj_thr: Optional[float] = None):
    """``(init, chunk, extract)`` of the multi-sweep descent, the chunked
    contract of ``optim.lbfgs.lbfgs_chunk_programs``: ``init(thetas0) ->
    carry``, ``chunk(carry, limit, target) -> carry`` (sweeps until
    ``carry.it >= limit`` or a stop), ``extract(carry) -> CoordDescentRun``.
    Stops when the largest angle change of a sweep falls below
    ``thetas_tol``, when ``fobj < fobj_thr``, or at ``maxiter``.  Each sweep
    reads one flag back to the host."""
    thr = float("-inf") if fobj_thr is None else float(fobj_thr)

    def init(thetas0: torch.Tensor) -> CoordDescentCarry:
        th = thetas0.detach().clone()
        profile = torch.full((int(maxiter),), float("nan"), dtype=th.dtype, device=th.device)
        inf = torch.tensor(float("inf"), dtype=th.dtype, device=th.device)
        return CoordDescentCarry(0, False, th, inf, th, profile)

    @torch.no_grad()
    def chunk(c: CoordDescentCarry, limit: int, target: torch.Tensor) -> CoordDescentCarry:
        while c.it < limit and not c.stop:
            new_thetas, fobj = _coord_descent_sweep(circ, c.thetas, target)
            change = torch.max(torch.abs(new_thetas - c.thetas))
            improved = fobj < c.best_f
            c.best_f = torch.where(improved, fobj, c.best_f)
            c.best_thetas = torch.where(improved, new_thetas, c.best_thetas)
            c.profile[c.it] = fobj
            c.stop = bool((change < thetas_tol) | (fobj < thr))
            c.thetas = new_thetas
            c.it += 1
        return c

    def extract(c: CoordDescentCarry) -> CoordDescentRun:
        return CoordDescentRun(c.best_thetas, c.best_f, c.it, c.stop, c.profile)

    return init, chunk, extract


def coord_descent_run(
    circ: Ansatz,
    thetas0,
    target,
    *,
    maxiter: int,
    thetas_tol: float = 1e-8,
    fobj_thr: Optional[float] = None,
    time_limit: Optional[float] = None,
    chunk_sweeps: int = 20,
) -> Tuple[CoordDescentRun, bool]:
    """Full multi-sweep coordinate descent on the target's device, the wall
    clock checked every ``chunk_sweeps`` sweeps.  Returns
    ``(CoordDescentRun, timed_out)``; ``time_limit`` of None or <= 0
    disables the clock."""
    init, chunk, extract = coord_descent_programs(circ, int(maxiter), float(thetas_tol), fobj_thr)
    th0, tgt = _sweep_inputs(thetas0, target)
    deadline = None if time_limit is None or time_limit <= 0 else time.perf_counter() + float(time_limit)
    carry = init(th0)
    timed_out = False
    while carry.it < maxiter:
        carry = chunk(carry, min(carry.it + int(chunk_sweeps), int(maxiter)), tgt)
        if carry.stop:
            break
        if deadline is not None and time.perf_counter() >= deadline:
            timed_out = carry.it < maxiter
            break
    return extract(carry), timed_out
