"""Plain matrix-product-state reference of the ASP objective and its
gradient, in complex128 with ``torch.linalg.svd``.

The state is kept in right-canonical form: site tensors ``B_i`` of shape
(left bond, 2, right bond) whose product is the amplitude, and the Schmidt
values ``lam[i]`` of bond i (between sites i and i + 1).  A two-site gate
contracts the pair, takes one SVD and truncates it by the workload's rule:
drop the largest tail of singular values whose norm is at most
``trunc_thr`` times the norm of all of them, keep at most ``chi``, and scale
the kept ones back to the full norm.  Bonds have the size they need; no
padding.

* :func:`target_state` -- the second-order XXZ Trotter evolution of the
  Neel state (circuit.trotter_schedule).
* :func:`objective` -- ``1 - |<t | V(theta) |neel>|^2``.
* :func:`objective_and_gradient` -- the same and its gradient: one
  ``V^dagger`` sweep from the target keeps every intermediate ``z_k``, one
  forward sweep from the Neel state meets each ``z_k`` at triplet k and
  reads the 4x4 pair environment there; the angle derivatives then come
  from differentiating ``sum_k <U_k(theta), env_k>`` (small 4x4 gates, no
  SVD) with ``torch.autograd``.

A :class:`Precision` says how every contraction is computed.  ``EXACT`` is
complex128.  ``TF32`` is the control: complex64 with each contraction's
operands rounded to TF32 (10 mantissa bits) and summed in float32, as the
tensor cores compute with TF32 on.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import circuit as C


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype
    tf32: bool = False

    @property
    def real(self) -> torch.dtype:
        return torch.float64 if self.dtype == torch.complex128 else torch.float32


EXACT = Precision(torch.complex128)
TF32 = Precision(torch.complex64, tf32=True)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Rounds float32 (or complex64) values to TF32: 10 mantissa bits,
    to nearest, ties to even."""
    if x.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(x.resolve_conj()).contiguous()))
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def ein(prec: Precision, eq: str, *ops: torch.Tensor) -> torch.Tensor:
    if prec.tf32:
        ops = tuple(round_tf32(o) for o in ops)
    return torch.einsum(eq, *ops)


@dataclasses.dataclass
class State:
    B: List[torch.Tensor]
    lam: List[torch.Tensor]

    def copy(self) -> "State":
        return State(list(self.B), list(self.lam))

    def to(self, prec: Precision) -> "State":
        return State([b.to(prec.dtype) for b in self.B], [x.to(prec.real) for x in self.lam])


def basis_state(bits: Sequence[int], prec: Precision, device) -> State:
    B = []
    for b in bits:
        t = torch.zeros(1, 2, 1, dtype=prec.dtype, device=device)
        t[0, int(b), 0] = 1.0
        B.append(t)
    lam = [torch.ones(1, dtype=prec.real, device=device) for _ in range(len(bits) - 1)]
    return State(B, lam)


def keep_count(s: torch.Tensor, chi: int, trunc_thr: float) -> int:
    """How many of the descending singular values ``s`` the rule keeps."""
    s2 = s * s
    tail = torch.sqrt(torch.flip(torch.cumsum(torch.flip(s2, [0]), 0), [0]))
    keep = int((tail > trunc_thr * tail[0]).sum())
    return max(1, min(chi, keep))


def apply_1q(st: State, gate: torch.Tensor, q: int, prec: Precision) -> None:
    st.B[q] = ein(prec, "su,aub->asb", gate.to(prec.dtype), st.B[q])


def apply_2q(st: State, gate: torch.Tensor, lo: int, chi: int, trunc_thr: float, prec: Precision) -> None:
    """``gate`` (4x4, (lo, hi) order) on qubits (lo, lo + 1), in place."""
    bl, bh = st.B[lo], st.B[lo + 1]
    dl, dr = bl.shape[0], bh.shape[2]
    th = ein(prec, "asb,btc->astc", bl, bh)
    th = ein(prec, "stuv,auvc->astc", gate.to(prec.dtype).reshape(2, 2, 2, 2), th)
    lam_l = st.lam[lo - 1] if lo > 0 else torch.ones(1, dtype=prec.real, device=th.device)
    m = (lam_l.to(prec.dtype)[:, None, None, None] * th).reshape(dl * 2, 2 * dr)
    _, s, vh = torch.linalg.svd(m, full_matrices=False)
    k = keep_count(s, chi, trunc_thr)
    total = torch.linalg.vector_norm(s)
    scale = total / torch.linalg.vector_norm(s[:k])
    vk = vh[:k]
    st.B[lo + 1] = vk.reshape(k, 2, dr)
    st.B[lo] = ein(prec, "astc,ktc->ask", th, vk.conj().reshape(k, 2, dr)) * scale.to(prec.dtype)
    st.lam[lo] = s[:k] * scale


def overlap(a: State, b: State, prec: Precision) -> torch.Tensor:
    """``<a | b>``."""
    env = torch.ones(1, 1, dtype=prec.dtype, device=a.B[0].device)
    for x, y in zip(a.B, b.B):
        env = ein(prec, "xy,xsa,ysb->ab", env, x.conj(), y)
    return env[0, 0]


def _left_env(a: State, b: State, upto: int, prec: Precision) -> torch.Tensor:
    env = torch.ones(1, 1, dtype=prec.dtype, device=a.B[0].device)
    for i in range(upto):
        env = ein(prec, "xy,xsa,ysb->ab", env, a.B[i].conj(), b.B[i])
    return env


def _right_env(a: State, b: State, frm: int, prec: Precision) -> torch.Tensor:
    env = torch.ones(1, 1, dtype=prec.dtype, device=a.B[0].device)
    for i in range(len(a.B) - 1, frm - 1, -1):
        env = ein(prec, "asx,bsy,xy->ab", a.B[i].conj(), b.B[i], env)
    return env


def pair_environment(z: State, w: State, lo: int, prec: Precision) -> torch.Tensor:
    """(2, 2, 2, 2) ``O[s, t, u, v]`` with ``<z | X | w> = sum X[st, uv]
    O[s, t, u, v]`` for a 4x4 X on (lo, lo + 1)."""
    left = _left_env(z, w, lo, prec)
    right = _right_env(z, w, lo + 2, prec)
    zl = ein(prec, "xy,xsa->ysa", left, z.B[lo].conj())
    zl = ein(prec, "ysa,atc->ystc", zl, z.B[lo + 1].conj())
    zl = ein(prec, "ystc,cd->ystd", zl, right)
    wl = ein(prec, "yub,bvd->yuvd", w.B[lo], w.B[lo + 1])
    return ein(prec, "ystd,yuvd->stuv", zl, wl)


# ---------------------------------------------------------------- workload


@dataclasses.dataclass(frozen=True)
class Workload:
    """The sizes a configuration file states."""

    num_qubits: int
    num_layers: int
    chi: int
    trunc_thr: float
    evol_time: float
    trotter_steps: int
    delta: float
    second_order: bool = True

    @classmethod
    def from_config(cls, cfg: dict) -> "Workload":
        tgt = cfg["target"]
        return cls(int(cfg["num_qubits"]), int(cfg["num_layers"]), int(cfg["chi"]), float(cfg["trunc_thr"]),
                   float(tgt["evol_time"]), int(tgt["trotter_steps"]), float(tgt["delta"]),
                   bool(cfg["second_order"]))


def target_state(wl: Workload, prec: Precision, device) -> State:
    st = basis_state(C.neel_bits(wl.num_qubits), prec, device)
    for gate, los in C.trotter_schedule(wl.num_qubits, wl.evol_time, wl.trotter_steps, wl.delta,
                                        wl.second_order):
        g = torch.as_tensor(gate, device=device).to(prec.dtype)
        for lo in los:
            apply_2q(st, g, lo, wl.chi, wl.trunc_thr, prec)
    return st


def _gates(wl: Workload, thetas: torch.Tensor, prec: Precision):
    return (C.front_gates(thetas, wl.num_qubits, prec.dtype),
            C.triplet_gates(thetas, wl.num_qubits, wl.num_layers, prec.dtype),
            C.triplet_sequence(wl.num_qubits, wl.num_layers, wl.second_order))


def _thetas(thetas, prec: Precision, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(thetas, dtype=np.float64), device=device).to(prec.real)


def apply_ansatz(wl: Workload, thetas, prec: Precision, device) -> State:
    """``V(theta) |neel>``, truncated at every triplet."""
    th = _thetas(thetas, prec, device)
    front, trip, seq = _gates(wl, th, prec)
    st = basis_state(C.neel_bits(wl.num_qubits), prec, device)
    for q in range(wl.num_qubits):
        apply_1q(st, front[q], q, prec)
    for k, lo in seq:
        apply_2q(st, trip[k], lo, wl.chi, wl.trunc_thr, prec)
    return st


def objective(wl: Workload, thetas, target: State, prec: Precision = EXACT) -> float:
    w = apply_ansatz(wl, thetas, prec, target.B[0].device)
    return float(1.0 - overlap(target, w, prec).abs() ** 2)


def objective_and_gradient(wl: Workload, thetas, target: State,
                           prec: Precision = EXACT) -> Tuple[float, np.ndarray]:
    device = target.B[0].device
    th = _thetas(thetas, prec, device)
    with torch.no_grad():
        front, trip, seq = _gates(wl, th, prec)
        # z[k]: the target after the daggered gates of applications k.. (z[len] = t).
        zs = [None] * (len(seq) + 1)
        z = target.copy()
        zs[len(seq)] = z.copy()
        for i in range(len(seq) - 1, -1, -1):
            k, lo = seq[i]
            apply_2q(z, trip[k].conj().T, lo, wl.chi, wl.trunc_thr, prec)
            zs[i] = z.copy()
        # Front layer on the product state, and its per-qubit environments.
        bits = C.neel_bits(wl.num_qubits)
        phi = [front[q][:, bits[q]] for q in range(wl.num_qubits)]
        w = basis_state(bits, prec, device)
        for q in range(wl.num_qubits):
            apply_1q(w, front[q], q, prec)
        z0 = zs[0]
        envs_1q = []
        for q in range(wl.num_qubits):
            left = _left_env(z0, w, q, prec)
            right = _right_env(z0, w, q + 1, prec)
            envs_1q.append(ein(prec, "xy,xsa,ab->ys", left, z0.B[q].conj(), right)[0])
        envs_2q = []
        for i, (k, lo) in enumerate(seq):
            envs_2q.append(pair_environment(zs[i + 1], w, lo, prec).reshape(4, 4))
            apply_2q(w, trip[k], lo, wl.chi, wl.trunc_thr, prec)
        amp = overlap(target, w, prec)
        del zs
    # d<t|w>/dtheta = sum_k <z_k| dU_k |w_k-1> + front terms: differentiate
    # Re(conj(amp) * that sum) through the small gates alone.
    th_g = th.detach().clone().requires_grad_(True)
    front_g = C.front_gates(th_g, wl.num_qubits, prec.dtype)
    trip_g = C.triplet_gates(th_g, wl.num_qubits, wl.num_layers, prec.dtype)
    lin = sum((front_g[q][:, bits[q]] * envs_1q[q]).sum() for q in range(wl.num_qubits))
    lin = lin + sum((trip_g[k] * env).sum() for (k, _), env in zip(seq, envs_2q))
    (lin * amp.conj()).real.backward()
    grad = -2.0 * th_g.grad.detach().to(torch.float64).cpu().numpy()
    return float(1.0 - amp.abs() ** 2), grad


def from_vidal(gammas: torch.Tensor, lambdas: torch.Tensor, prec: Precision = EXACT) -> State:
    """A padded Vidal-form MPS (``gammas (n, 2, chi, chi)``, ``lambdas
    (n - 1, chi)``, site j = bit j, the outer bonds on index 0) in this
    module's form, to compare a state another code produced."""
    g = gammas.to(prec.dtype)
    lam = lambdas.to(prec.real)
    n = g.shape[0]
    B = []
    for i in range(n):
        t = g[i].permute(1, 0, 2)  # (left, s, right)
        if i == 0:
            t = t[:1]
        t = t * lam[i].to(prec.dtype)[None, None, :] if i < n - 1 else t[:, :, :1]
        B.append(t)
    return State(B, [lam[i] for i in range(n - 1)])


def infidelity(a: State, b: State) -> float:
    """``1 - |<a|b>|^2 / (<a|a> <b|b>)``, in complex128."""
    prec = EXACT
    a, b = a.to(prec), b.to(prec)
    ab = overlap(a, b, prec)
    aa = overlap(a, a, prec).real
    bb = overlap(b, b, prec).real
    return float(1.0 - ab.abs() ** 2 / (aa * bb))
