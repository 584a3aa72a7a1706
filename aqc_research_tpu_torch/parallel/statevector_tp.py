"""Sharded statevector circuit engine (twin of
``aqc_research_tpu/parallel/statevector_tp.py``).

* The ``2^n`` state is sharded over the ``tp`` ranks of a mesh: the TOP
  ``log2(tp)`` qubits index the shard (``parallel/mesh.shard_state``), the
  rest are local.  Every rank passes its shard and gets its shard back.
* Gates on local qubits run the port's ``ops/statevector`` appliers (no
  message).
* A gate on a sharded qubit swaps the paired shard halves with the partner
  rank (the rank whose index differs in that qubit's bit) in one
  point-to-point round, then combines them locally; a two-qubit gate with
  both qubits sharded takes three rounds.  Exactly the bytes that must move
  move; the state is never gathered.

The exchanges are differentiable (the adjoint of a swap with the partner is
the same swap), so ``torch.autograd`` runs through the sharded engine; the
gradient of a replicated loss with respect to replicated Θ is then the sum
over the ranks of each rank's own contribution.
"""

from __future__ import annotations

import torch

from ..circuit.ansatz import Ansatz
from ..ops.statevector import (
    _main_and_half_gates,
    apply_1q,
    apply_2q,
    as_thetas,
    front_gates,
    pauli_dot,
)
from .comm import Axis, all_reduce_sum, axis_of, swap_with
from .mesh import num_local_qubits


class _Swap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, peer, ax):
        ctx.peer, ctx.ax = peer, ax
        return swap_with(local, peer, ax)

    @staticmethod
    def backward(ctx, grad):
        return swap_with(grad.contiguous(), ctx.peer, ctx.ax), None, None


class _SumOverAxis(torch.autograd.Function):
    """All-reduce SUM whose backward is the identity: every rank
    back-propagates the same (replicated) loss."""

    @staticmethod
    def forward(ctx, val, ax):
        return all_reduce_sum(val, ax)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _exchange(local: torch.Tensor, sb: int, ax: Axis) -> torch.Tensor:
    """The shard of the partner whose index differs in shard bit ``sb``."""
    return _Swap.apply(local, ax.index ^ (1 << sb), ax)


def _my_bit(sb: int, ax: Axis) -> int:
    return (ax.index >> sb) & 1


def _apply_1q_sharded(local, gate, sb: int, ax: Axis):
    """1q gate on a sharded qubit: one exchange + local combine."""
    other = _exchange(local, sb, ax)
    b = _my_bit(sb, ax)
    return gate[b, b].to(local.dtype) * local + gate[b, 1 - b].to(local.dtype) * other


def _apply_2q_mixed(local, g4hl, q_lo: int, sb_hi: int, ax: Axis):
    """2q gate with the high qubit sharded and the low one local; ``g4hl``
    is the gate as (hi_out, lo_out, hi_in, lo_in)."""
    other = _exchange(local, sb_hi, ax)
    b = _my_bit(sb_hi, ax)
    s0, s1 = (local, other) if b == 0 else (other, local)
    g_b = g4hl[b]  # (lo_out, hi_in, lo_in)
    return apply_1q(s0, g_b[:, 0, :], q_lo) + apply_1q(s1, g_b[:, 1, :], q_lo)


def _apply_2q_both_sharded(local, g4hl, sb_hi: int, sb_lo: int, ax: Axis):
    """2q gate with both qubits sharded: three exchanges + local combine."""
    o_l = _exchange(local, sb_lo, ax)
    o_h = _exchange(local, sb_hi, ax)
    o_hl = _exchange(o_l, sb_hi, ax)
    bh, bl = _my_bit(sb_hi, ax), _my_bit(sb_lo, ax)
    g_row = g4hl[bh, bl].to(local.dtype)  # (hi_in, lo_in)
    halves = {(bh, bl): local, (bh, 1 - bl): o_l, (1 - bh, bl): o_h, (1 - bh, 1 - bl): o_hl}
    out = torch.zeros_like(local)
    for h in (0, 1):
        for lo in (0, 1):
            out = out + g_row[h, lo] * halves[(h, lo)]
    return out


def _gate_4hl(gate4, ctrl: int, targ: int):
    """Reorders a (ctrl, targ)-ordered 4x4 into (hi, lo) (2,2,2,2) axes."""
    g = gate4.reshape(2, 2, 2, 2)
    if ctrl < targ:
        g = g.permute(1, 0, 3, 2)
    return g


def _apply_block_tp(local, gate4, ctrl: int, targ: int, n_local: int, ax: Axis):
    q_hi, q_lo = max(ctrl, targ), min(ctrl, targ)
    if q_hi < n_local:
        return apply_2q(local, gate4, ctrl, targ)
    g = _gate_4hl(gate4.to(local.dtype), ctrl, targ)
    if q_lo >= n_local:
        return _apply_2q_both_sharded(local, g, q_hi - n_local, q_lo - n_local, ax)
    return _apply_2q_mixed(local, g, q_lo, q_hi - n_local, ax)


def _tp_apply(circ: Ansatz, thetas, local: torch.Tensor, mesh, axis: str, dagger: bool):
    ax = axis_of(mesh, axis)
    n_local, _ = num_local_qubits(circ.num_qubits, ax.size)
    if local.shape[-1] != 2**n_local or local.ndim != 1:
        raise ValueError(f"expected this rank's (2^{n_local},) shard, got {tuple(local.shape)}")
    thetas = as_thetas(thetas, local)
    dtype = local.dtype
    f1q = front_gates(circ, circ.subset1q(thetas), dtype, dagger=dagger)
    gates, pattern, half = _main_and_half_gates(circ, thetas, dtype, dagger)

    def front(local):
        for q in range(circ.num_qubits):
            if q < n_local:
                local = apply_1q(local, f1q[q], q)
            else:
                local = _apply_1q_sharded(local, f1q[q], q - n_local, ax)
        return local

    def blocks(local, idx):
        for k in idx:
            c, t = pattern[k]
            local = _apply_block_tp(local, gates[k], c, t, n_local, ax)
        return local

    nb = len(pattern)
    main = list(range(nb - 1, -1, -1) if dagger else range(nb))
    half_idx = list(range(half - 1, -1, -1) if dagger else range(half))
    for _ in range(circ.circuit_power):
        if dagger:
            local = front(blocks(blocks(local, half_idx), main))
        else:
            local = blocks(blocks(front(local), main), half_idx)
    return local


def v_mul_vec_tp(circ: Ansatz, thetas, state: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """``V @ state`` on a tp-sharded statevector: ``state`` is this rank's
    ``(2^n / tp,)`` shard, the result its shard of the product.  One
    exchange per gate touch of a sharded qubit (three for a block with both
    qubits sharded), no gather."""
    return _tp_apply(circ, thetas, state, mesh, axis, dagger=False)


def v_dagger_mul_vec_tp(circ: Ansatz, thetas, state: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """``V† @ state`` on a tp-sharded statevector (this rank's shard)."""
    return _tp_apply(circ, thetas, state, mesh, axis, dagger=True)


def pauli_dot_tp(w: torch.Tensor, z: torch.Tensor, pauli: str, qubit: int, mesh, axis: str = "tp"):
    """``0.5j * <P@w|z>`` on tp-sharded states (every rank passes its
    shards); the sum over the axis is replicated on every rank."""
    ax = axis_of(mesh, axis)
    n = (w.shape[-1] * ax.size).bit_length() - 1
    n_local, _ = num_local_qubits(n, ax.size)
    if qubit < n_local:
        val = pauli_dot(w, z, pauli, qubit)
    else:
        sb = qubit - n_local
        b = _my_bit(sb, ax)
        if pauli == "x":
            val = 0.5j * torch.sum(_exchange(w, sb, ax).conj() * z)
        elif pauli == "y":
            # (Y w) on my half = Y[b, 1-b]·other = (-i if b == 0 else +i)·other
            coeff = -1j if b == 0 else 1j
            val = 0.5j * torch.sum((coeff * _exchange(w, sb, ax)).conj() * z)
        elif pauli == "z":
            sign = 1.0 if b == 0 else -1.0
            val = 0.5j * torch.sum(sign * w.conj() * z)
        else:
            raise ValueError(f"unknown Pauli: {pauli}")
    return _SumOverAxis.apply(val, ax)
