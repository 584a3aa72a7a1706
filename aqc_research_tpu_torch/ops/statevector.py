"""Statevector / dense-matrix circuit engine (twin of
``aqc_research_tpu/ops/statevector.py``): plain functions on tensors, every
one differentiable by ``torch.autograd`` (no in-place writes to tensors on
the graph).

* **Fused unit blocks** — each unit block (entangler, four 1-qubit gates and,
  for a Trotterized ansatz, the ±pi/2 Rz framing) folds into one 4x4 gate;
  the 4x4 gates of all blocks are built in one batched sweep over Θ.
* **Fused groups** — consecutive blocks on the same adjacent pair multiply
  into one 4x4, and up to three disjoint adjacent pairs that tile a
  contiguous qubit span kron into one 64x64 contraction, so a half-layer
  costs one pass over the state instead of one per block.  Where the JAX
  twin runs ``lax.scan`` over the repeated period of the block pattern, this
  engine runs a Python loop over the same period groups: the grouping, and
  so the number of passes over the state, is the same.
* **Little-endian qubit indexing** — qubit ``q`` is bit ``q`` of the basis
  index (Qiskit convention).

Shapes: a state is ``(..., 2^n)``; a matrix right-hand side is ``(2^n, m)``.
Both go through the same appliers via ``tail``: in the row-major flattening
of ``(2^n, m)``, bit ``q`` of the row index sits at weight ``2^q * m``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..circuit import gates as G
from ..circuit.ansatz import Ansatz
from ..config import complex_dtype, device as default_device, real_of
from .cuda_graphs import device_table

# -----------------------------------------------------------------------------
# Gate-application primitives.
# -----------------------------------------------------------------------------


def apply_1q(arr: torch.Tensor, gate: torch.Tensor, qubit: int, tail: int = 1) -> torch.Tensor:
    """Applies a 2x2 gate at ``qubit`` to a state (``tail=1``) or to the rows
    of a ``(2^n, m)`` matrix (``tail=m``).  Leading batch dims are allowed."""
    m = arr.reshape(-1, 2, (2**qubit) * tail)
    return torch.matmul(gate.to(arr.dtype), m).reshape(arr.shape)


def apply_2q(
    arr: torch.Tensor, gate4: torch.Tensor, ctrl: int, targ: int, tail: int = 1
) -> torch.Tensor:
    """Applies a 4x4 gate given in (ctrl, targ) index order at arbitrary
    (possibly non-adjacent) qubits.  One pass over the state."""
    q_hi, q_lo = (ctrl, targ) if ctrl > targ else (targ, ctrl)
    g = gate4.to(arr.dtype).reshape(2, 2, 2, 2)
    if ctrl < targ:  # reorder gate axes to (hi, lo)
        g = g.permute(1, 0, 3, 2)
    mid = 2 ** (q_hi - q_lo - 1)
    m = arr.reshape(-1, 2, mid, 2, (2**q_lo) * tail)
    return torch.einsum("hlHL,aHbLc->ahblc", g, m).reshape(arr.shape)


def _pauli_from_overlaps(p: torch.Tensor, pauli: str) -> torch.Tensor:
    """``0.5j * <P w | z>`` from the 2x2 overlaps ``p[i, j] = <w_i | z_j>``
    of the qubit's two halves."""
    if pauli == "x":  # <X w|z> = <w1|z0> + <w0|z1>
        return 0.5j * (p[1, 0] + p[0, 1])
    if pauli == "y":  # <Y w|z> = i(<w1|z0> - <w0|z1>); 0.5j * i = -0.5
        return -0.5 * (p[1, 0] - p[0, 1])
    if pauli == "z":  # <Z w|z> = <w0|z0> - <w1|z1>
        return 0.5j * (p[0, 0] - p[1, 1])
    raise ValueError(f"unknown Pauli: {pauli}")


def half_overlaps(w: torch.Tensor, z: torch.Tensor, qubit: int, tail: int = 1) -> torch.Tensor:
    """The 2x2 overlaps ``<w_i | z_j>`` of the halves of ``w`` and ``z`` where
    bit ``qubit`` is i and j (one contraction for every Pauli at ``qubit``)."""
    h = (2**qubit) * tail
    return torch.einsum("aib,ajb->ij", w.reshape(-1, 2, h).conj(), z.reshape(-1, 2, h))


def pauli_dot(
    w: torch.Tensor, z: torch.Tensor, pauli: str, qubit: int, tail: int = 1
) -> torch.Tensor:
    """Computes ``0.5j * <P @ w | z>`` for P in {X, Y, Z} at ``qubit``: the
    per-parameter derivative primitive of the analytic co-sweep gradient."""
    if pauli not in ("x", "y", "z"):
        raise ValueError(f"unknown Pauli: {pauli}")
    return _pauli_from_overlaps(half_overlaps(w, z, qubit, tail), pauli)


# -----------------------------------------------------------------------------
# Folded block gates.
# -----------------------------------------------------------------------------


def _swappable_gate(entangler: str):
    """Rs — Rx for CX, Rz for CZ/CP."""
    return G.rx if entangler == "cx" else G.rz


def _entangler_gate(entangler: str, tht, dtype, dagger: bool):
    if entangler == "cp":
        angle = -tht[..., 4] if dagger else tht[..., 4]
        return G.controlled(G.phase(angle, dtype))
    base = G.z if entangler == "cz" else G.x
    return G.controlled(base(dtype, tht.device))


def block_gates(circ: Ansatz, thetas2q: torch.Tensor, dtype, dagger: bool = False):
    """Fused 4x4 gates of all unit blocks, ``(..., num_blocks, 4, 4)`` in
    (ctrl, targ) index order (leading axes of ``thetas2q``, lanes, kept).  Forward block = (C ⊗ T) @ E with C = Rz(t1)·Ry(t0),
    T = Rs(t3)·Ry(t2); dagger block = E† @ (C† ⊗ T†).  For a Trotterized
    ansatz the triplet framings Rz(∓pi/2) fold into the first/last block of
    each triplet."""
    rs = _swappable_gate(circ.entangler)
    t = thetas2q
    if dagger:
        c_mat = torch.matmul(G.ry(-t[..., 0], dtype), G.rz(-t[..., 1], dtype))
        t_mat = torch.matmul(G.ry(-t[..., 2], dtype), rs(-t[..., 3], dtype))
        ent = _entangler_gate(circ.entangler, t, dtype, dagger=True)
        blocks4 = torch.matmul(ent, G.kron2(c_mat, t_mat))
    else:
        c_mat = torch.matmul(G.rz(t[..., 1], dtype), G.ry(t[..., 0], dtype))
        t_mat = torch.matmul(rs(t[..., 3], dtype), G.ry(t[..., 2], dtype))
        ent = _entangler_gate(circ.entangler, t, dtype, dagger=False)
        blocks4 = torch.matmul(G.kron2(c_mat, t_mat), ent)

    if circ.is_trotterized and circ.num_blocks > 0:
        dev = thetas2q.device
        idx = np.arange(thetas2q.shape[-2])
        eye = G.eye2(dtype, dev)
        rz_m = G.kron2(G.rz(-np.pi / 2, dtype, dev), eye)  # on ctrl, triplet start
        rz_p = G.kron2(eye, G.rz(np.pi / 2, dtype, dev))  # on targ, triplet end
        start = device_table(tuple(bool(k) for k in idx % 3 == 0), torch.bool, dev)[:, None, None]
        end = device_table(tuple(bool(k) for k in idx % 3 == 2), torch.bool, dev)[:, None, None]
        if dagger:
            pre = torch.where(end, torch.matmul(blocks4, rz_p.conj().T), blocks4)
            blocks4 = torch.where(start, torch.matmul(rz_m.conj().T, pre), pre)
        else:
            pre = torch.where(start, torch.matmul(blocks4, rz_m), blocks4)
            blocks4 = torch.where(end, torch.matmul(rz_p, pre), pre)
    return blocks4


def front_gates(circ: Ansatz, thetas1q: torch.Tensor, dtype, dagger: bool = False):
    """Fused Rz·Ry·Rz front-layer gates, ``(..., num_qubits, 2, 2)``.
    Forward: Rz(t0)·Ry(t1)·Rz(t2); dagger: Rz(-t2)·Ry(-t1)·Rz(-t0)."""
    t = thetas1q
    if dagger:
        return torch.matmul(
            torch.matmul(G.rz(-t[..., 2], dtype), G.ry(-t[..., 1], dtype)),
            G.rz(-t[..., 0], dtype),
        )
    return torch.matmul(
        torch.matmul(G.rz(t[..., 0], dtype), G.ry(t[..., 1], dtype)), G.rz(t[..., 2], dtype)
    )


# -----------------------------------------------------------------------------
# Structure periodicity.
# -----------------------------------------------------------------------------


def structure_period(circ: Ansatz) -> int:
    """Smallest block-pattern period ``p`` such that column ``k`` of the block
    structure equals column ``k mod p`` (and, for Trotterized ansatze,
    ``p % 3 == 0`` so the triplet framing stays aligned).  Returns
    ``num_blocks`` when no shorter period exists."""
    blocks = circ.blocks
    nb = circ.num_blocks
    if nb == 0:
        return 0
    for p in range(1, nb):
        if circ.is_trotterized and p % 3 != 0:
            continue
        if np.array_equal(blocks[:, p:], blocks[:, : nb - p]):
            return p
    return nb


def _split_periods(circ: Ansatz) -> Tuple[int, int, int]:
    """Returns (period, full_repeats, remainder)."""
    p = structure_period(circ)
    if p == 0:
        return 0, 0, 0
    return p, circ.num_blocks // p, circ.num_blocks % p


# -----------------------------------------------------------------------------
# Circuit application.
# -----------------------------------------------------------------------------


def _block_pattern(circ: Ansatz) -> List[Tuple[int, int]]:
    return [(int(circ.blocks[0, k]), int(circ.blocks[1, k])) for k in range(circ.num_blocks)]


def _main_and_half_gates(circ: Ansatz, thetas: torch.Tensor, dtype, dagger: bool):
    """Returns ``(gates, pattern, half)`` — the fused 4x4 gates and (ctrl,
    targ) pattern of the main blocks, plus the number of implicit trailing
    half-layer blocks (2nd-order Trotter).  The half-layer reuses
    ``gates[:half]`` and ``pattern[:half]``."""
    gates = block_gates(circ, circ.subset2q(thetas), dtype, dagger=dagger)
    half = circ.half_layer_num_blocks if circ.is_trotterized else 0
    return gates, _block_pattern(circ), half


_MAX_FUSED_PAIRS = 3  # up to 3 disjoint unit blocks fuse into one 64x64 gate


def _plan_disjoint_groups(seq: Sequence[Tuple[int, int]]) -> List[List[int]]:
    """Greedily groups consecutive blocks for fusion.  Within a group:

    * blocks on the SAME adjacent pair multiply into one 4x4 (Trotter
      triplets: three blocks on one pair become one gate), and
    * blocks on DISJOINT pairs that tile a contiguous qubit span kron into
      one ``4^m x 4^m`` gate (m <= _MAX_FUSED_PAIRS) — one state pass per
      half-layer instead of one per block.

    Reordering consecutive blocks within a group is safe: same-pair gates
    keep their order (matrix product), and distinct pairs are disjoint, so
    their gates commute.  Returns a list of index-lists into ``seq``.
    """
    groups: List[List[int]] = []
    current: List[int] = []
    current_pairs: set = set()

    def span_ok(pairs):
        qs = sorted(q for p_ in pairs for q in p_)
        return qs == list(range(qs[0], qs[-1] + 1))

    for k, (c, t) in enumerate(seq):
        if abs(c - t) != 1:
            if current:
                groups.append(current)
                current, current_pairs = [], set()
            groups.append([k])
            continue
        pr = (min(c, t), max(c, t))
        if pr in current_pairs:
            current.append(k)  # same pair: fuse by matrix product
            continue
        trial_pairs = current_pairs | {pr}
        overlap = any(set(pr) & set(p_) for p_ in current_pairs)
        if current and not overlap and len(trial_pairs) <= _MAX_FUSED_PAIRS and span_ok(trial_pairs):
            current.append(k)
            current_pairs = trial_pairs
        else:
            if current:
                groups.append(current)
            current, current_pairs = [k], {pr}
    if current:
        groups.append(current)
    return groups


def _hi_lo(gate4: torch.Tensor, ctrl: int, targ: int) -> torch.Tensor:
    """A 4x4 gate in (ctrl, targ) order, reordered to (hi, lo)."""
    if ctrl > targ:
        return gate4
    return gate4.reshape(2, 2, 2, 2).permute(1, 0, 3, 2).reshape(4, 4)


def _apply_group(state, gseq, seq, group, tail):
    """Applies one fused group (same-pair products + disjoint-pair kron)."""
    if len(group) == 1:
        c, t = seq[group[0]]
        return apply_2q(state, gseq[group[0]], c, t, tail)

    # Accumulate per-pair 4x4 products in (hi, lo) index order.
    per_pair: dict = {}
    for k in group:
        c, t = seq[k]
        lo = min(c, t)
        g = _hi_lo(gseq[k], c, t)
        per_pair[lo] = g if lo not in per_pair else torch.matmul(g, per_pair[lo])  # later gate left

    items = sorted(per_pair.items(), key=lambda x: -x[0])  # highest pair first
    combined = items[0][1]
    for _, g in items[1:]:
        combined = torch.kron(combined, g)
    span_lo = items[-1][0]
    m = state.reshape(-1, 4 ** len(items), (2**span_lo) * tail)
    return torch.matmul(combined.to(state.dtype), m).reshape(state.shape)


def _apply_block_sequence(state, gates, pattern, tail, reverse: bool):
    """Applies a sequence of 4x4 gates along ``pattern``: consecutive
    disjoint adjacent pairs fuse into single 4^m-dim contractions.  Where the
    ordered pattern repeats a period at least twice, the groups are planned
    over one period and the loop runs over the repetitions (the JAX twin's
    ``lax.scan``), so the grouping is the twin's."""
    total = len(pattern)
    if total == 0:
        return state
    idx = list(range(total - 1, -1, -1)) if reverse else list(range(total))
    seq = [pattern[i] for i in idx]
    p = total
    for cand in range(1, total):
        if total % cand == 0 and all(seq[k] == seq[k % cand] for k in range(total)):
            p = cand
            break

    gseq = gates.flip(0) if reverse else gates
    if p == total or total // p < 2:
        for group in _plan_disjoint_groups(seq):
            state = _apply_group(state, gseq, seq, group, tail)
        return state

    period_seq = seq[:p]
    period_groups = _plan_disjoint_groups(period_seq)
    for rep in range(total // p):
        gs = gseq[rep * p : (rep + 1) * p]
        for group in period_groups:
            state = _apply_group(state, gs, period_seq, group, tail)
    return state


def _v_mul(circ: Ansatz, thetas: torch.Tensor, arr: torch.Tensor, tail: int) -> torch.Tensor:
    """arr <- V(Θ) @ arr  (functional)."""
    dtype = arr.dtype
    f1q = front_gates(circ, circ.subset1q(thetas), dtype, dagger=False)
    for _ in range(circ.circuit_power):
        for q in range(circ.num_qubits):
            arr = apply_1q(arr, f1q[q], q, tail)
        gates, pattern, half = _main_and_half_gates(circ, thetas, dtype, dagger=False)
        arr = _apply_block_sequence(arr, gates, pattern, tail, reverse=False)
        if half:  # implicit trailing half-layer == leading half-layer
            arr = _apply_block_sequence(arr, gates[:half], pattern[:half], tail, reverse=False)
    return arr


def _v_dagger_mul(circ: Ansatz, thetas: torch.Tensor, arr: torch.Tensor, tail: int) -> torch.Tensor:
    """arr <- V(Θ)† @ arr  (functional)."""
    dtype = arr.dtype
    f1q = front_gates(circ, circ.subset1q(thetas), dtype, dagger=True)
    for _ in range(circ.circuit_power):
        gates, pattern, half = _main_and_half_gates(circ, thetas, dtype, dagger=True)
        if half:  # dagger applies the trailing half-layer first, reversed
            arr = _apply_block_sequence(arr, gates[:half], pattern[:half], tail, reverse=True)
        arr = _apply_block_sequence(arr, gates, pattern, tail, reverse=True)
        for q in range(circ.num_qubits):
            arr = apply_1q(arr, f1q[q], q, tail)
    return arr


def as_state(arr) -> torch.Tensor:
    """A state or matrix as a tensor: a tensor as it is, anything else
    (numpy) on the default device in its own dtype."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.as_tensor(np.asarray(arr), device=default_device())


def as_thetas(thetas, like: torch.Tensor) -> torch.Tensor:
    """Θ as a tensor: a tensor as it is (it may carry a graph), anything
    else in ``like``'s real precision on ``like``'s device."""
    if isinstance(thetas, torch.Tensor):
        return thetas
    return torch.as_tensor(np.asarray(thetas), dtype=real_of(like.dtype), device=like.device)


def v_mul_vec(circ: Ansatz, thetas, vec) -> torch.Tensor:
    """``V @ vec``."""
    vec = as_state(vec)
    return _v_mul(circ, as_thetas(thetas, vec), vec, 1)


def v_dagger_mul_vec(circ: Ansatz, thetas, vec) -> torch.Tensor:
    """``V† @ vec``."""
    vec = as_state(vec)
    return _v_dagger_mul(circ, as_thetas(thetas, vec), vec, 1)


def v_mul_mat(circ: Ansatz, thetas, mat) -> torch.Tensor:
    """``V @ mat`` for a ``(2^n, m)`` matrix."""
    mat = as_state(mat)
    return _v_mul(circ, as_thetas(thetas, mat), mat, int(mat.shape[-1]))


def v_dagger_mul_mat(circ: Ansatz, thetas, mat) -> torch.Tensor:
    """``V† @ mat`` for a ``(2^n, m)`` matrix."""
    mat = as_state(mat)
    return _v_dagger_mul(circ, as_thetas(thetas, mat), mat, int(mat.shape[-1]))


def ansatz_to_matrix(circ: Ansatz, thetas) -> torch.Tensor:
    """Dense circuit matrix V(Θ) in the precision in effect, on Θ's device
    (a tensor Θ) or the default device."""
    dev = thetas.device if isinstance(thetas, torch.Tensor) else default_device()
    eye = torch.eye(circ.dimension, dtype=complex_dtype(), device=dev)
    return v_mul_mat(circ, thetas, eye)
