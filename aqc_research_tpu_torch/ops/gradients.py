"""Analytic co-sweep gradient of the dot product ``<x | V(Θ)† | y>`` (twin of
``aqc_research_tpu/ops/gradients.py``).

Two carried states

    w  <- G_k · w        (starts at x)
    z  <- G_k · z        (starts at V† y, cached from the objective pass)

walk through the circuit gate by gate; after each parametrized gate the
contribution ``grad_k = 0.5j * <P_k w | z>`` (P_k the gate's Pauli
generator) is one inner product — so the whole gradient costs ~2 circuit
applications regardless of the parameter count.

The JAX twin applies each gate of a unit block to the stacked (w, z) and
reads each inner product off the state.  Here a unit block costs two passes
over the stacked pair: one reads the 4x4 *pair overlap* ``P[k, l] = <w_k |
z_l>`` of the block's two qubits (summed over the others) where the block
starts, one applies the block's fused 4x4 gate (ops/statevector.py
``block_gates``, framing included).  A gate U on the pair maps the overlap
to ``conj(U) P U^T``, and a gate elsewhere leaves it unchanged, so every
per-parameter inner product of the block follows from its overlap and its
gates by 4x4 algebra, done for all blocks at once after the sweep.  The
front layer reads the 2x2 overlap of every qubit before its gates.  The
arithmetic is exact; only its order differs from the JAX twin's.

* One implementation serves the vector and the matrix engines through the
  ``tail`` trick (see ops/statevector.py).
* Partial gradients (``block_range``): entries outside the range are
  exactly zero.
* The 2nd-order Trotter trailing half-layer accumulates into the leading
  half-layer's gradient entries.

Returned gradients are **complex**; objectives take the real part after
scaling by the appropriate conjugate factors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..circuit import gates as G
from ..circuit.ansatz import Ansatz
from ..config import real_of
from .statevector import (
    _block_pattern,
    _entangler_gate,
    _pauli_from_overlaps,
    apply_1q,
    apply_2q,
    as_state,
    as_thetas,
    block_gates,
    front_gates,
    half_overlaps,
    v_dagger_mul_mat,
    v_dagger_mul_vec,
)


def _cp_derv_4x4(angles: torch.Tensor, dtype) -> torch.Tensor:
    """Derivative of the controlled-phase gate: diag(0, 0, 0, i e^{ia}),
    batched over ``angles``."""
    ang = angles.to(real_of(dtype))
    e = torch.complex(-torch.sin(ang), torch.cos(ang))  # i e^{ia}
    zero = torch.zeros_like(e)
    return torch.diag_embed(torch.stack([zero, zero, zero, e], dim=-1))


def _entangler_4x4(circ: Ansatz, tht2q: torch.Tensor, dtype) -> torch.Tensor:
    """The entangler of every block, ``(num_blocks, 4, 4)``."""
    return _entangler_gate(circ.entangler, tht2q, dtype, dagger=False).expand(tht2q.shape[0], 4, 4)


def pair_overlaps(w: torch.Tensor, z: torch.Tensor, ctrl: int, targ: int, tail: int = 1) -> torch.Tensor:
    """The 4x4 overlap ``P[k, l] = <w_k | z_l>`` of the qubits (ctrl, targ),
    k and l in (ctrl, targ) index order, summed over every other qubit."""
    q_hi, q_lo = (ctrl, targ) if ctrl > targ else (targ, ctrl)
    shape = (-1, 2, 2 ** (q_hi - q_lo - 1), 2, (2**q_lo) * tail)
    p = torch.einsum("aibjc,akblc->ijkl", w.reshape(shape).conj(), z.reshape(shape))
    if ctrl < targ:  # (hi, lo) -> (ctrl, targ) = (lo, hi)
        p = p.permute(1, 0, 3, 2)
    return p.reshape(4, 4)


def _block_cosweep_step(wz, gate4: torch.Tensor, ctrl: int, targ: int, tail: int):
    """One unit-block step of the co-sweep: the pair overlap where the block
    starts, then the block's fused gate on (w, z).  Returns (wz, overlap)."""
    overlap = pair_overlaps(wz[0], wz[1], ctrl, targ, tail)
    return apply_2q(wz, gate4, ctrl, targ, tail), overlap


def _transform(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The overlap after gate ``u`` on both states: ``conj(u) p u^T``."""
    return torch.matmul(torch.matmul(u.conj(), p), u.transpose(-1, -2))


def _block_dots(circ: Ansatz, thetas2q: torch.Tensor, overlaps: torch.Tensor, frame_start: torch.Tensor):
    """Per-parameter dots ``(num_steps, tpb)`` of the block steps from their
    starting pair overlaps ``(num_steps, 4, 4)`` (rows of ``thetas2q``
    aligned with them), following the gate order of a block: optional
    Rz(-pi/2) framing on ctrl, entangler (+ the CP derivative), Ry/Rz on
    ctrl, Ry/Rs on targ."""
    dtype = overlaps.dtype
    eye = G.eye2(dtype, overlaps.device)
    rs, s_char = (G.rx, "x") if circ.entangler == "cx" else (G.rz, "z")

    def on_ctrl(g):
        return G.kron2(g, eye.expand_as(g))

    def on_targ(g):
        return G.kron2(eye.expand_as(g), g)

    def pauli(p, which, kind):
        p = p.reshape(-1, 2, 2, 2, 2)
        half = torch.einsum("nitjt->nij" if which == "ctrl" else "ncicj->nij", p)
        return _pauli_from_overlaps(half.permute(1, 2, 0), kind)

    framing = on_ctrl(G.rz(-np.pi / 2, dtype, overlaps.device)[None])
    p = torch.where(frame_start[:, None, None], _transform(overlaps, framing), overlaps)
    ent = _entangler_4x4(circ, thetas2q, dtype)
    dots = []
    p_ent = _transform(p, ent)
    for g, which, kind in (
        (on_ctrl(G.ry(thetas2q[:, 0], dtype)), "ctrl", "y"),
        (on_ctrl(G.rz(thetas2q[:, 1], dtype)), "ctrl", "z"),
        (on_targ(G.ry(thetas2q[:, 2], dtype)), "targ", "y"),
        (on_targ(rs(thetas2q[:, 3], dtype)), "targ", s_char),
    ):
        p_ent = _transform(p_ent, g)
        dots.append(pauli(p_ent, which, kind))
    if circ.entangler == "cp":
        # <D w | E z> = trace(conj(D) P E^T) over the pair.
        dw_z = torch.matmul(torch.matmul(_cp_derv_4x4(thetas2q[:, 4], dtype).conj(), p), ent.transpose(-1, -2))
        dots.append(dw_z.diagonal(dim1=-2, dim2=-1).sum(-1))
    return torch.stack(dots, dim=-1)


def _front_cosweep(circ: Ansatz, wz, thetas1q, front_layer: bool, tail: int):
    """Front Rz·Ry·Rz layer of the co-sweep; returns (wz, grads (n, 3)).
    Each qubit's 2x2 overlap is read before the layer: a gate on another
    qubit leaves it unchanged."""
    dtype = wz.dtype
    n = circ.num_qubits
    grads = torch.zeros((n, 3), dtype=dtype, device=wz.device)
    if front_layer:
        p = torch.stack([half_overlaps(wz[0], wz[1], q, tail) for q in range(n)])
        dots = []
        for gate, kind in ((G.rz(thetas1q[:, 2], dtype), "z"), (G.ry(thetas1q[:, 1], dtype), "y"),
                           (G.rz(thetas1q[:, 0], dtype), "z")):
            p = _transform(p, gate)
            dots.append(_pauli_from_overlaps(p.permute(1, 2, 0), kind))
        grads = torch.stack(dots[::-1], dim=-1)  # (d0, d1, d2)
    f1q = front_gates(circ, thetas1q, dtype)
    for q in range(n):
        wz = apply_1q(wz, f1q[q], q, tail)
    return wz, grads


def _dot_product_gradient(
    circ: Ansatz,
    thetas: torch.Tensor,
    x: torch.Tensor,
    vh_y: torch.Tensor,
    tail: int,
    block_range: Tuple[int, int],
    front_layer: bool,
) -> torch.Tensor:
    # One application of V only — the value engines loop circuit_power
    # times, so power > 1 would silently give a mismatched gradient.
    if circ.circuit_power != 1:
        raise ValueError("the analytic gradient requires circuit_power == 1")
    dtype = x.dtype
    nb, tpb = circ.num_blocks, circ.tpb
    thetas = thetas.detach().to(real_of(dtype))
    thetas2q = circ.subset2q(thetas)

    wz = torch.stack([x, vh_y.to(dtype)])
    wz, grad1q = _front_cosweep(circ, wz, circ.subset1q(thetas), front_layer, tail)

    # 2nd-order Trotter: the trailing half-layer repeats blocks [0:half)
    # with their parameters; its dots accumulate into those rows.
    trot = circ.is_trotterized
    half = circ.half_layer_num_blocks if trot else 0
    steps = list(range(nb)) + list(range(half))
    pattern = _block_pattern(circ)
    gates = block_gates(circ, thetas2q, dtype)
    overlaps = []
    for k in steps:
        wz, p = _block_cosweep_step(wz, gates[k], *pattern[k], tail)
        overlaps.append(p)
    if not steps:
        return torch.cat([grad1q.reshape(-1), torch.zeros(0, dtype=dtype, device=x.device)])

    rows = torch.as_tensor(steps, device=x.device)
    frame_start = torch.as_tensor([trot and k % 3 == 0 for k in steps], device=x.device)
    dots = _block_dots(circ, thetas2q[rows], torch.stack(overlaps), frame_start)
    grad2q = torch.zeros((nb, tpb), dtype=dtype, device=x.device).index_add(0, rows, dots)
    inside = np.zeros((nb, 1), bool)
    inside[block_range[0] : block_range[1]] = True
    grad2q = torch.where(torch.as_tensor(inside, device=x.device), grad2q, torch.zeros_like(grad2q))
    return torch.cat([grad1q.reshape(-1), grad2q.reshape(-1)])


def _block_range(circ: Ansatz, block_range) -> Tuple[int, int]:
    block_range = (0, circ.num_blocks) if block_range is None else tuple(int(b) for b in block_range)
    if not 0 <= block_range[0] < block_range[1] <= circ.num_blocks:
        raise ValueError(f"block_range {block_range} outside [0, {circ.num_blocks}]")
    return block_range


def grad_of_dot_product(
    circ: Ansatz,
    thetas,
    x_vec,
    vh_y_vec,
    *,
    block_range: Optional[Tuple[int, int]] = None,
    front_layer: bool = True,
) -> torch.Tensor:
    """Complex gradient of ``<V x, y> = <x, V† y>`` w.r.t. Θ (vector engine).

    ``vh_y_vec`` must already hold ``V† y`` (cached from the objective
    pass)."""
    x_vec = as_state(x_vec)
    return _dot_product_gradient(
        circ, as_thetas(thetas, x_vec), x_vec, as_state(vh_y_vec), 1,
        _block_range(circ, block_range), bool(front_layer),
    )


def grad_of_matrix_dot_product(
    circ: Ansatz,
    thetas,
    x_mat,
    vh_y_mat,
    *,
    block_range: Optional[Tuple[int, int]] = None,
    front_layer: bool = True,
) -> torch.Tensor:
    """Complex gradient of ``<V X, Y>`` for matrices stacked in columns."""
    x_mat = as_state(x_mat)
    return _dot_product_gradient(
        circ, as_thetas(thetas, x_mat), x_mat, as_state(vh_y_mat),
        int(x_mat.shape[-1]), _block_range(circ, block_range), bool(front_layer),
    )


# -----------------------------------------------------------------------------
# Autodiff cross-check path.
# -----------------------------------------------------------------------------


def dot_product(circ: Ansatz, thetas, x, y) -> torch.Tensor:
    """``<x | V(Θ)† | y>`` (complex scalar), via the appropriate engine."""
    x = as_state(x)
    vh_y = v_dagger_mul_vec(circ, thetas, y) if x.ndim == 1 else v_dagger_mul_mat(circ, thetas, y)
    return torch.vdot(x.reshape(-1), vh_y.reshape(-1))


def grad_of_dot_product_autodiff(circ: Ansatz, thetas, x, y) -> torch.Tensor:
    """Complex gradient of ``<x, V† y>`` via ``torch.autograd`` (reverse mode
    on the real and imaginary parts): the independent cross-check of the
    co-sweep."""
    x = as_state(x)
    th = as_thetas(thetas, x).detach().clone().requires_grad_(True)
    with torch.enable_grad():
        d = dot_product(circ, th, x, y)
        (g_re,) = torch.autograd.grad(d.real, th, retain_graph=True)
        (g_im,) = torch.autograd.grad(d.imag, th)
    return torch.complex(g_re, g_im)
