"""Folded unit-block gates of an ansatz (the part of
``aqc_research_tpu/ops/statevector.py`` the MPS engine needs).

The dense appliers (``v_mul_vec``, ``v_dagger_mul_vec``, ...) belong to the
dense slice and are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit import gates as G
from ..circuit.ansatz import Ansatz


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
    """Fused 4x4 gates of all unit blocks, ``(num_blocks, 4, 4)`` in (ctrl,
    targ) index order.  Forward block = (C ⊗ T) @ E with C = Rz(t1)·Ry(t0),
    T = Rs(t3)·Ry(t2); dagger block = E† @ (C† ⊗ T†).  For a Trotterized
    ansatz the triplet framings Rz(∓pi/2) fold into the first/last block of
    each triplet."""
    rs = _swappable_gate(circ.entangler)
    t = thetas2q
    if dagger:
        c_mat = torch.matmul(G.ry(-t[:, 0], dtype), G.rz(-t[:, 1], dtype))
        t_mat = torch.matmul(G.ry(-t[:, 2], dtype), rs(-t[:, 3], dtype))
        ent = _entangler_gate(circ.entangler, t, dtype, dagger=True)
        blocks4 = torch.matmul(ent, G.kron2(c_mat, t_mat))
    else:
        c_mat = torch.matmul(G.rz(t[:, 1], dtype), G.ry(t[:, 0], dtype))
        t_mat = torch.matmul(rs(t[:, 3], dtype), G.ry(t[:, 2], dtype))
        ent = _entangler_gate(circ.entangler, t, dtype, dagger=False)
        blocks4 = torch.matmul(G.kron2(c_mat, t_mat), ent)

    if circ.is_trotterized and circ.num_blocks > 0:
        dev = thetas2q.device
        idx = np.arange(thetas2q.shape[0])
        eye = G.eye2(dtype, dev)
        rz_m = G.kron2(G.rz(-np.pi / 2, dtype, dev), eye)  # on ctrl, triplet start
        rz_p = G.kron2(eye, G.rz(np.pi / 2, dtype, dev))  # on targ, triplet end
        start = torch.as_tensor(idx % 3 == 0, device=dev)[:, None, None]
        end = torch.as_tensor(idx % 3 == 2, device=dev)[:, None, None]
        if dagger:
            pre = torch.where(end, torch.matmul(blocks4, rz_p.conj().T), blocks4)
            blocks4 = torch.where(start, torch.matmul(rz_m.conj().T, pre), pre)
        else:
            pre = torch.where(start, torch.matmul(blocks4, rz_m), blocks4)
            blocks4 = torch.where(end, torch.matmul(rz_p, pre), pre)
    return blocks4


def front_gates(circ: Ansatz, thetas1q: torch.Tensor, dtype, dagger: bool = False):
    """Fused Rz·Ry·Rz front-layer gates, ``(num_qubits, 2, 2)``.
    Forward: Rz(t0)·Ry(t1)·Rz(t2); dagger: Rz(-t2)·Ry(-t1)·Rz(-t0)."""
    t = thetas1q
    if dagger:
        return torch.matmul(
            torch.matmul(G.rz(-t[:, 2], dtype), G.ry(-t[:, 1], dtype)),
            G.rz(-t[:, 0], dtype),
        )
    return torch.matmul(
        torch.matmul(G.rz(t[:, 0], dtype), G.ry(t[:, 1], dtype)), G.rz(t[:, 2], dtype)
    )
