"""Analytic co-sweep gradient of ``<lvec | V† | phi>`` in MPS form (twin of
``aqc_research_tpu/ops/mps_gradient.py``), with the JAX package's dispatch:

* layered Trotter (CX) ansatze take the triplet path: within a chessboard
  half-layer the triplets act on disjoint pairs, so each triplet composes
  into one 4x4 prefix per pair, every per-parameter dot becomes 4x4 algebra
  against one two-site environment tensor, and the states take one batched
  pair update per half-layer.  With the V† sweep's per-layer z cache
  (``_fast_dot_gradient_layered_zcache``) the z side needs no truncated
  update at all; without it (a one-layer horizon) w and z take the update
  together (``_fast_dot_gradient_layered``);
* plain layer-periodic nearest-neighbour ansatze (cx, cz, cp) take the same
  machinery with per-block prefixes (``_fast_dot_gradient_layered_plain``);
* everything else, non-nearest-neighbour layouts included (through the swap
  network), takes the per-gate sweep with cached left/right environments
  (``_fast_dot_gradient_impl``).

Every pair update goes through ``ops/mps._pair_update``, so on the card the
decompositions run the route's kernels.

Every path takes lane axes: ``thetas (..., P)``, states with the same
leading axes (or none, broadcast), gradients ``(..., P)``.  Each pair
update of all lanes (a pair group on the layered paths; one block, its
swaps and the CP shift on the per-gate sweep) decomposes as one batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..circuit import gates as G
from ..circuit.ansatz import Ansatz
from .mps import (
    MPS,
    _folded_tensors,
    apply_1q_many,
    apply_1q_mps,
    apply_2q_any_mps,
    apply_pairs_mps,
    mps_resize,
    no_truncation_threshold,
    site_index,
)
from .cuda_graphs import tracing


def _e0(cw: int, cz: int, dtype, device) -> torch.Tensor:
    e0 = torch.zeros((cw, cz), dtype=dtype, device=device)
    e0[0, 0].fill_(1.0)
    return e0


def _env_left_step(env, aw, az):
    """env'[b,B] = sum_s conj(aw)[s,a,b] env[a,A] az[s,A,B]."""
    return torch.einsum("...aA,...sab,...sAB->...bB", env, aw.conj(), az)


def _env_right_step(aw, az, env):
    """env'[a,A] = sum_s conj(aw)[s,a,b] az[s,A,B] env[b,B]."""
    return torch.einsum("...sab,...sAB,...bB->...aA", aw.conj(), az, env)


def _lead(thetas: torch.Tensor) -> tuple:
    """The lane axes of Θ (``()`` for one lane)."""
    return tuple(thetas.shape[:-1])


def _site_tensor(mps: MPS, q: int) -> torch.Tensor:
    """λ-folded site tensor A_q = Γ_q diag(λ_q) (A_{n-1} = Γ_{n-1})."""
    g = mps.gammas[..., q, :, :, :]
    if q < mps.num_sites - 1:
        return g * mps.lambdas[..., q, None, None, :].to(g.dtype)
    return g


class _EnvTracker:
    """Carries the left environment and a right-environment stack of <w|z>
    through a gate-by-gate sweep; refreshes the stack whenever the gate
    order wraps leftwards or a site right of the current block changed."""

    def __init__(self, w: MPS, z: MPS):
        self.w = w
        self.z = z
        self.n = w.num_sites
        self._left = None  # env of sites [0, absorbed)
        self._absorbed = 0
        self._right = None  # [q] = env of the sites > q
        self._max_mod = -1  # highest site modified since the last refresh

    def _boundary(self):
        return _e0(self.w.chi, self.z.chi, self.w.gammas.dtype, self.w.gammas.device)

    def refresh(self):
        """Recomputes the right-environment stack from the current tensors."""
        right = [self._boundary()]
        for q in range(self.n - 1, 0, -1):
            right.append(_env_right_step(_site_tensor(self.w, q), _site_tensor(self.z, q), right[-1]))
        self._right = right[::-1]
        self._left = self._boundary()
        self._absorbed = 0
        self._max_mod = -1

    def prepare(self, lo: int, hi: int):
        """Makes L cover the sites < lo and R[hi] valid for the block (lo, hi)."""
        if self._right is None or self._absorbed > lo or self._max_mod > hi:
            self.refresh()
        while self._absorbed < lo:
            q = self._absorbed
            self._left = _env_left_step(self._left, _site_tensor(self.w, q), _site_tensor(self.z, q))
            self._absorbed += 1

    def mark_modified(self, hi: int):
        self._max_mod = max(self._max_mod, hi)

    def _left_to(self, q: int):
        """Left env extended (without committing) from ``absorbed`` to q."""
        env = self._left
        for k in range(self._absorbed, q):
            env = _env_left_step(env, _site_tensor(self.w, k), _site_tensor(self.z, k))
        return env

    def dot_span(self, lo: int, hi: int, pauli_site: Optional[int], pauli_mat, w_override: Optional[MPS] = None):
        """<(P@)w | z> through the multi-site transfer over [lo, hi]:
        L · T_lo · ... · T_hi · R[hi] (``pauli_site`` None: no Pauli), one
        value per lane.  Valid while the sites > hi are unchanged since the
        last refresh, which is what makes it work for non-nearest-neighbour
        blocks: every site the swap network touched lies inside [lo, hi]."""
        w = self.w if w_override is None else w_override
        env = self._left if self._absorbed == lo else self._left_to(lo)
        for q in range(lo, hi + 1):
            aw = _site_tensor(w, q)
            if pauli_site == q:
                aw = torch.einsum("ij,...jab->...iab", pauli_mat.to(aw.dtype), aw)
            env = _env_left_step(env, aw, _site_tensor(self.z, q))
        return (env * self._right[hi]).sum((-2, -1))


def _entangler_4x4_lo_hi(circ: Ansatz, tht, dtype, ctrl: int, targ: int, shift: float = 0.0):
    """The block's entangler as a ``(..., 4, 4)`` in (lo, hi) site order
    (``tht (..., tpb)``; lanes only where the entangler has an angle)."""
    device = tht.device
    if circ.entangler == "cp":
        mat = G.controlled(G.phase(tht[..., 4] + shift, dtype))
    elif circ.entangler == "cz":
        mat = G.controlled(G.z(dtype, device))
    else:
        mat = G.controlled(G.x(dtype, device))
    lead = tuple(mat.shape[:-2])
    g = mat.reshape(lead + (2, 2, 2, 2))
    if ctrl > targ:  # (ctrl, targ) = (hi, lo) -> (lo, hi)
        g = g.transpose(-4, -3).transpose(-2, -1)
    return g.reshape(lead + (4, 4))


def _fast_dot_gradient_impl(
    circ: Ansatz,
    thetas: torch.Tensor,
    lvec: MPS,
    vh_phi: MPS,
    trunc_thr: float,
    block_range: Tuple[int, int],
    front_layer: bool,
) -> torch.Tensor:
    """The per-gate co-sweep: every gate applies to w and z in circuit order
    and every per-parameter dot ``0.5j <P w | z>`` is read from the cached
    environments.  Covers any layout and entangler (non-adjacent blocks
    through the swap network); thousands of small ops per sweep, so the
    layered paths take every ansatz they can."""
    dtype = lvec.gammas.dtype
    device = lvec.gammas.device
    n, nb, tpb = circ.num_qubits, circ.num_blocks, circ.tpb
    cp = circ.entangler == "cp"
    rs_fn = G.rx if circ.entangler == "cx" else G.rz
    s_mat = G.x(dtype, device) if circ.entangler == "cx" else G.z(dtype, device)
    y_mat, z_mat = G.y(dtype, device), G.z(dtype, device)
    trot = circ.is_trotterized
    lead = _lead(thetas)
    thetas1q = circ.subset1q(thetas)
    thetas2q = circ.subset2q(thetas)
    env = _EnvTracker(lvec, vh_phi)
    zero = torch.zeros(lead, dtype=dtype, device=device)

    def apply_both(gate, site):
        env.w = apply_1q_mps(env.w, gate, site)
        env.z = apply_1q_mps(env.z, gate, site)
        env.mark_modified(site)

    grad1q = torch.zeros(lead + (n, 3), dtype=dtype, device=device)
    for q in range(n):
        t = thetas1q[..., q, :]
        env.prepare(q, q)
        for col, gate_fn, pauli in ((2, G.rz, z_mat), (1, G.ry, y_mat), (0, G.rz, z_mat)):
            apply_both(gate_fn(t[..., col], dtype), q)
            if front_layer:
                grad1q[..., q, col] = 0.5j * env.dot_span(q, q, q, pauli)

    def block_step(k: int, i_mod3: int, t, inside: bool):
        """One unit block of the co-sweep; returns its per-parameter dots
        (zeros outside the block range)."""
        ctrl, targ = int(circ.blocks[0, k]), int(circ.blocks[1, k])
        lo, hi = min(ctrl, targ), max(ctrl, targ)
        env.prepare(lo, hi)
        if trot and i_mod3 == 0:
            apply_both(G.rz(-np.pi / 2, dtype, device), ctrl)
        ent = _entangler_4x4_lo_hi(circ, t, dtype, ctrl, targ)
        env.z = apply_2q_any_mps(env.z, ent, lo, hi, trunc_thr=trunc_thr)
        dots = [zero] * tpb
        if cp:
            # The CP derivative is not unitary-proportional: the two-point
            # difference of shifted CP gates.
            ent2 = _entangler_4x4_lo_hi(circ, t, dtype, ctrl, targ, shift=np.pi)
            w2 = apply_2q_any_mps(env.w, ent2, lo, hi, trunc_thr=trunc_thr) if inside else None
            env.w = apply_2q_any_mps(env.w, ent, lo, hi, trunc_thr=trunc_thr)
            env.mark_modified(hi)
            if inside:
                dots[4] = -0.5j * (env.dot_span(lo, hi, None, None) - env.dot_span(lo, hi, None, None, w2))
        else:
            env.w = apply_2q_any_mps(env.w, ent, lo, hi, trunc_thr=trunc_thr)
            env.mark_modified(hi)
        for col, gate_fn, site, pauli in (
            (0, G.ry, ctrl, y_mat), (1, G.rz, ctrl, z_mat), (2, G.ry, targ, y_mat), (3, rs_fn, targ, s_mat),
        ):
            apply_both(gate_fn(t[..., col], dtype), site)
            if inside:
                dots[col] = 0.5j * env.dot_span(lo, hi, site, pauli)
        if trot and i_mod3 == 2:
            apply_both(G.rz(np.pi / 2, dtype, device), targ)
        return torch.stack(dots, dim=-1)

    inside = [block_range[0] <= k < block_range[1] for k in range(nb)]
    grad2q = torch.stack([block_step(k, k % 3, thetas2q[..., k, :], inside[k]) for k in range(nb)], dim=-2)
    half = circ.half_layer_num_blocks if trot else 0
    if half:
        # 2nd-order Trotter trailing half-layer: accumulates into rows [0, half).
        rows = [block_step(k, k % 3, thetas2q[..., k, :], inside[k]) for k in range(half)]
        grad2q[..., :half, :] += torch.stack(rows, dim=-2)
    return torch.cat([grad1q.reshape(lead + (-1,)), grad2q.reshape(lead + (-1,))], dim=-1)


# -----------------------------------------------------------------------------
# Layer-batched co-sweeps.
# -----------------------------------------------------------------------------


def _env_stacks(w: MPS, z: MPS):
    """Left/right environment stacks of <w|z>: L[q] covers sites < q,
    R[q] covers sites >= q (both (n+1, cw, cz)).  A dot inserted at site s
    uses L[s] · T_s · R[s+1]."""
    aw, az = _folded_tensors(w), _folded_tensors(z)
    n = w.num_sites
    batch = torch.broadcast_shapes(aw.shape[:-4], az.shape[:-4])
    e0 = _e0(w.chi, z.chi, aw.dtype, aw.device).expand(batch + (w.chi, z.chi))
    left = [e0]
    for q in range(n):
        left.append(_env_left_step(left[-1], aw[..., q, :, :, :], az[..., q, :, :, :]))
    right = [e0]
    for q in range(n - 1, -1, -1):
        right.append(_env_right_step(aw[..., q, :, :, :], az[..., q, :, :, :], right[-1]))
    return aw, az, torch.stack(left, dim=-3), torch.stack(right[::-1], dim=-3)


def _dots_from_stacks(w: MPS, z: MPS, l_stack, r_stack, pauli_mats, sites):
    """All ``<P_k w | z>`` for distinct sites in one batched contraction
    against pre-built environment stacks (valid across 1-qubit gates applied
    to both states: the per-site transfer matrix is invariant)."""
    idx = site_index(sites, l_stack.device)
    aw, az = _folded_tensors(w), _folded_tensors(z)
    paw = torch.einsum("...pij,...pjab->...piab", pauli_mats.to(aw.dtype), aw[..., idx, :, :, :])
    x = torch.einsum("...paA,...psab->...pAsb", l_stack[..., idx, :, :], paw.conj())
    x = torch.einsum("...pAsb,...psAB->...pbB", x, az[..., idx, :, :, :])
    return (x * r_stack[..., idx + 1, :, :]).sum((-2, -1))


def _apply_pairs_both(w: MPS, z: MPS, gates, los, trunc_thr):
    """The same batched pair gates on w and z: one batched decomposition
    of both states where their bond dimensions match."""
    if w.chi == z.chi and w.gammas.dtype == z.gammas.dtype:
        wz = MPS(torch.stack([w.gammas, z.gammas]), torch.stack([w.lambdas, z.lambdas]))
        wz = apply_pairs_mps(wz, gates, los, trunc_thr=trunc_thr)
        return wz[0], wz[1]
    return (
        apply_pairs_mps(w, gates, los, trunc_thr=trunc_thr),
        apply_pairs_mps(z, gates, los, trunc_thr=trunc_thr),
    )


def _layered_plan(circ: Ansatz):
    """Static structure of one layer: half-layer groups of (triplet index,
    lo site), each group sorted by lo."""
    bpl = circ.bpl
    triplets = []
    for t in range(bpl // 3):
        c0 = int(circ.blocks[0, 3 * t])
        t0 = int(circ.blocks[1, 3 * t])
        triplets.append((t, min(c0, t0)))
    groups, current, used = [], [], set()
    for t, lo in triplets:
        if any(abs(lo - u) <= 1 for u in used):
            groups.append(current)
            current, used = [], set()
        current.append((t, lo))
        used.add(lo)
    if current:
        groups.append(current)
    return [sorted(g, key=lambda tl: tl[1]) for g in groups]


def _cx_lo_hi(ctrl_is_hi: bool, dtype, device):
    """CX in (lo, hi) row ordering (row index = s_lo * 2 + s_hi)."""
    mat = G.controlled(G.x(dtype, device)).reshape(2, 2, 2, 2)  # (ctrl, targ)
    if ctrl_is_hi:
        mat = mat.permute(1, 0, 3, 2)
    return mat.reshape(4, 4)


def _rz_frame_lo_hi(angle, on_hi: bool, dtype, device):
    """1q Rz framing embedded as a 4x4 in (lo, hi) ordering."""
    rz = G.rz(angle, dtype, device)
    eye = G.eye2(dtype, device)
    return G.kron2(eye, rz) if on_hi else G.kron2(rz, eye)


def _pair_env_tensors(w: MPS, z: MPS, l_stack, r_stack, los):
    """The 4x4 two-site environment tensors N_p of <w|z> at pairs
    (lo, lo+1): ``<(Y w)|z> = sum(conj(Y) * N)`` for any pair-local Y."""
    idx = site_index(los, l_stack.device)
    aw, az = _folded_tensors(w), _folded_tensors(z)

    def at(a, off):
        return a[..., idx + off, :, :, :]

    tw = torch.einsum("...psam,...ptmb->...pstab", at(aw, 0), at(aw, 1))
    tz = torch.einsum("...puAM,...pvMB->...puvAB", at(az, 0), at(az, 1))
    tz = torch.einsum("...puvAB,...pbB->...puvAb", tz, r_stack[..., idx + 2, :, :])
    x = torch.einsum("...paA,...pstab->...pstAb", l_stack[..., idx, :, :], tw.conj())
    n4 = torch.einsum("...pstAb,...puvAb->...puvst", x, tz)
    return n4.reshape(n4.shape[:-4] + (4, 4))  # rows = z phys (u,v), cols = w phys (s,t)


def _embed_1q_batch(g, on_hi: bool):
    """Batched 1q gates (..., 2, 2) embedded as 4x4 in lo-major ordering."""
    eye = torch.eye(2, dtype=g.dtype, device=g.device)
    if on_hi:
        out = torch.einsum("ij,...kl->...ikjl", eye, g)
    else:
        out = torch.einsum("...ij,kl->...ikjl", g, eye)
    return out.reshape(g.shape[:-2] + (4, 4))


def _embed_pauli(p, on_hi: bool):
    eye = torch.eye(2, dtype=p.dtype, device=p.device)
    return torch.kron(eye, p) if on_hi else torch.kron(p, eye)


def _triplet_prefixes(group, layer_thetas, layer_masks, dtype, device):
    """Pure 4x4 algebra of one half-layer group: the composed triplet
    prefixes F_p (..., P, 4, 4) and, per parameter column, the sandwiches
    ``pre^H P pre`` at that point of the triplet (``layer_thetas (...,
    bpl, tpb)``: the leading axes are lanes).

    Returns (prefix, [(blk, col, msk, y4), ...])."""
    y_mat, z_mat, x_mat = G.y(dtype, device), G.z(dtype, device), G.x(dtype, device)
    tidx = [t for t, _ in group]
    P = len(group)
    prefix = torch.eye(4, dtype=dtype, device=device).expand(tuple(layer_thetas.shape[:-2]) + (P, 4, 4))
    sandwiches = []
    for b in range(3):
        ctrl_is_hi = b != 1  # triplet blocks 0/2 have ctrl = hi, block 1 flipped
        ent = _cx_lo_hi(ctrl_is_hi, dtype, device)
        if b == 0:
            # Leading triplet framing Rz(-pi/2) on ctrl (= hi) folds into E.
            ent = torch.matmul(ent, _rz_frame_lo_hi(-np.pi / 2, True, dtype, device))
        prefix = torch.matmul(ent, prefix)

        blk = site_index([3 * t + b for t in tidx], device)
        th = layer_thetas[..., blk, :]  # (..., P, tpb)
        msk = layer_masks[blk].to(dtype)  # (P,)
        specs = (
            (G.ry, y_mat, ctrl_is_hi, 0),  # on ctrl
            (G.rz, z_mat, ctrl_is_hi, 1),  # on ctrl
            (G.ry, y_mat, not ctrl_is_hi, 2),  # on targ
            (G.rx, x_mat, not ctrl_is_hi, 3),  # on targ
        )
        for gate_fn, pauli, on_hi, col in specs:
            g4 = _embed_1q_batch(gate_fn(th[..., col], dtype), on_hi)
            prefix = torch.matmul(g4, prefix)
            p4 = _embed_pauli(pauli, on_hi)
            y4 = torch.matmul(torch.matmul(prefix.conj().transpose(-1, -2), p4), prefix)
            sandwiches.append((blk, col, msk, y4))
        if b == 2:
            # Trailing triplet framing Rz(pi/2) on targ (= lo).
            frame = G.rz(np.pi / 2, dtype, device).expand(P, 2, 2)
            prefix = torch.matmul(_embed_1q_batch(frame, not ctrl_is_hi), prefix)
    return prefix, sandwiches


def _half_layer_cosweep(
    circ, group, layer_thetas, layer_masks, w: MPS, z: MPS, trunc_thr, dtype, skip_z: bool = False
):
    """One chessboard half-layer against the current z: returns (w', z',
    dots (..., bpl, 4)) with rows only for this group's blocks filled.  With
    ``skip_z`` the z side is not updated (the caller substitutes the cached
    boundary)."""
    device = w.gammas.device
    los = tuple(lo for _, lo in group)
    _, _, l_stack, r_stack = _env_stacks(w, z)
    n4 = _pair_env_tensors(w, z, l_stack, r_stack, los)
    prefix, sandwiches = _triplet_prefixes(group, layer_thetas, layer_masks, dtype, device)
    dots = torch.zeros(tuple(layer_thetas.shape[:-2]) + (circ.bpl, 4), dtype=dtype, device=device)
    for blk, col, msk, y4 in sandwiches:
        dots[..., blk, col] += 0.5j * (y4.conj() * n4).sum((-2, -1)) * msk
    if skip_z:
        return apply_pairs_mps(w, prefix, los, trunc_thr=trunc_thr), z, dots
    w, z = _apply_pairs_both(w, z, prefix, los, trunc_thr)
    return w, z, dots


def _half_layer_cosweep_znext(circ, group, layer_thetas, layer_masks, w: MPS, z_next: MPS, trunc_thr, dtype):
    """Group co-sweep against the cached POST-group boundary ``z_next``:
    with G = prod_p F_p and z_mid = G† z_next, every dot satisfies
    ``<Y_p w | z_mid> = <(F_p Y_p) w | z_next>``, where the OTHER pairs' F_q
    fold into the w-side two-site transfers of <w|z_next>.  Every
    environment cut lands between pairs, so the z side needs zero truncated
    decompositions.  Returns (w', dots)."""
    device = w.gammas.device
    los = tuple(lo for _, lo in group)
    prefix, sandwiches = _triplet_prefixes(group, layer_thetas, layer_masks, dtype, device)

    aw, az = _folded_tensors(w), _folded_tensors(z_next)
    n = w.num_sites
    e0 = _e0(w.chi, z_next.chi, dtype, device)
    pair_of_lo = {lo: i for i, lo in enumerate(los)}

    def site_w(q):
        return aw[..., q, :, :, :]

    def site_z(q):
        return az[..., q, :, :, :]

    def fold_pair_w(lo, f4):
        """tw[s,t,a,c] = sum_{uv,b} f4[(st),(uv)] aw_lo[u,a,b] aw_hi[v,b,c]."""
        two = torch.einsum("...uab,...vbc->...uvac", site_w(lo), site_w(lo + 1))
        return torch.einsum("...stuv,...uvac->...stac", f4.reshape(f4.shape[:-2] + (2, 2, 2, 2)), two)

    def pair_z(lo):
        return torch.einsum("...uAB,...vBC->...uvAC", site_z(lo), site_z(lo + 1))

    units, q = [], 0
    while q < n:
        if q in pair_of_lo:
            units.append(("pair", q))
            q += 2
        else:
            units.append(("site", q))
            q += 1

    l_envs, env = {}, e0
    for kind, q in units:
        if kind == "pair":
            l_envs[q] = env
            tw = fold_pair_w(q, prefix[..., pair_of_lo[q], :, :])
            env = torch.einsum("...aA,...stac,...stAC->...cC", env, tw.conj(), pair_z(q))
        else:
            env = _env_left_step(env, site_w(q), site_z(q))

    r_envs, env = {}, e0
    for kind, q in reversed(units):
        if kind == "pair":
            r_envs[q] = env
            tw = fold_pair_w(q, prefix[..., pair_of_lo[q], :, :])
            env = torch.einsum("...stac,...stAC,...cC->...aA", tw.conj(), pair_z(q), env)
        else:
            env = _env_right_step(site_w(q), site_z(q), env)

    def n4_at(lo):
        tw = torch.einsum("...uab,...vbc->...uvac", site_w(lo), site_w(lo + 1))  # open w legs
        x = torch.einsum("...aA,...stac->...stAc", l_envs[lo], tw.conj())
        x = torch.einsum("...stAc,...cC->...stAC", x, r_envs[lo])
        n4_lo = torch.einsum("...stAC,...uvAC->...uvst", x, pair_z(lo))
        return n4_lo.reshape(n4_lo.shape[:-4] + (4, 4))

    n4 = torch.stack([n4_at(lo) for lo in los], dim=-3)
    dots = torch.zeros(tuple(layer_thetas.shape[:-2]) + (circ.bpl, 4), dtype=dtype, device=device)
    for blk, col, msk, y4 in sandwiches:
        y4f = torch.matmul(prefix, y4)
        dots[..., blk, col] += 0.5j * (y4f.conj() * n4).sum((-2, -1)) * msk
    return apply_pairs_mps(w, prefix, los, trunc_thr=trunc_thr), dots


def _front_cosweep_batched(circ, thetas1q, w: MPS, z: MPS, front_layer: bool, dtype):
    """Front Rz·Ry·Rz layer: batched 1q applies + batched dots."""
    n = circ.num_qubits
    device = w.gammas.device
    sites = tuple(range(n))
    grads = torch.zeros(tuple(thetas1q.shape[:-2]) + (n, 3), dtype=dtype, device=device)
    if front_layer:  # one stack build serves all three dot rounds
        _, _, l_stack, r_stack = _env_stacks(w, z)
    for col, gate_fn, pauli in ((2, G.rz, G.z), (1, G.ry, G.y), (0, G.rz, G.z)):
        g1q = gate_fn(thetas1q[..., col], dtype)
        w = apply_1q_many(w, g1q, sites)
        z = apply_1q_many(z, g1q, sites)
        if front_layer:
            paulis = pauli(dtype, device).expand(n, 2, 2)
            grads[..., col] = 0.5j * _dots_from_stacks(w, z, l_stack, r_stack, paulis, sites)
    return w, z, grads


def _masks(nb: int, block_range: Tuple[int, int], dtype, device) -> torch.Tensor:
    masks = torch.zeros(nb, dtype=dtype, device=device)
    masks[block_range[0] : block_range[1]].fill_(1.0)
    return masks


def _fast_dot_gradient_layered(
    circ: Ansatz,
    thetas: torch.Tensor,
    lvec: MPS,
    vh_phi: MPS,
    trunc_thr: float,
    block_range: Tuple[int, int],
    front_layer: bool,
) -> torch.Tensor:
    """Layered Trotter co-sweep without the z cache: each half-layer group
    updates w and z together (one batched decomposition where their bond
    dimensions match).  The path of a horizon the V† layer cache does not
    cover (one layer)."""
    dtype = lvec.gammas.dtype
    nb, bpl, tpb = circ.num_blocks, circ.bpl, circ.tpb
    layers = nb // bpl
    groups = _layered_plan(circ)
    lead = _lead(thetas)
    thetas1q = circ.subset1q(thetas)
    th_layers = circ.subset2q(thetas).reshape(lead + (layers, bpl, tpb))
    m_layers = _masks(nb, block_range, thetas.dtype, thetas.device).reshape(layers, bpl)

    w, z, grad1q = _front_cosweep_batched(circ, thetas1q, lvec, vh_phi, front_layer, dtype)
    rows = []
    for j in range(layers):
        dots = torch.zeros(lead + (bpl, 4), dtype=dtype, device=thetas.device)
        for group in groups:
            w, z, d = _half_layer_cosweep(circ, group, th_layers[..., j, :, :], m_layers[j], w, z, trunc_thr, dtype)
            dots = dots + d
        rows.append(dots)
    grad2q = torch.stack(rows, dim=-3).reshape(lead + (nb, tpb))
    if circ.half_layer_num_blocks:
        # Trailing half-layer == leading even group of layer 0; accumulate.
        w, z, d = _half_layer_cosweep(circ, groups[0], th_layers[..., 0, :, :], m_layers[0], w, z, trunc_thr, dtype)
        grad2q[..., :bpl, :] += d
    return torch.cat([grad1q.reshape(lead + (-1,)), grad2q.reshape(lead + (-1,))], dim=-1)


def _fast_dot_gradient_layered_zcache(
    circ: Ansatz,
    thetas: torch.Tensor,
    lvec: MPS,
    vh_phi: MPS,
    z_layers: MPS,
    trunc_thr: float,
    block_range: Tuple[int, int],
    front_layer: bool,
    grow_w: bool = False,
):
    """Layered co-sweep consuming the V† sweep's per-layer z cache: the last
    group of every layer skips its z-side truncated update (the cached
    boundary substitutes); chessboard (2-group) layers need none at all.
    ``grow_w`` (chessboard layers): with a rank-1 product ``lvec`` the head
    layers run the w side at a growing bond dimension (exact).
    Returns (gradient, final w = V @ lvec)."""
    dtype = lvec.gammas.dtype
    device = lvec.gammas.device
    nb, bpl, tpb = circ.num_blocks, circ.bpl, circ.tpb
    layers = nb // bpl
    groups = _layered_plan(circ)
    chessboard = len(groups) == 2
    grow_w = grow_w and chessboard

    lead = _lead(thetas)
    thetas1q = circ.subset1q(thetas)
    th_layers = circ.subset2q(thetas).reshape(lead + (layers, bpl, tpb))
    m_layers = _masks(nb, block_range, thetas.dtype, device).reshape(layers, bpl)

    chi_z = vh_phi.chi
    if grow_w:
        lvec = mps_resize(lvec, 1)  # exact for a rank-1 product lvec

    w, z, grad1q = _front_cosweep_batched(circ, thetas1q, lvec, vh_phi, front_layer, dtype)
    z_next = z_layers[1:]  # z_next[j] = z state after layer j

    rows = []
    chi_w = w.chi
    for j in range(layers):
        th_l, m_l, znx = th_layers[..., j, :, :], m_layers[j], z_next[j]
        if not chessboard:
            dots = torch.zeros(lead + (bpl, 4), dtype=dtype, device=device)
            for gi, group in enumerate(groups):
                last = gi == len(groups) - 1
                w, z, d = _half_layer_cosweep(circ, group, th_l, m_l, w, z, trunc_thr, dtype, skip_z=last)
                dots = dots + d
            z = znx
            rows.append(dots)
            continue
        # Head layers grow w's bond dimension x2 before each half-layer.
        grow = grow_w and chi_w < chi_z
        if grow:
            chi_w = min(chi_z, 2 * chi_w)
            w = mps_resize(w, chi_w)
        # Group 1 dots use the layer-entry boundary z; group 2 contracts
        # against the NEXT cached boundary with the group prefixes folded
        # into the w-side transfers.
        w, _, d1 = _half_layer_cosweep(circ, groups[0], th_l, m_l, w, z, trunc_thr, dtype, skip_z=True)
        if grow:
            chi_w = min(chi_z, 2 * chi_w)
            w = mps_resize(w, chi_w)
        w, d2 = _half_layer_cosweep_znext(circ, groups[1], th_l, m_l, w, znx, trunc_thr, dtype)
        z = znx
        rows.append(d1 + d2)
    if grow_w:
        w = mps_resize(w, max(w.chi, chi_z))
    grad2q = torch.stack(rows, dim=-3).reshape(lead + (nb, tpb))

    if circ.half_layer_num_blocks:
        # Trailing half-layer == leading even group of layer 0; z already
        # holds cache[L].
        w, _, d = _half_layer_cosweep(
            circ, groups[0], th_layers[..., 0, :, :], m_layers[0], w, z, trunc_thr, dtype, skip_z=True
        )
        grad2q[..., :bpl, :] += d

    # The co-sweep's final w IS V @ lvec.
    return torch.cat([grad1q.reshape(lead + (-1,)), grad2q.reshape(lead + (-1,))], dim=-1), w


def _layered_eligible(circ: Ansatz) -> bool:
    if not (circ.is_trotterized and circ.entangler == "cx"):
        return False
    nb, bpl = circ.num_blocks, circ.bpl
    if nb == 0 or bpl == 0 or nb % bpl != 0:
        return False
    return all(
        circ.blocks[0, k] == circ.blocks[0, k % bpl] and circ.blocks[1, k] == circ.blocks[1, k % bpl]
        for k in range(nb)
    )


# -----------------------------------------------------------------------------
# Plain (non-Trotter) layer-periodic nearest-neighbour ansatze, entanglers
# cx, cz and cp: the triplet machinery with per-block prefixes, no framings,
# and the CP angle derivative in pair-local form — CP(a)^H CP(a+π) = CZ =
# I - 2 P11 turns the two-point difference into -1j <(pre^H P11 pre) w | z>.
# -----------------------------------------------------------------------------


def _plain_layer_period(circ: Ansatz) -> int:
    """Smallest d dividing num_blocks with a d-periodic block pattern and at
    least two layers; 0 if none."""
    nb = circ.num_blocks
    for d in range(1, nb // 2 + 1):
        if nb % d:
            continue
        if all(
            int(circ.blocks[0, k]) == int(circ.blocks[0, k % d])
            and int(circ.blocks[1, k]) == int(circ.blocks[1, k % d])
            for k in range(nb)
        ):
            return d
    return 0


def _plain_layered_eligible(circ: Ansatz) -> bool:
    if circ.is_trotterized or circ.num_blocks == 0:
        return False
    if not all(abs(int(circ.blocks[0, k]) - int(circ.blocks[1, k])) == 1 for k in range(circ.num_blocks)):
        return False
    return _plain_layer_period(circ) > 0


def _plain_groups(circ: Ansatz, bpl: int):
    """Splits one layer's block indices into maximal runs whose pairs are
    pairwise disjoint-or-identical (such runs commute freely)."""
    groups, current, pairs = [], [], set()
    for k in range(bpl):
        lo = min(int(circ.blocks[0, k]), int(circ.blocks[1, k]))
        if current and any(abs(lo - p) == 1 for p in pairs):
            groups.append(current)
            current, pairs = [], set()
        current.append(k)
        pairs.add(lo)
    if current:
        groups.append(current)
    return groups


def _embed_1q(g, on_hi: bool):
    """A single 1q gate embedded as a 4x4 in (lo, hi) lo-major order."""
    eye = G.eye2(g.dtype, g.device)
    return G.kron2(eye, g) if on_hi else G.kron2(g, eye)


def _plain_group_cosweep(circ: Ansatz, group, layer_thetas, layer_masks, w: MPS, z: MPS, trunc_thr, dtype):
    """One disjoint-pair run of a plain layer; returns (w', z', dots (...,
    bpl, tpb)) with rows only for this group's blocks filled
    (``layer_thetas (..., bpl, tpb)``: the leading axes are lanes)."""
    device = w.gammas.device
    cp = circ.entangler == "cp"
    cx = circ.entangler == "cx"
    y_mat, z_mat, x_mat = G.y(dtype, device), G.z(dtype, device), G.x(dtype, device)
    rs_fn, s_mat = (G.rx, x_mat) if cx else (G.rz, z_mat)

    los = []
    blocks_info = []
    for k in group:
        ctrl, targ = int(circ.blocks[0, k]), int(circ.blocks[1, k])
        lo = min(ctrl, targ)
        if lo not in los:
            los.append(lo)
        blocks_info.append((k, ctrl > targ, los.index(lo)))

    dots = torch.zeros(tuple(layer_thetas.shape[:-1]) + (circ.tpb,), dtype=dtype, device=device)
    _, _, l_stack, r_stack = _env_stacks(w, z)
    n4 = _pair_env_tensors(w, z, l_stack, r_stack, tuple(los))  # (..., P, 4, 4)
    prefix = [torch.eye(4, dtype=dtype, device=device) for _ in los]
    p11 = torch.zeros((4, 4), dtype=dtype, device=device)
    p11[3, 3].fill_(1.0)

    def dot(pre, op, p):
        """<(pre^H op pre) w | z> at pair p, one value per lane."""
        y4 = torch.einsum("...ji,jk,...kl->...il", pre.conj(), op, pre)
        return (y4.conj() * n4[..., p, :, :]).sum((-2, -1))

    for k, ctrl_is_hi, p in blocks_info:
        th = layer_thetas[..., k, :]
        msk = layer_masks[k].to(dtype)
        if cx:
            ent = _cx_lo_hi(ctrl_is_hi, dtype, device)
        elif cp:
            # CP and CZ are symmetric in their two qubits: no reordering.
            ent = G.controlled(G.phase(th[..., 4], dtype))
        else:
            ent = G.controlled(z_mat)
        pre = torch.matmul(ent, prefix[p])
        if cp:
            dots[..., k, 4] += (-1j) * dot(pre, p11, p) * msk
        for gate_fn, pauli, on_hi, col in (
            (G.ry, y_mat, ctrl_is_hi, 0),  # on ctrl
            (G.rz, z_mat, ctrl_is_hi, 1),  # on ctrl
            (G.ry, y_mat, not ctrl_is_hi, 2),  # on targ
            (rs_fn, s_mat, not ctrl_is_hi, 3),  # on targ
        ):
            pre = torch.matmul(_embed_1q(gate_fn(th[..., col], dtype), on_hi), pre)
            dots[..., k, col] += 0.5j * dot(pre, _embed_pauli(pauli, on_hi), p) * msk
        prefix[p] = pre

    order = np.argsort(los)
    w, z = _apply_pairs_both(
        w, z, torch.stack([prefix[i] for i in order], dim=-3), tuple(los[i] for i in order), trunc_thr
    )
    return w, z, dots


def _fast_dot_gradient_layered_plain(
    circ: Ansatz,
    thetas: torch.Tensor,
    lvec: MPS,
    vh_phi: MPS,
    trunc_thr: float,
    block_range: Tuple[int, int],
    front_layer: bool,
) -> torch.Tensor:
    dtype = lvec.gammas.dtype
    nb, tpb = circ.num_blocks, circ.tpb
    bpl = _plain_layer_period(circ)
    layers = nb // bpl
    groups = _plain_groups(circ, bpl)
    lead = _lead(thetas)
    thetas1q = circ.subset1q(thetas)
    th_layers = circ.subset2q(thetas).reshape(lead + (layers, bpl, tpb))
    m_layers = _masks(nb, block_range, thetas.dtype, thetas.device).reshape(layers, bpl)

    w, z, grad1q = _front_cosweep_batched(circ, thetas1q, lvec, vh_phi, front_layer, dtype)
    rows = []
    for j in range(layers):
        dots = torch.zeros(lead + (bpl, tpb), dtype=dtype, device=thetas.device)
        for group in groups:
            w, z, d = _plain_group_cosweep(circ, group, th_layers[..., j, :, :], m_layers[j], w, z, trunc_thr, dtype)
            dots = dots + d
        rows.append(dots)
    grad2q = torch.stack(rows, dim=-3).reshape(lead + (nb, tpb))
    return torch.cat([grad1q.reshape(lead + (-1,)), grad2q.reshape(lead + (-1,))], dim=-1)


def _check_grow_w_contract(grow_w: bool, lvec: MPS) -> None:
    """grow_w truncates ``lvec`` to chi=1, which is exact ONLY for a rank-1
    product state with all bond weight at index 0.  Checked on every eager
    call; a device program reads no device value, so the contract is checked
    once where the program is built (ops/cuda_graphs.tracing; the JAX
    package's rule under tracing)."""
    if grow_w and not tracing() and bool((lvec.lambdas[..., 1:] != 0).any()):
        raise ValueError(
            "grow_w=True requires a chi=1 product-state lvec "
            "(all bond spectra confined to index 0)"
        )


def fast_dot_gradient(
    circ: Ansatz,
    thetas: torch.Tensor,
    lvec: MPS,
    vh_phi: MPS,
    *,
    trunc_thr: float = no_truncation_threshold(),
    block_range: Optional[Tuple[int, int]] = None,
    front_layer: bool = True,
    z_layers: Optional[MPS] = None,
    grow_w: bool = False,
) -> torch.Tensor:
    """Complex gradient of ``<lvec | V† | phi>`` with MPS states; ``vh_phi``
    must hold ``V† phi``.  ``z_layers`` (optional): the per-layer cache of
    ``v_dagger_mul_mps_layers``, which layered Trotter ansatze consume to
    skip the z-side decompositions.  Dispatch: the z-cached Trotter path,
    the uncached Trotter path, the plain layered path, else the per-gate
    sweep (module docstring).  ``thetas``: a tensor ``(..., P)``, or numpy
    on ``lvec``'s device in its real precision; on every path the leading
    axes are lanes and the gradient is ``(..., P)``."""
    if circ.circuit_power != 1:
        # The co-sweep differentiates ONE application of V.
        raise ValueError("analytic gradient requires circuit_power == 1")
    _check_grow_w_contract(grow_w, lvec)
    block_range = (0, circ.num_blocks) if block_range is None else tuple(int(b) for b in block_range)
    if not 0 <= block_range[0] < block_range[1] <= circ.num_blocks:
        raise ValueError(f"bad block_range {block_range}")
    if not isinstance(thetas, torch.Tensor):
        thetas = torch.as_tensor(np.asarray(thetas), dtype=lvec.lambdas.dtype, device=lvec.device)
    layered = _layered_eligible(circ)
    if z_layers is not None and layered:
        grad, _ = _fast_dot_gradient_layered_zcache(
            circ, thetas, lvec, vh_phi, z_layers, float(trunc_thr), block_range,
            bool(front_layer), bool(grow_w),
        )
        return grad
    if layered:
        impl = _fast_dot_gradient_layered
    elif _plain_layered_eligible(circ):
        impl = _fast_dot_gradient_layered_plain
    else:
        impl = _fast_dot_gradient_impl
    return impl(circ, thetas, lvec, vh_phi, float(trunc_thr), block_range, bool(front_layer))


def fast_dot_gradient_with_state(
    circ: Ansatz,
    thetas: torch.Tensor,
    lvec: MPS,
    vh_phi: MPS,
    z_layers: MPS,
    *,
    trunc_thr: float = no_truncation_threshold(),
    grow_w: bool = False,
) -> Tuple[torch.Tensor, MPS]:
    """Full gradient PLUS the co-sweep's final w state (= ``V @ lvec``), from
    which the objective overlap ``<V lvec | phi>`` is read
    forward-consistently."""
    if not _layered_eligible(circ):
        raise ValueError("fast_dot_gradient_with_state needs a layered Trotter ansatz")
    if circ.circuit_power != 1:
        raise ValueError("analytic gradient requires circuit_power == 1")
    _check_grow_w_contract(grow_w, lvec)
    return _fast_dot_gradient_layered_zcache(
        circ, thetas, lvec, vh_phi, z_layers, float(trunc_thr), (0, circ.num_blocks),
        True, bool(grow_w),
    )
