"""Memory-sharded MPS: the site chain lives in blocks, one block per rank
(twin of ``aqc_research_tpu/parallel/mps_chain.py``).

The pair-sharded engine (``parallel/mps_sharded.py``) divides the
decomposition work but replicates (Γ, λ) on every rank; this engine divides
the *state*: position d of the mesh axis (default ``"sp"``) holds only
sites [d·m, (d+1)·m) of the chain (m = n / P ≥ 2), so each rank's memory
is ~1/P of the replicated footprint.

* **Representation** — :class:`ChainMPS` holds this rank's block: ``gammas
  (m, 2, χ, χ)`` and ``lam_r (m, χ)``, where ``lam_r[i]`` is the Vidal bond
  weight to the *right* of site i and the chain's last site carries the
  trivial boundary e₀, so the λ-folded site tensor ``Γ_i · diag(lam_r[i])``
  is uniform over every site (``ops.mps._folded_tensors``'s convention).
* **Half-layer pair updates** (:func:`chain_apply_pairs`) — every pair of a
  chessboard half-layer lies inside one block except the one anchored at a
  block's last site, which straddles into the right neighbour's first site
  (with an even block size: the odd half-layers' pairs at every block edge;
  with an odd one the blocks alternate).  The halos are O(χ²): the left
  neighbour's last λ (and, where a pair straddles, the right neighbour's
  (Γ₀, λ₀)) in one point-to-point round, and the updated straddling Γ₀ back
  in a second.  The JAX package asks for even blocks; the port takes any
  block of at least two sites.  Each rank's own pairs go through one batched
  ``ops.mps._pair_update`` call (on the card: the kernels of the route in
  effect, at the rank-local batch).
* **Inner products and environments** (:func:`chain_dot`,
  :func:`chain_env_stacks`) — the transfer contraction is sequential, so it
  runs as a pipeline over the ranks: rank d scans its block from the χ×χ
  environment its left neighbour hands on (P rounds, P − 1 handoffs); the
  product is then broadcast from the last rank, so it is replicated bitwise.
* **Gradients** — each θ's entry is computed on exactly one rank (the rank
  of its site, or of its pair's low site); the others hold zero, and one
  all-reduce SUM makes the gradient replicated bitwise (x + 0 is exact).

Every function takes the mesh and the axis name; every rank passes its own
block and gets its own block (or the replicated value) back.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..circuit import gates as G
from ..config import real_of
from ..ops.mps import MPS, _boundary, _pair_update, no_truncation_threshold
from ..ops.mps_gradient import (
    _e0,
    _env_left_step,
    _env_right_step,
    _layered_eligible,
    _layered_plan,
    _masks,
    _triplet_prefixes,
)
from ..ops.statevector import block_gates, front_gates
from .comm import Axis, all_gather, all_reduce_max, all_reduce_sum, axis_of, broadcast, p2p_round, \
    pipeline_recv, pipeline_send


@dataclasses.dataclass
class ChainMPS:
    """This rank's block of a Vidal-form MPS whose site axis is sharded over
    a mesh axis.  ``lam_r[..., i, :]`` is the bond right of local site i
    (the chain's last site: the boundary e₀).  Leading axes of both tensors
    are batch axes."""

    gammas: torch.Tensor  # (..., m, 2, chi, chi)
    lam_r: torch.Tensor  # (..., m, chi)
    num_sites: int  # the whole chain's n

    @property
    def chi(self) -> int:
        return self.gammas.shape[-1]

    @property
    def block_size(self) -> int:
        return self.gammas.shape[-4]


def chain_block_size(n: int, mesh, axis: str = "sp") -> int:
    """Sites per rank; checks the layout contract (equal blocks of at least
    two sites, so a straddling pair's halos come from one neighbour)."""
    ndev = axis_of(mesh, axis).size
    if n % ndev:
        raise ValueError(f"num_sites {n} must divide over {ndev} ranks")
    m = n // ndev
    if m < 2:
        raise ValueError(f"block size {m}: every rank needs at least two sites; use fewer ranks")
    return m


def _straddles(m: int, ax: Axis, parity: int):
    """(this rank's last site anchors a pair of the half-layer into its
    right neighbour, its left neighbour's last site does into it), blocks of
    ``m`` sites."""
    start = ax.index * m
    return (ax.index + 1 < ax.size and (start + m - 1) % 2 == parity,
            ax.index > 0 and (start - 1) % 2 == parity)


def chain_from_mps(mps: MPS, mesh, *, axis: str = "sp") -> ChainMPS:
    """This rank's block of a replicated MPS (its own copy, so the replica
    can be freed)."""
    n, chi = mps.num_sites, mps.chi
    m = chain_block_size(n, mesh, axis)
    ax = axis_of(mesh, axis)
    lam = mps.lambdas
    lam_r = torch.cat([lam, _boundary(chi, lam.shape[:-2], lam.dtype, lam.device)], dim=-2)
    sl = slice(ax.index * m, (ax.index + 1) * m)
    return ChainMPS(mps.gammas[..., sl, :, :, :].clone(), lam_r[..., sl, :].clone(), n)


def _gather_sites(t: torch.Tensor, site_dim: int, ax: Axis) -> torch.Tensor:
    g = all_gather(t, ax)  # (P, ..., m, ...)
    lead = t.ndim + site_dim
    return g.movedim(0, lead).flatten(lead, lead + 1)


def chain_to_mps(cmps: ChainMPS, mesh, *, axis: str = "sp") -> MPS:
    """The whole chain as a replicated MPS on every rank (all_gather; drops
    the boundary row)."""
    ax = axis_of(mesh, axis)
    gammas = _gather_sites(cmps.gammas, -4, ax)
    lam_r = _gather_sites(cmps.lam_r, -2, ax)
    return MPS(gammas, lam_r[..., :-1, :])


def chain_bytes_per_device(cmps: ChainMPS, mesh, *, axis: str = "sp") -> Tuple[int, int]:
    """(largest block's bytes on any rank, the whole chain's bytes): the
    memory contract is per-rank ≈ whole / P."""
    ax = axis_of(mesh, axis)
    local = cmps.gammas.element_size() * cmps.gammas.numel() + cmps.lam_r.element_size() * cmps.lam_r.numel()
    t = torch.tensor([local], dtype=torch.int64, device=cmps.gammas.device)
    return int(all_reduce_max(t, ax)[0]), int(all_reduce_sum(t, ax)[0])


def _fold(cmps: ChainMPS) -> torch.Tensor:
    return cmps.gammas * cmps.lam_r[..., :, None, None, :].to(cmps.gammas.dtype)


def _env_e00(aw: torch.Tensor, az: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(aw.shape[:-4], az.shape[:-4])
    e00 = _e0(aw.shape[-1], az.shape[-1], aw.dtype, aw.device)
    return e00.expand(batch + tuple(e00.shape)).clone()


def _promoted(a: ChainMPS, b: ChainMPS):
    dtype = torch.promote_types(a.gammas.dtype, b.gammas.dtype)
    return _fold(a).to(dtype), _fold(b).to(dtype)


def chain_dot(a: ChainMPS, b: ChainMPS, mesh, *, axis: str = "sp") -> torch.Tensor:
    """``<a | b>``, replicated on every rank: the transfer contraction as a
    pipeline — rank d scans its λ-folded block from the environment rank
    d − 1 hands on and hands its result to rank d + 1; the last rank's
    value is broadcast.  Parity: ``ops.mps.mps_dot``."""
    if a.num_sites != b.num_sites:
        raise ValueError("the two chains have different lengths")
    chain_block_size(a.num_sites, mesh, axis)
    ax = axis_of(mesh, axis)
    aw, az = _promoted(a, b)
    e00 = _env_e00(aw, az)
    env = pipeline_recv(e00, 1, ax)
    env = e00 if env is None else env
    for j in range(aw.shape[-4]):
        env = _env_left_step(env, aw[..., j, :, :, :], az[..., j, :, :, :])
    pipeline_send(env, 1, ax)
    return broadcast(env[..., 0, 0], ax.size - 1, ax)


def chain_norm(cmps: ChainMPS, mesh, *, axis: str = "sp") -> torch.Tensor:
    return torch.sqrt(chain_dot(cmps, cmps, mesh, axis=axis).real)


def pairs_to_dense(n: int, gates4, lo_sites, dtype):
    """Packs a half-layer's (gates, anchors) into the dense per-slot layout
    of :func:`chain_apply_pairs`: slot s of parity p is the pair anchored
    at 2s + p.  Returns (gates_dense (n//2, 4, 4), active (n//2,) bool,
    parity); every anchor must share one parity."""
    lo = np.asarray(lo_sites, dtype=int)
    if not (lo.size > 0 and lo.min() >= 0 and lo.max() + 1 < n):
        raise ValueError(f"pair positions out of range: {lo_sites}")
    parity = int(lo[0] % 2)
    if not np.all(lo % 2 == parity):
        raise ValueError("half-layer anchors must share parity")
    slots = (lo - parity) // 2
    gates4 = torch.as_tensor(gates4)
    dense = torch.eye(4, dtype=dtype, device=gates4.device).repeat(n // 2, 1, 1)
    dense[torch.as_tensor(slots, dtype=torch.long, device=gates4.device)] = gates4.to(dtype)
    active = np.zeros(n // 2, dtype=bool)
    active[slots] = True
    return dense, torch.as_tensor(active), parity


def _apply_local(cmps: ChainMPS, gates: torch.Tensor, lo_loc: np.ndarray, parity: int, ax: Axis,
                 trunc_thr: float) -> ChainMPS:
    """The pair updates of one half-layer on this rank's pairs: ``lo_loc``
    their local low sites (ascending, all of parity ``parity``), ``gates
    (K, 4, 4)`` their gates in (lo, hi) order.  Every rank of the axis
    calls it (the halo rounds are collective)."""
    gam, lamr = cmps.gammas.clone(), cmps.lam_r.clone()
    m, chi = cmps.block_size, cmps.chi
    dtype, rdtype = gam.dtype, lamr.dtype
    d, P = ax.index, ax.size
    left, right = d > 0, d + 1 < P
    straddles, left_straddles = _straddles(m, ax, parity)

    # Round 1: the left neighbour's last λ in; where a pair straddles, also
    # the right neighbour's first (Γ, λ).
    sends, recvs = [], []
    if right:
        sends.append((lamr[..., m - 1, :], d + 1))
    if left:
        recvs.append((lamr[..., m - 1, :], d - 1))
    if left_straddles:
        sends += [(gam[..., 0, :, :, :], d - 1), (lamr[..., 0, :], d - 1)]
    if straddles:
        recvs += [(gam[..., 0, :, :, :], d + 1), (lamr[..., 0, :], d + 1)]
    got = p2p_round(sends, recvs, ax)
    lam_in = got.pop(0) if left else _boundary(chi, lamr.shape[:-2], rdtype, lamr.device)[..., 0, :]
    g0_in, l0_in = (got[0], got[1]) if straddles else (None, None)

    g0_out = g0_in
    if lo_loc.size:
        lo = torch.as_tensor(lo_loc, dtype=torch.long, device=gam.device)
        lam_left = torch.cat([lam_in[..., None, :], lamr], dim=-2)  # [j] = bond left of site j
        gam_ext, lamr_ext = gam, lamr
        if straddles:
            gam_ext = torch.cat([gam, g0_in[..., None, :, :, :]], dim=-4)
            lamr_ext = torch.cat([lamr, l0_in[..., None, :]], dim=-2)
        ng1, ng2, nlam = _pair_update(
            lam_left[..., lo, :], lamr[..., lo, :], lamr_ext[..., lo + 1, :],
            gam[..., lo, :, :, :], gam_ext[..., lo + 1, :, :, :],
            gates, chi, trunc_thr, dtype, rdtype,
        )
        gam[..., lo, :, :, :] = ng1
        lamr[..., lo, :] = nlam
        inner = torch.as_tensor(lo_loc + 1 < m, device=gam.device)
        gam[..., lo[inner] + 1, :, :, :] = ng2[..., inner, :, :, :]
        if straddles and lo_loc[-1] == m - 1:
            g0_out = ng2[..., -1, :, :, :]
    # Round 2: the straddling pair's updated Γ back to the right neighbour's
    # first site (the original rides back when the pair was idle).
    back = p2p_round([(g0_out, d + 1)] if straddles else [],
                     [(gam[..., 0, :, :, :], d - 1)] if left_straddles else [], ax)
    if left_straddles:
        gam[..., 0, :, :, :] = back[0]
    return ChainMPS(gam, lamr, cmps.num_sites)


def chain_apply_pairs(
    cmps: ChainMPS,
    gates_dense: torch.Tensor,  # (n//2, 4, 4), slot s = pair anchored at 2s+parity
    active,  # (n//2,) bool — inactive slots keep their state
    parity: int,
    mesh,
    *,
    axis: str = "sp",
    trunc_thr: float = no_truncation_threshold(),
) -> ChainMPS:
    """One chessboard half-layer of truncated Vidal pair updates on the
    site-sharded chain (every rank passes its block).  Each rank updates its
    active slots in one batched ``_pair_update`` call; halos are at most
    two point-to-point rounds of O(χ²) (see the module docstring).  For odd
    parity the slot anchored at n − 1 does not exist and must be inactive.
    Parity: ``ops.mps.apply_pairs_mps``."""
    n = cmps.num_sites
    m = chain_block_size(n, mesh, axis)
    ax = axis_of(mesh, axis)
    if parity not in (0, 1):
        raise ValueError(f"parity must be 0 or 1, got {parity}")
    act = np.asarray(active.cpu() if isinstance(active, torch.Tensor) else active, dtype=bool)
    if act.shape != (n // 2,) or tuple(gates_dense.shape[-3:]) != (n // 2, 4, 4):
        raise ValueError("gates_dense and active must hold n // 2 slots")
    slots = np.nonzero(act)[0]
    anchors = 2 * slots + parity
    if anchors.size and anchors[-1] + 1 >= n:
        raise ValueError("the odd-parity slot anchored at n - 1 must be inactive")
    start = ax.index * m
    mine = (anchors >= start) & (anchors < start + m)
    idx = torch.as_tensor(slots[mine], dtype=torch.long, device=gates_dense.device)
    gates = gates_dense[..., idx, :, :].to(cmps.gammas.device, cmps.gammas.dtype)
    return _apply_local(cmps, gates, anchors[mine] - start, parity, ax, float(trunc_thr))


def chain_apply_1q_dense(cmps: ChainMPS, gates: torch.Tensor, mesh, *, axis: str = "sp") -> ChainMPS:
    """Distinct 1q gates at EVERY site (``gates (n, 2, 2)``, replicated);
    purely local.  Parity: ``ops.mps.apply_1q_many``."""
    m = chain_block_size(cmps.num_sites, mesh, axis)
    ax = axis_of(mesh, axis)
    g = torch.as_tensor(gates)[ax.index * m:(ax.index + 1) * m].to(cmps.gammas.device, cmps.gammas.dtype)
    return ChainMPS(torch.einsum("pij,...pjab->...piab", g, cmps.gammas), cmps.lam_r, cmps.num_sites)


# -----------------------------------------------------------------------------
# Environment pipelines: boundary environments flow along the ranks; each
# rank keeps only its own block of the environment stacks.
# -----------------------------------------------------------------------------


def _env_pipelines(aw: torch.Tensor, az: torch.Tensor, ax: Axis):
    """This rank's blocks of the environment stacks of <w|z> from its folded
    blocks: ``l_blk[j]`` covers every site left of local site j, ``r_blk[j]``
    every site at or right of it (``ops.mps_gradient._env_stacks``'s L and R
    at the rank's sites).  Two pipelines of P rounds."""
    m = aw.shape[-4]
    e00 = _env_e00(aw, az)
    env = pipeline_recv(e00, 1, ax)
    env = e00 if env is None else env
    left: List[torch.Tensor] = []
    for j in range(m):
        left.append(env)
        env = _env_left_step(env, aw[..., j, :, :, :], az[..., j, :, :, :])
    pipeline_send(env, 1, ax)
    env = pipeline_recv(e00, -1, ax)
    env = e00 if env is None else env
    right: List[Optional[torch.Tensor]] = [None] * m
    for j in range(m - 1, -1, -1):
        env = _env_right_step(aw[..., j, :, :, :], az[..., j, :, :, :], env)
        right[j] = env
    pipeline_send(env, -1, ax)
    return torch.stack(left, dim=-3), torch.stack(right, dim=-3)


def chain_env_stacks(w: ChainMPS, z: ChainMPS, mesh, *, axis: str = "sp"):
    """This rank's (m, cw, cz) blocks of the L/R environment stacks of <w|z>."""
    chain_block_size(w.num_sites, mesh, axis)
    aw, az = _promoted(w, z)
    return _env_pipelines(aw, az, axis_of(mesh, axis))


def _pair_n4_local(aw, az, l_blk, r_blk, lo_loc: np.ndarray, parity: int, ax: Axis) -> torch.Tensor:
    """The two-site environment tensors N₄ of <w|z> for this rank's pairs
    (``(..., K, 4, 4)``; rows = z physical (u,v), cols = w physical (s,t)):
    the shard of ``ops.mps_gradient._pair_env_tensors``.  One halo round
    from the right neighbour: its first R environment and, where a pair
    straddles, its second one and its first site tensors."""
    d, P = ax.index, ax.size
    left, right = d > 0, d + 1 < P
    straddles, left_straddles = _straddles(aw.shape[-4], ax, parity)

    def heads(on: bool):
        extra = [r_blk[..., 1, :, :], aw[..., 0, :, :, :], az[..., 0, :, :, :]] if on else []
        return [r_blk[..., 0, :, :]] + extra

    got = p2p_round([(t, d - 1) for t in heads(left_straddles)] if left else [],
                    [(t, d + 1) for t in heads(straddles)] if right else [], ax)
    r0 = got[0] if right else _env_e00(aw, az)  # R[n] is the trivial boundary
    r_ext, aw_ext, az_ext = [r_blk, r0[..., None, :, :]], aw, az
    if straddles:
        r_ext.append(got[1][..., None, :, :])
        aw_ext = torch.cat([aw, got[2][..., None, :, :, :]], dim=-4)
        az_ext = torch.cat([az, got[3][..., None, :, :, :]], dim=-4)
    r_ext = torch.cat(r_ext, dim=-3)
    lo = torch.as_tensor(lo_loc, dtype=torch.long, device=aw.device)
    tw = torch.einsum("...psam,...ptmb->...pstab", aw[..., lo, :, :, :], aw_ext[..., lo + 1, :, :, :])
    tz = torch.einsum("...puAM,...pvMB->...puvAB", az[..., lo, :, :, :], az_ext[..., lo + 1, :, :, :])
    tz = torch.einsum("...puvAB,...pbB->...puvAb", tz, r_ext[..., lo + 2, :, :])
    x = torch.einsum("...paA,...pstab->...pstAb", l_blk[..., lo, :, :], tw.conj())
    n4 = torch.einsum("...pstAb,...puvAb->...puvst", x, tz)
    return n4.reshape(n4.shape[:-4] + (4, 4))


def _local_members(group, cmps: ChainMPS, ax: Axis):
    """The members (t, lo) of a half-layer group whose pair this rank owns,
    their local low sites and the group's parity."""
    parity = int(group[0][1] % 2)
    if any(lo % 2 != parity for _, lo in group):
        raise ValueError("group anchors must share parity")
    m = cmps.block_size
    start = ax.index * m
    local = [(t, lo) for t, lo in group if start <= lo < start + m]
    return local, np.asarray([lo - start for _, lo in local], dtype=int), parity


def _apply_both(w: ChainMPS, z: ChainMPS, gates, lo_loc, parity, ax, trunc_thr):
    """The same pair gates on w and z: one batched decomposition of both
    blocks where their bond dimensions match."""
    if w.chi == z.chi and w.gammas.dtype == z.gammas.dtype:
        wz = ChainMPS(torch.stack([w.gammas, z.gammas]), torch.stack([w.lam_r, z.lam_r]), w.num_sites)
        wz = _apply_local(wz, gates, lo_loc, parity, ax, trunc_thr)
        return (ChainMPS(wz.gammas[0], wz.lam_r[0], w.num_sites),
                ChainMPS(wz.gammas[1], wz.lam_r[1], z.num_sites))
    return (_apply_local(w, gates, lo_loc, parity, ax, trunc_thr),
            _apply_local(z, gates, lo_loc, parity, ax, trunc_thr))


def chain_half_layer_cosweep(
    circ,
    group,
    layer_thetas: torch.Tensor,  # (bpl, tpb)
    layer_masks: torch.Tensor,  # (bpl,)
    w: ChainMPS,
    z: ChainMPS,
    trunc_thr: float,
    dtype,
    mesh,
    axis: str = "sp",
):
    """One half-layer group of the layered co-sweep on the site-sharded
    chains: the per-parameter dots of this rank's pairs plus the truncated
    pair update of BOTH states.  Returns (w', z', rows (bpl, 4)) with rows
    only for the blocks of this rank's pairs (the sum over the ranks is the
    replicated engine's rows).  The algebra is
    ``ops.mps_gradient._half_layer_cosweep``'s."""
    ax = axis_of(mesh, axis)
    local, lo_loc, parity = _local_members(group, w, ax)
    aw, az = _promoted(w, z)
    l_blk, r_blk = _env_pipelines(aw, az, ax)
    n4 = _pair_n4_local(aw, az, l_blk, r_blk, lo_loc, parity, ax)
    dots = torch.zeros((circ.bpl, 4), dtype=dtype, device=w.gammas.device)
    if local:
        prefix, sandwiches = _triplet_prefixes(local, layer_thetas, layer_masks, dtype, w.gammas.device)
        for blk, col, msk, y4 in sandwiches:
            dots[..., blk, col] += 0.5j * (y4.conj() * n4).sum((-2, -1)) * msk
    else:
        prefix = torch.empty((0, 4, 4), dtype=dtype, device=w.gammas.device)
    w, z = _apply_both(w, z, prefix, lo_loc, parity, ax, trunc_thr)
    return w, z, dots


def chain_front_cosweep(circ, thetas1q: torch.Tensor, w: ChainMPS, z: ChainMPS, front_layer: bool, mesh,
                        axis: str, dtype):
    """The front Rz·Ry·Rz layer on the site-sharded chains: local 1q applies;
    the per-site dots reuse ONE stack build (a 1q gate on both states leaves
    every environment unchanged: ``ops.mps_gradient._front_cosweep_batched``).
    Returns (w', z', grads (m, 3) of this rank's sites)."""
    ax = axis_of(mesh, axis)
    m = chain_block_size(circ.num_qubits, mesh, axis)
    dev = w.gammas.device
    th = thetas1q[ax.index * m:(ax.index + 1) * m]
    grads = torch.zeros((m, 3), dtype=dtype, device=dev)
    if front_layer:
        aw, az = _promoted(w, z)
        l_blk, r_blk = _env_pipelines(aw, az, ax)
        # R one site to the right: the last one is the right neighbour's first.
        got = p2p_round([(r_blk[..., 0, :, :], ax.index - 1)] if ax.index > 0 else [],
                        [(r_blk[..., 0, :, :], ax.index + 1)] if ax.index + 1 < ax.size else [], ax)
        r_next = got[0] if got else _env_e00(aw, az)
        r_shift = torch.cat([r_blk[..., 1:, :, :], r_next[..., None, :, :]], dim=-3)
    gw, gz = w.gammas, z.gammas
    for col, gate_fn, pauli in ((2, G.rz, G.z), (1, G.ry, G.y), (0, G.rz, G.z)):
        g = gate_fn(th[..., col], dtype)
        gw = torch.einsum("pij,...pjab->...piab", g.to(gw.dtype), gw)
        gz = torch.einsum("pij,...pjab->...piab", g.to(gz.dtype), gz)
        if front_layer:
            aw = gw * w.lam_r[..., :, None, None, :].to(gw.dtype)
            az = gz * z.lam_r[..., :, None, None, :].to(gz.dtype)
            paw = torch.einsum("...pij,...pjab->...piab", pauli(dtype, dev).expand(m, 2, 2).to(aw.dtype), aw)
            x = torch.einsum("...paA,...psab->...pAsb", l_blk, paw.conj())
            x = torch.einsum("...pAsb,...psAB->...pbB", x, az)
            grads[..., col] = 0.5j * (x * r_shift).sum((-2, -1))
    return (ChainMPS(gw, w.lam_r, w.num_sites), ChainMPS(gz, z.lam_r, z.num_sites), grads)


def _as_thetas(thetas, like: torch.Tensor) -> torch.Tensor:
    if isinstance(thetas, torch.Tensor):
        return thetas.to(like.device)
    return torch.as_tensor(np.asarray(thetas), dtype=real_of(like.dtype), device=like.device)


def _as_chain(state, mesh, axis: str) -> ChainMPS:
    return state if isinstance(state, ChainMPS) else chain_from_mps(state, mesh, axis=axis)


def chain_fast_dot_gradient(
    circ,
    thetas,
    lvec,
    vh_phi,
    mesh,
    *,
    axis: str = "sp",
    trunc_thr: float = no_truncation_threshold(),
    block_range=None,
    front_layer: bool = True,
) -> torch.Tensor:
    """Complex gradient of ``<lvec | V† | phi>`` with SITE-SHARDED states —
    the memory-scaling twin of ``ops.mps_gradient.fast_dot_gradient``'s
    layered path (a layered Trotterized CX ansatz).  ``lvec`` / ``vh_phi``
    are replicated MPS (sharded on entry) or this rank's ChainMPS blocks;
    the gradient is replicated on every rank (each entry computed by one
    rank, then one all-reduce SUM)."""
    if not _layered_eligible(circ):
        raise ValueError("the chain gradient needs the layered Trotter (cx) family")
    ax = axis_of(mesh, axis)
    w, z = _as_chain(lvec, mesh, axis), _as_chain(vh_phi, mesh, axis)
    dtype = w.gammas.dtype
    dev = w.gammas.device
    nb, bpl, tpb = circ.num_blocks, circ.bpl, circ.tpb
    layers = nb // bpl
    groups = _layered_plan(circ)
    thetas = _as_thetas(thetas, w.gammas)
    block_range = (0, nb) if block_range is None else tuple(block_range)
    masks = _masks(nb, block_range, thetas.dtype, dev)
    m = w.block_size

    w, z, g1_loc = chain_front_cosweep(circ, circ.subset1q(thetas), w, z, front_layer, mesh, axis, dtype)
    grad1q = torch.zeros((circ.num_qubits, 3), dtype=dtype, device=dev)
    grad1q[ax.index * m:(ax.index + 1) * m] = g1_loc

    th_layers = circ.subset2q(thetas).reshape(layers, bpl, tpb)
    m_layers = masks.reshape(layers, bpl)
    rows = []
    for j in range(layers):
        dots = torch.zeros((bpl, 4), dtype=dtype, device=dev)
        for group in groups:
            w, z, r = chain_half_layer_cosweep(circ, group, th_layers[j], m_layers[j], w, z, trunc_thr, dtype,
                                               mesh, axis)
            dots = dots + r
        rows.append(dots)
    grad2q = torch.stack(rows).reshape(nb, tpb)
    if circ.half_layer_num_blocks:
        w, z, r = chain_half_layer_cosweep(circ, groups[0], th_layers[0], m_layers[0], w, z, trunc_thr, dtype,
                                           mesh, axis)
        grad2q[:bpl] += r
    return all_reduce_sum(torch.cat([grad1q.reshape(-1), grad2q.reshape(-1)]), ax)


def chain_asp_objective_and_gradient(circ, thetas, lvec: ChainMPS, phi: ChainMPS, mesh, *, axis: str = "sp",
                                     trunc_thr: float = no_truncation_threshold()):
    """ASP fidelity objective ``1 - |<lvec | V†(Θ) phi>|²`` and its real
    analytic gradient with every state, environment and pair batch
    site-sharded; both replicated bitwise on every rank."""
    vh = chain_v_dagger_mul_mps(circ, thetas, phi, mesh, axis=axis, trunc_thr=trunc_thr)
    dot = chain_dot(lvec, vh, mesh, axis=axis)  # <lvec | V† phi>
    grad_c = chain_fast_dot_gradient(circ, thetas, lvec, vh, mesh, axis=axis, trunc_thr=trunc_thr)
    grad = (-2.0 * dot.conj() * grad_c).real
    return (1.0 - dot.abs() ** 2).to(grad.dtype), grad


def chain_optimize_horizon(
    circ,
    thetas0,
    lvec: ChainMPS,
    phi: ChainMPS,
    mesh,
    *,
    axis: str = "sp",
    trunc_thr: float = no_truncation_threshold(),
    maxiter: int = 50,
    fobj_thr: Optional[float] = None,
):
    """Compact L-BFGS (``optim/lbfgs.minimize_lbfgs_compact``) over the
    memory-sharded ASP objective: every rank runs the same replicated loop,
    its decisions read from bitwise-replicated values.  The sharded
    counterpart of ``models/sp_lhs/jit_asp.optimize_horizon_mps_jit``."""
    from ..optim.lbfgs import minimize_lbfgs_compact

    def vgrad(th):
        return chain_asp_objective_and_gradient(circ, th, lvec, phi, mesh, axis=axis, trunc_thr=trunc_thr)

    def value_only(th):
        # Linesearch trials need only the V† sweep and the overlap.
        vh = chain_v_dagger_mul_mps(circ, th, phi, mesh, axis=axis, trunc_thr=trunc_thr)
        return (1.0 - chain_dot(lvec, vh, mesh, axis=axis).abs() ** 2).to(th.dtype)

    x0 = _as_thetas(thetas0, lvec.gammas)
    return minimize_lbfgs_compact(value_only, x0, maxiter=maxiter, fobj_thr=fobj_thr, value_and_grad_fn=vgrad)


def chain_v_dagger_mul_mps(circ, thetas, cmps: ChainMPS, mesh, *, axis: str = "sp",
                           trunc_thr: float = no_truncation_threshold()) -> ChainMPS:
    """``V(Θ)† @ state`` for a layered Trotterized CX ansatz on the
    site-sharded chain — the memory-scaling twin of
    ``ops.mps.v_dagger_mul_mps`` for this family (a triplet's three daggered
    block gates compose into one 4x4 per pair, so a half-layer is ONE
    sharded truncated update)."""
    if not _layered_eligible(circ):
        raise ValueError("the chain V† sweep needs the layered Trotter (cx) family")
    ax = axis_of(mesh, axis)
    thetas = _as_thetas(thetas, cmps.gammas)
    dtype = cmps.gammas.dtype
    nb, bpl = circ.num_blocks, circ.bpl
    layers = nb // bpl
    groups = _layered_plan(circ)
    gates = block_gates(circ, circ.subset2q(thetas), dtype, dagger=True)
    f1q = front_gates(circ, circ.subset1q(thetas), dtype, dagger=True)

    def lo_major(g, k):
        if int(circ.blocks[0, k]) > int(circ.blocks[1, k]):
            g = g.reshape(2, 2, 2, 2).permute(1, 0, 3, 2).reshape(4, 4)
        return g

    def composite(g_src, t):
        # Forward order G0, G1, G2 -> dagger composite G0† G1† G2† (g_src
        # holds the daggered block gates).
        g = lo_major(g_src[3 * t], 3 * t)
        for b in (1, 2):
            g = torch.matmul(g, lo_major(g_src[3 * t + b], 3 * t + b))
        return g

    def apply_group(state, group, g_src):
        local, lo_loc, parity = _local_members(group, state, ax)
        comp = (torch.stack([composite(g_src, t) for t, _ in local]) if local
                else torch.empty((0, 4, 4), dtype=dtype, device=state.gammas.device))
        return _apply_local(state, comp, lo_loc, parity, ax, float(trunc_thr))

    out = cmps
    if circ.half_layer_num_blocks:
        # The trailing half-layer first (V† order); it reuses the leading
        # even group's blocks and angles (the 2nd-order Trotter tail).
        out = apply_group(out, groups[0], gates)
    for layer in range(layers - 1, -1, -1):
        g_l = gates[layer * bpl:(layer + 1) * bpl]
        for group in reversed(groups):
            out = apply_group(out, group, g_l)
    return chain_apply_1q_dense(out, f1q, mesh, axis=axis)
