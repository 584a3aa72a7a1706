"""Sharded MPS pair updates: a half-layer's truncated decompositions spread
over the ranks of a mesh axis (twin of
``aqc_research_tpu/parallel/mps_sharded.py``).

The pairs of a chessboard half-layer touch disjoint (Γ, λ), so their
updates are independent.  Every rank holds the replicated MPS, takes its own
run of the pairs (a local slice, no message), runs the ordinary pair update
on it — on the card the rand route's K2 → range-finder → K3, or K4 / K1 on
the jacobi route, at the rank-local batch — and one ``all_gather`` of the
updated Γ_lo, Γ_hi and λ' (packed into one real buffer: O(P·χ²) elements)
brings every rank the whole half-layer, which each writes back into its
replica.  The whole Γ is never gathered.

Every rank writes the same gathered bytes into a replica that was bitwise
the same before, so the state — and every value computed from it — stays
bitwise replicated across the ranks.

:func:`aqc_research_tpu_torch.ops.mps.set_pair_sharding` routes every
batched half-layer of the MPS engine through this module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import real_of
from ..ops.mps import MPS, _lam_ext, _pair_update, broadcast_mps, no_truncation_threshold, site_index
from .comm import all_gather, axis_of


def apply_pairs_mps_sharded(
    mps: MPS,
    gates4: torch.Tensor,
    lo_sites: Tuple[int, ...],
    mesh,
    *,
    axis: str = "tp",
    trunc_thr: float = no_truncation_threshold(),
) -> MPS:
    """Like ``ops.mps.apply_pairs_mps`` (``gates4 (..., P, 4, 4)``, leading
    lane axes broadcast with the MPS's), with the pair axis sharded over
    ``mesh``'s ``axis``; every rank passes its replica and returns the
    updated replica.  The pair list is padded to a multiple of the rank
    count by repeating the last pair with its own gate, and only the
    original pairs are written back (a duplicate's factors come from another
    decomposition batch and must not be mixed in)."""
    n, chi = mps.num_sites, mps.chi
    lo = np.asarray(lo_sites, dtype=int)
    if not (lo.size > 0 and np.all(np.diff(lo) >= 2)):
        raise ValueError(f"pairs must be disjoint and ascending: {lo_sites}")
    if lo.min() < 0 or lo.max() + 1 >= n:
        raise ValueError(f"pair positions out of range: {lo_sites}")
    ax = axis_of(mesh, axis)
    dev = mps.gammas.device
    dtype, rdtype = mps.gammas.dtype, mps.lambdas.dtype
    gates4 = torch.as_tensor(gates4, device=dev)
    mps = broadcast_mps(mps, gates4.shape[:-3])
    batch = tuple(mps.gammas.shape[:-4])

    pad = (-lo.size) % ax.size
    if pad:
        lo_pad = np.concatenate([lo, np.repeat(lo[-1], pad)])
        last = gates4[..., -1:, :, :]
        gates4 = torch.cat([gates4, last.expand(last.shape[:-3] + (pad, 4, 4))], dim=-3)
    else:
        lo_pad = lo
    k = lo_pad.size // ax.size
    mine = slice(ax.index * k, (ax.index + 1) * k)
    lo_mine = site_index(lo_pad[mine], dev)
    lam_ext = _lam_ext(mps)
    new = _pair_update(
        lam_ext[..., lo_mine, :], lam_ext[..., lo_mine + 1, :], lam_ext[..., lo_mine + 2, :],
        mps.gammas[..., lo_mine, :, :, :], mps.gammas[..., lo_mine + 1, :, :, :],
        gates4[..., mine, :, :], chi, trunc_thr, dtype, rdtype,
    )

    # One all_gather of the three updated slices, packed as one real buffer.
    rtype = real_of(dtype)
    flat = [torch.view_as_real(t.contiguous()).reshape(-1) for t in new[:2]]
    flat.append(new[2].to(rtype).reshape(-1))
    gathered = all_gather(torch.cat(flat), ax)  # (ranks, buffer)
    shapes = [new[0].shape + (2,), new[1].shape + (2,), new[2].shape]
    outs, at = [], 0
    for shape in shapes:
        size = int(np.prod(shape))
        part = gathered[:, at:at + size].reshape((ax.size,) + tuple(shape))
        at += size
        # (ranks, *batch, k, ...) -> (*batch, ranks * k, ...), rank-major as lo_pad.
        part = part.movedim(0, len(batch)).flatten(len(batch), len(batch) + 1)
        outs.append(part[(slice(None),) * len(batch) + (slice(0, lo.size),)])
    new_g1 = torch.view_as_complex(outs[0].contiguous())
    new_g2 = torch.view_as_complex(outs[1].contiguous())
    new_lam = outs[2].to(rdtype)

    lo_t = site_index(lo, dev)
    gammas = mps.gammas.clone()
    gammas[..., lo_t, :, :, :] = new_g1
    gammas[..., lo_t + 1, :, :, :] = new_g2
    lambdas = mps.lambdas.clone()
    lambdas[..., lo_t, :] = new_lam
    return MPS(gammas, lambdas)
