"""The collectives of the port's multi-GPU layer, over ``torch.distributed``.

The JAX package runs one controller over a ``Mesh`` and lets ``shard_map``
place its collectives; the port runs one process per card (SPMD), and every
rank calls the same sequence of these helpers.  A mesh axis is a
:class:`~torch.distributed.device_mesh.DeviceMesh` dimension: its process
group, its size and this rank's index along it (:func:`axis_of`).

Rules every helper keeps:

* complex tensors travel as their ``torch.view_as_real`` views (NCCL has no
  complex type);
* a rank never sends to itself: along an axis of one rank the neighbour
  exchanges have no peer and the caller takes its own boundary value, so a
  group of one runs the same code with no message;
* point-to-point rounds go through one ``batch_isend_irecv`` call each, so a
  spy on that function counts rounds.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh axis as this rank sees it."""

    group: object  # the axis's ProcessGroup
    size: int
    index: int  # this rank's position along the axis
    ranks: Tuple[int, ...]  # global rank of each position


def axis_of(mesh, axis: str) -> Axis:
    """The process group, size and this rank's index of ``mesh``'s ``axis``."""
    group = mesh.get_group(axis)
    size = dist.get_world_size(group)
    ranks = tuple(dist.get_global_rank(group, i) for i in range(size))
    return Axis(group, size, dist.get_rank(group), ranks)


def _real(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _like(t: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(buf) if t.is_complex() else buf


def all_gather(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``(size, *t.shape)``: every rank's ``t`` along the axis, in index order."""
    src = _real(t)
    bufs = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(bufs, src, group=ax.group)
    return _like(t, torch.stack(bufs))


def all_reduce_sum(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum of ``t`` over the axis (a new tensor).  Where every entry has
    one writer and the others hold zero, the sum is exact and so bitwise the
    same on every rank."""
    out = _real(t).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ax.group)
    return _like(t, out)


def all_reduce_max(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group)
    return out


def broadcast(t: torch.Tensor, src_index: int, ax: Axis) -> torch.Tensor:
    """Position ``src_index``'s ``t`` on every rank of the axis (a new tensor)."""
    out = _real(t).clone()
    dist.broadcast(out, ax.ranks[src_index], group=ax.group)
    return _like(t, out)


def p2p_round(
    sends: Sequence[Tuple[torch.Tensor, int]],
    recvs: Sequence[Tuple[torch.Tensor, int]],
    ax: Axis,
) -> List[torch.Tensor]:
    """One round of point-to-point messages along the axis: each ``(tensor,
    peer index)`` of ``sends`` goes to its peer; each ``(like, peer index)``
    of ``recvs`` returns a tensor shaped and typed like ``like`` from its
    peer, in the order given.  Messages between one pair of ranks match in
    the order they are listed on both sides."""
    ops, bufs, keep = [], [], []
    for t, peer in sends:
        if peer == ax.index:
            raise ValueError("a rank never sends to itself")
        src = _real(t)
        keep.append(src)
        ops.append(dist.P2POp(dist.isend, src, ax.ranks[peer], ax.group))
    for like, peer in recvs:
        if peer == ax.index:
            raise ValueError("a rank never receives from itself")
        buf = torch.empty_like(_real(like))
        bufs.append((like, buf))
        ops.append(dist.P2POp(dist.irecv, buf, ax.ranks[peer], ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [_like(like, buf) for like, buf in bufs]


def swap_with(t: torch.Tensor, peer: int, ax: Axis) -> torch.Tensor:
    """Sends ``t`` to ``peer`` and returns the peer's tensor of the same shape."""
    return p2p_round([(t, peer)], [(t, peer)], ax)[0]


def pipeline_recv(like: torch.Tensor, step: int, ax: Axis) -> Optional[torch.Tensor]:
    """The value the previous stage of a one-way pipeline hands on: from
    index - step (step = +1: rightward, -1: leftward); None at the stage
    that starts the pipeline."""
    src = ax.index - step
    if not 0 <= src < ax.size:
        return None
    return p2p_round([], [(like, src)], ax)[0]


def pipeline_send(t: torch.Tensor, step: int, ax: Axis) -> None:
    """Hands ``t`` on to index + step; nothing at the pipeline's last stage."""
    dst = ax.index + step
    if 0 <= dst < ax.size:
        p2p_round([(t, dst)], [], ax)
