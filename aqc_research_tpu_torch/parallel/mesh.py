"""Device meshes and the sharded-statevector layout (twin of
``aqc_research_tpu/parallel/mesh.py``).

* :func:`make_mesh` — a named ``DeviceMesh`` (``dp`` = the multi-start
  batch, ``tp`` = the statevector shards, ``sp`` = the MPS site chain) over
  the first ``prod(axis_sizes)`` ranks of the process group.
* A ``2^n`` state sharded over ``tp`` puts its TOP ``log2(tp)`` qubits on
  the axis: position r along ``tp`` holds amplitudes ``[r·L, (r+1)·L)``,
  L = 2^n / tp (:func:`shard_state`).

The JAX package's ``NamedSharding`` helpers (``state_sharding``,
``batch_sharding``, ``replicated``) describe where one global array lives;
the port is SPMD and every rank holds its own shard, which
:func:`shard_state` and :func:`shard_batch` return.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .comm import axis_of


def make_mesh(
    axis_sizes: Sequence[int],
    axis_names: Sequence[str] = ("dp", "tp"),
    ranks: Optional[Sequence[int]] = None,
):
    """A named mesh over ``prod(axis_sizes)`` ranks (default: ranks 0, 1, …
    in order).  Every rank of the process group must call it (the axis
    groups are made collectively); a rank outside ``ranks`` gets a mesh it
    is not on."""
    from torch.distributed.device_mesh import DeviceMesh

    from .distributed import mesh_device_type, process_info

    sizes = tuple(int(s) for s in axis_sizes)
    total = int(np.prod(sizes))
    _, world = process_info()
    ranks = list(range(total)) if ranks is None else list(ranks)
    if len(ranks) != total or total > world:
        raise ValueError(f"mesh {sizes} needs {total} of the {world} ranks, got {len(ranks)}")
    grid = torch.as_tensor(ranks, dtype=torch.int64).reshape(sizes)
    return DeviceMesh(mesh_device_type(), grid, mesh_dim_names=tuple(axis_names[: len(sizes)]))


def num_local_qubits(num_qubits: int, tp_size: int) -> Tuple[int, int]:
    """Splits qubits into (local, sharded): the top log2(tp) qubits live on
    the mesh axis."""
    k = int(np.log2(tp_size))
    if 2**k != tp_size:
        raise ValueError("tp axis size must be a power of 2")
    if k >= num_qubits:
        raise ValueError(f"{num_qubits} qubits cannot shard over {tp_size} ranks")
    return num_qubits - k, k


def _block(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    ax = axis_of(mesh, axis)
    size = t.shape[dim]
    if size % ax.size:
        raise ValueError(f"axis of {size} does not divide over {ax.size} ranks of {axis!r}")
    step = size // ax.size
    return t.narrow(dim, ax.index * step, step).clone()


def shard_state(state: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """This rank's shard of a dense state's last axis (its own copy)."""
    return _block(state, -1, mesh, axis)


def shard_batch(batch: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """This rank's rows of a batch's leading (multi-start) axis."""
    return _block(batch, 0, mesh, axis)
