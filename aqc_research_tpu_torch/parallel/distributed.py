"""Multi-process runtime on ``torch.distributed`` (twin of
``aqc_research_tpu/parallel/distributed.py``).

The JAX package joins one multi-process JAX runtime and sees every device
from one controller.  The port runs one process per card (SPMD): every rank
runs the same program on its own card and the ranks meet in collectives.

* :func:`initialize_distributed` — joins the process group only when one is
  configured (explicit arguments; torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``; or the JAX package's
  ``AQC_TPU_COORDINATOR`` with ``AQC_TPU_NUM_PROCESSES`` /
  ``AQC_TPU_PROCESS_ID``), so single-process runs are unaffected.  NCCL for
  the card, Gloo where the CPU was asked for (``config.set_device("cpu")``
  or ``AQC_TORCH_DEVICE=cpu``); never a silent switch between them.
* :func:`global_mesh` — a named ``DeviceMesh`` over every rank with the
  ``dcn_axis`` (default ``dp``, the multi-start axis) outermost, so that on
  several hosts only that axis crosses between them (ranks are numbered
  host by host), as the JAX package keeps ``dp`` on DCN.
* :func:`build_kernels_once` — local rank 0 builds the kernel library, the
  other ranks of the host wait at a barrier and load it.

Start a multi-GPU run with ``torchrun --nproc-per-node=K ...`` (see
``parallel/dryrun.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import config

_COORD_ENVS = ("AQC_TPU_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
DEFAULT_TIMEOUT_S = 600.0


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        val = os.environ.get(name)
        if val:
            return int(val)
    return None


def backend_for(dev: torch.device) -> str:
    """NCCL for CUDA tensors, Gloo for CPU tensors."""
    return "nccl" if torch.device(dev).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's index among the ranks of its host: torchrun's
    ``LOCAL_RANK``; else the global rank modulo the ranks per host
    (``LOCAL_WORLD_SIZE``, else the host's cards, else every rank)."""
    val = _env_int("LOCAL_RANK")
    if val is not None:
        return val
    rank, world = process_info()
    per_host = _env_int("LOCAL_WORLD_SIZE") or torch.cuda.device_count() or world
    return rank % per_host


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Joins the process group when one is configured; returns True when the
    group is (already) up, False for an ordinary single-process run.

    Resolution order: explicit arguments (``coordinator_address`` =
    ``"host:port"``), then torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT`` with ``RANK`` and ``WORLD_SIZE``), then
    ``AQC_TPU_COORDINATOR`` / ``JAX_COORDINATOR_ADDRESS`` with
    ``AQC_TPU_NUM_PROCESSES`` / ``JAX_NUM_PROCESSES`` and
    ``AQC_TPU_PROCESS_ID`` / ``JAX_PROCESS_ID``.  On the card it first
    selects this rank's card (``torch.cuda.set_device(LOCAL_RANK)``), so
    ``config.device()`` resolves to it.  A collective that waits longer than
    ``timeout_s`` fails, so a rank that dies cannot hang the others."""
    if dist.is_initialized():
        return True
    coord = coordinator_address
    if coord is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT") \
            and os.environ.get("WORLD_SIZE"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if coord is None:
        coord = next((os.environ[e] for e in _COORD_ENVS if os.environ.get(e)), None)
    if coord is None:
        return False
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE", "AQC_TPU_NUM_PROCESSES", "JAX_NUM_PROCESSES")
    rank = process_id if process_id is not None else _env_int(
        "RANK", "AQC_TPU_PROCESS_ID", "JAX_PROCESS_ID")
    if world is None or rank is None:
        raise ValueError(f"coordinator {coord!r} is set but the world size or this rank is not")
    dev = config.device()
    card = {}
    if dev.type == "cuda":
        lr = _env_int("LOCAL_RANK")
        card["device_id"] = torch.device("cuda", lr if lr is not None else int(rank) % torch.cuda.device_count())
        torch.cuda.set_device(card["device_id"])
    dist.init_process_group(
        backend_for(dev), init_method=f"tcp://{coord}", world_size=int(world), rank=int(rank),
        timeout=datetime.timedelta(seconds=timeout_s), **card,
    )
    return True


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> Tuple[int, int]:
    """(process index, process count); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def mesh_device_type() -> str:
    """The DeviceMesh device type of the process group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("dp", "tp"),
    *,
    dcn_axis: str = "dp",
):
    """Named ``DeviceMesh`` over every rank.  ``axis_sizes`` defaults to all
    ranks on the first axis.  The ``dcn_axis`` takes the slowest-varying
    rank coordinate, so every other axis stays inside a host when its sizes
    divide the ranks per host (torchrun's ``LOCAL_WORLD_SIZE``); on several
    hosts the ``dcn_axis`` size must be a multiple of the host count."""
    from torch.distributed.device_mesh import DeviceMesh

    _, total = process_info()
    names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (total,) + (1,) * (len(names) - 1)
    sizes = tuple(int(s) for s in axis_sizes)
    if int(np.prod(sizes)) != total:
        raise ValueError(f"mesh {sizes} does not cover the {total} ranks")
    names = names[: len(sizes)]
    per_host = _env_int("LOCAL_WORLD_SIZE") or total
    hosts = max(total // per_host, 1)
    di = names.index(dcn_axis) if dcn_axis in names else 0
    if hosts > 1 and sizes[di] % hosts:
        raise ValueError(f"dcn axis {names[di]}={sizes[di]} must be a multiple of the host count {hosts}")
    order = [di] + [i for i in range(len(sizes)) if i != di]
    grid = torch.arange(total).reshape([sizes[i] for i in order]).permute([int(i) for i in np.argsort(order)])
    return DeviceMesh(mesh_device_type(), grid.contiguous(), mesh_dim_names=names)


def build_kernels_once() -> None:
    """Builds the kernel library on local rank 0 while the host's other
    ranks wait at a barrier, then loads it on every rank (without this every
    rank would run nvcc on the same sources)."""
    from ..ops import cuda_build

    if not dist.is_initialized():
        cuda_build.load()
        return
    if local_rank() == 0:
        cuda_build.build_kernel_library()
    dist.barrier()
    cuda_build.load()
