"""Batched multi-start optimization (twin of
``aqc_research_tpu/parallel/multistart.py``): the B rows of a batch of
initial Θ run one loop in lock step as a fleet (optim/lbfgs.py's lanes),
every evaluation one batched pass over the running lanes — the twin of the
JAX package's ``vmap`` over the one-start loop.  Over a mesh the rows are
sharded over the ``dp`` ranks, each rank one fleet.

Per-start randomness comes from an explicit ``torch.Generator`` (the JAX
package splits a JAX key, which torch cannot replay)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..optim.lbfgs import lane_objective, minimize_adam_lanes, minimize_lbfgs_lanes
from ..utils import rand_thetas_gen


class MultistartResult(NamedTuple):
    thetas: torch.Tensor  # (B, P) best parameters per start
    fobj: torch.Tensor  # (B,) best objective values
    num_iters: np.ndarray  # (B,)
    best_index: int  # argmin of fobj


def random_initial_thetas(generator: torch.Generator, num_starts: int, num_thetas: int,
                          dtype=torch.float64) -> torch.Tensor:
    """B random Θ0 rows in (-pi, pi), drawn in turn from ``generator``, on
    its device."""
    return torch.stack([rand_thetas_gen(generator, num_thetas, dtype) for _ in range(int(num_starts))])


def multistart_minimize(
    fun: Callable[[torch.Tensor], torch.Tensor],
    thetas_batch,
    *,
    method: str = "lbfgs",
    maxiter: int = 100,
    learn_rate: float = 0.1,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
    mesh=None,
    batch_axis: str = "dp",
) -> MultistartResult:
    """Minimizes the scalar ``fun`` from every row of ``thetas_batch (B,
    P)`` at once: "lbfgs" (optax's L-BFGS with its zoom linesearch) or
    "adam", on the lanes of ``torch.func.vmap(fun)`` with the gradient from
    one ``torch.autograd`` call.  A numpy batch goes to the default device.

    With ``mesh`` (a DeviceMesh) the starts are sharded over its
    ``batch_axis``: every rank passes the whole batch, runs its own rows
    (B must divide over the axis) as its own lane fleet, and gets the whole
    :class:`MultistartResult` back (the rows all-gathered, ``best_index``
    the global argmin)."""
    if method not in ("lbfgs", "adam"):
        raise ValueError(f"unknown method: {method}")
    if not isinstance(thetas_batch, torch.Tensor):
        from ..config import device

        thetas_batch = torch.as_tensor(np.asarray(thetas_batch), device=device())
    if mesh is not None:
        from .comm import all_gather, axis_of
        from .mesh import shard_batch

        if not hasattr(mesh, "get_group"):
            raise TypeError(f"mesh must be a torch DeviceMesh, got {type(mesh).__name__}")
        ax = axis_of(mesh, batch_axis)
        res = multistart_minimize(
            fun, shard_batch(thetas_batch, mesh, batch_axis), method=method, maxiter=maxiter,
            learn_rate=learn_rate, fobj_thr=fobj_thr, no_improve_iters=no_improve_iters,
        )
        thetas = all_gather(res.thetas, ax).flatten(0, 1)
        fobj = all_gather(res.fobj, ax).flatten(0, 1)
        iters = torch.as_tensor(np.asarray(res.num_iters), dtype=torch.int64, device=fobj.device)
        iters = all_gather(iters, ax).flatten(0, 1).cpu().numpy()
        return MultistartResult(thetas, fobj, iters, int(torch.argmin(fobj)))
    _, value_and_grad = lane_objective(fun)
    opts = dict(maxiter=int(maxiter), fobj_thr=fobj_thr, no_improve_iters=no_improve_iters)
    if method == "lbfgs":
        res = minimize_lbfgs_lanes(value_and_grad, thetas_batch, **opts)
    else:
        res = minimize_adam_lanes(value_and_grad, thetas_batch, learn_rate=learn_rate, **opts)
    return MultistartResult(res.thetas, res.fobj, res.num_iters, int(torch.argmin(res.fobj)))
