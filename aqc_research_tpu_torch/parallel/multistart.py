"""Batched multi-start optimization (twin of
``aqc_research_tpu/parallel/multistart.py``): the B rows of a batch of
initial Θ run one loop in lock step as a fleet (optim/lbfgs.py's lanes),
every evaluation one batched pass over the running lanes — the twin of the
JAX package's ``vmap`` over the one-start loop.

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
) -> MultistartResult:
    """Minimizes the scalar ``fun`` from every row of ``thetas_batch (B,
    P)`` at once: "lbfgs" (optax's L-BFGS with its zoom linesearch) or
    "adam", on the lanes of ``torch.func.vmap(fun)`` with the gradient from
    one ``torch.autograd`` call.  A numpy batch goes to the default device.
    ``mesh`` (sharding the starts over several cards) is not ported: it is
    ROADMAP.md section 1, item 16 (multi-GPU)."""
    if mesh is not None:
        raise NotImplementedError(
            "multistart_minimize(mesh=...) is not ported: sharding the starts over several GPUs is "
            "ROADMAP.md section 1, item 16 (multi-GPU)"
        )
    if method not in ("lbfgs", "adam"):
        raise ValueError(f"unknown method: {method}")
    if not isinstance(thetas_batch, torch.Tensor):
        from ..config import device

        thetas_batch = torch.as_tensor(np.asarray(thetas_batch), device=device())
    _, value_and_grad = lane_objective(fun)
    opts = dict(maxiter=int(maxiter), fobj_thr=fobj_thr, no_improve_iters=no_improve_iters)
    if method == "lbfgs":
        res = minimize_lbfgs_lanes(value_and_grad, thetas_batch, **opts)
    else:
        res = minimize_adam_lanes(value_and_grad, thetas_batch, learn_rate=learn_rate, **opts)
    return MultistartResult(res.thetas, res.fobj, res.num_iters, int(torch.argmin(res.fobj)))
