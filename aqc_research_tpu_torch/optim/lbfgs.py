"""L-BFGS and Adam loops on tensors (twin of ``aqc_research_tpu/optim/lbfgs.py``).

* **Compact L-BFGS** (:func:`lbfgs_fleet_programs`): two-loop recursion +
  Armijo backtracking over a fleet of L lanes, the twin of ``jax.vmap`` over
  ``_compact_lbfgs_machinery``.  Each phase of an iteration is ONE batched
  evaluation over the lanes still running; a lane that has stopped, or whose
  Armijo test has passed, keeps its state, so every lane follows its own
  one-lane trajectory.  ``batch_linesearch`` / ``fuse_linesearch_grad``
  evaluate a whole step grid in one batch.  The one-lane loop
  (``minimize_lbfgs_compact``, ``minimize_lbfgs_compact_stateful``, the
  time-limited ``lbfgs_chunk_programs`` / ``run_lbfgs_chunked``) is the
  fleet of one lane.
* **optax's L-BFGS with its zoom linesearch** (:func:`minimize_lbfgs`) and
  **optax's Adam** (:func:`minimize_adam`), on lanes as well
  (:func:`minimize_lbfgs_lanes`, :func:`minimize_adam_lanes`).

PyTorch has no device-side while loop, so the loops run on the host; the
iterates, gradients and histories stay on the parameters' device, and the
host reads back only the masks the control flow needs (the stop flags once
per iteration, the Armijo or linesearch flags once per linesearch step, for
all lanes together).  Stopping rules, the best-so-far carry and
``num_iters`` are those of the JAX loops.  A loop's state is a carry, so a
run may stop after any iteration count and go on from there: the chunked
runner checks the wall clock between chunks.

The objective may carry a state (the surrogate's hysteresis and weight EMA):
``value_fn(x, st) -> (f, st')`` at every linesearch trial,
``value_and_grad_fn(x, st) -> (f, g, st')`` at every accepted point, the
state riding in the carry.  A stateless objective carries ``()``.  A lane
objective takes ``X (L, P)`` and returns ``f (L,)`` (and ``G (L, P)``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import count, instant, span


class JitMinimizeResult(NamedTuple):
    """Same fields as the JAX result (the name keeps the twin findable)."""

    thetas: torch.Tensor  # best parameters found
    fobj: torch.Tensor  # best objective value
    num_iters: int  # iterations actually executed
    converged: bool  # True if a stop condition fired before maxiter
    last_thetas: torch.Tensor  # final iterate (not necessarily the best)


def autograd_value_and_grad(fun: Callable[[torch.Tensor], torch.Tensor]):
    """``x -> (fun(x), d fun / dx)`` through ``torch.autograd`` (the JAX
    twin's ``jax.value_and_grad``); the value comes back detached.  Raises
    ValueError where ``fun``'s value carries no graph back to ``x``."""

    def value_and_grad(x: torch.Tensor):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = fun(xg)
            if not f.requires_grad:
                raise ValueError("the objective's value does not depend differentiably on x; "
                                 "pass value_and_grad_fn")
            (g,) = torch.autograd.grad(f, xg)
        return f.detach(), g

    return value_and_grad


class _TrialStates(tuple):
    """The objective states of a one-lane objective evaluated at the K
    points of a linesearch step grid, one per point, each from the same
    incoming state; the grid keeps the accepted point's (the JAX loop's
    per-trial states under ``vmap``)."""


def _one_lane(value_fn: Callable, value_and_grad_fn: Callable):
    """A one-lane objective (``x (P,)``, scalar ``f``) as a lane objective
    over a fleet of one lane.  Several rows (a step grid) are evaluated one
    after another from the same state; a stateful objective then returns
    their states as :class:`_TrialStates`."""

    def rows(fn, xs, st):
        outs = [fn(x, st) for x in xs]
        states = [o[-1] for o in outs]
        stateless = all(isinstance(t, tuple) and len(t) == 0 for t in states)
        return outs, (states[0] if len(outs) == 1 or stateless else _TrialStates(states))

    def value(xs, st):
        outs, st = rows(value_fn, xs, st)
        return torch.stack([f.reshape(()) for f, _ in outs]), st

    def value_and_grad(xs, st):
        outs, st = rows(value_and_grad_fn, xs, st)
        return torch.stack([f.reshape(()) for f, _, _ in outs]), torch.stack([g for _, g, _ in outs]), st

    return value, value_and_grad


def lbfgs_chunk_programs(
    value_fn: Callable,
    value_and_grad_fn: Callable,
    *,
    maxiter: int,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
    memory_size: int = 10,
    max_backtracks: int = 20,
    c1: float = 1e-4,
    stop_fn: Optional[Callable] = None,
    batch_linesearch: Optional[int] = None,
    fuse_linesearch_grad: bool = False,
):
    """The compact L-BFGS loop on one lane as ``(init, chunk, extract)``:
    :func:`lbfgs_fleet_programs` over a fleet of one lane.
    ``init(x0, obj_state0=()) -> FleetCarry`` evaluates the start point,
    ``chunk(carry, limit) -> FleetCarry`` iterates until ``carry.it >=
    limit`` or a stop condition fires, ``extract(carry) ->
    (JitMinimizeResult, obj_state)``.  The JAX twin compiles the three into
    programs and threads the objective's data through them; here they are
    closures.

    ``value_fn(x, st) -> (f, st')`` is called at every linesearch trial,
    ``value_and_grad_fn(x, st) -> (f, g, st')`` at the start point and
    every accepted point.  The loop stops on ``f < fobj_thr``, after more
    than ``no_improve_iters`` non-improving iterations, on a failed
    linesearch, on ``stop_fn(st)`` (checked after each accepted step and at
    the start point), or at the limit.  ``batch_linesearch`` /
    ``fuse_linesearch_grad``: the step grid of :func:`lbfgs_fleet_programs`
    (one evaluation of K trial points per linesearch, the gradients too
    when fused)."""
    init, chunk, extract = lbfgs_fleet_programs(
        *_one_lane(value_fn, value_and_grad_fn), maxiter=maxiter, fobj_thr=fobj_thr,
        no_improve_iters=no_improve_iters, memory_size=memory_size,
        max_backtracks=max_backtracks, c1=c1, batch_linesearch=batch_linesearch,
        fuse_linesearch_grad=fuse_linesearch_grad, stop_fn=stop_fn,
    )

    def extract_lane(c: FleetCarry) -> Tuple[JitMinimizeResult, Any]:
        res, ost = extract(c)
        return JitMinimizeResult(res.thetas[0], res.fobj[0], int(res.num_iters[0]), bool(res.converged[0]),
                                 res.last_thetas[0]), ost

    return (lambda x0, obj_state0=(): init(x0[None], obj_state0)), chunk, extract_lane


def minimize_lbfgs_compact_stateful(
    value_fn: Callable,
    value_and_grad_fn: Callable,
    x0: torch.Tensor,
    obj_state0,
    *,
    maxiter: int,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
    memory_size: int = 10,
    max_backtracks: int = 20,
    c1: float = 1e-4,
    stop_fn: Optional[Callable] = None,
    batch_linesearch: Optional[int] = None,
    fuse_linesearch_grad: bool = False,
) -> Tuple[JitMinimizeResult, Any]:
    """Compact L-BFGS threading an objective state through every evaluation
    — the functional form of the reference's stateful objectives
    (hysteresis / EMA bookkeeping).  ``value_fn(x, st) -> (f, st')`` runs at
    the linesearch trials, ``value_and_grad_fn(x, st) -> (f, g, st')`` at
    the accepted points; ``stop_fn(st) -> bool`` is an extra stop condition
    checked after each accepted step.  ``batch_linesearch=K`` evaluates the
    whole step grid (1, 1/2, ..., 2^-(K-1)) in one ``value_fn`` call and
    takes the largest passing step (the state then ticks once per
    linesearch); ``fuse_linesearch_grad`` evaluates value_and_grad on the
    grid and reuses the chosen point's gradient.  Returns
    ``(JitMinimizeResult, final objective state)``."""
    init, chunk, extract = lbfgs_chunk_programs(
        value_fn, value_and_grad_fn, maxiter=maxiter, fobj_thr=fobj_thr,
        no_improve_iters=no_improve_iters, memory_size=memory_size,
        max_backtracks=max_backtracks, c1=c1, stop_fn=stop_fn,
        batch_linesearch=batch_linesearch, fuse_linesearch_grad=fuse_linesearch_grad,
    )
    return extract(chunk(init(x0, obj_state0), maxiter))


def stateless(fun: Callable, value_and_grad_fn: Optional[Callable]):
    """``(value_fn, value_and_grad_fn)`` of a stateless objective in the
    stateful signatures; without ``value_and_grad_fn`` the gradient is
    ``torch.autograd``'s on ``fun``."""
    vgrad = autograd_value_and_grad(fun) if value_and_grad_fn is None else value_and_grad_fn
    return (lambda x, st: (fun(x), st)), (lambda x, st: vgrad(x) + (st,))


def minimize_lbfgs_compact(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    maxiter: int,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
    memory_size: int = 10,
    max_backtracks: int = 20,
    c1: float = 1e-4,
    value_and_grad_fn: Optional[Callable] = None,
    batch_linesearch: Optional[int] = None,
    fuse_linesearch_grad: bool = False,
) -> JitMinimizeResult:
    """Minimizes ``fun`` from ``x0`` with compact L-BFGS in one run of at
    most ``maxiter`` iterations.  ``value_and_grad_fn(x) -> (f, g)``
    supplies the gradient (e.g. the analytic MPS co-sweep); without it the
    gradient is ``torch.autograd``'s on ``fun``.  ``batch_linesearch`` and
    ``fuse_linesearch_grad`` as in :func:`minimize_lbfgs_compact_stateful`
    (``fun`` then takes a batch of K points: (K, P) -> (K,))."""
    value_fn, vgrad = stateless(fun, value_and_grad_fn)
    res, _ = minimize_lbfgs_compact_stateful(
        value_fn, vgrad, x0, (), maxiter=maxiter, fobj_thr=fobj_thr,
        no_improve_iters=no_improve_iters, memory_size=memory_size,
        max_backtracks=max_backtracks, c1=c1, batch_linesearch=batch_linesearch,
        fuse_linesearch_grad=fuse_linesearch_grad,
    )
    return res


def run_lbfgs_chunked(
    programs,
    x0: torch.Tensor,
    obj_state0=(),
    *,
    maxiter: int,
    time_limit: Optional[float] = None,
    chunk_iters: int = 25,
) -> Tuple[Any, Any, bool]:
    """Runs the loop of :func:`lbfgs_chunk_programs` (or of a fleet's
    :func:`lbfgs_fleet_programs`) ``chunk_iters`` iterations at a time and checks the wall clock between chunks (the reference's
    host-loop ``TimeoutChecker``).  Returns ``(result, obj_state,
    timed_out)``: ``timed_out`` when the clock stopped the run before
    ``maxiter``.  ``time_limit`` of None or <= 0 disables the clock, and the
    result is then the one-run result exactly."""
    if int(chunk_iters) < 1:
        raise ValueError(f"chunk_iters must be >= 1, got {chunk_iters}")
    init, chunk, extract = programs
    deadline = None if time_limit is None or time_limit <= 0 else time.perf_counter() + float(time_limit)
    carry = init(x0, obj_state0)
    timed_out = False
    while carry.it < maxiter:
        carry = chunk(carry, min(carry.it + int(chunk_iters), int(maxiter)))
        if carry.stop:
            break
        if deadline is not None and time.perf_counter() >= deadline:
            timed_out = carry.it < maxiter
            break
    res, ost = extract(carry)
    return res, ost, timed_out


# -----------------------------------------------------------------------------
# Lanes: the twin of jax.vmap over the compact loop (the one-lane loop above is
# its fleet of one lane).
# -----------------------------------------------------------------------------


def lane_objective(fun: Callable[[torch.Tensor], torch.Tensor]):
    """``(value, value_and_grad)`` over lanes from a one-lane scalar
    ``fun``: ``value(X (L, P)) -> f (L,)`` through ``torch.func.vmap`` (one
    batched pass, not a loop over lanes), ``value_and_grad(X) -> (f, G)``
    with G from one ``torch.autograd`` call on the sum of the lane values
    (lanes are independent, so row l of G is lane l's gradient)."""
    batched = torch.func.vmap(fun)

    def value(xs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return batched(xs)

    def value_and_grad(xs: torch.Tensor):
        with torch.enable_grad():
            xg = xs.detach().requires_grad_(True)
            f = batched(xg)
            (g,) = torch.autograd.grad(f.sum(), xg)
        return f.detach(), g

    return value, value_and_grad


def stateless_lanes(value: Callable, value_and_grad: Callable):
    """A stateless lane objective in the stateful signatures."""
    return (lambda xs, st: (value(xs), st)), (lambda xs, st: value_and_grad(xs) + (st,))


class FleetResult(NamedTuple):
    """The lanes' results (the JAX package's vmapped ``JitMinimizeResult``)."""

    thetas: torch.Tensor  # (L, P) best parameters per lane
    fobj: torch.Tensor  # (L,) best objective values
    num_iters: np.ndarray  # (L,) iterations each lane executed
    converged: np.ndarray  # (L,) a stop condition fired before the limit
    last_thetas: torch.Tensor  # (L, P) final iterates


@dataclasses.dataclass
class FleetCarry:
    """The loop state of a fleet of L lanes.  ``it_host`` and ``stop_host``
    are the host's copies (``stop_host`` as of the latest read of
    ``stop_mask``); ``it`` and ``stop`` summarize them the way the chunked
    runner reads a one-lane carry: the furthest lane, and all lanes
    stopped.  The histories hold each lane's stored pairs newest first;
    the entries past a lane's history are zero."""

    it_host: np.ndarray  # (L,) int64
    stop_host: np.ndarray  # (L,) bool
    stop_mask: torch.Tensor  # (L,) bool, on the device
    x: torch.Tensor
    f: torch.Tensor
    grad: torch.Tensor
    s_hist: torch.Tensor  # (L, m, P)
    y_hist: torch.Tensor
    rho_hist: torch.Tensor  # (L, m)
    best_f: torch.Tensor
    best_x: torch.Tensor
    since_best: torch.Tensor  # (L,) int64
    ost: Any = ()

    @property
    def it(self) -> int:
        return int(self.it_host.max(initial=0))

    @property
    def stop(self) -> bool:
        return bool(self.stop_host.all())


# The per-lane tensors of a FleetCarry, gathered for the running lanes.
_LANE_FIELDS = ("x", "f", "grad", "s_hist", "y_hist", "rho_hist", "best_f", "best_x", "since_best", "stop_mask")


def _read_mask(mask: torch.Tensor) -> np.ndarray:
    """One device->host read of a lane mask (a ``host.read`` span and the
    ``host_reads`` counter while spans are on)."""
    with span("host.read"):
        count("host_reads")
        return mask.cpu().numpy().astype(bool)


def _lane_index(lanes: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(lanes, dtype=torch.long, device=device)


def _push(hist: torch.Tensor, new: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """``new`` in front of each accepting lane's history, its oldest entry
    dropped; the other lanes' histories as they were."""
    pushed = torch.cat([new[:, None], hist[:, :-1]], 1)
    return torch.where(accept.reshape((-1,) + (1,) * (hist.dim() - 1)), pushed, hist)


def lbfgs_fleet_programs(
    value_fn: Callable,
    value_and_grad_fn: Callable,
    *,
    maxiter: int,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
    memory_size: int = 10,
    max_backtracks: int = 20,
    c1: float = 1e-4,
    batch_linesearch: Optional[int] = None,
    fuse_linesearch_grad: bool = False,
    stop_fn: Optional[Callable] = None,
):
    """The compact L-BFGS loop over L lanes as ``(init, chunk, extract)``:
    the twin of ``jax.vmap`` over ``lbfgs_chunk_programs``.

    ``value_fn(X, st) -> (f, st')`` and ``value_and_grad_fn(X, st) -> (f, G,
    st')`` take the rows of the lanes being evaluated (``X (La, P)``; the
    loop passes only the lanes still running, so ``st`` is shared by all
    lanes and must not hold per-lane rows).  ``init(X0 (L, P), st0=()) ->
    FleetCarry``, ``chunk(carry, limit) -> FleetCarry``, ``extract(carry)
    -> (FleetResult, st)``.

    Per iteration the running lanes take the two-loop direction, then one
    linesearch and one gradient phase, each a single batched evaluation:

    * ``batch_linesearch=None``: sequential Armijo backtracking in lock
      step; each backtracking step evaluates only the lanes whose test has
      not passed, after one read of the Armijo mask;
    * ``batch_linesearch=K``: the step grid (1, 1/2, ..., 2^-(K-1)) of
      every lane in ONE evaluation of L x K points; the largest passing step,
      else the smallest grid step;
    * ``fuse_linesearch_grad`` (with K): the grid's evaluation returns the
      gradients too, and the chosen point's gradient is the next iterate's
      (one evaluation phase per iteration).

    A lane stops on ``f < fobj_thr``, after more than ``no_improve_iters``
    non-improving iterations, on a failed linesearch, or at the limit; every
    running lane stops on ``stop_fn(st)`` (checked at the start point and
    after each iteration's accepted step).  While every lane runs, the loop
    works on the whole carry and gathers nothing."""
    m = int(memory_size)
    fobj_thr_v = float("-inf") if fobj_thr is None else float(fobj_thr)
    no_imp = maxiter + 1 if no_improve_iters is None else int(no_improve_iters)
    k_grid = None if batch_linesearch is None else int(batch_linesearch)
    if fuse_linesearch_grad and k_grid is None:
        raise ValueError("fuse_linesearch_grad needs batch_linesearch")

    def state_stop(stop: torch.Tensor, ost) -> torch.Tensor:
        return stop if stop_fn is None else stop | stop_fn(ost)

    def two_loop(grad, s_hist, y_hist, rho_hist, depth: int):
        """H . grad per lane with its stored pairs, newest first and then
        back, over the ``depth`` newest entries (no lane holds more).  A
        zero entry leaves q and r as they are, as the JAX loop's masks do."""
        ss, ys_, rhos = s_hist.unbind(1), y_hist.unbind(1), rho_hist[..., None].unbind(1)
        q = grad
        alphas = []
        for i in range(depth):
            alpha = rhos[i] * (ss[i] * q).sum(-1, keepdim=True)
            q = q - alpha * ys_[i]
            alphas.append(alpha)
        ys = (ss[0] * ys_[0]).sum(-1, keepdim=True)
        yy = (ys_[0] * ys_[0]).sum(-1, keepdim=True)
        gamma = torch.where(yy > 0, ys / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
        r = gamma * q
        for i in reversed(range(depth)):
            beta = rhos[i] * (ys_[i] * r).sum(-1, keepdim=True)
            r = r + (alphas[i] - beta) * ss[i]
        return r

    def backtrack(x, f, direction, slope, ost):
        """Lock-step Armijo backtracking: the lanes whose test failed halve
        their step and are evaluated again, together."""
        step = torch.ones_like(f)
        f_new, ost = value_fn(x + direction, ost)
        ok = f_new <= f + c1 * step * slope
        for _ in range(max_backtracks):
            retry = np.flatnonzero(~_read_mask(ok))
            if retry.size == 0:
                break
            if retry.size == f.shape[0]:
                step = step * 0.5
                f_new, ost = value_fn(x + step[:, None] * direction, ost)
                ok = f_new <= f + c1 * step * slope
                continue
            ib = _lane_index(retry, x.device)
            st = step[ib] * 0.5
            f_b, ost = value_fn(x[ib] + st[:, None] * direction[ib], ost)
            step[ib] = st
            f_new[ib] = f_b
            ok[ib] = f_b <= f[ib] + c1 * st * slope[ib]
        return step, f_new, ok, ost

    def grid(x, f, direction, slope, ost, with_grad: bool):
        """The whole step grid of every lane in one evaluation."""
        la, p = x.shape
        steps = 2.0 ** -torch.arange(k_grid, dtype=x.dtype, device=x.device)
        pts = (x[:, None, :] + steps[None, :, None] * direction[:, None, :]).reshape(la * k_grid, p)
        if with_grad:
            f_k, g_k, ost = value_and_grad_fn(pts, ost)
        else:
            f_k, ost = value_fn(pts, ost)
        f_k = f_k.reshape(la, k_grid)
        ok_vec = f_k <= f[:, None] + c1 * steps[None, :] * slope[:, None]
        any_ok = ok_vec.any(-1)
        # First (largest) passing step; if none passes, the smallest grid
        # step (never the rejected full step).
        idx = torch.where(any_ok, ok_vec.to(torch.uint8).argmax(-1), torch.full_like(any_ok, k_grid - 1, dtype=torch.long))
        rows = torch.arange(la, device=x.device)
        g_new = g_k.reshape(la, k_grid, p)[rows, idx] if with_grad else None
        if isinstance(ost, _TrialStates):  # one lane's grid: the accepted trial's state
            ost = ost[int(idx[0])]
        return steps[idx], f_k[rows, idx], g_new, any_ok, ost

    def init(x0: torch.Tensor, obj_state0=()) -> FleetCarry:
        with span("lbfgs.init"):
            x = x0.detach().clone()
            lanes, n = x.shape
            with torch.no_grad():
                f, grad, ost = value_and_grad_fn(x, obj_state0)
            stop = state_stop(f < fobj_thr_v, ost)
            return FleetCarry(
                it_host=np.zeros(lanes, np.int64), stop_host=_read_mask(stop), stop_mask=stop,
                x=x, f=f, grad=grad,
                s_hist=x.new_zeros((lanes, m, n)), y_hist=x.new_zeros((lanes, m, n)),
                rho_hist=x.new_zeros((lanes, m)), best_f=f.clone(), best_x=x.clone(),
                since_best=torch.zeros(lanes, dtype=torch.long, device=x.device), ost=ost,
            )

    def iterate(c: FleetCarry, act: np.ndarray) -> None:
        """One L-BFGS iteration of the lanes ``act`` (direction, line search,
        gradient at the accepted point, histories), in place."""
        whole = act.size == c.it_host.size
        ia = None if whole else _lane_index(act, c.x.device)
        x, f, grad, s_hist, y_hist, rho_hist, best_f, best_x, since_best, _ = (
            getattr(c, name) if whole else getattr(c, name)[ia] for name in _LANE_FIELDS)
        depth = min(m, int(c.it_host[act].max()))
        direction = -two_loop(grad, s_hist, y_hist, rho_hist, depth)
        # Fall back to steepest descent where the direction is not descent.
        descent = (grad * direction).sum(-1) < 0
        direction = torch.where(descent[:, None], direction, -grad)
        slope = (grad * direction).sum(-1)

        if k_grid is not None and fuse_linesearch_grad:
            with span("lbfgs.linesearch"):
                step, f_new, g_new, ok, ost = grid(x, f, direction, slope, c.ost, True)
            x_new = x + step[:, None] * direction
        else:
            with span("lbfgs.linesearch"):
                if k_grid is None:
                    step, f_new, ok, ost = backtrack(x, f, direction, slope, c.ost)
                else:
                    step, f_new, _, ok, ost = grid(x, f, direction, slope, c.ost, False)
            x_new = x + step[:, None] * direction
            with span("lbfgs.grad"):
                _, g_new, ost = value_and_grad_fn(x_new, ost)

        s = x_new - x
        y = g_new - grad
        sy = (s * y).sum(-1)
        accept = sy > 1e-10
        s_hist = _push(s_hist, s, accept)
        y_hist = _push(y_hist, y, accept)
        rho_hist = _push(rho_hist, 1.0 / torch.clamp(sy, min=1e-30), accept)

        improved = f_new < best_f
        best_f = torch.where(improved, f_new, best_f)
        best_x = torch.where(improved[:, None], x_new, best_x)
        since_best = torch.where(improved, torch.zeros_like(since_best), since_best + 1)
        stop = state_stop((f_new < fobj_thr_v) | (since_best > no_imp) | ~ok, ost)

        new = (x_new, f_new, g_new, s_hist, y_hist, rho_hist, best_f, best_x, since_best, stop)
        for name, val in zip(_LANE_FIELDS, new):
            if whole:
                setattr(c, name, val)
            else:
                getattr(c, name)[ia] = val
        c.ost = ost
        c.it_host[act] += 1

    @torch.no_grad()
    def chunk(c: FleetCarry, limit: int) -> FleetCarry:
        c.stop_host = _read_mask(c.stop_mask)
        while True:
            act = np.flatnonzero(~c.stop_host & (c.it_host < limit))
            if act.size == 0:
                return c
            # One pass over the running lanes; its span closes after the
            # stop-mask read that ends it, so its wall holds the device time
            # of the accepted point's gradient.  The counters give the
            # steps and the lanes each step ran.  The pass is an iteration
            # of every running lane: its span stands for the first lane's,
            # and each further lane's is an instant beside it, so that the
            # spans count lane iterations and hold the pass's wall once.
            with span("lbfgs.iteration"):
                count("fleet_steps")
                count("fleet_lanes", int(act.size))
                iterate(c, act)
                c.stop_host = _read_mask(c.stop_mask)
            for lane in act[1:]:
                instant("lbfgs.iteration", lane=int(lane))

    def extract(c: FleetCarry) -> Tuple[FleetResult, Any]:
        return FleetResult(c.best_x, c.best_f, c.it_host.copy(), c.stop_host.copy(), c.x), c.ost

    return init, chunk, extract


def minimize_lbfgs_compact_lanes(
    value: Callable,
    value_and_grad: Callable,
    x0: torch.Tensor,
    *,
    maxiter: int,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
    memory_size: int = 10,
    max_backtracks: int = 20,
    c1: float = 1e-4,
    batch_linesearch: Optional[int] = None,
    fuse_linesearch_grad: bool = False,
) -> FleetResult:
    """Compact L-BFGS from every row of ``x0 (L, P)`` at once over a
    stateless lane objective (``value(X) -> f``, ``value_and_grad(X) -> (f,
    G)``; :func:`lane_objective` makes one from a one-lane function): the
    twin of ``jax.vmap(minimize_lbfgs_compact)``."""
    init, chunk, extract = lbfgs_fleet_programs(
        *stateless_lanes(value, value_and_grad), maxiter=maxiter, fobj_thr=fobj_thr,
        no_improve_iters=no_improve_iters, memory_size=memory_size, max_backtracks=max_backtracks,
        c1=c1, batch_linesearch=batch_linesearch, fuse_linesearch_grad=fuse_linesearch_grad,
    )
    return extract(chunk(init(x0), maxiter))[0]


# -----------------------------------------------------------------------------
# optax's L-BFGS with the zoom linesearch (optax 0.2.6: scale_by_lbfgs,
# scale(-1) and scale_by_zoom_linesearch(max_linesearch_steps=20), whose
# initial guess is the previous step), on lanes.
# -----------------------------------------------------------------------------

_ZOOM_SLOPE_RTOL = 1e-4
_ZOOM_CURV_RTOL = 0.9
_ZOOM_APPROX_DEC_RTOL = 1e-6
_ZOOM_INTERVAL_THRESHOLD = 1e-5  # optax's stepsize_precision
_ZOOM_INCREASE = 2.0


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa, fpa), (b, fb) and (c, fc)
    (optax's ``_cubicmin``); NaN where it has none."""
    cc = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - cc * db
    v1 = fc - fa - cc * dc
    aa = (dc**2 * v0 + (-(db**2)) * v1) / denom
    bb = ((-(dc**3)) * v0 + db**3 * v1) / denom
    radical = bb * bb - 3.0 * aa * cc
    return a + (-bb + torch.sqrt(radical)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa, fpa) and (b, fb)."""
    db = b - a
    bb = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * bb)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _ZOOM_SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * _ZOOM_SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - _ZOOM_APPROX_DEC_RTOL * torch.abs(value_init)
    err = torch.minimum(torch.maximum(approx, delta_values), err)
    err = torch.clamp(err, min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)


def _curvature_error(slope, slope_init):
    err = torch.clamp(torch.abs(slope) - _ZOOM_CURV_RTOL * torch.abs(slope_init), min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)


def _pick(cond, new: dict, old: dict) -> dict:
    """Per lane: ``new`` where ``cond``, else ``old`` (vectors broadcast
    over the parameter axis)."""
    out = {}
    for key, a in new.items():
        cnd = cond if a.ndim == 1 else cond[:, None]
        out[key] = torch.where(cnd, a, old[key])
    return out


def _zoom_linesearch(value_and_grad, x, updates, value, grad, stepsize_guess, max_steps: int):
    """optax's zoom linesearch on the running lanes: every step evaluates
    the lanes whose search is not done at one stepsize each, in one
    batch.  Returns (stepsize, value, grad) per lane."""
    zero = torch.zeros_like(value)
    slope = (updates * grad).sum(-1)
    st = dict(
        stepsize=zero, value=value, grad=grad, slope=slope, decrease_error=torch.full_like(value, math.inf),
        interval_found=torch.zeros_like(value, dtype=torch.bool), done=torch.zeros_like(value, dtype=torch.bool),
        failed=torch.zeros_like(value, dtype=torch.bool), low=zero, value_low=value, slope_low=slope,
        high=zero, value_high=value, slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
        safe_stepsize=zero, safe_value=value, safe_grad=grad,
    )
    st = {key: val.clone() for key, val in st.items()}  # updated in place, lane by lane
    value_init, slope_init = value, slope
    for count in range(max_steps):
        running = np.flatnonzero(~_read_mask(st["done"] | st["failed"]))
        if running.size == 0:
            break
        ir = _lane_index(running, x.device)
        s = {k: v[ir] for k, v in st.items()}
        v_init, s_init, u = value_init[ir], slope_init[ir], updates[ir]

        # The step each lane tries: a larger one while the interval is not
        # bracketed yet, the interpolated middle once it is.
        new_step = stepsize_guess[ir] if count == 0 else _ZOOM_INCREASE * s["stepsize"]
        low, high = s["low"], s["high"]
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        too_small_int = delta <= _ZOOM_INTERVAL_THRESHOLD
        mid_c = _cubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"], s["cubic_ref"],
                          s["value_cubic_ref"])
        use_cubic = (mid_c > left + 0.2 * delta) & (mid_c < right - 0.2 * delta)
        mid_q = _quadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
        use_quad = ~use_cubic & (mid_q > left + 0.1 * delta) & (mid_q < right - 0.1 * delta)
        use_bis = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, mid_c, s["cubic_ref"])
        middle = torch.where(use_quad, mid_q, middle)
        middle = torch.where(use_bis, (low + high) / 2.0, middle)
        zoom = s["interval_found"]
        trial = torch.where(zoom, middle, new_step)

        f_t, g_t = value_and_grad(x[ir] + trial[:, None] * u)
        slope_t = (g_t * u).sum(-1)
        dec = _decrease_error(trial, f_t, slope_t, v_init, s_init)
        curv = _curvature_error(slope_t, s_init)
        err = torch.maximum(dec, curv)
        safe_dec = dec <= 0.0
        reached = count + 1 >= max_steps

        # Search-interval branch.
        srch = _pick(safe_dec, dict(safe_stepsize=trial, safe_value=f_t, safe_grad=g_t),
                     dict(safe_stepsize=s["safe_stepsize"], safe_value=s["safe_value"], safe_grad=s["safe_grad"]))
        hi_new = (dec > 0.0) | ((f_t >= s["value"]) & (count > 0))
        lo_new = (slope_t >= 0.0) & ~hi_new
        srch.update(_pick(
            lo_new,
            dict(low=trial, value_low=f_t, slope_low=slope_t, high=s["stepsize"], value_high=s["value"],
                 slope_high=s["slope"]),
            dict(low=s["stepsize"], value_low=s["value"], slope_low=s["slope"], high=trial, value_high=f_t,
                 slope_high=slope_t),
        ))
        srch["cubic_ref"], srch["value_cubic_ref"] = srch["low"], srch["value_low"]
        srch["interval_found"] = hi_new | lo_new | (err <= 0.0)
        srch["done"] = err <= 0.0
        srch["failed"] = torch.full_like(safe_dec, reached) & ~srch["done"]

        # Zoom branch.
        upd_safe = safe_dec & (f_t < s["safe_value"])
        zm = _pick(upd_safe, dict(safe_stepsize=trial, safe_value=f_t, safe_grad=g_t),
                   dict(safe_stepsize=s["safe_stepsize"], safe_value=s["safe_value"], safe_grad=s["safe_grad"]))
        hi_mid = (dec > 0.0) | (f_t >= s["value_low"])
        hi_low = (slope_t * (high - low) >= 0.0) & ~hi_mid
        hi = _pick(hi_mid, dict(high=trial, value_high=f_t, slope_high=slope_t),
                   dict(high=high, value_high=s["value_high"], slope_high=s["slope_high"]))
        zm.update(_pick(hi_low, dict(high=low, value_high=s["value_low"], slope_high=s["slope_low"]), hi))
        zm.update(_pick(~hi_mid, dict(low=trial, value_low=f_t, slope_low=slope_t),
                        dict(low=low, value_low=s["value_low"], slope_low=s["slope_low"])))
        zm.update(_pick(hi_mid | hi_low, dict(cubic_ref=high, value_cubic_ref=s["value_high"]),
                        dict(cubic_ref=low, value_cubic_ref=s["value_low"])))
        zm["interval_found"] = s["interval_found"]
        zm["done"] = err <= 0.0
        zm["failed"] = (torch.full_like(safe_dec, reached) | (too_small_int & (zm["safe_stepsize"] > 0.0))) & ~zm["done"]

        common = dict(stepsize=trial, value=f_t, grad=g_t, slope=slope_t, decrease_error=dec)
        new = _pick(zoom, {**common, **zm}, {**common, **srch})
        # A failed search returns its safe step where it has one (or where
        # the trial left the domain).
        use_safe = new["failed"] & ((new["safe_stepsize"] > 0.0) | torch.isinf(new["decrease_error"]))
        new.update(_pick(use_safe, dict(stepsize=new["safe_stepsize"], value=new["safe_value"],
                                        grad=new["safe_grad"]),
                         dict(stepsize=new["stepsize"], value=new["value"], grad=new["grad"])))
        for key, val in new.items():
            st[key][ir] = val
    return st["stepsize"], st["value"], st["grad"]


def minimize_lbfgs_lanes(
    value_and_grad: Callable,
    x0: torch.Tensor,
    *,
    maxiter: int,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
    grad_tol: float = 0.0,
    memory_size: int = 10,
    max_linesearch_steps: int = 20,
) -> FleetResult:
    """optax's L-BFGS with the zoom linesearch from every row of ``x0 (L,
    P)`` (the twin of ``jax.vmap(minimize_lbfgs)``): ``value_and_grad(X) ->
    (f (L,), G (L, P))``.  Each lane stops on ``f < fobj_thr``, after more
    than ``no_improve_iters`` non-improving iterations, once ``max|grad| <=
    grad_tol`` (0 disables), or at ``maxiter``."""
    m = int(memory_size)
    fobj_thr_v = float("-inf") if fobj_thr is None else float(fobj_thr)
    no_imp = maxiter + 1 if no_improve_iters is None else int(no_improve_iters)
    x = x0.detach().clone()
    lanes, n = x.shape
    with torch.no_grad():
        f, grad = value_and_grad(x)
    long = dict(dtype=torch.long, device=x.device)
    dw, du = x.new_zeros((lanes, m, n)), x.new_zeros((lanes, m, n))
    rho = x.new_zeros((lanes, m))
    prev_x, prev_g = torch.zeros_like(x), torch.zeros_like(x)
    lr = torch.ones_like(f)
    best_f, best_x, since_best = f.clone(), x.clone(), torch.zeros(lanes, **long)
    stop = torch.zeros(lanes, dtype=torch.bool, device=x.device)
    it_host = np.zeros(lanes, np.int64)
    stop_host = np.zeros(lanes, bool)
    with torch.no_grad():
        for it in range(int(maxiter)):
            stop_host = _read_mask(stop)
            act = np.flatnonzero(~stop_host)
            if act.size == 0:
                break
            ia = _lane_index(act, x.device)
            xa, fa, ga = x[ia], f[ia], grad[ia]
            # scale_by_lbfgs: store the newest pair, then precondition.
            mem_idx, prev_idx = it % m, (it - 1) % m
            dwa, dua, rhoa = dw[ia], du[ia], rho[ia]
            if it > 0:
                dp, dg = xa - prev_x[ia], ga - prev_g[ia]
                vd = (dg * dp).sum(-1)
                dwa[:, prev_idx], dua[:, prev_idx] = dp, dg
                rhoa[:, prev_idx] = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
                den = (dg * dg).sum(-1)
                gamma = torch.where(den > 0.0, vd / den, torch.ones_like(vd))
            else:
                gamma = torch.clamp(1.0 / torch.sqrt((ga * ga).sum(-1)), max=1.0)
            order = [(mem_idx + j) % m for j in range(m)]
            vec, alphas = ga, {}
            for idx in reversed(order):
                alphas[idx] = rhoa[:, idx] * (dwa[:, idx] * vec).sum(-1)
                vec = vec + (-alphas[idx])[:, None] * dua[:, idx]
            vec = gamma[:, None] * vec
            for idx in order:
                beta = rhoa[:, idx] * (dua[:, idx] * vec).sum(-1)
                vec = vec + (alphas[idx] - beta)[:, None] * dwa[:, idx]
            updates = -1.0 * vec
            step, f_new, g_new = _zoom_linesearch(value_and_grad, xa, updates, fa, ga, lr[ia], max_linesearch_steps)
            x_new = xa + step[:, None] * updates

            improved = f_new < best_f[ia]
            sb = torch.where(improved, torch.zeros_like(since_best[ia]), since_best[ia] + 1)
            stp = (f_new < fobj_thr_v) | (sb > no_imp)
            if grad_tol > 0:
                stp = stp | (ga.abs().amax(-1) <= grad_tol)
            best_f[ia] = torch.where(improved, f_new, best_f[ia])
            best_x[ia] = torch.where(improved[:, None], x_new, best_x[ia])
            since_best[ia] = sb
            dw[ia], du[ia], rho[ia] = dwa, dua, rhoa
            prev_x[ia], prev_g[ia] = xa, ga
            x[ia], f[ia], grad[ia], lr[ia], stop[ia] = x_new, f_new, g_new, step, stp
            it_host[act] += 1
        stop_host = _read_mask(stop)
    return FleetResult(best_x, best_f, it_host, stop_host, x)


def minimize_lbfgs(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    maxiter: int,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
    grad_tol: float = 0.0,
    memory_size: int = 10,
) -> JitMinimizeResult:
    """Minimizes a scalar function with optax's L-BFGS and its zoom
    linesearch (20 steps at most), the gradient from ``torch.autograd``:
    the twin of the JAX ``minimize_lbfgs``.  ``fobj_thr``,
    ``no_improve_iters`` and ``grad_tol`` stop it as there."""
    res = minimize_lbfgs_lanes(
        lane_objective(fun)[1], x0[None], maxiter=maxiter, fobj_thr=fobj_thr,
        no_improve_iters=no_improve_iters, grad_tol=grad_tol, memory_size=memory_size,
    )
    return JitMinimizeResult(res.thetas[0], res.fobj[0], int(res.num_iters[0]), bool(res.converged[0]),
                             res.last_thetas[0])


# optax.adam's defaults: moment decays, and eps added after the square root.
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def minimize_adam_lanes(
    value_and_grad: Callable,
    x0: torch.Tensor,
    *,
    maxiter: int,
    learn_rate: float = 0.1,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
) -> FleetResult:
    """optax's ``adam(learn_rate)`` from every row of ``x0 (L, P)`` (the twin
    of ``jax.vmap(minimize_adam)``), one batched ``value_and_grad(X)`` per
    iteration over the running lanes.  As in the JAX loop, the best value is
    the one evaluated at an iteration's start and its θ the iterate that
    iteration produces."""
    fobj_thr_v = float("-inf") if fobj_thr is None else float(fobj_thr)
    no_imp = maxiter + 1 if no_improve_iters is None else int(no_improve_iters)
    x = x0.detach().clone()
    lanes = x.shape[0]
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    best_f = torch.full((lanes,), math.inf, dtype=x.dtype, device=x.device)
    best_x = x.clone()
    since_best = torch.zeros(lanes, dtype=torch.long, device=x.device)
    stop = torch.zeros(lanes, dtype=torch.bool, device=x.device)
    it_host = np.zeros(lanes, np.int64)
    with torch.no_grad():
        for t in range(1, int(maxiter) + 1):
            act = np.flatnonzero(~_read_mask(stop))
            if act.size == 0:
                break
            ia = _lane_index(act, x.device)
            xa = x[ia]
            value, grad = value_and_grad(xa)
            mu_a = (1.0 - _ADAM_B1) * grad + _ADAM_B1 * mu[ia]
            nu_a = (1.0 - _ADAM_B2) * (grad * grad) + _ADAM_B2 * nu[ia]
            mu_hat = mu_a / (1.0 - _ADAM_B1**t)
            nu_hat = nu_a / (1.0 - _ADAM_B2**t)
            x_new = xa + (-learn_rate) * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS))
            improved = value < best_f[ia]
            sb = torch.where(improved, torch.zeros_like(since_best[ia]), since_best[ia] + 1)
            best_f[ia] = torch.where(improved, value, best_f[ia])
            best_x[ia] = torch.where(improved[:, None], x_new, best_x[ia])
            since_best[ia] = sb
            stop[ia] = (value < fobj_thr_v) | (sb > no_imp)
            x[ia], mu[ia], nu[ia] = x_new, mu_a, nu_a
            it_host[act] += 1
    return FleetResult(best_x, best_f, it_host, _read_mask(stop), x)


def minimize_adam(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    maxiter: int,
    learn_rate: float = 0.1,
    fobj_thr: Optional[float] = None,
    no_improve_iters: Optional[int] = None,
) -> JitMinimizeResult:
    """Adam (optax's rule) on a scalar function with the gradient from
    ``torch.autograd`` and the JAX loop's stop conditions."""
    res = minimize_adam_lanes(
        lane_objective(fun)[1], x0[None], maxiter=maxiter, learn_rate=learn_rate,
        fobj_thr=fobj_thr, no_improve_iters=no_improve_iters,
    )
    return JitMinimizeResult(res.thetas[0], res.fobj[0], int(res.num_iters[0]), bool(res.converged[0]),
                             res.last_thetas[0])
