"""Compact L-BFGS: two-loop recursion + sequential Armijo backtracking (twin
of ``minimize_lbfgs_compact``, ``minimize_lbfgs_compact_stateful`` over
``_compact_lbfgs_machinery``, and of the time-limited
``lbfgs_chunk_programs`` / ``run_lbfgs_chunked``, in
``aqc_research_tpu/optim/lbfgs.py``).

PyTorch has no device-side while loop, so the loop runs on the host; the
iterate, the gradient and the (s, y) history stay on the parameters'
device, and each iteration reads back the few scalars the control flow
needs (the Armijo test and the stop flags).  Stopping rules, the best-so-far
carry and ``num_iters`` are those of the JAX loop.  The loop's state is an
:class:`LbfgsCarry`, so a run may stop after any iteration count and go on
from there: the chunked runner checks the wall clock between chunks.

The objective may carry a state (the surrogate's hysteresis and weight EMA):
``value_fn(x, st) -> (f, st')`` at every linesearch trial,
``value_and_grad_fn(x, st) -> (f, g, st')`` at every accepted point, the
state riding in the carry.  A stateless objective carries ``()``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


class JitMinimizeResult(NamedTuple):
    """Same fields as the JAX result (the name keeps the twin findable)."""

    thetas: torch.Tensor  # best parameters found
    fobj: torch.Tensor  # best objective value
    num_iters: int  # iterations actually executed
    converged: bool  # True if a stop condition fired before maxiter
    last_thetas: torch.Tensor  # final iterate (not necessarily the best)


@dataclasses.dataclass
class LbfgsCarry:
    """The loop state carried from one chunk of iterations to the next."""

    it: int
    stop: bool
    x: torch.Tensor
    f: torch.Tensor
    grad: torch.Tensor
    s_hist: torch.Tensor
    y_hist: torch.Tensor
    rho_hist: torch.Tensor
    hist_len: int
    best_f: torch.Tensor
    best_x: torch.Tensor
    since_best: int
    ost: Any = ()  # the objective's state after the latest evaluation


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
):
    """The compact L-BFGS loop as ``(init, chunk, extract)``:
    ``init(x0, obj_state0=()) -> LbfgsCarry`` evaluates the start point,
    ``chunk(carry, limit) -> LbfgsCarry`` iterates until ``carry.it >=
    limit`` or a stop condition fires, ``extract(carry) ->
    (JitMinimizeResult, obj_state)``.  The JAX twin compiles the three into
    programs and threads the objective's data through them; here they are
    closures.

    ``value_fn(x, st) -> (f, st')`` is called at every linesearch trial,
    ``value_and_grad_fn(x, st) -> (f, g, st')`` at the start point and
    every accepted point.  The loop stops on ``f < fobj_thr``, after more
    than ``no_improve_iters`` non-improving iterations, on a failed
    linesearch, on ``stop_fn(st)`` (checked after each accepted step and at
    the start point), or at the limit."""
    m = int(memory_size)
    fobj_thr_v = float("-inf") if fobj_thr is None else float(fobj_thr)
    no_imp = maxiter + 1 if no_improve_iters is None else int(no_improve_iters)

    def two_loop(c: LbfgsCarry, grad):
        """H . grad with the stored (s, y) pairs (newest first, then back)."""
        q = grad
        alphas = [0.0] * m
        for i in range(min(c.hist_len, m)):
            idx = (c.hist_len - 1 - i) % m
            alpha = c.rho_hist[idx] * torch.dot(c.s_hist[idx], q)
            q = q - alpha * c.y_hist[idx]
            alphas[idx] = alpha
        newest = (c.hist_len - 1) % m
        ys = torch.dot(c.s_hist[newest], c.y_hist[newest])
        yy = torch.dot(c.y_hist[newest], c.y_hist[newest])
        if c.hist_len > 0:
            gamma = torch.where(yy > 0, ys / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
        else:
            gamma = torch.ones_like(yy)
        r = gamma * q
        for i in range(m - min(c.hist_len, m), m):
            idx = (c.hist_len - m + i) % m
            beta = c.rho_hist[idx] * torch.dot(c.y_hist[idx], r)
            r = r + (alphas[idx] - beta) * c.s_hist[idx]
        return r

    def backtrack(x, f, grad, direction, ost):
        """Armijo backtracking along a descent ``direction``."""
        slope = torch.dot(grad, direction)
        step = 1.0
        f_new, ost = value_fn(x + step * direction, ost)
        ok = bool(f_new <= f + c1 * step * slope)
        tries = 0
        while not ok and tries < max_backtracks:
            step *= 0.5
            f_new, ost = value_fn(x + step * direction, ost)
            ok = bool(f_new <= f + c1 * step * slope)
            tries += 1
        return step, f_new, ok, ost

    def init(x0: torch.Tensor, obj_state0=()) -> LbfgsCarry:
        x = x0.detach().clone()
        n = x.shape[0]
        with torch.no_grad():
            f, grad, ost = value_and_grad_fn(x, obj_state0)
        stop = bool(f < fobj_thr_v) or (stop_fn is not None and bool(stop_fn(ost)))
        return LbfgsCarry(
            it=0, stop=stop, x=x, f=f, grad=grad,
            s_hist=x.new_zeros((m, n)), y_hist=x.new_zeros((m, n)), rho_hist=x.new_zeros((m,)),
            hist_len=0, best_f=f, best_x=x, since_best=0, ost=ost,
        )

    @torch.no_grad()
    def chunk(c: LbfgsCarry, limit: int) -> LbfgsCarry:
        while c.it < limit and not c.stop:
            direction = -two_loop(c, c.grad)
            # Fall back to steepest descent when the direction is not descent.
            if not bool(torch.dot(c.grad, direction) < 0):
                direction = -c.grad
            step, f_new, ok, ost = backtrack(c.x, c.f, c.grad, direction, c.ost)
            x_new = c.x + step * direction
            _, g_new, ost = value_and_grad_fn(x_new, ost)

            s = x_new - c.x
            y = g_new - c.grad
            sy = torch.dot(s, y)
            if bool(sy > 1e-10):
                slot = c.hist_len % m
                c.s_hist[slot] = s
                c.y_hist[slot] = y
                c.rho_hist[slot] = 1.0 / torch.clamp(sy, min=1e-30)
                c.hist_len += 1

            if bool(f_new < c.best_f):
                c.best_f, c.best_x, c.since_best = f_new, x_new, 0
            else:
                c.since_best += 1
            c.stop = bool(f_new < fobj_thr_v) or c.since_best > no_imp or not ok
            if stop_fn is not None:
                c.stop = c.stop or bool(stop_fn(ost))
            c.x, c.f, c.grad, c.ost = x_new, f_new, g_new, ost
            c.it += 1
        return c

    def extract(c: LbfgsCarry) -> Tuple[JitMinimizeResult, Any]:
        return JitMinimizeResult(c.best_x, c.best_f, c.it, c.stop, c.x), c.ost

    return init, chunk, extract


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
) -> Tuple[JitMinimizeResult, Any]:
    """Compact L-BFGS threading an objective state through every evaluation
    — the functional form of the reference's stateful objectives
    (hysteresis / EMA bookkeeping).  ``value_fn(x, st) -> (f, st')`` runs at
    the linesearch trials, ``value_and_grad_fn(x, st) -> (f, g, st')`` at
    the accepted points; ``stop_fn(st) -> bool`` is an extra stop condition
    checked after each accepted step.  Returns ``(JitMinimizeResult, final
    objective state)``."""
    init, chunk, extract = lbfgs_chunk_programs(
        value_fn, value_and_grad_fn, maxiter=maxiter, fobj_thr=fobj_thr,
        no_improve_iters=no_improve_iters, memory_size=memory_size,
        max_backtracks=max_backtracks, c1=c1, stop_fn=stop_fn,
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
) -> JitMinimizeResult:
    """Minimizes ``fun`` from ``x0`` with compact L-BFGS in one run of at
    most ``maxiter`` iterations.  ``value_and_grad_fn(x) -> (f, g)``
    supplies the gradient (e.g. the analytic MPS co-sweep); without it the
    gradient is ``torch.autograd``'s on ``fun``."""
    value_fn, vgrad = stateless(fun, value_and_grad_fn)
    res, _ = minimize_lbfgs_compact_stateful(
        value_fn, vgrad, x0, (), maxiter=maxiter, fobj_thr=fobj_thr,
        no_improve_iters=no_improve_iters, memory_size=memory_size,
        max_backtracks=max_backtracks, c1=c1,
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
) -> Tuple[JitMinimizeResult, Any, bool]:
    """Runs :func:`lbfgs_chunk_programs`' loop ``chunk_iters`` iterations at
    a time and checks the wall clock between chunks (the reference's
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
