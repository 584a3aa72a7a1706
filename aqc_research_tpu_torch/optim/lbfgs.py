"""Compact L-BFGS: two-loop recursion + sequential Armijo backtracking (twin
of ``minimize_lbfgs_compact`` over ``_compact_lbfgs_machinery`` in
``aqc_research_tpu/optim/lbfgs.py``).

PyTorch has no device-side while loop, so the loop runs on the host; the
iterate, the gradient and the (s, y) history stay on the parameters'
device, and each iteration reads back the few scalars the control flow
needs (the Armijo test and the stop flags).  Stopping rules, the best-so-far
carry and ``num_iters`` are those of the JAX loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class JitMinimizeResult(NamedTuple):
    """Same fields as the JAX result (the name keeps the twin findable)."""

    thetas: torch.Tensor  # best parameters found
    fobj: torch.Tensor  # best objective value
    num_iters: int  # iterations actually executed
    converged: bool  # True if a stop condition fired before maxiter
    last_thetas: torch.Tensor  # final iterate (not necessarily the best)


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
    """Minimizes ``fun`` from ``x0`` with compact L-BFGS.

    ``value_and_grad_fn(x) -> (f, g)`` supplies the gradient (the analytic
    MPS co-sweep); it is required — this port has no autodiff fallback.
    Stops on ``f < fobj_thr``, after more than ``no_improve_iters``
    non-improving iterations, on a failed linesearch, or at ``maxiter``."""
    if value_and_grad_fn is None:
        raise ValueError("minimize_lbfgs_compact needs value_and_grad_fn")
    m = int(memory_size)
    fobj_thr_v = float("-inf") if fobj_thr is None else float(fobj_thr)
    no_imp = maxiter + 1 if no_improve_iters is None else int(no_improve_iters)

    x = x0.clone()
    n = x.shape[0]
    s_hist = x.new_zeros((m, n))
    y_hist = x.new_zeros((m, n))
    rho_hist = x.new_zeros((m,))
    hist_len = 0

    def two_loop(grad):
        """H . grad with the stored (s, y) pairs (newest first, then back)."""
        q = grad
        alphas = [0.0] * m
        for i in range(min(hist_len, m)):
            idx = (hist_len - 1 - i) % m
            alpha = rho_hist[idx] * torch.dot(s_hist[idx], q)
            q = q - alpha * y_hist[idx]
            alphas[idx] = alpha
        newest = (hist_len - 1) % m
        ys = torch.dot(s_hist[newest], y_hist[newest])
        yy = torch.dot(y_hist[newest], y_hist[newest])
        if hist_len > 0:
            gamma = torch.where(yy > 0, ys / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
        else:
            gamma = torch.ones_like(yy)
        r = gamma * q
        for i in range(m - min(hist_len, m), m):
            idx = (hist_len - m + i) % m
            beta = rho_hist[idx] * torch.dot(y_hist[idx], r)
            r = r + (alphas[idx] - beta) * s_hist[idx]
        return r

    def backtrack(x, f, grad, direction):
        """Armijo backtracking along a descent ``direction``."""
        slope = torch.dot(grad, direction)
        step = 1.0
        f_new = fun(x + step * direction)
        ok = bool(f_new <= f + c1 * step * slope)
        tries = 0
        while not ok and tries < max_backtracks:
            step *= 0.5
            f_new = fun(x + step * direction)
            ok = bool(f_new <= f + c1 * step * slope)
            tries += 1
        return step, f_new, ok

    f, grad = value_and_grad_fn(x)
    best_f, best_x = f, x
    since_best = 0
    stop = bool(f < fobj_thr_v)
    it = 0
    while it < maxiter and not stop:
        direction = -two_loop(grad)
        # Fall back to steepest descent when the direction is not descent.
        if not bool(torch.dot(grad, direction) < 0):
            direction = -grad
        step, f_new, ok = backtrack(x, f, grad, direction)
        x_new = x + step * direction
        _, g_new = value_and_grad_fn(x_new)

        s = x_new - x
        y = g_new - grad
        sy = torch.dot(s, y)
        if bool(sy > 1e-10):
            slot = hist_len % m
            s_hist[slot] = s
            y_hist[slot] = y
            rho_hist[slot] = 1.0 / torch.clamp(sy, min=1e-30)
            hist_len += 1

        if bool(f_new < best_f):
            best_f, best_x, since_best = f_new, x_new, 0
        else:
            since_best += 1
        stop = bool(f_new < fobj_thr_v) or since_best > no_imp or not ok
        x, f, grad = x_new, f_new, g_new
        it += 1
    return JitMinimizeResult(best_x, best_f, it, stop, x)
