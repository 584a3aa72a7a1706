"""ASP horizon optimization (twin of
``aqc_research_tpu/models/sp_lhs/jit_asp.py``): one horizon is a compact
L-BFGS (optim/lbfgs.py) over a surrogate objective, on the tensors' device.
The ``_jit`` names keep the JAX twins findable; the loops run on the host.
The MPS horizons, one lane and the fleet, evaluate through device
programs, the JAX package's jitted ``_mps_value_program`` and
``_mps_chunk_cache``: on CUDA each value and obj+grad is the replay of a
CUDA graph captured at its first call, cached per (circuit, base bits,
trunc_thr, route, shapes, policy) and pinned to its route
(ops/cuda_graphs.py); on the CPU they are the eager functions.

* **Dense** (full state vectors): :func:`make_surrogate_loss` is the
  stateless max-projection surrogate (fixed weight, hard argmax), optimized
  by :func:`optimize_horizon_jit` with the ``torch.autograd`` gradient —
  the flagship of ``bench.py``; :func:`make_surrogate_stateful` carries
  the reference's 1.1x max-projection hysteresis and the weight EMA
  ``w += 0.1 (sqrt|fobj| - w)`` through the loop with the analytic
  co-sweep gradient, optimized by :func:`optimize_horizon_surrogate_jit`
  (the ASP driver's ``sur_max`` objective).
* **MPS**: the fidelity objective ``1 - |<V lvec | target>|^2`` and its
  analytic co-sweep gradient; ``lvec`` is the X-layer product prep (e.g.
  the Neel state) given as ``base_bits``
  (:func:`optimize_horizon_mps_jit`, with the collapse watchdog).

The ``_timed`` runners run the same loops in chunks and check the wall
clock between them.  The ``_multistart`` runners run L starts as one fleet
(optim/lbfgs.py's lanes): the dense one through ``torch.func.vmap`` over
the one-lane loss, the MPS one with the lanes folded into the batch of
every pair update, through the same device programs as one lane (a graph
per running-lane count) and with the collapse watchdog per lane.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...circuit.ansatz import Ansatz
from ...config import mps_watchdog_enabled, svd_impl, svd_impl_override, trace_policy
from ...ops.mps import (
    MPS,
    mps_basis_state,
    mps_dot,
    mps_flip_amplitudes,
    v_dagger_layer_cache_eligible,
    v_dagger_mul_mps,
    v_dagger_mul_mps_layers,
    v_mul_mps_growing,
)
from ...ops.cuda_graphs import ProgramCache
from ...ops.gradients import grad_of_dot_product
from ...ops.mps_gradient import _layered_eligible  # noqa: F401  (read as jit_asp._layered_eligible)
from ...ops.mps_gradient import _check_grow_w_contract, fast_dot_gradient, fast_dot_gradient_with_state
from ...ops.statevector import as_state, as_thetas, v_dagger_mul_vec
from ...optim.lbfgs import (
    lane_objective,
    lbfgs_chunk_programs,
    lbfgs_fleet_programs,
    minimize_lbfgs,
    minimize_lbfgs_compact,
    minimize_lbfgs_compact_lanes,
    minimize_lbfgs_lanes,
    run_lbfgs_chunked,
)
from ...utils.profiling import count, request, span


class JitHorizonResult(NamedTuple):
    thetas: torch.Tensor
    fobj: torch.Tensor  # best (lowest) objective value
    fidelity: torch.Tensor  # dense: hs2[0] at the best thetas; MPS: 1 - fobj
    num_iters: int
    converged: bool


# -----------------------------------------------------------------------------
# Dense surrogate objectives.
# -----------------------------------------------------------------------------


def flip_state_indices(num_qubits: int, state_prep_program=None) -> np.ndarray:
    """Dense-basis indices of {S|0>, S X_i|0>} when S is an X-layer product
    program (identity / Neel / half-zero preps)."""
    base = 0
    if state_prep_program is not None:
        for gate in state_prep_program:
            if gate.name != "x":
                raise ValueError("flip_state_indices expects an X-layer product prep")
            base ^= 1 << gate.qubits[0]
    return np.asarray([base] + [base ^ (1 << k) for k in range(num_qubits)])


def make_surrogate_loss(
    circ: Ansatz,
    state_idx: Sequence[int],
    weight: float = 0.0,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns ``loss(thetas, target)`` = the max-projection surrogate
    ``1 - (1-w)·hs2[0] - w·max_i hs2[i]``, differentiable in ``thetas``."""
    idx = [int(i) for i in np.asarray(state_idx)]
    w = float(weight)

    def loss(thetas, target):
        vh = v_dagger_mul_vec(circ, thetas, target)
        if w == 0.0:
            return 1.0 - vh[idx[0]].abs() ** 2
        hs2 = vh[torch.as_tensor(idx, device=vh.device)].abs() ** 2
        return 1.0 - (1.0 - w) * hs2[0] - w * hs2.max()

    return loss


class SurrogateState(NamedTuple):
    """The reference ``sur_max`` objective's state: the hysteresis-selected
    leading flip state (a host int: the host branches on it) and, on the
    device, the EMA weight and the latest evaluation's hs2[0] and fobj."""

    max_no: int  # leading flip-state index
    weight: torch.Tensor  # EMA weight of the max-projection term
    fidelity: torch.Tensor  # hs2[0] at the latest evaluation
    fobj: torch.Tensor  # fobj at the latest evaluation


def make_surrogate_stateful(
    circ: Ansatz,
    state_idx: Sequence[int],
    gamma: float = 0.1,
):
    """The reference's stateful ``sur_max`` objective as functions: returns
    ``(value, value_and_grad)`` with signatures

        value(thetas, state, target)          -> (fobj, state')
        value_and_grad(thetas, state, target) -> (fobj, grad, state')

    * every evaluation applies the 1.1x max-projection hysteresis over the
      flip states, in order, and ticks the weight EMA ``w += gamma
      (sqrt|fobj| - w)`` — under SciPy L-BFGS-B the reference's objective
      and gradient are always called as a pair, so both state updates fire
      at every evaluation point, linesearch trials included;
    * ``value_and_grad`` adds the analytic co-sweep gradient.  The
      gradient of ``<x | V† t>`` is antilinear in x, so the two terms
      ``-2 Re[(1-w) conj(hs[0]) ∇<e_0|V†t> + w conj(hs[m]) ∇<e_m|V†t>]``
      (just ``-2 Re[conj(hs[0]) ∇<e_0|V†t>]`` when m = 0) take one sweep
      from x = (1-w) hs[0] e_0 + w hs[m] e_m, where the JAX twin runs one
      sweep per term.

    The hysteresis runs on the host over hs2, read back once per evaluation
    (the JAX twin's ``fori_loop`` and ``lax.cond`` become host code), in
    hs2's own precision; ``state_idx`` are the dense-basis indices of the
    flip states (:func:`flip_state_indices`)."""
    idx = [int(i) for i in np.asarray(state_idx)]

    def _project(thetas, target, st: SurrogateState):
        vh = v_dagger_mul_vec(circ, thetas, target)
        hs = vh[torch.as_tensor(idx, device=vh.device)]
        hs2 = hs.abs() ** 2
        h = hs2.cpu().numpy()
        ratio = h.dtype.type(1.1)
        max_no, max_proj = st.max_no, h[st.max_no]
        for i in range(len(idx)):
            if ratio * max_proj < h[i]:
                max_proj, max_no = h[i], i
        w = st.weight
        fobj = (1.0 - (1.0 - w) * hs2[0] - w * hs2[max_no]).to(thetas.dtype)
        return vh, hs, hs2, max_no, fobj

    def _next_state(st, max_no, hs2, fobj, dtype):
        w_new = st.weight + gamma * (torch.sqrt(fobj.abs()) - st.weight)
        return SurrogateState(max_no, w_new, hs2[0].to(dtype), fobj)

    def value(thetas, st, target):
        _, _, hs2, max_no, fobj = _project(thetas, target, st)
        return fobj, _next_state(st, max_no, hs2, fobj, thetas.dtype)

    def value_and_grad(thetas, st, target):
        vh, hs, hs2, max_no, fobj = _project(thetas, target, st)
        x = torch.zeros_like(vh)
        if max_no == 0:
            x[idx[0]] = hs[0]
        else:
            w = st.weight.to(hs2.dtype)
            x[idx[0]] = (1.0 - w) * hs[0]
            x[idx[max_no]] = w * hs[max_no]
        grad = -2.0 * grad_of_dot_product(circ, thetas, x, vh, front_layer=True).real
        return fobj, grad.to(thetas.dtype), _next_state(st, max_no, hs2, fobj, thetas.dtype)

    return value, value_and_grad


def _fidelity_readout(circ: Ansatz, idx0: int, thetas: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``|<idx0| V(thetas)† |target>|^2``."""
    with torch.no_grad():
        return v_dagger_mul_vec(circ, thetas, target)[idx0].abs() ** 2


def _dense_inputs(thetas0, target):
    target = as_state(target)
    return as_thetas(thetas0, target).detach().to(target.device), target


def optimize_horizon_jit(
    circ: Ansatz,
    thetas0,
    target,
    *,
    state_idx: Sequence[int],
    weight: float = 0.0,
    fidelity_thr: Optional[float] = None,
    maxiter: int = 100,
    no_improve_iters: Optional[int] = None,
    solver: str = "compact",
) -> JitHorizonResult:
    """Optimizes one ASP horizon over the stateless dense surrogate
    (:func:`make_surrogate_loss`) with the ``torch.autograd`` gradient
    through the statevector engine, on the target's device (the JAX twin's
    ``jax.value_and_grad``).

    ``fidelity_thr`` maps to the loss threshold ``1 - fidelity_thr`` (exact
    for ``weight == 0``, approximate otherwise).  ``solver``: "compact"
    (two-loop L-BFGS + Armijo backtracking) or "zoom" (optax's L-BFGS with
    its zoom linesearch, optim/lbfgs.minimize_lbfgs)."""
    if solver not in ("compact", "zoom"):
        raise ValueError(f"unknown solver {solver!r} (use 'compact' or 'zoom')")
    x0, tgt = _dense_inputs(thetas0, target)
    idx = [int(i) for i in np.asarray(state_idx)]
    loss = make_surrogate_loss(circ, idx, weight)
    minimize = minimize_lbfgs_compact if solver == "compact" else minimize_lbfgs
    res = minimize(
        lambda th: loss(th, tgt), x0, maxiter=int(maxiter), fobj_thr=_loss_thr(fidelity_thr),
        no_improve_iters=None if no_improve_iters is None else int(no_improve_iters),
    )
    fid = _fidelity_readout(circ, idx[0], res.thetas, tgt)
    return JitHorizonResult(res.thetas, res.fobj, fid, res.num_iters, res.converged)


def _loss_thr(fidelity_thr: Optional[float]) -> Optional[float]:
    return None if fidelity_thr is None else (1.0 - float(fidelity_thr))


def optimize_horizon_multistart(
    circ: Ansatz,
    thetas0_batch,
    target,
    *,
    state_idx: Sequence[int],
    weight: float = 0.0,
    fidelity_thr: Optional[float] = None,
    maxiter: int = 100,
    no_improve_iters: Optional[int] = None,
    solver: str = "compact",
    batch_linesearch: Optional[int] = 2,
    fuse_linesearch_grad: bool = False,
) -> JitHorizonResult:
    """Multi-start ASP horizon optimization (BASELINE config 4): the L rows
    of ``thetas0_batch`` run :func:`optimize_horizon_jit`'s loop in lock
    step as one fleet (optim/lbfgs.lbfgs_fleet_programs).  Every evaluation
    is ONE batched statevector pass over the running lanes
    (``torch.func.vmap`` over the one-lane loss) and the gradient one
    ``torch.autograd`` call on the sum of the lane losses.  Returns the
    lanes' results (``num_iters`` and ``converged`` as host arrays); the
    winner is ``argmin(res.fobj)``.

    ``batch_linesearch`` (default 2) evaluates a short Armijo step grid of
    every lane in one batch per iteration; ``None`` backtracks in lock
    step; ``fuse_linesearch_grad`` takes the gradients in the grid's batch
    as well.  ``solver="zoom"`` runs optax's L-BFGS on the lanes instead."""
    if solver not in ("compact", "zoom"):
        raise ValueError(f"unknown solver {solver!r} (use 'compact' or 'zoom')")
    tgt = as_state(target)
    x0 = as_thetas(thetas0_batch, tgt).detach().to(tgt.device)
    idx = [int(i) for i in np.asarray(state_idx)]
    loss = make_surrogate_loss(circ, idx, weight)
    value, value_and_grad = lane_objective(lambda th: loss(th, tgt))
    opts = dict(maxiter=int(maxiter), fobj_thr=_loss_thr(fidelity_thr),
                no_improve_iters=None if no_improve_iters is None else int(no_improve_iters))
    if solver == "zoom":
        res = minimize_lbfgs_lanes(value_and_grad, x0, **opts)
    else:
        res = minimize_lbfgs_compact_lanes(
            value, value_and_grad, x0, batch_linesearch=batch_linesearch,
            fuse_linesearch_grad=bool(fuse_linesearch_grad), **opts,
        )
    with torch.no_grad():
        fid = torch.func.vmap(lambda th: v_dagger_mul_vec(circ, th, tgt)[idx[0]].abs() ** 2)(res.thetas)
    return JitHorizonResult(res.thetas, res.fobj, fid, res.num_iters, res.converged)


class JitSurrogateResult(NamedTuple):
    thetas: torch.Tensor
    fobj: torch.Tensor  # best (lowest) surrogate value
    fidelity: torch.Tensor  # hs2[0] at the best thetas
    num_iters: int
    converged: bool
    weight: torch.Tensor  # final EMA weight
    max_no: int  # final hysteresis-selected flip state


def optimize_horizon_surrogate_jit(
    circ: Ansatz,
    thetas0,
    target,
    *,
    state_idx: Sequence[int],
    weight0: float = 1.0,  # the reference's initial weight
    gamma: float = 0.1,
    fidelity_thr: Optional[float] = None,
    maxiter: int = 100,
    no_improve_iters: Optional[int] = None,
) -> JitSurrogateResult:
    """Optimizes one ASP horizon with the full reference surrogate —
    max-projection hysteresis + weight EMA carried through the compact
    L-BFGS loop, the analytic co-sweep gradient — on the target's device.

    Stops on ``fidelity > fidelity_thr`` (with a live EMA weight fobj is not
    1 - fidelity, so the threshold acts on the fidelity itself)."""
    return optimize_horizon_surrogate_timed(
        circ, thetas0, target, state_idx=state_idx, weight0=weight0, gamma=gamma,
        fidelity_thr=fidelity_thr, maxiter=maxiter, no_improve_iters=no_improve_iters,
    )[0]


def optimize_horizon_surrogate_timed(
    circ: Ansatz,
    thetas0,
    target,
    *,
    state_idx: Sequence[int],
    weight0: float = 1.0,
    gamma: float = 0.1,
    fidelity_thr: Optional[float] = None,
    maxiter: int = 100,
    no_improve_iters: Optional[int] = None,
    time_limit: Optional[float] = None,
    chunk_iters: int = 25,
):
    """:func:`optimize_horizon_surrogate_jit` with the wall clock checked
    every ``chunk_iters`` iterations (no clock when ``time_limit`` is None
    or <= 0: the one-run result).  Returns ``(JitSurrogateResult,
    timed_out)``."""
    x0, tgt = _dense_inputs(thetas0, target)
    idx = [int(i) for i in np.asarray(state_idx)]
    value, vgrad = make_surrogate_stateful(circ, idx, float(gamma))
    st0 = SurrogateState(
        0,
        torch.tensor(float(weight0), dtype=x0.dtype, device=x0.device),
        torch.tensor(0.0, dtype=x0.dtype, device=x0.device),
        torch.tensor(float("inf"), dtype=x0.dtype, device=x0.device),
    )
    fid_thr = None if fidelity_thr is None else float(fidelity_thr)
    programs = lbfgs_chunk_programs(
        lambda x, st: value(x, st, tgt),
        lambda x, st: vgrad(x, st, tgt),
        maxiter=int(maxiter),
        no_improve_iters=None if no_improve_iters is None else int(no_improve_iters),
        stop_fn=None if fid_thr is None else (lambda st: st.fidelity > fid_thr),
    )
    timed = time_limit is not None and time_limit > 0
    res, st, timed_out = run_lbfgs_chunked(
        programs, x0, st0, maxiter=int(maxiter), time_limit=time_limit,
        chunk_iters=int(chunk_iters) if timed else max(int(maxiter), 1),
    )
    fid = _fidelity_readout(circ, idx[0], res.thetas, tgt)
    out = JitSurrogateResult(res.thetas, res.fobj, fid, res.num_iters, res.converged, st.weight, st.max_no)
    return out, timed_out


# -----------------------------------------------------------------------------
# The MPS objective.
# -----------------------------------------------------------------------------


def _mps_value_fns(circ: Ansatz, base_bits: tuple, trunc_thr: float):
    """The MPS fidelity objective as functions of ``(thetas, target)``:
    returns ``(value, value_and_grad)``.  ``thetas`` may be a fleet's rows
    ``(L, P)`` on any ansatz: the values are then ``(L,)`` and every pair
    update of all lanes is one batched decomposition.  On the "rand" route
    the sketch Ω is drawn per batch shape (ops/rand_svd.sketch)."""
    use_cache = v_dagger_layer_cache_eligible(circ)

    def value(th: torch.Tensor, tgt: MPS) -> torch.Tensor:
        if use_cache:
            # Forward objective |<V lvec | t>|^2 == |<lvec | V† t>|^2, grown
            # from the product state with χ-growth scheduling (exact) — the
            # cheap linesearch path, consistent with the gradient path.
            w = v_mul_mps_growing(
                circ, th, base_bits, tgt.chi, trunc_thr=trunc_thr, dtype=tgt.gammas.dtype
            )
            return (1.0 - mps_dot(w, tgt).abs() ** 2).to(th.dtype)
        vh = v_dagger_mul_mps(circ, th, tgt, trunc_thr=trunc_thr)
        amps = mps_flip_amplitudes(vh, base_bits)
        return (1.0 - amps[..., 0].abs() ** 2).to(th.dtype)

    def value_and_grad(th: torch.Tensor, tgt: MPS):
        lvec = mps_basis_state(base_bits, tgt.chi, tgt.gammas.dtype, tgt.device)
        if use_cache:
            # The V† sweep's per-layer cache makes the co-sweep z-free; its
            # final w (= V lvec) gives the forward-consistent objective.
            # grow_w: lvec is a rank-1 product state (exact).
            vh, zcache = v_dagger_mul_mps_layers(circ, th, tgt, trunc_thr=trunc_thr)
            grad, w_fin = fast_dot_gradient_with_state(
                circ, th, lvec, vh, zcache, trunc_thr=trunc_thr, grow_w=True
            )
            hs0 = mps_dot(w_fin, tgt)
        else:
            # No layer cache (a one-layer horizon): the amplitude from the V†
            # sweep, the co-sweep updating w and z together.
            vh = v_dagger_mul_mps(circ, th, tgt, trunc_thr=trunc_thr)
            hs0 = mps_flip_amplitudes(vh, base_bits)[..., 0]
            grad = fast_dot_gradient(circ, th, lvec, vh, trunc_thr=trunc_thr)
        fobj = (1.0 - hs0.abs() ** 2).to(th.dtype)
        grad = (-2.0 * hs0.conj()[..., None] * grad).real.to(th.dtype)
        return fobj, grad

    return value, value_and_grad


# -----------------------------------------------------------------------------
# The MPS objective's device programs (the JAX package's jitted
# ``_mps_value_program`` and ``_mps_chunk_cache``): on CUDA every evaluation of
# a horizon is the replay of a CUDA graph captured at its first call
# (ops/cuda_graphs.py), one graph per (circuit, base bits, trunc_thr, route,
# θ shape and the target's χ, dtype and device, and the policy the pair
# updates read); on the CPU a program is the eager function.  θ's shape keys
# the lane count: one lane's (P,), a fleet's running lanes (L', P).  Each
# program is pinned to its route, so flipping the ambient route between calls
# never serves a stale graph.
# -----------------------------------------------------------------------------

_PROGRAMS: dict = {}


def _wrap_svd_impl(fn, impl: str):
    """Pins ``fn`` to one SVD route: it runs under ``svd_impl_override(impl)``
    (programs made from it are cached keyed on ``impl``)."""

    def pinned(*args):
        with svd_impl_override(impl):
            return fn(*args)

    return pinned


def _trace_key(impl: str) -> tuple:
    """What a program's capture reads beyond its arguments: the route, the
    pair updates' global policy and the range-finder's knobs."""
    from ...ops import rand_svd
    from ...ops.mps import pair_sharding

    knobs = (rand_svd._OVERSAMPLE, rand_svd._POWER_ITERS, rand_svd._INTERMEDIATE, rand_svd.RAND_MIN_N)
    return (impl, trace_policy(), knobs, pair_sharding() is not None)


class _MpsProgram:
    """An MPS objective function of ``(thetas, target)`` as device
    programs, one per signature of its tensors and trace key."""

    def __init__(self, fn, impl: str, name: str):
        self.impl = impl
        pinned = _wrap_svd_impl(fn, impl)
        self.cache = ProgramCache(lambda th, g, lam: pinned(th, MPS(g, lam)), name)

    def entry(self, th: torch.Tensor, tgt: MPS):
        """The program that a call at these tensors replays."""
        return self.cache.entry((th, tgt.gammas, tgt.lambdas), _trace_key(self.impl))

    def __call__(self, th: torch.Tensor, tgt: MPS):
        return self.entry(th, tgt)(th, tgt.gammas, tgt.lambdas)


def _cached(key, build):
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = build()
    return prog


def _mps_value_program(circ: Ansatz, base_bits: tuple, trunc_thr: float, impl: str) -> _MpsProgram:
    """The objective's value as device programs pinned to ``impl``."""

    def build():
        value, _ = _mps_value_fns(circ, base_bits, trunc_thr)
        return _MpsProgram(value, impl, "mps value")

    return _cached(("value", circ, base_bits, trunc_thr, impl), build)


def _mps_value_and_grad_program(circ: Ansatz, base_bits: tuple, trunc_thr: float, impl: str) -> _MpsProgram:
    """The objective and its co-sweep gradient as device programs pinned to
    ``impl``.  The co-sweep's grow_w contract (a rank-1 product lvec), which
    the traced function skips, is checked here once, on the basis state the
    function builds."""

    def build():
        lvec = mps_basis_state(base_bits, 2, torch.complex128, "cpu")
        _check_grow_w_contract(v_dagger_layer_cache_eligible(circ), lvec)
        _, value_and_grad = _mps_value_fns(circ, base_bits, trunc_thr)
        return _MpsProgram(value_and_grad, impl, "mps obj+grad")

    return _cached(("value_and_grad", circ, base_bits, trunc_thr, impl), build)


def _mps_chunk_cache(circ: Ansatz, base_bits: tuple, trunc_thr: float, fobj_thr, maxiter: int,
                     no_improve_iters, impl: str, fleet: bool = False):
    """The L-BFGS loop's ``(init, chunk, extract)`` over the programs of
    ``impl``; the target rides in the loop's objective state, as the JAX
    package threads it through its chunk programs as data.  The loop stays on
    the host: its scalar reads fall between replays.  ``fleet``: the loop
    over lanes (optim/lbfgs.lbfgs_fleet_programs), which evaluates the
    running lanes' rows, so every running-lane count replays programs of its
    own."""

    def build():
        value = _mps_value_program(circ, base_bits, trunc_thr, impl)
        value_and_grad = _mps_value_and_grad_program(circ, base_bits, trunc_thr, impl)
        return (lbfgs_fleet_programs if fleet else lbfgs_chunk_programs)(
            lambda x, tgt: (value(x, tgt), tgt),
            lambda x, tgt: value_and_grad(x, tgt) + (tgt,),
            maxiter=maxiter,
            fobj_thr=fobj_thr,
            no_improve_iters=no_improve_iters,
        )

    kind = "fleet_chunks" if fleet else "chunks"
    return _cached((kind, circ, base_bits, trunc_thr, fobj_thr, maxiter, no_improve_iters, impl), build)


def mps_programs() -> list:
    """Every device program the cached MPS programs hold (their stats say
    what each capture cost)."""
    return [p for _, p in mps_program_shapes()]


def mps_program_shapes() -> list:
    """``(θ shape, program)`` of every device program the cached MPS
    programs hold: ``(P,)`` for one lane, ``(L', P)`` for L' lanes."""
    return [(sig[0][0][0], p) for prog in _PROGRAMS.values() if isinstance(prog, _MpsProgram)
            for sig, p in prog.cache.programs.items()]


def release_mps_programs() -> int:
    """Drops every cached MPS program, frees its graph and memory pool, and
    returns the pool bytes released.  A schedule calls it between horizons:
    a new horizon's circuit needs new programs."""
    freed = 0
    for prog in _PROGRAMS.values():
        if isinstance(prog, _MpsProgram):
            freed += sum(p.pool_bytes or 0 for p in prog.cache.programs.values())
            prog.cache.release()
    _PROGRAMS.clear()
    if freed and torch.cuda.is_available():
        torch.cuda.empty_cache()
    return freed


def _run_horizon(circ, x0, tgt, base_bits, trunc_thr, fobj_thr, maxiter, no_improve_iters,
                 time_limit=None, chunk_iters=None, impl=None):
    """The L-BFGS loop over the MPS objective's programs of ``impl`` (None:
    the route in effect for the target's device): in one run, or in chunks
    of ``chunk_iters`` iterations with the clock checked between them when
    ``time_limit`` > 0.  ``x0`` of shape (L, P) runs L lanes as one fleet
    (``num_iters`` and ``converged`` are then host arrays).  Returns
    (JitHorizonResult, timed_out)."""
    impl = svd_impl(tgt.device) if impl is None else impl
    programs = _mps_chunk_cache(circ, base_bits, trunc_thr, fobj_thr, maxiter, no_improve_iters, impl,
                                fleet=x0.dim() == 2)
    res, _, timed_out = run_lbfgs_chunked(
        programs, x0, tgt, maxiter=maxiter, time_limit=time_limit, chunk_iters=chunk_iters or max(maxiter, 1)
    )
    return JitHorizonResult(res.thetas, res.fobj, 1.0 - res.fobj, res.num_iters, res.converged), timed_out


def _check_base_bits(circ: Ansatz, base_bits: Sequence[int]) -> tuple:
    if len(base_bits) != circ.num_qubits:
        raise ValueError(
            f"base_bits must give one 0/1 occupation per site: got "
            f"{len(base_bits)} for {circ.num_qubits} qubits"
        )
    return tuple(int(b) for b in base_bits)


def _fleet_starts(thetas0_batch, target: MPS) -> torch.Tensor:
    if isinstance(thetas0_batch, torch.Tensor):
        return thetas0_batch.detach()
    return torch.as_tensor(np.asarray(thetas0_batch), dtype=target.lambdas.dtype, device=target.device)


def optimize_horizon_mps_multistart(
    circ: Ansatz,
    thetas0_batch,
    target: MPS,
    *,
    base_bits: Sequence[int],
    trunc_thr: float = 1e-6,
    fidelity_thr: Optional[float] = None,
    maxiter: int = 100,
    no_improve_iters: Optional[int] = None,
) -> JitHorizonResult:
    """Multi-start MPS ASP horizon optimization: the L rows of
    ``thetas0_batch`` run :func:`optimize_horizon_mps_jit`'s loop in lock
    step as one fleet (optim/lbfgs.lbfgs_fleet_programs, sequential
    backtracking as in the JAX twin).  On every ansatz the lanes fold into
    the batch of every pair update (each engine path takes lane axes): one
    evaluation decomposes each pair update of all running lanes in ONE
    launch of the route's kernels, as the JAX twin's vmapped program does.
    No ansatz is evaluated lane by lane.  Every evaluation goes through the
    device programs of the one-lane horizon, keyed by θ's shape: each
    running-lane count L' replays graphs of its own at (L', P)
    (:func:`capture_mps_fleet` captures them ahead).  Under a route other
    than the watchdog's reference for the target's device, every lane
    passes the collapse watchdog (:func:`_mps_fleet_watchdog`), which the
    JAX twin does not have.  Returns the lanes' results
    (``num_iters``/``converged`` host arrays); the winner is
    ``argmin(res.fobj)``.

    On the "rand" route the sketch Ω is drawn per batch shape
    (ops/rand_svd.sketch), so a folded lane agrees with its one-lane run to
    the f32 sketch noise, not bit for bit."""
    base_t = _check_base_bits(circ, base_bits)
    x0 = _fleet_starts(thetas0_batch, target)
    fobj_thr = _loss_thr(fidelity_thr)
    no_imp = None if no_improve_iters is None else int(no_improve_iters)
    with request("asp.horizon", lanes=int(x0.shape[0])):
        res, _ = _run_horizon(circ, x0, target, base_t, float(trunc_thr), fobj_thr, int(maxiter), no_imp)
        with span("asp.watchdog"):
            res = _mps_fleet_watchdog(
                circ, x0, target, res, base_bits=base_t, trunc_thr=float(trunc_thr),
                fobj_thr=fobj_thr, maxiter=int(maxiter), no_improve_iters=no_imp,
            )
    return res


def capture_mps_fleet(circ: Ansatz, thetas0_batch, target: MPS, *, base_bits: Sequence[int],
                      trunc_thr: float = 1e-6) -> list:
    """Runs every program an L-lane fleet on ``target`` can replay once, so
    that each is captured before the first fleet: the value and the
    obj+grad of the route in effect at every running-lane count L' = 1..L
    (at the first L' rows of ``thetas0_batch``), and the watchdog's
    reference value at L lanes where the watchdog runs.  Returns those
    programs (on the CPU, where each call is eager, the calls only
    evaluate)."""
    base_t = _check_base_bits(circ, base_bits)
    x = _fleet_starts(thetas0_batch, target)
    route, reference = svd_impl(target.device), _watchdog_reference_impl(target.device)
    value = _mps_value_program(circ, base_t, float(trunc_thr), route)
    value_and_grad = _mps_value_and_grad_program(circ, base_t, float(trunc_thr), route)
    calls = [(prog, x[:lanes]) for lanes in range(1, x.shape[0] + 1) for prog in (value, value_and_grad)]
    if mps_watchdog_enabled() and route != reference:
        calls.append((_mps_value_program(circ, base_t, float(trunc_thr), reference), x))
    with torch.no_grad():
        for prog, th in calls:
            prog(th, target)
    return [prog.entry(th, target) for prog, th in calls]


# -----------------------------------------------------------------------------
# MPS optimization watchdog (the fobj=1.0 collapse fence): after a horizon
# optimized under a fast route, re-evaluate the returned iterate under the
# reference decomposition; a gross disagreement flags the run (logger +
# ``watchdog_events``) and re-optimizes the horizon under the reference.  One
# extra objective evaluation per horizon; a fleet's lanes share one evaluation
# and are flagged and re-optimized one by one.
# -----------------------------------------------------------------------------

_watchdog_logger = logging.getLogger(__name__)

#: Flagged events (dicts with the disagreeing values), newest last.
watchdog_events: list = []

# "Gross" = beyond BOTH bounds: cross-route noise at a common iterate is
# ~1e-5-class, the collapse signature is O(1).
_WATCHDOG_ABS = 1e-2
_WATCHDOG_REL = 1.0


def _watchdog_reference_impl(dev) -> str:
    """The decomposition the watchdog trusts for tensors on ``dev`` (a
    device or a tensor): the hand-written Jacobi kernel on CUDA, LAPACK
    elsewhere — the JAX package's rule (its Pallas Jacobi kernel on the
    accelerator, LAPACK elsewhere)."""
    dev = dev.device if isinstance(dev, torch.Tensor) else torch.device(dev)
    return "jacobi" if dev.type == "cuda" else "native"


def _watchdog_check(circ, target, thetas: torch.Tensor, fobj: torch.Tensor, base_bits, trunc_thr):
    """The reference's value at the returned ``thetas`` (one replay of its
    value program at their shape) against the optimized ``fobj``: returns
    ``(route, reference, [(fobj_optimized, fobj_reference)])``, one pair
    per lane, or None where the watchdog does not run."""
    route = svd_impl(target.device)
    reference = _watchdog_reference_impl(target.device)
    if not mps_watchdog_enabled() or route == reference:
        return None
    value_ref = _mps_value_program(circ, base_bits, trunc_thr, reference)(thetas, target)
    with span("host.read"):
        count("host_reads", 2)
        fobj_ref = value_ref.reshape(-1).tolist()
        fobj_opt = fobj.reshape(-1).tolist()
    return route, reference, list(zip(fobj_opt, fobj_ref))


def _flagged(circ, route: str, reference: str, fobj_opt: float, fobj_ref: float, what: str, **where) -> bool:
    """True where the two values disagree grossly; the event is then
    recorded in ``watchdog_events`` (with ``where``) and logged."""
    diff = abs(fobj_opt - fobj_ref)
    scale = min(abs(fobj_opt), abs(fobj_ref))
    if diff <= max(_WATCHDOG_ABS, _WATCHDOG_REL * scale):
        return False
    event = {
        "fobj_optimized": fobj_opt,
        "fobj_reference": fobj_ref,
        "svd_impl": route,
        "reference_impl": reference,
        "num_qubits": circ.num_qubits,
        **where,
    }
    watchdog_events.append(event)
    _watchdog_logger.warning(
        "MPS watchdog: optimized fobj %0.6g disagrees with the reference "
        "decomposition's %0.6g at the returned iterate (svd_impl=%s) — "
        "re-optimizing %s under %s",
        fobj_opt, fobj_ref, route, what, reference,
    )
    return True


def _mps_watchdog(circ, thetas0, target, res: JitHorizonResult, *, base_bits, trunc_thr,
                  fobj_thr, maxiter, no_improve_iters) -> JitHorizonResult:
    checked = _watchdog_check(circ, target, res.thetas, res.fobj, base_bits, trunc_thr)
    if checked is None:
        return res
    route, reference, [(fobj_opt, fobj_ref)] = checked
    if not _flagged(circ, route, reference, fobj_opt, fobj_ref, "this horizon"):
        return res
    return _run_horizon(circ, thetas0, target, base_bits, trunc_thr, fobj_thr, maxiter, no_improve_iters,
                        impl=reference)[0]


def _mps_fleet_watchdog(circ, thetas0, target, res: JitHorizonResult, *, base_bits, trunc_thr,
                        fobj_thr, maxiter, no_improve_iters) -> JitHorizonResult:
    """The collapse watchdog of a fleet, per lane: every lane's returned θ
    re-evaluated in one replay of the reference's value program at (L, P);
    a lane that disagrees grossly is flagged (its event carries ``lane``)
    and re-optimized alone under the reference from its start, as
    :func:`_mps_watchdog` re-runs a horizon.  The other lanes' results stay
    as the fleet returned them."""
    checked = _watchdog_check(circ, target, res.thetas, res.fobj, base_bits, trunc_thr)
    if checked is None:
        return res
    route, reference, pairs = checked
    lanes = [lane for lane, (fobj_opt, fobj_ref) in enumerate(pairs)
             if _flagged(circ, route, reference, fobj_opt, fobj_ref, f"lane {lane}", lane=lane)]
    if not lanes:
        return res
    thetas, fobj = res.thetas.clone(), res.fobj.clone()
    num_iters, converged = res.num_iters.copy(), res.converged.copy()
    for lane in lanes:
        one = _run_horizon(circ, thetas0[lane], target, base_bits, trunc_thr, fobj_thr, maxiter, no_improve_iters,
                           impl=reference)[0]
        thetas[lane], fobj[lane] = one.thetas, one.fobj
        num_iters[lane], converged[lane] = one.num_iters, one.converged
    return JitHorizonResult(thetas, fobj, 1.0 - fobj, num_iters, converged)


def optimize_horizon_mps_jit(
    circ: Ansatz,
    thetas0: torch.Tensor,
    target: MPS,
    *,
    base_bits: Sequence[int],
    trunc_thr: float = 1e-6,
    fidelity_thr: Optional[float] = None,
    maxiter: int = 100,
    no_improve_iters: Optional[int] = None,
) -> JitHorizonResult:
    """ASP horizon optimization with the MPS engine: the fidelity objective
    and the layer-batched analytic co-sweep gradient inside compact L-BFGS.
    ``thetas0`` lives on the target's device; ``base_bits`` encodes the
    X-layer product prep.

    Under a route other than the watchdog's reference for the target's
    device the result passes the collapse watchdog."""
    return optimize_horizon_mps_timed(
        circ, thetas0, target, base_bits=base_bits, trunc_thr=trunc_thr, fidelity_thr=fidelity_thr,
        maxiter=maxiter, no_improve_iters=no_improve_iters,
    )[0]


def optimize_horizon_mps_timed(
    circ: Ansatz,
    thetas0: torch.Tensor,
    target: MPS,
    *,
    base_bits: Sequence[int],
    trunc_thr: float = 1e-6,
    fidelity_thr: Optional[float] = None,
    maxiter: int = 100,
    no_improve_iters: Optional[int] = None,
    time_limit: Optional[float] = None,
    chunk_iters: int = 25,
):
    """:func:`optimize_horizon_mps_jit` with the wall clock checked every
    ``chunk_iters`` iterations (optim/lbfgs.run_lbfgs_chunked; no clock
    when ``time_limit`` is None or <= 0).  Returns ``(JitHorizonResult,
    timed_out)``.

    The collapse watchdog runs here too; a flagged horizon recovers through
    the one-run reference-route runner, which does not honour
    ``time_limit`` again (a rare flagged event puts correctness first)."""
    base_t = _check_base_bits(circ, base_bits)
    fobj_thr = _loss_thr(fidelity_thr)
    no_imp = None if no_improve_iters is None else int(no_improve_iters)
    with request("asp.horizon"):
        res, timed_out = _run_horizon(circ, thetas0, target, base_t, float(trunc_thr), fobj_thr, int(maxiter),
                                      no_imp, time_limit, int(chunk_iters))
        with span("asp.watchdog"):
            res = _mps_watchdog(
                circ, thetas0, target, res, base_bits=base_t, trunc_thr=float(trunc_thr),
                fobj_thr=fobj_thr, maxiter=int(maxiter), no_improve_iters=no_imp,
            )
    return res, timed_out
