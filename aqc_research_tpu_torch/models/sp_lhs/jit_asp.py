"""ASP horizon optimization over the MPS objective (twin of the MPS subset
of ``aqc_research_tpu/models/sp_lhs/jit_asp.py``).

One horizon is a compact L-BFGS over the fidelity objective
``1 - |<V lvec | target>|^2`` and its analytic co-sweep gradient; ``lvec``
is the X-layer product prep (e.g. the Neel state) given as ``base_bits``.
The name :func:`optimize_horizon_mps_jit` keeps the JAX twin findable; the
loop itself runs on the host (optim/lbfgs.py).
:func:`optimize_horizon_mps_timed` runs the same loop in chunks and checks
the wall clock between them.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Sequence

import torch

from ...circuit.ansatz import Ansatz
from ...config import mps_watchdog_enabled, svd_impl, svd_impl_override
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
from ...ops.mps_gradient import fast_dot_gradient_with_state
from ...optim.lbfgs import lbfgs_chunk_programs, run_lbfgs_chunked


class JitHorizonResult(NamedTuple):
    thetas: torch.Tensor
    fobj: torch.Tensor  # best (lowest) objective value
    fidelity: torch.Tensor  # 1 - fobj
    num_iters: int
    converged: bool


def _mps_value_fns(circ: Ansatz, base_bits: tuple, trunc_thr: float):
    """The MPS fidelity objective as functions of ``(thetas, target)``:
    returns ``(value, value_and_grad)``."""
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
        return (1.0 - amps[0].abs() ** 2).to(th.dtype)

    def value_and_grad(th: torch.Tensor, tgt: MPS):
        if not use_cache:
            raise NotImplementedError(
                "only the layered Trotter co-sweep gradient is ported (TrotterAnsatz)"
            )
        lvec = mps_basis_state(base_bits, tgt.chi, tgt.gammas.dtype, tgt.device)
        # The V† sweep's per-layer cache makes the co-sweep z-free; its final
        # w (= V lvec) gives the forward-consistent objective.  grow_w: lvec
        # is a rank-1 product state (exact).
        vh, zcache = v_dagger_mul_mps_layers(circ, th, tgt, trunc_thr=trunc_thr)
        grad, w_fin = fast_dot_gradient_with_state(
            circ, th, lvec, vh, zcache, trunc_thr=trunc_thr, grow_w=True
        )
        hs0 = mps_dot(w_fin, tgt)
        fobj = (1.0 - hs0.abs() ** 2).to(th.dtype)
        grad = (-2.0 * hs0.conj() * grad).real.to(th.dtype)
        return fobj, grad

    return value, value_and_grad


def _run_horizon(circ, x0, tgt, base_bits, trunc_thr, fobj_thr, maxiter, no_improve_iters,
                 time_limit=None, chunk_iters=None):
    """The L-BFGS loop over the MPS objective: in one run, or in chunks of
    ``chunk_iters`` iterations with the clock checked between them when
    ``time_limit`` > 0.  Returns (JitHorizonResult, timed_out)."""
    value, value_and_grad = _mps_value_fns(circ, base_bits, trunc_thr)
    programs = lbfgs_chunk_programs(
        lambda th: value(th, tgt),
        lambda th: value_and_grad(th, tgt),
        maxiter=maxiter,
        fobj_thr=fobj_thr,
        no_improve_iters=no_improve_iters,
    )
    res, timed_out = run_lbfgs_chunked(
        programs, x0, maxiter=maxiter, time_limit=time_limit, chunk_iters=chunk_iters or max(maxiter, 1)
    )
    return JitHorizonResult(res.thetas, res.fobj, 1.0 - res.fobj, res.num_iters, res.converged), timed_out


# -----------------------------------------------------------------------------
# MPS optimization watchdog (the fobj=1.0 collapse fence): after a horizon
# optimized under a fast route, re-evaluate the returned iterate under the
# reference decomposition; a gross disagreement flags the run (logger +
# ``watchdog_events``) and re-optimizes the horizon under the reference.  One
# extra objective evaluation per horizon.
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


def _mps_watchdog(circ, thetas0, target, res: JitHorizonResult, *, base_bits, trunc_thr,
                  fobj_thr, maxiter, no_improve_iters) -> JitHorizonResult:
    route = svd_impl(target.device)
    reference = _watchdog_reference_impl(target.device)
    if not mps_watchdog_enabled() or route == reference:
        return res
    value, _ = _mps_value_fns(circ, base_bits, trunc_thr)
    with svd_impl_override(reference):
        fobj_ref = float(value(res.thetas, target))
    fobj_opt = float(res.fobj)
    diff = abs(fobj_opt - fobj_ref)
    scale = min(abs(fobj_opt), abs(fobj_ref))
    if diff <= max(_WATCHDOG_ABS, _WATCHDOG_REL * scale):
        return res
    event = {
        "fobj_optimized": fobj_opt,
        "fobj_reference": fobj_ref,
        "svd_impl": route,
        "reference_impl": reference,
        "num_qubits": circ.num_qubits,
    }
    watchdog_events.append(event)
    _watchdog_logger.warning(
        "MPS watchdog: optimized fobj %0.6g disagrees with the reference "
        "decomposition's %0.6g at the returned iterate (svd_impl=%s) — "
        "re-optimizing this horizon under %s",
        fobj_opt, fobj_ref, route, reference,
    )
    with svd_impl_override(reference):
        return _run_horizon(circ, thetas0, target, base_bits, trunc_thr, fobj_thr,
                            maxiter, no_improve_iters)[0]


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
    if len(base_bits) != circ.num_qubits:
        raise ValueError(
            f"base_bits must give one 0/1 occupation per site: got "
            f"{len(base_bits)} for {circ.num_qubits} qubits"
        )
    base_t = tuple(int(b) for b in base_bits)
    fobj_thr = None if fidelity_thr is None else (1.0 - float(fidelity_thr))
    no_imp = None if no_improve_iters is None else int(no_improve_iters)
    res, timed_out = _run_horizon(circ, thetas0, target, base_t, float(trunc_thr), fobj_thr, int(maxiter),
                                  no_imp, time_limit, int(chunk_iters))
    res = _mps_watchdog(
        circ, thetas0, target, res, base_bits=base_t, trunc_thr=float(trunc_thr),
        fobj_thr=fobj_thr, maxiter=int(maxiter), no_improve_iters=no_imp,
    )
    return res, timed_out
