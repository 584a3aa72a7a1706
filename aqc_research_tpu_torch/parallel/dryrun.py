"""Multi-GPU dry run of the port's sharded engines (the counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``), the entry point users
start for multi-GPU runs:

    torchrun --nproc-per-node=K -m aqc_research_tpu_torch.parallel.dryrun
    torchrun --nproc-per-node=K -m aqc_research_tpu_torch.parallel.dryrun --cpu   (Gloo ranks)

K = 1, 2, 4 or 8.  Every rank runs the same steps on a (dp, tp) mesh and a
(dp, sp) mesh over the K ranks, each held against the replicated engine on
the same inputs:

1. one SGD step of a multi-start fleet (dp) of the 6-qubit ASP objective on
   a tp-sharded statevector (``statevector_tp``; the gradient by autograd
   through the exchanges), and ``v_mul_vec_tp``;
2. the pair-sharded MPS obj+grad at n=19 χ=16 (9-pair groups: the padded
   path; the z-cached co-sweep with ``grow_w``; the χ-growth value sweep);
3. the site-sharded (chain) obj+grad at n=16 χ=16 over sp;
4. a chain-sharded and a pair-sharded L-BFGS horizon against the
   replicated ones;
5. on rank 0, the collective-cost model (``collective_model``): the chain
   obj+grad's census at n=16 χ=8 fitted at P = 2 and 4 Gloo ranks on the
   CPU and held out at P = 8; on the card, the model's predicted sp=4
   speedup of the 28q χ=128 obj+grad from T₁ measured in the same run
   (``collective_model.CHAIN28_MODEL``, NVLink datasheet link).

On the card the ranks run c64 (precision "fast") and the kernels of the
route in effect; on the CPU c128.  Rank 0 prints one line; any failed check
raises, so the launcher exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def _tol(dtype) -> float:
    return 1e-4 if dtype == torch.complex64 else 1e-10


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run check failed: {what}")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def _trotter_case(n: int, layers: int, chi: int, num_steps: int, perturb: float, seed: int, thr: float, rdtype, dev):
    """Perturbed perfect-init angles, the Néel lvec and a 2nd-order Trotter
    target MPS (the JAX dry run's cases)."""
    from ..circuit.ansatz import TrotterAnsatz
    from ..circuit.structures import make_trotter_like_circuit
    from ..ops import mps as mpsop
    from ..targets import trotter as trotop

    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), True)
    th = trotop.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=0.8, delta=1.0)
    th = th + perturb * np.random.default_rng(seed).standard_normal(circ.num_thetas)
    ini = trotop.neel_init_state(n)
    cdtype = torch.complex64 if rdtype == torch.float32 else torch.complex128
    target = trotop.Trotter(num_qubits=n, evol_time=0.8, num_steps=num_steps, delta=1.0, second_order=True).as_mps(
        ini, trunc_thr=thr, chi_max=chi, dtype=cdtype, device=dev)
    lvec = mpsop.mps_from_program(ini, n, chi_max=chi, dtype=cdtype, device=dev)
    return circ, torch.tensor(th, dtype=rdtype, device=dev), lvec, target


def _fleet_step(dp_tp, dtype, dev):
    """One SGD step of a 2-per-dp-rank fleet on the tp-sharded 6-qubit
    flagship target, against the replicated dense engine."""
    from ..circuit.ansatz import TrotterAnsatz
    from ..circuit.structures import make_trotter_like_circuit
    from ..ops.statevector import v_dagger_mul_vec
    from ..targets import trotter as trotop
    from .comm import all_gather, all_reduce_sum, axis_of
    from .mesh import shard_batch, shard_state
    from .statevector_tp import _SumOverAxis, v_dagger_mul_vec_tp, v_mul_vec_tp

    n = 6
    tp, dp = axis_of(dp_tp, "tp"), axis_of(dp_tp, "dp")
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, 1), True)
    th0 = trotop.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=1.2, delta=1.0)
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    batch = torch.stack([torch.tensor(th0 + 0.01 * k, dtype=rdtype, device=dev) for k in range(2 * dp.size)])
    target = trotop.Trotter(num_qubits=n, evol_time=1.2, num_steps=30, delta=1.0, second_order=True).as_vector(
        trotop.neel_init_state(n), dtype=dtype, device=dev)
    idx0 = sum(1 << k for k in range(0, n, 2))
    local_target = shard_state(target, dp_tp, "tp")
    size = local_target.shape[0]

    def sharded_loss(th):
        vh = v_dagger_mul_vec_tp(circ, th, local_target, dp_tp, "tp")
        # Every rank keeps its part of the graph (x 0 where it does not own
        # the amplitude), so every rank's backward runs the same exchanges.
        part = vh[idx0 % size] * (1.0 if idx0 // size == tp.index else 0.0)
        hs0 = _SumOverAxis.apply(part, tp)
        return 1.0 - hs0.abs() ** 2

    fobjs, steps = [], []
    for th in shard_batch(batch, dp_tp, "dp"):
        th = th.clone().requires_grad_(True)
        f = sharded_loss(th)
        (g,) = torch.autograd.grad(f, th)
        g = all_reduce_sum(g, tp)  # each tp rank holds its own part of the gradient
        ref_th = th.detach().clone().requires_grad_(True)
        ref_f = 1.0 - v_dagger_mul_vec(circ, ref_th, target)[idx0].abs() ** 2
        (ref_g,) = torch.autograd.grad(ref_f, ref_th)
        f, ref_f = f.detach(), ref_f.detach()
        _check(abs(float(f) - float(ref_f)) <= _tol(dtype) and _rel(g, ref_g) <= _tol(dtype),
               f"tp fleet loss/gradient vs replicated: {float(f)} vs {float(ref_f)}, rel {_rel(g, ref_g):.3g}")
        fobjs.append(f)
        steps.append(th.detach() - 0.05 * g)
    fobj = all_gather(torch.stack(fobjs), dp).flatten()
    new_batch = all_gather(torch.stack(steps), dp).flatten(0, 1)
    _check(bool(torch.isfinite(fobj).all()) and new_batch.shape == batch.shape, "non-finite fleet step")
    out = v_mul_vec_tp(circ, new_batch[0], local_target, dp_tp, "tp")
    _check(bool(torch.isfinite(out).all()), "tp statevector engine produced NaN")
    return fobj


def _pair_sharded_obj_grad(dp_tp, rdtype, dev, thr):
    from ..ops import mps as mpsop
    from ..ops.mps_gradient import fast_dot_gradient

    n, chi = 19, 16
    circ, th, lvec, target = _trotter_case(n, 2, chi, 2, 0.05, 3, thr, rdtype, dev)
    bits = tuple(int(k % 2 == 0) for k in range(n))

    def obj_grad():
        vh, zc = mpsop.v_dagger_mul_mps_layers(circ, th, target, trunc_thr=thr)
        g = fast_dot_gradient(circ, th, lvec, vh, trunc_thr=thr, z_layers=zc, grow_w=True)
        w = mpsop.v_mul_mps_growing(circ, th, bits, chi, trunc_thr=thr, dtype=target.gammas.dtype)
        return g, mpsop.mps_dot(w, target)

    mpsop.set_pair_sharding(dp_tp, "tp")
    try:
        g, ov = obj_grad()
    finally:
        mpsop.set_pair_sharding(None)
    g_ref, ov_ref = obj_grad()
    gnorm = float(torch.linalg.vector_norm(g.real))
    _check(np.isfinite(gnorm) and gnorm > 0 and abs(complex(ov)) > 0, f"pair-sharded |grad|={gnorm}, ov={ov}")
    _check(_rel(g, g_ref) <= 10 * _tol(g.dtype) and abs(complex(ov - ov_ref)) <= _tol(g.dtype),
           f"pair-sharded vs replicated: rel {_rel(g, g_ref):.3g}, overlap {complex(ov)} vs {complex(ov_ref)}")
    return gnorm, abs(complex(ov))


def _chain_obj_grad(dp_sp, rdtype, dev, thr):
    from ..ops import mps as mpsop
    from ..ops.mps_gradient import fast_dot_gradient
    from .mps_chain import chain_dot, chain_fast_dot_gradient, chain_from_mps, chain_v_dagger_mul_mps

    n, chi = 16, 16
    circ, th, lvec, phi = _trotter_case(n, 2, chi, 2, 0.05, 5, thr, rdtype, dev)
    vh = chain_v_dagger_mul_mps(circ, th, chain_from_mps(phi, dp_sp, axis="sp"), dp_sp, axis="sp", trunc_thr=thr)
    clvec = chain_from_mps(lvec, dp_sp, axis="sp")
    dot = chain_dot(clvec, vh, dp_sp, axis="sp")
    g = chain_fast_dot_gradient(circ, th, clvec, vh, dp_sp, axis="sp", trunc_thr=thr)
    vh_ref = mpsop.v_dagger_mul_mps(circ, th, phi, trunc_thr=thr)
    dot_ref = mpsop.mps_dot(lvec, vh_ref)
    g_ref = fast_dot_gradient(circ, th, lvec, vh_ref, trunc_thr=thr)
    _check(abs(complex(dot - dot_ref)) <= _tol(g.dtype) and _rel(g, g_ref) <= 10 * _tol(g.dtype),
           f"chain vs replicated: dot {complex(dot)} vs {complex(dot_ref)}, rel {_rel(g, g_ref):.3g}")
    return float(torch.linalg.vector_norm(g.real)), abs(complex(dot))


def _horizons(dp_tp, dp_sp, rdtype, dev, thr):
    """The chain horizon (n=8 χ=16) and the pair-sharded horizon (n=9) against
    the replicated runs of the same compact L-BFGS."""
    from ..models.sp_lhs.jit_asp import optimize_horizon_mps_jit
    from ..ops import mps as mpsop
    from ..ops.mps_gradient import fast_dot_gradient
    from ..optim.lbfgs import minimize_lbfgs_compact
    from .mps_chain import chain_from_mps, chain_optimize_horizon

    circ, th, lvec, phi = _trotter_case(8, 2, 16, 3, 0.1, 11, thr, rdtype, dev)
    res_chain = chain_optimize_horizon(circ, th, chain_from_mps(lvec, dp_sp, axis="sp"),
                                       chain_from_mps(phi, dp_sp, axis="sp"), dp_sp, axis="sp",
                                       trunc_thr=thr, maxiter=20)

    def value(x):
        vh = mpsop.v_dagger_mul_mps_layers(circ, x, phi, trunc_thr=thr)[0]
        return (1.0 - mpsop.mps_dot(lvec, vh).abs() ** 2).to(x.dtype)

    def vgrad(x):
        vh = mpsop.v_dagger_mul_mps_layers(circ, x, phi, trunc_thr=thr)[0]
        dot = mpsop.mps_dot(lvec, vh)
        g = fast_dot_gradient(circ, x, lvec, vh, trunc_thr=thr)
        return (1.0 - dot.abs() ** 2).to(x.dtype), (-2.0 * dot.conj() * g).real.to(x.dtype)

    res_repl = minimize_lbfgs_compact(value, th, maxiter=20, value_and_grad_fn=vgrad)
    f_start, f_chain, f_repl = float(value(th)), float(res_chain.fobj), float(res_repl.fobj)
    _check(f_chain < 0.2 * f_start and f_repl < 0.2 * f_start, f"horizons did not converge: {f_start} -> "
           f"chain {f_chain}, replicated {f_repl}")
    _check(abs(f_chain - f_repl) < 1e-3 + 0.2 * max(f_chain, f_repl), f"chain {f_chain} vs replicated {f_repl}")

    pcirc, pth, _, ptarget = _trotter_case(9, 2, 16, 3, 0.1, 13, thr, rdtype, dev)
    bits = tuple(int(k % 2 == 0) for k in range(9))
    mpsop.set_pair_sharding(dp_tp, "tp")
    try:
        f_ps = float(optimize_horizon_mps_jit(pcirc, pth, ptarget, base_bits=bits, trunc_thr=thr, maxiter=15).fobj)
    finally:
        mpsop.set_pair_sharding(None)
    f_pr = float(optimize_horizon_mps_jit(pcirc, pth, ptarget, base_bits=bits, trunc_thr=thr, maxiter=15).fobj)
    _check(np.isfinite(f_ps) and abs(f_ps - f_pr) < 1e-3 + 0.2 * max(abs(f_ps), abs(f_pr)),
           f"pair-sharded horizon {f_ps} vs replicated {f_pr}")
    return f_start, f_chain, f_repl, f_ps, f_pr


def _collective_model_step(rdtype, dev) -> dict:
    """Step 5 (rank 0 only): fit at (2, 4), hold out at 8, and on the card
    the predicted sp=4 speedup at 28q χ=128 from a T₁ measured here."""
    from ..ops import roofline
    from .collective_model import CHAIN28_MODEL, fit_chain_model, predicted_speedup, validate_chain_model

    circ, th, lvec, phi = _trotter_case(16, 2, 8, 2, 0.05, 5, 1e-10, rdtype, dev)
    model = fit_chain_model(circ, th, lvec, phi, (2, 4))
    held = validate_chain_model(model, circ, th, lvec, phi, 8)
    _check(model.a > 0 and model.b > 0, f"collective model without halo or pipeline terms: {model}")
    out = {"model": (model.a, model.b, model.bytes_a, model.bytes_b),
           "held_out_8": {k: held[k] for k in ("ppermute_pred", "ppermute_actual", "bytes_pred", "bytes_actual")}}
    if dev.type != "cuda":
        out["sp4_speedup_28q"] = "not measured: no card (T1 comes from an unsharded 28q sweep on the card)"
        return out
    from ..models.sp_lhs.jit_asp import _mps_value_fns

    c28, th28, t28, bits, thr = roofline.make_case(28, 128, 4, dev)
    _, value_and_grad = _mps_value_fns(c28, bits, thr)
    value_and_grad(th28, t28)
    torch.cuda.synchronize(dev)
    tic = time.perf_counter()
    for _ in range(3):
        value_and_grad(th28, t28)
    torch.cuda.synchronize(dev)
    t1 = (time.perf_counter() - tic) / 3
    out["t1_28q_s"] = t1
    out["sp4_speedup_28q"] = predicted_speedup(CHAIN28_MODEL, 4, t1)
    return out


def dryrun_multichip() -> dict:
    """Runs the dry run on this rank (the process group must be up or
    configured: see :func:`parallel.distributed.initialize_distributed`)."""
    from .. import config
    from .distributed import build_kernels_once, global_mesh, initialize_distributed, process_info

    if not initialize_distributed():
        raise RuntimeError("no process group is configured: start the dry run under torchrun")
    rank, world = process_info()
    dev = config.device()
    if dev.type == "cuda":
        config.set_precision("fast")
        build_kernels_once()
    dtype = config.complex_dtype()
    rdtype = config.real_dtype()
    dp = 2 if world % 2 == 0 else 1
    tp = world // dp
    sp = 4 if world % 4 == 0 else dp
    if tp & (tp - 1) or world > 8:
        raise ValueError(f"the dry run takes 1, 2, 4 or 8 ranks, not {world}")
    dp_tp = global_mesh((dp, tp), ("dp", "tp"))
    dp_sp = global_mesh((world // sp, sp), ("dp", "sp"))
    thr = 1e-8
    tic = time.perf_counter()
    fobj = _fleet_step(dp_tp, dtype, dev)
    gnorm, grow_ov = _pair_sharded_obj_grad(dp_tp, rdtype, dev, thr)
    cgnorm, cobj = _chain_obj_grad(dp_sp, rdtype, dev, thr)
    f_start, f_chain, f_repl, f_ps, f_pr = _horizons(dp_tp, dp_sp, rdtype, dev, thr)
    collective = _collective_model_step(rdtype, dev) if rank == 0 else None
    summary = {
        "ranks": world, "backend": torch.distributed.get_backend(), "mesh": {"dp": dp, "tp": tp, "sp": sp},
        "fleet_fobj": [round(float(f), 6) for f in fobj], "pair_sharded_grad_norm": gnorm,
        "pair_sharded_growth_overlap": grow_ov, "chain_grad_norm": cgnorm, "chain_overlap": cobj,
        "chain_horizon": (f_start, f_chain, f_repl), "pair_sharded_horizon": (f_ps, f_pr),
        "collective_model": collective, "seconds": time.perf_counter() - tic,
    }
    if rank == 0:
        print(f"dryrun_multichip OK: {summary}", flush=True)
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run the ranks on the CPU over Gloo (c128)")
    args = parser.parse_args(argv)
    if args.cpu:
        os.environ["AQC_TORCH_DEVICE"] = "cpu"
        from .. import config

        config.set_device("cpu")
        torch.set_num_threads(1)
    try:
        dryrun_multichip()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
