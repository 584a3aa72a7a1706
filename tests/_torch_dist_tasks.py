"""Per-rank functions of the port's multi-rank CPU tests (run by
``tests/_torch_gloo.GlooPool`` in Gloo workers).  They import torch and the
port only, take numpy inputs and return numpy results, plus a census of the
collectives each call made (a spy on ``torch.distributed``)."""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from aqc_research_tpu_torch import interop
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.parallel.mesh import make_mesh

_SPIED = ("all_gather", "all_reduce", "broadcast", "batch_isend_irecv")


@contextlib.contextmanager
def census():
    """Counts the calls of each spied collective and the elements each moved
    (``all_gather``: the elements one rank contributes; P2P rounds: the
    elements of every message this rank sends or receives)."""
    counts: Dict[str, int] = {name: 0 for name in _SPIED}
    elements: Dict[str, list] = {name: [] for name in _SPIED}
    originals = {name: getattr(dist, name) for name in _SPIED}

    def spy(name):
        def call(*args, **kwargs):
            counts[name] += 1
            first = args[0]
            if name == "all_gather":
                elements[name].append(int(args[1].numel()))
            elif name == "batch_isend_irecv":
                elements[name].append(sum(int(op.tensor.numel()) for op in first))
            else:
                elements[name].append(int(first.numel()))
            return originals[name](*args, **kwargs)
        return call

    for name in _SPIED:
        setattr(dist, name, spy(name))
    try:
        yield {"counts": counts, "elements": elements}
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def _mesh(axis: str):
    return make_mesh((dist.get_world_size(),), (axis,))


def _mps(gammas, lambdas) -> tm.MPS:
    return tm.MPS(torch.as_tensor(gammas), torch.as_tensor(lambdas))


def _np_mps(mps) -> dict:
    return {"gammas": mps.gammas.numpy(), "lambdas": mps.lambdas.numpy()}


# -----------------------------------------------------------------------------
# Pair-sharded engine.
# -----------------------------------------------------------------------------


def pairs_sharded(gammas, lambdas, gates4, lo_sites, trunc_thr):
    from aqc_research_tpu_torch.parallel.mps_sharded import apply_pairs_mps_sharded

    tm_config_native()
    mesh = _mesh("tp")
    with census() as c:
        out = apply_pairs_mps_sharded(_mps(gammas, lambdas), torch.as_tensor(gates4), tuple(lo_sites), mesh,
                                      trunc_thr=trunc_thr)
    return dict(_np_mps(out), census=c)


def tm_config_native():
    from aqc_research_tpu_torch import config

    config.set_svd_impl("native")


def policy_value_and_grad(circ_args, thetas, t_gammas, t_lambdas, base_bits, trunc_thr):
    """The port's MPS obj+grad (``jit_asp._mps_value_fns``) with every
    half-layer sharded over the pairs, and its value."""
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp

    tm_config_native()
    circ = interop.ansatz_from_args(circ_args)
    value, value_and_grad = jit_asp._mps_value_fns(circ, tuple(base_bits), trunc_thr)
    tgt = _mps(t_gammas, t_lambdas)
    th = torch.as_tensor(thetas)
    tm.set_pair_sharding(_mesh("tp"), "tp")
    try:
        with census() as c:
            f, g = value_and_grad(th, tgt)
        v = value(th, tgt)
    finally:
        tm.set_pair_sharding(None)
    return {"fobj": float(f), "grad": g.numpy(), "value": float(v), "census": c}


# -----------------------------------------------------------------------------
# Sharded statevector.
# -----------------------------------------------------------------------------


def tp_apply(circ_args, thetas, state, dagger: bool):
    from aqc_research_tpu_torch.parallel.comm import all_gather, axis_of
    from aqc_research_tpu_torch.parallel.mesh import shard_state
    from aqc_research_tpu_torch.parallel.statevector_tp import v_dagger_mul_vec_tp, v_mul_vec_tp

    mesh = _mesh("tp")
    circ = interop.ansatz_from_args(circ_args)
    local = shard_state(torch.as_tensor(state), mesh)
    fn = v_dagger_mul_vec_tp if dagger else v_mul_vec_tp
    with census() as c:
        out = fn(circ, torch.as_tensor(thetas), local, mesh)
    full = all_gather(out, axis_of(mesh, "tp")).reshape(-1)
    return {"state": full.numpy(), "census": c}


def tp_pauli(w, z, pauli: str, qubit: int):
    from aqc_research_tpu_torch.parallel.mesh import shard_state
    from aqc_research_tpu_torch.parallel.statevector_tp import pauli_dot_tp

    mesh = _mesh("tp")
    wl, zl = shard_state(torch.as_tensor(w), mesh), shard_state(torch.as_tensor(z), mesh)
    return complex(pauli_dot_tp(wl, zl, pauli, qubit, mesh))


# -----------------------------------------------------------------------------
# Site-sharded (chain) engine.
# -----------------------------------------------------------------------------


def _chain(gammas, lambdas, mesh):
    from aqc_research_tpu_torch.parallel.mps_chain import chain_from_mps

    return chain_from_mps(_mps(gammas, lambdas), mesh)


def _gathered(cmps, mesh) -> dict:
    from aqc_research_tpu_torch.parallel.mps_chain import chain_to_mps

    return _np_mps(chain_to_mps(cmps, mesh))


def chain_dot(a, b):
    """``a``, ``b``: (gammas, lambdas) of two replicated MPS."""
    from aqc_research_tpu_torch.parallel import mps_chain as mc

    mesh = _mesh("sp")
    ca, cb = _chain(*a, mesh), _chain(*b, mesh)
    with census() as c:
        val = mc.chain_dot(ca, cb, mesh)
    return {"dot": complex(val), "norm": float(mc.chain_norm(ca, mesh)),
            "bytes": mc.chain_bytes_per_device(ca, mesh), "census": c}


def chain_apply_pairs(gammas, lambdas, gates4, lo_sites, trunc_thr):
    from aqc_research_tpu_torch.parallel import mps_chain as mc

    tm_config_native()
    mesh = _mesh("sp")
    cm = _chain(gammas, lambdas, mesh)
    dense, active, parity = mc.pairs_to_dense(cm.num_sites, torch.as_tensor(gates4), lo_sites, cm.gammas.dtype)
    with census() as c:
        out = mc.chain_apply_pairs(cm, dense, active, parity, mesh, trunc_thr=trunc_thr)
    return dict(_gathered(out, mesh), census=c)


def chain_env_stacks(w, z):
    from aqc_research_tpu_torch.parallel import mps_chain as mc
    from aqc_research_tpu_torch.parallel.comm import all_gather, axis_of

    mesh = _mesh("sp")
    ax = axis_of(mesh, "sp")
    l_blk, r_blk = mc.chain_env_stacks(_chain(*w, mesh), _chain(*z, mesh), mesh)
    return {"l": all_gather(l_blk, ax).flatten(0, 1).numpy(), "r": all_gather(r_blk, ax).flatten(0, 1).numpy()}


def chain_gradient(circ_args, thetas, lvec, vh, trunc_thr, block_range=None, front_layer=True):
    from aqc_research_tpu_torch.parallel import mps_chain as mc

    tm_config_native()
    mesh = _mesh("sp")
    circ = interop.ansatz_from_args(circ_args)
    with census() as c:
        g = mc.chain_fast_dot_gradient(circ, torch.as_tensor(thetas), _chain(*lvec, mesh), _chain(*vh, mesh), mesh,
                                       trunc_thr=trunc_thr, block_range=block_range, front_layer=front_layer)
    return {"grad": g.numpy(), "census": c}


def chain_v_dagger(circ_args, thetas, phi, trunc_thr):
    from aqc_research_tpu_torch.parallel import mps_chain as mc

    tm_config_native()
    mesh = _mesh("sp")
    circ = interop.ansatz_from_args(circ_args)
    out = mc.chain_v_dagger_mul_mps(circ, torch.as_tensor(thetas), _chain(*phi, mesh), mesh, trunc_thr=trunc_thr)
    return _gathered(out, mesh)


def chain_objective(circ_args, thetas, lvec, phi, trunc_thr):
    from aqc_research_tpu_torch.parallel import mps_chain as mc

    tm_config_native()
    mesh = _mesh("sp")
    circ = interop.ansatz_from_args(circ_args)
    f, g = mc.chain_asp_objective_and_gradient(circ, torch.as_tensor(thetas), _chain(*lvec, mesh),
                                               _chain(*phi, mesh), mesh, trunc_thr=trunc_thr)
    return {"fobj": f.numpy(), "grad": g.numpy()}


def chain_horizon(circ_args, thetas, lvec, phi, trunc_thr, maxiter):
    from aqc_research_tpu_torch.parallel import mps_chain as mc

    tm_config_native()
    mesh = _mesh("sp")
    circ = interop.ansatz_from_args(circ_args)
    res = mc.chain_optimize_horizon(circ, torch.as_tensor(thetas), _chain(*lvec, mesh), _chain(*phi, mesh), mesh,
                                    trunc_thr=trunc_thr, maxiter=maxiter)
    return {"thetas": res.thetas.numpy(), "fobj": res.fobj.numpy(), "num_iters": int(res.num_iters)}


# -----------------------------------------------------------------------------
# Sharded multi-start.
# -----------------------------------------------------------------------------


def rosen(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def multistart_dp(x0, method: str, maxiter: int):
    from aqc_research_tpu_torch.parallel.multistart import multistart_minimize

    with census() as c:
        res = multistart_minimize(rosen, torch.as_tensor(x0), method=method, maxiter=maxiter, learn_rate=0.05,
                                  mesh=_mesh("dp"))
    return {"thetas": res.thetas.numpy(), "fobj": res.fobj.numpy(), "num_iters": np.asarray(res.num_iters),
            "best_index": res.best_index, "census": c}


# -----------------------------------------------------------------------------
# The distributed runtime.
# -----------------------------------------------------------------------------


def env_group():
    """``initialize_distributed()`` from torchrun's variables alone; the
    group's shape and the meshes ``global_mesh`` makes over it."""
    from aqc_research_tpu_torch.parallel import distributed as td

    torch.set_num_threads(1)
    engaged = td.initialize_distributed(timeout_s=60)
    try:
        rank, world = td.process_info()
        mesh = td.global_mesh((world,), ("dp",))
        t = torch.tensor([float(rank)])
        dist.all_reduce(t)
        return {"engaged": engaged, "info": (rank, world), "multi": td.is_multiprocess(),
                "backend": dist.get_backend(), "mesh": mesh.mesh.tolist(), "sum": float(t)}
    finally:
        dist.destroy_process_group()


def failing_rank():
    """Rank 1 raises; rank 0 then waits in an all-reduce for a rank that is
    gone, which must fail within the group's timeout, not hang."""
    from aqc_research_tpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(timeout_s=10)
    try:
        if dist.get_rank() == 1:
            raise RuntimeError("rank 1 fails before the collective")
        t = torch.ones(1)
        dist.all_reduce(t)
        return float(t)
    finally:
        dist.destroy_process_group()


def mesh_layout(dcn_axis: str):
    """``global_mesh((2, W // 2), ("dp", "tp"))``: the ranks along each axis
    as this rank sees them."""
    from aqc_research_tpu_torch.parallel.comm import axis_of
    from aqc_research_tpu_torch.parallel.distributed import global_mesh

    world = dist.get_world_size()
    mesh = global_mesh((2, world // 2), ("dp", "tp"), dcn_axis=dcn_axis)
    return {"grid": mesh.mesh.tolist(), "dp": axis_of(mesh, "dp").ranks, "tp": axis_of(mesh, "tp").ranks}


def build_once(directory: str):
    """``build_kernels_once`` with the kernel library missing: the real
    ``cuda_build.build_kernel_library`` into an empty build directory, with
    ``nvcc`` replaced by a script that logs its caller's pid and writes its
    ``-o`` output, and ``load`` by a recorder of whether the library was
    there.  Returns this rank's pid and what ``load`` saw."""
    import os
    import stat
    from pathlib import Path

    from aqc_research_tpu_torch.ops import cuda_build
    from aqc_research_tpu_torch.parallel.distributed import build_kernels_once

    root = Path(directory)
    fake = root / "nvcc"
    if dist.get_rank() == 0:
        fake.write_text('#!/bin/sh\necho "$PPID" >> "' + str(root / "nvcc.log") + '"\n'
                        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then touch "$2"; fi; shift; done\n')
        fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    dist.barrier()
    original = cuda_build.BUILD_DIR, cuda_build._nvcc, cuda_build.load
    loads = []
    cuda_build.BUILD_DIR = root / "build"
    cuda_build._nvcc = lambda: str(fake)
    cuda_build.load = lambda: loads.append((root / "build" / f"libaqc_kernels_{cuda_build.source_digest()}.so").exists())
    try:
        build_kernels_once()
    finally:
        cuda_build.BUILD_DIR, cuda_build._nvcc, cuda_build.load = original
    return {"pid": os.getpid(), "loads": loads, "sources": len(list(cuda_build._CSRC.glob("*.cu")))}
