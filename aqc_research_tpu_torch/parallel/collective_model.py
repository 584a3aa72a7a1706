"""Collective-cost model of the chain-sharded MPS engine (twin of
``aqc_research_tpu/parallel/collective_model.py``): the checkable formula
behind the multi-card scaling claims.

The chain-sharded engine (parallel/mps_chain.py) moves only O(χ²) halos
and pipeline environments; everything else is rank-local work.  Its
collective census is therefore AFFINE in the rank count P for a fixed
circuit:

    rounds(P) = a + b·P          bytes(P) = A + B·P

* the ``b·P`` term: each pipeline (``chain_dot`` and the L/R environment
  pipelines of the gradient co-sweep) hands a (χ_w, χ_z) boundary
  environment along all P ranks — P − 1 hops one after another;
* the ``a`` term: the halo rounds of each half-layer (two for a pair
  update, one for the pair environments) and the collectives, a count fixed
  by the circuit's layer structure.

The census (:func:`collective_census`) is taken by spies on the
collectives of ``parallel/comm.py`` (``torch.distributed``'s
``all_gather``, ``all_reduce``, ``broadcast`` and ``batch_isend_irecv``,
one call per point-to-point round) while the production obj+grad runs.
Every rank keeps a clock of (hops, bytes) along its longest chain of
communication: a point-to-point round is one hop and starts no earlier
than the rounds that sent it messages, a collective is one hop after the
last of its group arrives; a round's bytes are the larger of what the rank
sends and receives in it, a collective's its result.  ``rounds`` and
``bytes`` are each rank's clock at the end, maximum over the ranks: the
critical path, which a per-rank call count cannot see (a pipeline's middle
rank makes two calls however long the pipeline is).

:func:`fit_chain_model` counts the production ``mps_chain`` obj+grad at two
rank counts and :func:`validate_chain_model` checks the affine prediction
at a held-out third.  The count does not depend on the device, so both run
P Gloo processes on the CPU per count, on a machine with one card or four.
The port's dry run (``parallel/dryrun.py``) runs this fit and hold-out.

:func:`predicted_sweep_time` states the wall-clock model

    T(P) = T₁ · s(P) / P  +  rounds(P) · t_hop  +  bytes(P) / bw

where T₁ is the measured single-card sweep, s(P) ≥ 1 the decomposition
batch efficiency loss, and (t_hop, bw) a hop's latency and a link's
bandwidth: the card's NVLink.  JAX's parameter names stay
(``hop_latency_s``, ``ici_bytes_per_s``); their defaults are the H100's
datasheet link rate (NVLink 4, 450 GB/s each way) and an assumed 10 µs
hop, until a ping-pong between two cards (:func:`ping_pong`) calibrates
them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import queue
import shutil
import tempfile
import traceback
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

_SPIED = ("all_gather", "all_reduce", "broadcast", "batch_isend_irecv")
CENSUS_TIMEOUT_S = 300.0


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def _group_arg(args, kwargs, position: int):
    return kwargs.get("group", args[position] if len(args) > position else None)


def _group_ranks(group) -> tuple:
    if group is None or group is dist.group.WORLD:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


@contextlib.contextmanager
def collective_log():
    """Records, in order, every collective this rank calls through
    ``torch.distributed``: ``("p2p", sends, recvs)`` per
    ``batch_isend_irecv`` round (lists of (peer rank, bytes)) and
    ``(kind, group ranks, bytes)`` per all_gather (its gathered result),
    all_reduce and broadcast."""
    log: List[tuple] = []
    originals = {name: getattr(dist, name) for name in _SPIED}

    def spy(name):
        def call(*args, **kwargs):
            if name == "batch_isend_irecv":
                sends, recvs = [], []
                for op in args[0]:
                    side = sends if "isend" in getattr(op.op, "__name__", "") else recvs
                    side.append((int(op.peer), _nbytes(op.tensor)))
                log.append(("p2p", sends, recvs))
            elif name == "all_gather":
                log.append((name, _group_ranks(_group_arg(args, kwargs, 2)), len(args[0]) * _nbytes(args[1])))
            else:
                log.append((name, _group_ranks(_group_arg(args, kwargs, 2)), _nbytes(args[0])))
            return originals[name](*args, **kwargs)
        return call

    for name in _SPIED:
        setattr(dist, name, spy(name))
    try:
        yield log
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def collective_census(logs: Sequence[Sequence[tuple]]) -> Dict[str, int]:
    """The census of one program from every rank's :func:`collective_log`
    (rank order): ``rounds`` and ``bytes`` of the critical path (see the
    module docstring), and per kind the most calls any rank made
    (``p2p`` rounds, ``all_gather``, ``all_reduce``, ``broadcast``).
    Messages between two ranks match in the order they were sent; raises if
    the logs cannot all complete."""
    world = len(logs)
    clock = [(0, 0)] * world
    pos = [0] * world
    registered = [-1] * world
    sent: Dict[tuple, tuple] = {}  # (src, dst, k) -> (sender's clock at the round, bytes)
    n_sent: Dict[tuple, int] = {}
    n_recv: Dict[tuple, int] = {}
    n_coll: Dict[tuple, int] = {}
    arrived: Dict[tuple, dict] = {}
    while any(pos[r] < len(logs[r]) for r in range(world)):
        moved = False
        for r in range(world):
            while pos[r] < len(logs[r]):
                ev = logs[r][pos[r]]
                if ev[0] == "p2p":
                    _, sends, recvs = ev
                    if registered[r] != pos[r]:
                        for dst, nb in sends:
                            k = n_sent.get((r, dst), 0)
                            sent[(r, dst, k)] = (clock[r], nb)
                            n_sent[(r, dst)] = k + 1
                        registered[r] = pos[r]
                    keys, seen = [], {}
                    for src, _ in recvs:
                        k = n_recv.get((src, r), 0) + seen.get(src, 0)
                        seen[src] = seen.get(src, 0) + 1
                        keys.append((src, r, k))
                    if not all(k in sent for k in keys):
                        break
                    own = max(sum(nb for _, nb in sends), sum(nb for _, nb in recvs))
                    best = (clock[r][0] + 1, clock[r][1] + own)
                    for key in keys:
                        (h, b), nb = sent.pop(key)
                        best = max(best, (h + 1, b + nb))
                    for src, n in seen.items():
                        n_recv[(src, r)] = n_recv.get((src, r), 0) + n
                    clock[r] = best
                else:
                    _, ranks, nb = ev
                    k = n_coll.get((ranks, r), 0)
                    here = arrived.setdefault((ranks, k), {})
                    here[r] = clock[r]
                    if len(here) < len(ranks):
                        break
                    h, b = max(here.values())
                    clock[r] = (h + 1, b + nb)
                    n_coll[(ranks, r)] = k + 1
                pos[r] += 1
                moved = True
        if not moved:
            raise RuntimeError(f"the collective logs deadlock at positions {pos}")
    counts = {kind: max(sum(1 for ev in log if ev[0] == kind) for log in logs) for kind in ("p2p",) + _SPIED[:3]}
    return {"rounds": max(c[0] for c in clock), "bytes": max(c[1] for c in clock), **counts}


# ------------------------------------------------------- the census ranks


def _census_rank(rank: int, world: int, store_path: str, cases, results) -> None:
    """One Gloo rank of :func:`chain_census`: runs the chain obj+grad on each
    case under :func:`collective_log` and sends back the logs."""
    os.environ["AQC_TORCH_DEVICE"] = "cpu"
    try:
        from .. import config
        from ..ops.mps import MPS
        from .mesh import make_mesh
        from .mps_chain import chain_asp_objective_and_gradient, chain_from_mps

        config.set_device("cpu")
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
        mesh = make_mesh((world,), ("sp",))
        logs = []
        for circ, thetas, lvec, phi, kwargs in cases:
            cl = chain_from_mps(MPS(torch.as_tensor(lvec[0]), torch.as_tensor(lvec[1])), mesh)
            cp = chain_from_mps(MPS(torch.as_tensor(phi[0]), torch.as_tensor(phi[1])), mesh)
            with collective_log() as log:
                chain_asp_objective_and_gradient(circ, torch.as_tensor(thetas), cl, cp, mesh, **kwargs)
            logs.append(log)
        results.put((rank, True, logs))
        dist.destroy_process_group()
    except Exception:  # the parent raises the traceback
        results.put((rank, False, traceback.format_exc()))


def _as_numpy_mps(mps):
    return mps.gammas.detach().cpu().numpy(), mps.lambdas.detach().cpu().numpy()


def chain_census(circ, thetas, lvec, phi, ndev: int, **kwargs) -> Dict[str, int]:
    """The collective census of the production chain obj+grad
    (``mps_chain.chain_asp_objective_and_gradient``, ``kwargs`` passed on)
    over ``ndev`` Gloo ranks on the CPU (see :func:`collective_census`)."""
    return _chain_censuses([(circ, thetas, lvec, phi, kwargs)], ndev)[0]


def _chain_censuses(cases, ndev: int) -> List[Dict[str, int]]:
    """The census of each (circ, thetas, lvec, phi, kwargs) case, in one
    pool of ``ndev`` spawned Gloo processes."""
    payload = [(circ, np.asarray(torch.as_tensor(th).detach().cpu()), _as_numpy_mps(lv), _as_numpy_mps(ph), kw)
               for circ, th, lv, ph, kw in cases]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="aqc_census_")
    procs = [ctx.Process(target=_census_rank, args=(r, ndev, os.path.join(store, "store"), payload, results),
                         daemon=True) for r in range(ndev)]
    for p in procs:
        p.start()
    logs: List = [None] * ndev
    errors = []
    try:
        for _ in range(ndev):
            try:
                rank, ok, val = results.get(timeout=CENSUS_TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError(f"a census rank sent nothing within {CENSUS_TIMEOUT_S} s") from None
            if ok:
                logs[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        shutil.rmtree(store, ignore_errors=True)
    if errors:
        raise RuntimeError("the chain census failed:\n" + "\n".join(errors))
    return [collective_census([logs[r][i] for r in range(ndev)]) for i in range(len(cases))]


# ------------------------------------------------------------------ model


@dataclasses.dataclass(frozen=True)
class ChainCollectiveModel:
    """Affine census model of the chain-sharded obj+grad program.

    ``ppermutes(P) = a + b*P`` counts the critical path's rounds (point-to-
    point rounds and collectives, the name kept from the JAX package's
    collective-permutes); ``bytes(P) = A + B*P`` its payload bytes.
    ``psums`` is the P-independent all-reduce count.
    """

    a: float
    b: float
    bytes_a: float
    bytes_b: float
    psums: int

    def ppermutes(self, ndev: int) -> float:
        return self.a + self.b * ndev

    def bytes_moved(self, ndev: int) -> float:
        return self.bytes_a + self.bytes_b * ndev


def _affine(p1: int, c1: Dict[str, float], p2: int, c2: Dict[str, float]) -> ChainCollectiveModel:
    b = (c2["rounds"] - c1["rounds"]) / (p2 - p1)
    bb = (c2["bytes"] - c1["bytes"]) / (p2 - p1)
    return ChainCollectiveModel(a=c1["rounds"] - b * p1, b=b, bytes_a=c1["bytes"] - bb * p1, bytes_b=bb,
                                psums=int(c1["all_reduce"]))


def fit_chain_model(
    circ, thetas, lvec, phi, device_counts: Sequence[int] = (2, 4),
) -> ChainCollectiveModel:
    """Fits the affine census model from the census of the production chain
    obj+grad at two rank counts (exact 2-point solve; the affine form is
    the claim :func:`validate_chain_model` checks at a third count)."""
    p1, p2 = sorted(int(p) for p in device_counts)
    if not p1 < p2:
        raise ValueError(f"two distinct rank counts expected, got {device_counts}")
    return _affine(p1, chain_census(circ, thetas, lvec, phi, p1), p2, chain_census(circ, thetas, lvec, phi, p2))


def validate_chain_model(
    model: ChainCollectiveModel, circ, thetas, lvec, phi, ndev: int,
    *, rel_tol: float = 0.05,
) -> Dict[str, float]:
    """Checks the fitted model against the ACTUAL census at a held-out rank
    count: rounds within max(2, rel_tol), bytes within max(1 KiB, rel_tol).
    Returns the comparison; raises on a miss."""
    actual = chain_census(circ, thetas, lvec, phi, ndev)
    pred, got = model.ppermutes(ndev), actual["rounds"]
    pred_bytes, got_bytes = model.bytes_moved(ndev), actual["bytes"]
    ok_n = abs(pred - got) <= max(2, rel_tol * got)
    ok_b = abs(pred_bytes - got_bytes) <= max(1024, rel_tol * got_bytes)
    result = {
        "ndev": ndev,
        "ppermute_pred": pred, "ppermute_actual": got,
        "bytes_pred": pred_bytes, "bytes_actual": got_bytes,
        "all_reduce_actual": actual["all_reduce"],
    }
    if not (ok_n and ok_b):
        raise AssertionError(f"collective model miss: {result}")
    return result


# The small bond dimensions whose counts fix the chain's bytes as a
# quadratic in χ (three points), on c64 product states.
CHAIN_FIT_CHIS = (4, 8, 16)


def chain_model_at(circ, thetas, chi: int) -> ChainCollectiveModel:
    """The model of the chain obj+grad of ``circ`` at bond dimension ``chi``,
    fitted at 2 and 4 ranks from counts at the small ``CHAIN_FIT_CHIS`` (c64
    product states): the chain's shapes are static in χ, so its rounds do
    not depend on χ (checked across them), and every message is a scalar,
    a λ (χ) or a Γ or environment (χ²), so its bytes are a quadratic in χ,
    solved exactly from three counts per rank count and read at ``chi``."""
    from ..ops.mps import mps_basis_state

    bits = tuple(1 if q % 2 == 0 else 0 for q in range(circ.num_qubits))
    th = torch.as_tensor(thetas).to(torch.float32)
    c64 = torch.complex64
    counts = {}
    for p in (2, 4):
        got = _chain_censuses(
            [(circ, th, mps_basis_state(bits, c, c64, "cpu"), mps_basis_state(bits, c, c64, "cpu"), {})
             for c in CHAIN_FIT_CHIS], p)
        if len({c["rounds"] for c in got}) != 1:
            raise RuntimeError(f"the chain's rounds changed with chi at P={p}: {got}")
        coef = np.polyfit(np.asarray(CHAIN_FIT_CHIS, float), np.asarray([c["bytes"] for c in got], float), 2)
        counts[p] = dict(got[0], bytes=float(np.rint(np.polyval(coef, float(chi)))))
    (p1, c1), (p2, c2) = sorted(counts.items())
    return _affine(p1, c1, p2, c2)


def chain28_model() -> ChainCollectiveModel:
    """:func:`chain_model_at` for BASELINE config 5's chain obj+grad: 28
    qubits, the 4-layer 2nd-order Trotter ansatz, χ=128, c64, fitted at 2
    and 4 ranks (28 sites do not divide over 8)."""
    from ..circuit.ansatz import TrotterAnsatz
    from ..circuit.structures import make_trotter_like_circuit

    circ = TrotterAnsatz.make(28, make_trotter_like_circuit(28, 4), True)
    return chain_model_at(circ, torch.zeros(circ.num_thetas), 128)


# chain28_model() as ``python -m aqc_research_tpu_torch.parallel.collective_model``
# counts it (a CPU count; tests/test_torch_collective_model.py holds it).
CHAIN28_MODEL = ChainCollectiveModel(a=7.0, b=26.0, bytes_a=-3658968.0, bytes_b=8329984.0, psums=1)

# Link bandwidth and hop latency: the H100's NVLink 4 datasheet rate (450
# GB/s each way) and an assumed 10 µs hop, until ping_pong calibrates them.
NVLINK_BYTES_PER_S = 450e9
HOP_LATENCY_S = 10e-6


def predicted_sweep_time(
    model: ChainCollectiveModel,
    ndev: int,
    single_chip_sweep_s: float,
    *,
    hop_latency_s: float = HOP_LATENCY_S,
    ici_bytes_per_s: float = NVLINK_BYTES_PER_S,
    svd_batch_efficiency: float = 1.0,
) -> float:
    """The stated wall-clock formula:

    ``T(P) = T₁·s(P)/P + rounds(P)·t_hop + bytes(P)/bw``.

    ``hop_latency_s`` and ``ici_bytes_per_s`` are the card's NVLink hop and
    bandwidth (the JAX package's ICI names); ``svd_batch_efficiency`` =
    s(P) ≥ 1 models the decomposition straggler loss."""
    compute = single_chip_sweep_s * svd_batch_efficiency / ndev
    comm = (
        model.ppermutes(ndev) * hop_latency_s
        + model.bytes_moved(ndev) / ici_bytes_per_s
    )
    return compute + comm


def predicted_speedup(
    model: ChainCollectiveModel,
    ndev: int,
    single_chip_sweep_s: float,
    **kw,
) -> float:
    """``T₁ / T(P)`` under :func:`predicted_sweep_time`."""
    return single_chip_sweep_s / predicted_sweep_time(
        model, ndev, single_chip_sweep_s, **kw
    )


def ping_pong(ax, nbytes: int, reps: int = 20) -> float:
    """Seconds of one hop between positions 0 and 1 of the axis ``ax``
    (``comm.axis_of``): half the mean round trip of ``reps`` exchanges of
    ``nbytes`` (uint8) after one warm-up, on the device of
    ``config.device()``.  Every rank of the axis calls it: all join a first
    broadcast (NCCL wants a group's first call to hold all its ranks, not
    a point-to-point round of two), and the others wait at the final one.
    Returns the same value on every rank."""
    import time

    from .. import config
    from .comm import broadcast, p2p_round

    dev = config.device()
    buf = torch.zeros(max(int(nbytes), 1), dtype=torch.uint8, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def trip():
        if ax.index == 0:
            p2p_round([(buf, 1)], [], ax)
            p2p_round([], [(buf, 1)], ax)
        elif ax.index == 1:
            got = p2p_round([], [(buf, 0)], ax)[0]
            p2p_round([(got, 0)], [], ax)

    broadcast(buf[:1], 0, ax)
    trip()
    sync()
    tic = time.perf_counter()
    for _ in range(reps):
        trip()
    sync()
    hop = torch.tensor([(time.perf_counter() - tic) / reps / 2], dtype=torch.float64, device=dev)
    return float(broadcast(hop, 0, ax)[0])


if __name__ == "__main__":
    print(chain28_model())
