"""The port's multi-GPU layer on ``torch.distributed`` over Gloo CPU ranks,
held against the JAX package's single-controller twins on the conftest's
virtual CPU devices, in complex128 within 1e-10 (the state compared by its
bond spectra and overlaps, not by raw Γ):

* ``apply_pairs_mps_sharded`` at tp = 2 and 4 on 4 pairs and on 3 (the
  padded path), against the JAX package's ``apply_pairs_mps_sharded``;
  one ``all_gather`` of the updated slices only;
* the pair-sharding policy over a whole obj+grad of the port's MPS
  objective against the JAX package's replicated ``value_and_grad``;
* ``v_mul_vec_tp``, ``v_dagger_mul_vec_tp`` and ``pauli_dot_tp`` at tp = 2
  and 4, with local, mixed and both-sharded blocks, against JAX's;
* ``multistart_minimize(mesh=dp2)`` against JAX's ``mesh=`` run;
* the replication invariant: every rank's result is bitwise the same;
* the runtime: ``initialize_distributed`` is a no-op without a
  coordinator and starts a two-process Gloo group from torchrun's
  variables; a rank that raises cannot hang the other (the group's
  timeout); ``global_mesh`` puts the dcn axis outermost.

The port side runs in Gloo worker processes (tests/_torch_gloo.py), one
pool per world size for the whole file."""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.models.sp_lhs import jit_asp as jja
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.ops import statevector as jsv
from aqc_research_tpu.parallel import multistart as jms
from aqc_research_tpu.parallel import statevector_tp as jtp
from aqc_research_tpu.parallel.mps_sharded import apply_pairs_mps_sharded
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.parallel import distributed as td
from aqc_research_tpu_torch.parallel import multistart as tms
from tests._torch_gloo import GlooPool, assert_bitwise_same, run_from_env
from tests import _torch_threads  # noqa: F401

TOL = 1e-10
TOL_RUN = 1e-8  # an L-BFGS run of either package (tests/test_torch_fleet.py)
WORLDS = (2, 4)
TASKS = "tests._torch_dist_tasks"


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    previous = config._DEVICE
    config.set_device("cpu")
    jcfg.set_svd_impl("native")
    yield
    jcfg.set_svd_impl(None)
    config.set_device(previous)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    directory = tmp_path_factory.mktemp("gloo")
    made = {w: GlooPool(w, directory) for w in WORLDS}
    yield made
    for pool in made.values():
        pool.close()


def _jmesh(size: int, axis: str) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:size]), (axis,))



def _unitaries(count: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((count, 4, 4)) + 1j * rng.standard_normal((count, 4, 4))
    return np.stack([np.linalg.qr(x)[0] for x in a])


def _overlap(g1, l1, g2, l2) -> complex:
    return complex(jm.mps_dot(jm.MPS(jnp.asarray(g1), jnp.asarray(l1)), jm.MPS(jnp.asarray(g2), jnp.asarray(l2))))


# -----------------------------------------------------------------------------
# Pair-sharded MPS engine.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("los", [(0, 2, 4, 6), (1, 3, 5)], ids=["4pairs", "3pairs_padded"])
def test_pair_sharded_matches_jax(pools, world, los):
    n, chi, thr = 8, 8, 1e-12
    mps = jm.rand_mps_vec(n, num_layers=2, chi_max=chi)
    gates = _unitaries(len(los), seed=len(los))
    want = apply_pairs_mps_sharded(mps, jnp.asarray(gates), los, _jmesh(world, "tp"), trunc_thr=thr)
    got = pools[world].run(f"{TASKS}:pairs_sharded", np.asarray(mps.gammas), np.asarray(mps.lambdas), gates, los,
                           thr)
    assert_bitwise_same(got, "gammas")
    assert_bitwise_same(got, "lambdas")
    g, lam = got[0]["gammas"], got[0]["lambdas"]
    wg, wl = np.asarray(want.gammas), np.asarray(want.lambdas)
    np.testing.assert_allclose(lam, wl, atol=TOL, rtol=0)
    norm = _overlap(wg, wl, wg, wl).real
    assert abs(_overlap(g, lam, wg, wl) - norm) <= TOL
    assert abs(_overlap(g, lam, g, lam) - norm) <= TOL
    # One all_gather per half-layer, of this rank's updated slices only.
    k = -(-len(los) // world)
    for r in got:
        c = r["census"]
        assert c["counts"]["all_gather"] == 1 and c["elements"]["all_gather"] == [k * (8 * chi * chi + chi)]
        assert c["counts"]["batch_isend_irecv"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_pair_sharding_policy_obj_grad_matches_jax(pools, world):
    """Every half-layer of a whole obj+grad (the V† sweep with its layer
    cache, the z-cached co-sweep with grow_w, the χ-growth value sweep)
    through the sharded update: fobj, gradient and value against the JAX
    package's replicated ``value_and_grad``; one all_gather per sharded
    half-layer, none of a whole Γ."""
    n, chi, thr = 8, 8, 1e-10
    jc = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, 2), True)
    th = np.asarray(jtrot.init_ansatz_to_trotter(jc, np.zeros(jc.num_thetas), evol_time=0.8, delta=1.0))
    th = th + 0.1 * np.random.default_rng(13).standard_normal(jc.num_thetas)
    target = jtrot.Trotter(num_qubits=n, evol_time=0.8, num_steps=2, delta=1.0, second_order=True).as_mps(
        jtrot.neel_init_state(n), trunc_thr=thr, chi_max=chi)
    bits = tuple(int(q % 2 == 0) for q in range(n))
    jv, jvg = jja._mps_value_fns(jc, bits, thr)
    jf, jgr = jvg(jnp.asarray(th), target)
    got = pools[world].run(f"{TASKS}:policy_value_and_grad", interop.ansatz_args(jc), th,
                           np.asarray(target.gammas), np.asarray(target.lambdas), bits, thr)
    for key in ("fobj", "grad", "value"):
        assert_bitwise_same(got, key)
    r = got[0]
    assert abs(r["fobj"] - float(jf)) <= TOL and abs(r["value"] - float(jv(jnp.asarray(th), target))) <= TOL
    np.testing.assert_allclose(r["grad"], np.asarray(jgr), atol=TOL, rtol=0)
    c = r["census"]
    assert c["counts"]["all_gather"] > 0 and c["counts"]["batch_isend_irecv"] == 0
    whole_gamma = n * 2 * chi * chi * 2
    assert max(c["elements"]["all_gather"]) < whole_gamma


# -----------------------------------------------------------------------------
# Sharded statevector.
# -----------------------------------------------------------------------------

# Blocks on local pairs, across the shard boundary, on two sharded qubits
# (at tp = 4) and non-adjacent ones, n = 8.
_TP_BLOCKS = np.array([[0, 4, 6, 7, 2, 5, 7], [1, 5, 7, 6, 3, 6, 4]])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("entangler", ["cx", "cp"])
def test_tp_statevector_matches_jax(pools, world, entangler):
    n = 8
    jc = JAnsatz.make(n, entangler, _TP_BLOCKS)
    rng = np.random.default_rng(21)
    th = rng.uniform(-np.pi, np.pi, jc.num_thetas)
    state = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    state /= np.linalg.norm(state)
    mesh = _jmesh(world, "tp")
    sj = jax.device_put(jnp.asarray(state), NamedSharding(mesh, P("tp")))
    for dagger, fn in ((False, jtp.v_mul_vec_tp), (True, jtp.v_dagger_mul_vec_tp)):
        want = np.asarray(fn(jc, jnp.asarray(th), sj, mesh))
        got = pools[world].run(f"{TASKS}:tp_apply", interop.ansatz_args(jc), th, state, dagger)
        assert_bitwise_same(got, "state")
        np.testing.assert_allclose(got[0]["state"], want, atol=TOL, rtol=0)
        # One exchange per sharded-qubit touch, three for a block with both
        # qubits sharded: never a gather.
        assert got[0]["census"]["counts"]["all_gather"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_pauli_dot_tp_matches_jax(pools, world):
    n = 8
    rng = np.random.default_rng(22)
    w, z = (rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n) for _ in range(2))
    mesh = _jmesh(world, "tp")
    sh = NamedSharding(mesh, P("tp"))
    wj, zj = jax.device_put(jnp.asarray(w), sh), jax.device_put(jnp.asarray(z), sh)
    # Each Pauli on the top (sharded) qubit and Y one below it against the
    # JAX package's pauli_dot_tp (an eager shard_map: ~1.3 s a call here);
    # the local qubit against its replicated pauli_dot.
    for pauli, qubit in (("x", 7), ("y", 7), ("z", 7), ("y", 6), ("x", 1), ("y", 1), ("z", 1)):
        if qubit == 1:
            want = complex(jsv.pauli_dot(jnp.asarray(w), jnp.asarray(z), pauli, qubit))
        else:
            want = complex(jtp.pauli_dot_tp(wj, zj, pauli, qubit, mesh))
        got = pools[world].run(f"{TASKS}:tp_pauli", w, z, pauli, qubit)
        assert len(set(got)) == 1, "pauli_dot_tp differs across ranks"
        assert abs(got[0] - want) <= TOL, (pauli, qubit)


# -----------------------------------------------------------------------------
# Sharded multi-start.
# -----------------------------------------------------------------------------


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


@pytest.mark.parametrize("method", ["lbfgs", "adam"])
def test_multistart_dp2_matches_jax(pools, method):
    x0 = np.random.default_rng(5).uniform(-2.0, 2.0, (4, 3))
    want = jms.multistart_minimize(_rosen_j, jnp.asarray(x0), method=method, maxiter=30, learn_rate=0.05,
                                   mesh=_jmesh(2, "dp"), batch_axis="dp")
    got = pools[2].run(f"{TASKS}:multistart_dp", x0, method, 30)
    for key in ("thetas", "fobj", "num_iters", "best_index"):
        assert_bitwise_same(got, key)
    r = got[0]
    np.testing.assert_allclose(r["fobj"], np.asarray(want.fobj), atol=TOL_RUN, rtol=0)
    np.testing.assert_allclose(r["thetas"], np.asarray(want.thetas), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(r["num_iters"], np.asarray(want.num_iters))
    assert r["best_index"] == int(want.best_index)
    # The rows are each rank's own fleet: the same as the unsharded fleet.
    alone = tms.multistart_minimize(lambda x: torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2),
                                    torch.as_tensor(x0), method=method, maxiter=30, learn_rate=0.05)
    np.testing.assert_array_equal(r["fobj"], alone.fobj.numpy())


def test_multistart_rejects_an_uneven_batch(pools):
    with pytest.raises(RuntimeError, match="does not divide"):
        pools[2].run(f"{TASKS}:multistart_dp", np.zeros((3, 2)), "lbfgs", 2)


# -----------------------------------------------------------------------------
# The distributed runtime.
# -----------------------------------------------------------------------------


def test_initialize_distributed_is_a_noop_without_coordinator(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "AQC_TPU_COORDINATOR",
                "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert td.initialize_distributed() is False
    assert td.process_info() == (0, 1) and not td.is_multiprocess()
    assert td.backend_for(torch.device("cpu")) == "gloo" and td.backend_for(torch.device("cuda", 0)) == "nccl"


def test_initialize_distributed_from_torchrun_env():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    envs = [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(r),
             "LOCAL_RANK": str(r), "AQC_TORCH_DEVICE": "cpu"} for r in range(2)]
    got = run_from_env(f"{TASKS}:env_group", envs)
    for rank, r in enumerate(got):
        assert r["engaged"] and r["info"] == (rank, 2) and r["multi"]
        assert r["backend"] == "gloo" and r["mesh"] == [0, 1] and r["sum"] == 1.0


def test_a_failing_rank_cannot_hang_the_group():
    """initialize_distributed's timeout: when rank 1 raises, rank 0's
    collective fails too instead of waiting forever."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    envs = [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(r),
             "AQC_TORCH_DEVICE": "cpu"} for r in range(2)]
    tic = time.monotonic()
    with pytest.raises(RuntimeError, match="failed on 2 rank") as err:
        run_from_env(f"{TASKS}:failing_rank", envs, timeout_s=60)
    assert "rank 1 fails before the collective" in str(err.value)
    assert time.monotonic() - tic < 60


@pytest.mark.parametrize("dcn_axis", ["dp", "tp"])
def test_global_mesh_layout(pools, dcn_axis):
    got = pools[4].run(f"{TASKS}:mesh_layout", dcn_axis)
    if dcn_axis == "dp":  # dp outermost: each tp group is two neighbouring ranks
        assert got[0]["grid"] == [[0, 1], [2, 3]]
        assert [r["tp"] for r in got] == [(0, 1), (0, 1), (2, 3), (2, 3)]
        assert [r["dp"] for r in got] == [(0, 2), (1, 3), (0, 2), (1, 3)]
    else:
        assert got[0]["grid"] == [[0, 2], [1, 3]]
        assert [r["dp"] for r in got] == [(0, 1), (0, 1), (2, 3), (2, 3)]
