"""The port's site-sharded (chain) MPS engine over Gloo CPU ranks, in
complex128 within 1e-10:

* ``chain_dot`` at sp = 2 and 4 and a half-layer of each parity (even at
  sp = 2, odd with its block-straddling pairs at sp = 4) against the JAX
  package's chain engine, the other half-layers against its replicated
  ``apply_pairs_mps``; ``chain_bytes_per_device`` shrinks as 1/P;
* blocks of an odd number of sites (which the JAX chain engine refuses)
  against the JAX package's replicated engine;
* ``chain_env_stacks``, ``chain_fast_dot_gradient``,
  ``chain_v_dagger_mul_mps``, ``chain_asp_objective_and_gradient`` and
  ``chain_optimize_horizon`` against the JAX package's replicated engine
  (the engine tests/test_mps_chain.py pins the JAX chain engine to; the JAX
  chain sweep itself compiles for minutes here, so the direct comparison
  with it is one test marked slow);
* the replication invariant (every rank's result bitwise the same) and the
  collective census: at most 3 point-to-point rounds per half-layer, P
  rounds per ring contraction, one all-reduce per gradient.

The port side runs in Gloo worker processes (tests/_torch_gloo.py), one
pool per world size for the whole file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.ops import mps_gradient as jg
from aqc_research_tpu.parallel import mps_chain as jc_chain
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.optim.lbfgs import minimize_lbfgs_compact
from tests._torch_gloo import GlooPool, assert_bitwise_same
from tests import _torch_threads  # noqa: F401

TOL = 1e-10
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


def _jmesh(size: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:size]), ("sp",))


def _random_mps(rng, n: int, chi: int):
    v = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    return jm.mps_from_dense(v / np.linalg.norm(v), chi)


def _np(mps):
    return np.asarray(mps.gammas), np.asarray(mps.lambdas)


def _jmps(d):
    return jm.MPS(jnp.asarray(d["gammas"]), jnp.asarray(d["lambdas"]))



def _trotter_case(n: int, chi: int, layers: int, seed: int, perturb: float = 0.1):
    """tests/test_mps_chain.py's horizon case: perturbed perfect init, Néel
    lvec, a 2nd-order Trotter target."""
    circ = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), True)
    th = np.asarray(jtrot.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=0.8, delta=1.0))
    th = th + perturb * np.random.default_rng(seed).standard_normal(circ.num_thetas)
    ini = jtrot.neel_init_state(n)
    phi = jtrot.Trotter(num_qubits=n, evol_time=0.8, num_steps=3, delta=1.0, second_order=True).as_mps(
        ini, trunc_thr=1e-10, chi_max=chi)
    return circ, th, jm.mps_from_program(ini, n, chi_max=chi), phi


# -----------------------------------------------------------------------------
# Against the JAX package's chain engine.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_chain_dot_matches_jax(pools, world):
    rng = np.random.default_rng(3)
    n, chi = 8, 8
    a, b = _random_mps(rng, n, chi), _random_mps(rng, n, chi)
    mesh = _jmesh(world)
    want = complex(jc_chain.chain_dot(jc_chain.chain_from_mps(a, mesh), jc_chain.chain_from_mps(b, mesh), mesh))
    got = pools[world].run(f"{TASKS}:chain_dot", _np(a), _np(b))
    assert len({r["dot"] for r in got}) == 1, "chain_dot differs across ranks"
    assert abs(got[0]["dot"] - want) <= TOL and abs(got[0]["dot"] - complex(jm.mps_dot(a, b))) <= TOL
    assert abs(got[0]["norm"] - float(jm.mps_norm(a))) <= TOL
    per_rank, whole = got[0]["bytes"]
    assert per_rank * world == whole
    # The ring: P rounds, P - 1 handoffs (a middle rank receives, then
    # sends), one broadcast of the product.
    for rank, r in enumerate(got):
        c = r["census"]["counts"]
        assert c["batch_isend_irecv"] == (rank > 0) + (rank < world - 1) and c["broadcast"] == 1


_EVEN, _ODD, _STRADDLE = (0, 2, 4, 6), (1, 3, 5), (3,)


@pytest.mark.parametrize("world, los, vs_chain", [
    (2, _EVEN, True), (4, _ODD, True), (2, _ODD, False), (4, _EVEN, False), (2, _STRADDLE, False),
    (4, _STRADDLE, False)], ids=["even-2-chain", "odd-4-chain", "odd-2", "even-4", "straddle_only-2",
                                 "straddle_only-4"])
def test_chain_apply_pairs_matches_jax(pools, world, los, vs_chain):
    """Against the JAX package's chain engine for one full half-layer of
    each parity (its chain update compiles for 15–45 s per case here), and
    against its replicated ``apply_pairs_mps`` (which tests/test_mps_chain.py
    pins its chain engine to) for the other cases."""
    rng = np.random.default_rng(7 + len(los))
    n, chi, thr = 8, 8, 1e-12
    mps = _random_mps(rng, n, chi)
    gates = np.stack([np.linalg.qr(x)[0] for x in
                      rng.standard_normal((len(los), 4, 4)) + 1j * rng.standard_normal((len(los), 4, 4))])
    if vs_chain:
        mesh = _jmesh(world)
        dense, active, parity = jc_chain.pairs_to_dense(n, jnp.asarray(gates), los, jnp.complex128)
        want = jc_chain.chain_to_mps(jc_chain.chain_apply_pairs(
            jc_chain.chain_from_mps(mps, mesh), dense, active, parity, mesh, trunc_thr=thr))
    else:
        want = jm.apply_pairs_mps(mps, jnp.asarray(gates), los, trunc_thr=thr)
    got = pools[world].run(f"{TASKS}:chain_apply_pairs", *_np(mps), gates, los, thr)
    assert_bitwise_same(got, "gammas")
    assert_bitwise_same(got, "lambdas")
    out = _jmps(got[0])
    np.testing.assert_allclose(np.asarray(out.lambdas), np.asarray(want.lambdas), atol=TOL, rtol=0)
    norm = complex(jm.mps_dot(want, want)).real
    assert abs(complex(jm.mps_dot(out, want)) - norm) <= TOL and abs(complex(jm.mps_dot(out, out)) - norm) <= TOL
    for r in got:  # at most 3 point-to-point rounds per half-layer
        assert r["census"]["counts"]["batch_isend_irecv"] <= 3
        assert r["census"]["counts"]["all_gather"] == 0


# -----------------------------------------------------------------------------
# Against the JAX package's replicated engine.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_chain_env_stacks_match_replicated(pools, world):
    rng = np.random.default_rng(11)
    w, z = _random_mps(rng, 8, 8), _random_mps(rng, 8, 8)
    _, _, left, right = jg._env_stacks(w, z)
    got = pools[world].run(f"{TASKS}:chain_env_stacks", _np(w), _np(z))
    assert_bitwise_same(got, "l")
    assert_bitwise_same(got, "r")
    np.testing.assert_allclose(got[0]["l"], np.asarray(left)[:-1], atol=TOL, rtol=0)
    np.testing.assert_allclose(got[0]["r"], np.asarray(right)[:-1], atol=TOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("second_order, block_range, front_layer",
                         [(True, None, True), (False, (3, 17), False)], ids=["2nd_order", "1st_order_partial"])
def test_chain_gradient_matches_replicated(pools, world, second_order, block_range, front_layer):
    rng = np.random.default_rng(17)
    n, chi = 8, 8
    circ = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, 2), second_order)
    th = rng.uniform(-np.pi, np.pi, circ.num_thetas)
    lvec, phi = _random_mps(rng, n, chi), _random_mps(rng, n, chi)
    vh = jm.v_dagger_mul_mps(circ, jnp.asarray(th), phi)
    want = np.asarray(jg.fast_dot_gradient(circ, jnp.asarray(th), lvec, vh, block_range=block_range,
                                           front_layer=front_layer))
    got = pools[world].run(f"{TASKS}:chain_gradient", interop.ansatz_args(circ), th, _np(lvec), _np(vh),
                           jm.no_truncation_threshold(), block_range, front_layer)
    assert_bitwise_same(got, "grad")
    np.testing.assert_allclose(got[0]["grad"], want, atol=TOL, rtol=0)
    c = got[0]["census"]["counts"]
    assert c["all_reduce"] == 1 and c["all_gather"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_chain_v_dagger_matches_replicated(pools, world):
    rng = np.random.default_rng(19)
    n, chi = 8, 16
    circ = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, 2), True)
    th = rng.uniform(-np.pi, np.pi, circ.num_thetas)
    phi = _random_mps(rng, n, chi)
    want = jm.v_dagger_mul_mps(circ, jnp.asarray(th), phi)
    got = pools[world].run(f"{TASKS}:chain_v_dagger", interop.ansatz_args(circ), th, _np(phi),
                           jm.no_truncation_threshold())
    assert_bitwise_same(got, "gammas")
    out = _jmps(got[0])
    np.testing.assert_allclose(np.asarray(out.lambdas), np.asarray(want.lambdas), atol=TOL, rtol=0)
    assert abs(complex(jm.mps_dot(out, want)) - complex(jm.mps_dot(want, want))) <= TOL


@pytest.mark.parametrize("world", WORLDS)
def test_chain_odd_blocks_match_replicated(pools, world):
    """Blocks of three sites (n = 3P), which the JAX package's chain engine
    refuses: the straddling pair alternates between the half-layers from
    one block to the next.  Both parities, the V† sweep and the co-sweep
    gradient against the JAX package's replicated engine."""
    rng = np.random.default_rng(29)
    n, chi, thr = 3 * world, 8, 1e-12
    mps = _random_mps(rng, n, chi)
    for los in (tuple(range(0, n - 1, 2)), tuple(range(1, n - 1, 2))):
        gates = np.stack([np.linalg.qr(x)[0] for x in
                          rng.standard_normal((len(los), 4, 4)) + 1j * rng.standard_normal((len(los), 4, 4))])
        want = jm.apply_pairs_mps(mps, jnp.asarray(gates), los, trunc_thr=thr)
        got = pools[world].run(f"{TASKS}:chain_apply_pairs", *_np(mps), gates, los, thr)
        assert_bitwise_same(got, "gammas")
        out = _jmps(got[0])
        np.testing.assert_allclose(np.asarray(out.lambdas), np.asarray(want.lambdas), atol=TOL, rtol=0)
        assert abs(complex(jm.mps_dot(out, want)) - complex(jm.mps_dot(want, want))) <= TOL
    circ = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, 2), True)
    th = rng.uniform(-np.pi, np.pi, circ.num_thetas)
    lvec = _random_mps(rng, n, chi)
    vh = jm.v_dagger_mul_mps(circ, jnp.asarray(th), mps)
    got_vh = _jmps(pools[world].run(f"{TASKS}:chain_v_dagger", interop.ansatz_args(circ), th, _np(mps),
                                    jm.no_truncation_threshold())[0])
    assert abs(complex(jm.mps_dot(got_vh, vh)) - complex(jm.mps_dot(vh, vh))) <= TOL
    want_g = np.asarray(jg.fast_dot_gradient(circ, jnp.asarray(th), lvec, vh))
    got = pools[world].run(f"{TASKS}:chain_gradient", interop.ansatz_args(circ), th, _np(lvec), _np(vh),
                           jm.no_truncation_threshold())
    assert_bitwise_same(got, "grad")
    np.testing.assert_allclose(got[0]["grad"], want_g, atol=TOL, rtol=0)


def _replicated_objective(circ, lvec, phi):
    """The JAX package's replicated ASP objective and real gradient (the
    dryrun's twin of the chain contract), as numpy-in, torch-out functions
    for the port's compact L-BFGS."""
    def vgrad(th):
        x = jnp.asarray(th.numpy())
        vh = jm.v_dagger_mul_mps_layers(circ, x, phi)[0]
        dot = complex(jm.mps_dot(lvec, vh))
        g = np.real(-2.0 * np.conj(dot) * np.asarray(jg.fast_dot_gradient(circ, x, lvec, vh)))
        return torch.tensor(1.0 - abs(dot) ** 2, dtype=torch.float64), torch.as_tensor(g)

    def value(th):
        vh = jm.v_dagger_mul_mps_layers(circ, jnp.asarray(th.numpy()), phi)[0]
        return torch.tensor(1.0 - abs(complex(jm.mps_dot(lvec, vh))) ** 2, dtype=torch.float64)

    return value, vgrad


@pytest.mark.parametrize("world", WORLDS)
def test_chain_objective_matches_replicated(pools, world):
    circ, th, lvec, phi = _trotter_case(8, 16, 2, 91)
    _, vgrad = _replicated_objective(circ, lvec, phi)
    want_f, want_g = vgrad(torch.as_tensor(th))
    got = pools[world].run(f"{TASKS}:chain_objective", interop.ansatz_args(circ), th, _np(lvec), _np(phi),
                           jm.no_truncation_threshold())
    assert_bitwise_same(got, "fobj")
    assert_bitwise_same(got, "grad")
    assert abs(float(got[0]["fobj"]) - float(want_f)) <= TOL
    np.testing.assert_allclose(got[0]["grad"], want_g.numpy(), atol=TOL, rtol=0)


def test_chain_optimize_horizon_matches_replicated(pools):
    """The chain horizon at sp = 4 against the same compact L-BFGS driven by
    the JAX package's replicated objective: the same iterations, θ and
    fobj within 1e-10."""
    circ, th, lvec, phi = _trotter_case(8, 8, 2, 92)
    value, vgrad = _replicated_objective(circ, lvec, phi)
    want = minimize_lbfgs_compact(value, torch.as_tensor(th), maxiter=6, value_and_grad_fn=vgrad)
    got = pools[4].run(f"{TASKS}:chain_horizon", interop.ansatz_args(circ), th, _np(lvec), _np(phi),
                       jm.no_truncation_threshold(), 6)
    for key in ("thetas", "fobj", "num_iters"):
        assert_bitwise_same(got, key)
    assert got[0]["num_iters"] == int(want.num_iters)
    assert abs(float(got[0]["fobj"]) - float(want.fobj)) <= TOL
    np.testing.assert_allclose(got[0]["thetas"], want.thetas.numpy(), atol=TOL, rtol=0)
    assert float(got[0]["fobj"]) < 0.5 * float(value(torch.as_tensor(th)))


@pytest.mark.slow
def test_chain_sweep_and_gradient_match_jax_chain(pools):
    """The port's chain V† sweep and co-sweep gradient against the JAX
    package's chain engine itself (slow: its chain sweep compiles for
    minutes on the CPU)."""
    rng = np.random.default_rng(23)
    n, chi, world = 8, 8, 2
    circ = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, 2), True)
    th = rng.uniform(-np.pi, np.pi, circ.num_thetas)
    lvec, phi = _random_mps(rng, n, chi), _random_mps(rng, n, chi)
    mesh = _jmesh(world)
    want_vh = jc_chain.chain_to_mps(
        jc_chain.chain_v_dagger_mul_mps(circ, jnp.asarray(th), jc_chain.chain_from_mps(phi, mesh), mesh))
    got_vh = _jmps(pools[world].run(f"{TASKS}:chain_v_dagger", interop.ansatz_args(circ), th, _np(phi),
                                    jm.no_truncation_threshold())[0])
    assert abs(complex(jm.mps_dot(got_vh, want_vh)) - complex(jm.mps_dot(want_vh, want_vh))) <= TOL
    want_g = np.asarray(jc_chain.chain_fast_dot_gradient(circ, jnp.asarray(th), lvec, want_vh, mesh))
    got_g = pools[world].run(f"{TASKS}:chain_gradient", interop.ansatz_args(circ), th, _np(lvec), _np(want_vh),
                             jm.no_truncation_threshold())[0]["grad"]
    np.testing.assert_allclose(got_g, want_g, atol=TOL, rtol=0)
