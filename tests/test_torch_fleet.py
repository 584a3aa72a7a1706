"""The port's lane fleets held against the JAX package on the CPU in
float64 / complex128: the same numpy-seeded starts go through
``jax.vmap`` over the JAX loops and through the port's lane loops.

* the lane-batched compact L-BFGS against ``jax.vmap(minimize_lbfgs_compact)``
  on Rosenbrock and on a 4-qubit dense ASP loss, ``batch_linesearch`` None,
  2 and 16, fused and not: per lane θ and fobj within 1e-10, the same
  ``num_iters`` and ``converged``;
* the chunked fleet equals one call; one fleet evaluation at L = 8 makes
  as many aten calls as one at L = 1 (within 10%), so the fleet is not a
  loop over lanes;
* ``minimize_adam`` (one lane and lanes) against JAX within 1e-10;
  ``minimize_lbfgs`` (optax's L-BFGS and zoom linesearch) against optax's
  own iterates on Rosenbrock, the first 25 within 1e-8;
  ``optimize_horizon_jit(solver="zoom")`` within 1e-8 at 4 qubits;
* ``multistart_minimize`` (lbfgs and adam) against JAX, and its refusal
  of a ``mesh`` that is not a DeviceMesh;
* ``optimize_horizon_multistart`` at the sizes of tests/test_jit_asp.py and
  ``optimize_horizon_mps_multistart`` at n = 3 χ = 8 and n = 6 χ = 16 on
  the "native" route: per-lane fobj within 1e-8, the same ``num_iters``;
  a wrong ``base_bits`` raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.models.sp_lhs import jit_asp as jja
from aqc_research_tpu.optim import lbfgs as jlbfgs
from aqc_research_tpu.parallel import multistart as jms
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.ops.mps import MPS
from aqc_research_tpu_torch.optim import lbfgs as tlbfgs
from aqc_research_tpu_torch.parallel import multistart as tms

TOL_LANE = 1e-10  # the fleet loop and Adam, per lane
TOL_RUN = 1e-8  # zoom, the fleets, the drivers


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


def rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def rosen_t(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _starts(lanes=5, dim=4, seed=0):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (lanes, dim))


def _asp(n=4, layers=1, evol_time=0.6, lanes=4, perturbation=0.2, seed=3):
    """A dense ASP horizon of tests/test_jit_asp.py's shape in both
    packages: ansatzes, perturbed perfect-init starts, the Neel-state
    Trotter target (numpy c128), the flip indices."""
    ini = jtrot.neel_init_state(n)
    target = np.array(jtrot.Trotter(num_qubits=n, evol_time=evol_time, num_steps=20, delta=1.0,
                                    second_order=True).as_vector(ini))
    jc = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), True)
    tc = TrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), True)
    th0 = jtrot.init_ansatz_to_trotter(jc, np.zeros(jc.num_thetas), evol_time=evol_time, delta=1.0)
    rng = np.random.default_rng(seed)
    batch = np.stack([th0 + perturbation * rng.standard_normal(th0.size) for _ in range(lanes)])
    return jc, tc, batch, target, jja.flip_state_indices(n, ini)


def _assert_lanes(jres, tres, tol=TOL_LANE):
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), rtol=0, atol=tol)
    np.testing.assert_allclose(tres.fobj.numpy(), np.asarray(jres.fobj), rtol=0, atol=tol)
    np.testing.assert_array_equal(np.asarray(tres.num_iters), np.asarray(jres.num_iters))
    np.testing.assert_array_equal(np.asarray(tres.converged), np.asarray(jres.converged))


GRIDS = [(None, False), (2, False), (2, True), (16, False), (16, True)]


@pytest.mark.parametrize("batch_ls, fuse", GRIDS)
def test_fleet_matches_vmap_rosenbrock(batch_ls, fuse):
    x0 = _starts()
    jres = jax.vmap(lambda x: jlbfgs.minimize_lbfgs_compact(
        rosen_j, x, maxiter=25, batch_linesearch=batch_ls, fuse_linesearch_grad=fuse))(jnp.asarray(x0))
    value, vgrad = tlbfgs.lane_objective(rosen_t)
    tres = tlbfgs.minimize_lbfgs_compact_lanes(value, vgrad, torch.as_tensor(x0), maxiter=25,
                                               batch_linesearch=batch_ls, fuse_linesearch_grad=fuse)
    _assert_lanes(jres, tres)


@pytest.mark.parametrize("batch_ls, fuse", [(None, False), (2, True), (16, False)])
def test_fleet_matches_vmap_dense_asp(batch_ls, fuse):
    jc, tc, batch, target, idx = _asp()
    jloss = jja.make_surrogate_loss(jc, idx)
    jres = jax.vmap(lambda x: jlbfgs.minimize_lbfgs_compact(
        lambda th: jloss(th, jnp.asarray(target)), x, maxiter=20, batch_linesearch=batch_ls,
        fuse_linesearch_grad=fuse))(jnp.asarray(batch))
    tloss = tja.make_surrogate_loss(tc, idx)
    tgt = torch.as_tensor(target)
    value, vgrad = tlbfgs.lane_objective(lambda th: tloss(th, tgt))
    tres = tlbfgs.minimize_lbfgs_compact_lanes(value, vgrad, torch.as_tensor(batch), maxiter=20,
                                               batch_linesearch=batch_ls, fuse_linesearch_grad=fuse)
    _assert_lanes(jres, tres)


@pytest.mark.parametrize("batch_ls", [None, 2])
def test_chunked_fleet_equals_one_call(batch_ls):
    value, vgrad = tlbfgs.lane_objective(rosen_t)
    programs = tlbfgs.lbfgs_fleet_programs(*tlbfgs.stateless_lanes(value, vgrad), maxiter=30,
                                           batch_linesearch=batch_ls)
    x0 = torch.as_tensor(_starts(lanes=4, seed=1))
    one, _, timed_out = tlbfgs.run_lbfgs_chunked(programs, x0, maxiter=30)
    assert not timed_out
    for chunk_iters in (1, 3, 7):
        res, _, _ = tlbfgs.run_lbfgs_chunked(programs, x0, maxiter=30, time_limit=1e9, chunk_iters=chunk_iters)
        assert torch.equal(res.thetas, one.thetas) and torch.equal(res.fobj, one.fobj)
        np.testing.assert_array_equal(res.num_iters, one.num_iters)
        np.testing.assert_array_equal(res.converged, one.converged)
    # An expired clock stops the fleet after its first chunk; it timed out
    # unless every lane had stopped on its own by then.
    res, _, timed_out = tlbfgs.run_lbfgs_chunked(programs, x0, maxiter=30, time_limit=1e-9, chunk_iters=2)
    assert int(res.num_iters.max()) <= 2 and timed_out == (not bool(res.converged.all()))
    assert timed_out or batch_ls is not None


class _AtenCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        return func(*args, **(kwargs or {}))


def test_fleet_evaluation_is_one_batched_pass():
    """One fleet evaluation (value, and value with gradient) makes as many
    aten calls at L = 8 as at L = 1, within 10%: not a loop over lanes."""
    _, tc, batch, target, idx = _asp(lanes=8)
    loss = tja.make_surrogate_loss(tc, idx)
    tgt = torch.as_tensor(target)
    value, vgrad = tlbfgs.lane_objective(lambda th: loss(th, tgt))
    for fn in (value, vgrad):
        counts = {}
        for lanes in (1, 8):
            with _AtenCount() as mode:
                fn(torch.as_tensor(batch[:lanes]))
            counts[lanes] = mode.calls
        assert abs(counts[8] - counts[1]) <= 0.1 * counts[1], counts


@pytest.mark.parametrize("lanes", [1, 5])
def test_minimize_adam_matches_jax(lanes):
    x0 = _starts(lanes=lanes, seed=2)
    jres = jax.vmap(lambda x: jlbfgs.minimize_adam(rosen_j, x, maxiter=60, learn_rate=0.05, fobj_thr=0.5))(
        jnp.asarray(x0))
    if lanes == 1:
        tres = tlbfgs.minimize_adam(rosen_t, torch.as_tensor(x0[0]), maxiter=60, learn_rate=0.05, fobj_thr=0.5)
        np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas[0]), rtol=0, atol=TOL_LANE)
        assert abs(float(tres.fobj) - float(jres.fobj[0])) <= TOL_LANE
        assert tres.num_iters == int(jres.num_iters[0]) and tres.converged == bool(jres.converged[0])
        return
    tres = tlbfgs.minimize_adam_lanes(tlbfgs.lane_objective(rosen_t)[1], torch.as_tensor(x0), maxiter=60,
                                      learn_rate=0.05, fobj_thr=0.5)
    _assert_lanes(jres, tres)


def test_minimize_lbfgs_zoom_matches_optax_iterates():
    """The port's zoom L-BFGS against optax's own loop on Rosenbrock: the
    first 25 iterates within 1e-8, and the final fobj of the JAX
    ``minimize_lbfgs``."""
    x0 = np.array([-1.2, 1.0, 0.5])
    solver = optax.lbfgs(memory_size=10, linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=20))
    value_and_grad = optax.value_and_grad_from_state(rosen_j)

    @jax.jit
    def step(params, state):
        value, grad = value_and_grad(params, state=state)
        updates, state = solver.update(grad, state, params, value=value, grad=grad, value_fn=rosen_j)
        return optax.apply_updates(params, updates), state

    params, state = jnp.asarray(x0), solver.init(jnp.asarray(x0))
    iterates = []
    for _ in range(25):
        params, state = step(params, state)
        iterates.append(np.asarray(params))
    for k in range(1, 26):
        got = tlbfgs.minimize_lbfgs(rosen_t, torch.as_tensor(x0), maxiter=k).last_thetas.numpy()
        np.testing.assert_allclose(got, iterates[k - 1], rtol=0, atol=TOL_RUN, err_msg=f"iterate {k}")
    jres = jlbfgs.minimize_lbfgs(rosen_j, jnp.asarray(x0), maxiter=25)
    tres = tlbfgs.minimize_lbfgs(rosen_t, torch.as_tensor(x0), maxiter=25)
    assert abs(float(tres.fobj) - float(jres.fobj)) <= TOL_RUN
    assert tres.num_iters == int(jres.num_iters)


def test_optimize_horizon_zoom_matches_jax():
    jc, tc, batch, target, idx = _asp(lanes=1, perturbation=0.1)
    jres = jja.optimize_horizon_jit(jc, batch[0], target, state_idx=idx, maxiter=40, solver="zoom")
    tres = tja.optimize_horizon_jit(tc, batch[0], torch.as_tensor(target), state_idx=idx, maxiter=40,
                                    solver="zoom")
    assert abs(float(tres.fobj) - float(jres.fobj)) <= TOL_RUN
    assert tres.num_iters == int(jres.num_iters)
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["lbfgs", "adam"])
def test_multistart_minimize_matches_jax(method):
    x0 = _starts(lanes=4, dim=3, seed=5)
    jres = jms.multistart_minimize(rosen_j, jnp.asarray(x0), method=method, maxiter=30, learn_rate=0.05)
    tres = tms.multistart_minimize(rosen_t, torch.as_tensor(x0), method=method, maxiter=30, learn_rate=0.05)
    np.testing.assert_allclose(tres.fobj.numpy(), np.asarray(jres.fobj), rtol=0, atol=TOL_RUN)
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tres.num_iters, np.asarray(jres.num_iters))
    assert tres.best_index == int(jres.best_index)


def test_multistart_refuses_a_mesh_and_draws_from_a_generator():
    with pytest.raises(TypeError, match="DeviceMesh"):
        tms.multistart_minimize(rosen_t, torch.zeros((2, 3), dtype=torch.float64), mesh=object())
    with pytest.raises(ValueError):
        tms.multistart_minimize(rosen_t, torch.zeros((2, 3), dtype=torch.float64), method="sgd")
    a = tms.random_initial_thetas(torch.Generator().manual_seed(7), 3, 11)
    b = tms.random_initial_thetas(torch.Generator().manual_seed(7), 3, 11)
    assert a.shape == (3, 11) and torch.equal(a, b)
    assert bool((a.abs() < np.pi).all()) and not torch.equal(a[0], a[1])


@pytest.mark.parametrize("batch_ls, fuse", [(2, False), (2, True), (None, False)])
def test_optimize_horizon_multistart_matches_jax(batch_ls, fuse):
    """tests/test_jit_asp.py's multistart horizon: 3 qubits, 1 layer, 4
    starts, fidelity bar 0.999, 60 iterations."""
    jc, tc, batch, target, idx = _asp(n=3, lanes=4)
    kw = dict(state_idx=idx, fidelity_thr=0.999, maxiter=60, batch_linesearch=batch_ls,
              fuse_linesearch_grad=fuse)
    jres = jja.optimize_horizon_multistart(jc, batch, target, **kw)
    tres = tja.optimize_horizon_multistart(tc, batch, torch.as_tensor(target), **kw)
    np.testing.assert_allclose(tres.fobj.numpy(), np.asarray(jres.fobj), rtol=0, atol=TOL_RUN)
    np.testing.assert_allclose(tres.fidelity.numpy(), np.asarray(jres.fidelity), rtol=0, atol=TOL_RUN)
    np.testing.assert_array_equal(tres.num_iters, np.asarray(jres.num_iters))
    np.testing.assert_array_equal(tres.converged, np.asarray(jres.converged))
    best = int(np.argmin(tres.fobj.numpy()))
    assert float(tres.fidelity[best]) > 0.999


@pytest.mark.parametrize("n, chi, layers", [(3, 8, 1), (6, 16, 2)])
def test_optimize_horizon_mps_multistart_matches_jax(n, chi, layers):
    """The MPS fleet on the "native" route: one layer (the uncached
    co-sweep) and two (the z-cached co-sweep, χ-growth forward sweep)."""
    ini = jtrot.neel_init_state(n)
    jt = jtrot.Trotter(num_qubits=n, evol_time=0.6, num_steps=20, delta=1.0, second_order=True).as_mps(
        ini, trunc_thr=1e-12, chi_max=chi)
    tt = MPS(torch.tensor(np.array(jt.gammas)), torch.tensor(np.array(jt.lambdas)))
    jc, tc, batch, _, _ = _asp(n=n, layers=layers, lanes=3, perturbation=0.1, seed=7)
    bits = tuple(1 if k % 2 == 0 else 0 for k in range(n))
    jres = jja.optimize_horizon_mps_multistart(jc, batch, jt, base_bits=bits, trunc_thr=1e-10, maxiter=12)
    with config.svd_impl_override("native"):
        tres = tja.optimize_horizon_mps_multistart(tc, batch, tt, base_bits=bits, trunc_thr=1e-10, maxiter=12)
    np.testing.assert_allclose(tres.fobj.numpy(), np.asarray(jres.fobj), rtol=0, atol=TOL_RUN)
    np.testing.assert_array_equal(tres.num_iters, np.asarray(jres.num_iters))
    with pytest.raises(ValueError, match="base_bits"):
        tja.optimize_horizon_mps_multistart(tc, batch, tt, base_bits=(1, 0), maxiter=1)
