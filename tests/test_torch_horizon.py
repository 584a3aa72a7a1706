"""The port's optimizer and ASP horizon runner held against the JAX package
at n=6, χ=8, 2 Trotter layers (2nd order), trunc_thr 1e-6.

* compact L-BFGS on a smooth test function: the same iterates (1e-10),
  the same iteration count.
* ``optimize_horizon_mps_jit`` with maxiter=8, complex128, "native" route
  on both sides: equal ``num_iters``, fobj within 1e-8 (eight iterations of
  a host loop amplify 1e-15 engine differences).
* the same horizon on the "jacobi" route (the port's plain twin against the
  Pallas kernel in interpret mode): fobj within 1e-4 (f32 decompositions
  along an 8-iteration path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.models.sp_lhs import jit_asp as jja
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.optim import lbfgs as jlbfgs
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.models.sp_lhs import target_states as tts
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.optim import lbfgs as tlbfgs
from aqc_research_tpu_torch.targets import trotter as ttrot
from tests import _torch_threads  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


N, CHI, LAYERS, THR, MAXITER = 6, 8, 2, 1e-6, 8
C128 = torch.complex128
BASE = tuple(1 if q % 2 == 0 else 0 for q in range(N))


@pytest.fixture(scope="module")
def case():
    jc = JTrotterAnsatz.make(N, make_trotter_like_circuit(N, LAYERS), True)
    th = jtrot.init_ansatz_to_trotter(jc, np.zeros(jc.num_thetas), evol_time=1.2, delta=1.0)
    th = th + 0.05 * np.random.default_rng(5).standard_normal(jc.num_thetas)
    jt = jtrot.Trotter(num_qubits=N, evol_time=1.2, num_steps=3, delta=1.0, second_order=True).as_mps(
        jtrot.neel_init_state(N), trunc_thr=THR, chi_max=CHI
    )
    return {
        "jc": jc,
        "tc": interop.ansatz_from_args(interop.ansatz_args(jc)),
        "th": th,
        "tth": interop.thetas_to_torch(th, torch.float64, "cpu"),
        "jt": jt,
        "tt": interop.mps_to_torch(np.asarray(jt.gammas), np.asarray(jt.lambdas), C128, "cpu"),
    }


def _rosenbrock(xp):
    def f(x):
        return ((1 - x[:-1]) ** 2).sum() + 10.0 * ((x[1:] - x[:-1] ** 2) ** 2).sum()

    def vg(x):
        g = xp.zeros_like(x)
        g_lo = -2 * (1 - x[:-1]) - 40.0 * x[:-1] * (x[1:] - x[:-1] ** 2)
        g_hi = 20.0 * (x[1:] - x[:-1] ** 2)
        if xp is jnp:
            g = g.at[:-1].add(g_lo).at[1:].add(g_hi)
        else:
            g[:-1] += g_lo
            g[1:] += g_hi
        return f(x), g

    return f, vg


@pytest.mark.parametrize("kwargs", [dict(maxiter=30), dict(maxiter=60, memory_size=4), dict(maxiter=40, fobj_thr=1e-3)])
def test_lbfgs_compact_matches_jax(kwargs):
    x0 = np.random.default_rng(1).uniform(-1.5, 1.5, 7)
    jf, jvg = _rosenbrock(jnp)
    tf, tvg = _rosenbrock(torch)
    jres = jlbfgs.minimize_lbfgs_compact(jf, jnp.asarray(x0), value_and_grad_fn=jvg, **kwargs)
    tres = tlbfgs.minimize_lbfgs_compact(tf, torch.tensor(x0), value_and_grad_fn=tvg, **kwargs)
    assert tres.num_iters == int(jres.num_iters)
    assert tres.converged == bool(jres.converged)
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), atol=1e-10)
    np.testing.assert_allclose(tres.last_thetas.numpy(), np.asarray(jres.last_thetas), atol=1e-10)
    assert abs(float(tres.fobj) - float(jres.fobj)) <= 1e-10


def test_lbfgs_needs_a_gradient():
    """Without ``value_and_grad_fn`` the gradient is torch.autograd's (the
    JAX twin's jax.value_and_grad): the same run as with the analytic one;
    an objective whose value carries no graph raises."""
    x0 = np.random.default_rng(1).uniform(-1.5, 1.5, 7)
    tf, tvg = _rosenbrock(torch)
    auto = tlbfgs.minimize_lbfgs_compact(tf, torch.tensor(x0), maxiter=30)
    given = tlbfgs.minimize_lbfgs_compact(tf, torch.tensor(x0), value_and_grad_fn=tvg, maxiter=30)
    assert auto.num_iters == given.num_iters == 30
    np.testing.assert_allclose(auto.thetas.numpy(), given.thetas.numpy(), atol=1e-10)
    with pytest.raises(ValueError, match="value_and_grad_fn"):
        tlbfgs.minimize_lbfgs_compact(lambda x: (x * x).sum().detach(), torch.ones(3), maxiter=2)


def test_horizon_native_matches_jax(case):
    assert jcfg.svd_impl() == "native" and config.svd_impl(torch.zeros(1)) == "native"
    jres = jja.optimize_horizon_mps_jit(case["jc"], jnp.asarray(case["th"]), case["jt"], base_bits=BASE,
                                        trunc_thr=THR, maxiter=MAXITER)
    tres = tja.optimize_horizon_mps_jit(case["tc"], case["tth"], case["tt"], base_bits=BASE,
                                        trunc_thr=THR, maxiter=MAXITER)
    assert tres.num_iters == int(jres.num_iters)
    assert abs(float(tres.fobj) - float(jres.fobj)) <= 1e-8
    assert abs(float(tres.fidelity) - float(jres.fidelity)) <= 1e-8
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), atol=1e-6)


def test_horizon_jacobi_matches_jax(case):
    config.set_svd_impl("jacobi")
    jcfg.set_svd_impl("jacobi")
    jcfg.set_jacobi_criterion(config.jacobi_criterion())
    jcfg.set_svd_chunk(1)
    jax.clear_caches()
    tja.watchdog_events.clear()
    try:
        jres = jja.optimize_horizon_mps_jit(case["jc"], jnp.asarray(case["th"]), case["jt"], base_bits=BASE,
                                            trunc_thr=THR, maxiter=MAXITER)
        tres = tja.optimize_horizon_mps_jit(case["tc"], case["tth"], case["tt"], base_bits=BASE,
                                            trunc_thr=THR, maxiter=MAXITER)
    finally:
        config.set_svd_impl(None)
        jcfg.set_svd_impl(None)
        jcfg.set_jacobi_criterion(None)
        jcfg.set_svd_chunk(None)
        jax.clear_caches()
    assert abs(float(tres.fobj) - float(jres.fobj)) <= 1e-4
    assert float(tres.fobj) < 0.01
    assert tja.watchdog_events == []


def test_watchdog_flags_and_recovers(case):
    """A returned iterate whose objective disagrees grossly with the native
    route is logged and re-optimized under "native"."""
    tja.watchdog_events.clear()
    fake = tja.JitHorizonResult(case["tth"], torch.tensor(0.9, dtype=torch.float64), torch.tensor(0.1), 0, True)
    config.set_svd_impl("jacobi")
    try:
        out = tja._mps_watchdog(case["tc"], case["tth"], case["tt"], fake, base_bits=BASE, trunc_thr=THR,
                                fobj_thr=None, maxiter=2, no_improve_iters=None)
    finally:
        config.set_svd_impl(None)
    assert len(tja.watchdog_events) == 1
    event = tja.watchdog_events.pop()
    assert event["reference_impl"] == "native" and event["fobj_optimized"] == 0.9
    assert float(out.fobj) < 0.9 and out.num_iters == 2
    # Under the reference route itself the watchdog never re-evaluates.
    assert tja._mps_watchdog(case["tc"], case["tth"], case["tt"], fake, base_bits=BASE, trunc_thr=THR,
                             fobj_thr=None, maxiter=2, no_improve_iters=None) is fake


def test_horizon_rejects_bad_base_bits(case):
    with pytest.raises(ValueError, match="base_bits"):
        tja.optimize_horizon_mps_jit(case["tc"], case["tth"], case["tt"], base_bits=BASE[:-1])


def test_first_horizon_target_matches_jax():
    kw = dict(num_qubits=N, evol_time=0.6, delta=1.0, second_order=True)
    target = tts.first_horizon_mps_target(num_trot_steps=2, chi_max=CHI, trunc_thr=1e-16, dtype=C128, device="cpu", **kw)
    assert (target.num_trot_steps, target.precise_multiplier, target.chi_max) == (2, 10, CHI)
    for got, steps in ((target.t1, 2), (target.t1_gt, 20)):
        want = jtrot.Trotter(num_qubits=N, evol_time=0.6, num_steps=steps, delta=1.0, second_order=True).as_mps(
            jtrot.neel_init_state(N), trunc_thr=1e-16, chi_max=CHI
        )
        np.testing.assert_allclose(tm.mps_to_vector(got).numpy(), np.asarray(jm.mps_to_vector(want)), atol=1e-10)
    assert 0.99 < ttrot.fidelity(target.t1, target.t1_gt) <= 1.0 + 1e-12

