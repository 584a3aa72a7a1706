"""The port's host-protocol surrogate objectives held against the JAX
package's on the CPU, in complex128 under "native" on both sides.

* ``SpSurrogateObjectiveMax`` at 6 qubits, 2 layers, and
  ``SpSurrogateObjectiveFastMpsTrotter`` at 6 qubits, χ=16, at 1 layer (no
  layer cache: the uncached co-sweep) and 2 layers (the z-cached one): a
  sequence of 6 objective and gradient calls along a path, the target built
  so that a flip state leads |0> by more than 1.1x (``max_no != 0``, so the
  second co-sweep runs), the gradient amplifier on, one gradient at a θ the
  objective did not see.  fobj and gradient within 1e-10 at every call;
  weight, ``max_no``, fidelity, counters and statistics equal.
* a partial ``layer_range`` / ``block_range`` (the last layer, the front
  layer out).
* SciPy's buffer reuse: the caller's θ buffer mutated in place between the
  objective and the gradient call is detected, an unchanged one is not."""

import numpy as np
import pytest

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.models.sp_lhs import sur_fast_mps as jsf
from aqc_research_tpu.models.sp_lhs import sur_max as jsm
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.ops.statevector import v_mul_vec as jv_mul_vec
from aqc_research_tpu.optim.stoppers import GradientAmplifier as JAmplifier
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.models.sp_lhs import sur_fast_mps as tsf
from aqc_research_tpu_torch.models.sp_lhs import sur_max as tsm
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.optim.stoppers import GradientAmplifier
from aqc_research_tpu_torch.targets import trotter as ttrot
from tests import _torch_threads  # noqa: F401

TOL = 1e-10
N = 6
CHI = 16
LEAD_FLIP = 3  # flip state X_2: the target's leading projection


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    previous = config._DEVICE
    config.set_device("cpu")
    config.set_svd_impl("native")
    jcfg.set_svd_impl("native")
    yield
    config.set_svd_impl(None)
    jcfg.set_svd_impl(None)
    config.set_device(previous)


def _params(prep, trunc_thr=1e-16):
    return {"num_qubits": N, "max_flips": 1, "maxiter": 6, "verbose": False, "enable_optim_stats": True,
            "num_simulations": 1, "trunc_thr": trunc_thr, "chi_max": CHI, "state_prep_func": prep}


def _case(layers: int):
    """(JAX ansatz, port ansatz, start θ, dense target): the target is
    V(θ0) S (0.5 |0> + 0.8 X_2 |0>) plus a little noise, normalized, so that
    at θ0 the flip state X_2 leads |0> by more than 1.1x."""
    jc = JTrotterAnsatz.make(N, make_trotter_like_circuit(N, layers), True)
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    rng = np.random.default_rng(100 + layers)
    th0 = jtrot.init_ansatz_to_trotter(jc, np.zeros(jc.num_thetas), evol_time=1.2, delta=1.0)
    th0 = th0 + 0.05 * rng.standard_normal(jc.num_thetas)
    neel = np.zeros(2**N, complex)
    neel[sum(1 << q for q in range(0, N, 2))] = 1.0
    mix = 0.5 * neel + 0.8 * np.roll(neel.reshape([2] * N), 1, axis=N - 1 - 2).reshape(-1)
    mix = mix + 0.02 * (rng.standard_normal(2**N) + 1j * rng.standard_normal(2**N))
    target = np.asarray(jv_mul_vec(jc, th0, mix / np.linalg.norm(mix)))
    return jc, tc, th0, target


def _path(th0, steps=6):
    rng = np.random.default_rng(7)
    return [th0 + 0.03 * k * rng.standard_normal(th0.size) for k in range(steps)]


def _objectives(kind: str, layers: int, layer_range=None):
    jc, tc, th0, target = _case(layers)
    if kind == "sur_max":
        br = None if layer_range is None else (layer_range[0] * jc.bpl, layer_range[1] * jc.bpl)
        front = layer_range is None or layer_range[0] == 0
        jo = jsm.SpSurrogateObjectiveMax(user_parameters=_params(jtrot.neel_init_state), circ=jc, block_range=br,
                                         front_layer=front, grad_scaler=JAmplifier(history=3))
        to = tsm.SpSurrogateObjectiveMax(user_parameters=_params(ttrot.neel_init_state), circ=tc, block_range=br,
                                         front_layer=front, grad_scaler=GradientAmplifier(history=3))
        jo.set_target(target)
        to.set_target(target)
    else:
        jo = jsf.SpSurrogateObjectiveFastMpsTrotter(user_parameters=_params(jtrot.neel_init_state), circ=jc,
                                                    layer_range=layer_range, grad_scaler=JAmplifier(history=3))
        to = tsf.SpSurrogateObjectiveFastMpsTrotter(user_parameters=_params(ttrot.neel_init_state), circ=tc,
                                                    layer_range=layer_range,
                                                    grad_scaler=GradientAmplifier(history=3))
        jo.set_target(jm.mps_from_dense(target, CHI))
        to.set_target(tm.mps_from_dense(target, CHI))
    return jo, to, th0


def _same_state(jo, to):
    assert to._max_no == jo._max_no
    assert abs(to._weight - jo._weight) <= TOL and abs(to.fidelity - jo.fidelity) <= TOL
    assert to._service.num_fun_ev == jo._service.num_fun_ev
    assert to._service.num_grad_ev == jo._service.num_grad_ev
    np.testing.assert_allclose(to._hs2, jo._hs2, atol=TOL, rtol=0)


def _run_sequence(jo, to, th0, gradient_elsewhere: int = 4):
    """6 objective+gradient calls along a path; at call ``gradient_elsewhere``
    the gradient is asked at the next point before its objective."""
    path = _path(th0)
    max_nos = []
    for k, th in enumerate(path):
        fj, ft = jo.objective(th.copy()), to.objective(th.copy())
        assert abs(ft - fj) <= TOL, k
        at = path[k + 1] if k == gradient_elsewhere else th
        gj, gt = jo.gradient(at.copy()), to.gradient(at.copy())
        assert gt.dtype == np.float64 and gt.shape == th.shape
        np.testing.assert_allclose(gt, np.asarray(gj), atol=TOL, rtol=0, err_msg=f"call {k}")
        _same_state(jo, to)
        max_nos.append(to._max_no)
    js, ts = jo.statistics, to.statistics
    assert set(ts) == set(js)
    for key in ("hs2", "weight", "fobj", "grad"):
        np.testing.assert_array_equal(ts[key], js[key], err_msg=key)
    for key in ("num_fun_ev", "num_grad_ev", "num_iters"):
        assert ts[key] == js[key], key
    return max_nos


@pytest.mark.parametrize(
    "kind,layers",
    [("sur_max", 2), ("sur_fast_mps_trotter", 1), ("sur_fast_mps_trotter", 2)],
    ids=["sur_max-2L", "mps-1L-uncached", "mps-2L-cached"],
)
def test_objective_sequence_matches_jax(kind, layers):
    jo, to, th0 = _objectives(kind, layers)
    max_nos = _run_sequence(jo, to, th0)
    assert LEAD_FLIP in max_nos  # the second co-sweep ran
    assert to._grad_scaler._scale > 1.0  # the amplifier scaled the later gradients
    if kind != "sur_max":
        assert (to._z_layers is None) == (layers == 1)
        assert to._vh_target.chi == CHI


@pytest.mark.parametrize("kind", ["sur_max", "sur_fast_mps_trotter"])
def test_partial_layer_range_matches_jax(kind):
    jo, to, th0 = _objectives(kind, 2, layer_range=(1, 2))
    for th in _path(th0, 2):
        assert abs(to.objective(th.copy()) - jo.objective(th.copy())) <= TOL
        gj, gt = np.asarray(jo.gradient(th.copy())), to.gradient(th.copy())
        np.testing.assert_allclose(gt, gj, atol=TOL, rtol=0)
        assert np.all(gt[: 3 * N] == 0)  # the front layer is outside the range
        assert np.all(gt[3 * N : 3 * N + 4 * to._circuit.bpl] == 0)  # so is layer 0
        assert np.abs(gt).max() > 0
        _same_state(jo, to)


@pytest.mark.parametrize("kind", ["sur_max", "sur_fast_mps_trotter"])
def test_scipy_buffer_reuse(kind):
    """SciPy passes the same buffer to fun and jac and may overwrite it in
    place: a gradient on the mutated buffer re-evaluates V† target, one on
    the unchanged buffer does not; both packages alike."""
    jo, to, th0 = _objectives(kind, 1)
    path = _path(th0, 2)
    for obj in (jo, to):
        buf = path[0].copy()
        obj.objective(buf)
        buf[:] = path[1]  # mutated in place, as SciPy's line search may
        g_moved = np.asarray(obj.gradient(buf))
        assert obj._service.num_fun_ev == 2
        obj.objective(buf)
        g_same = np.asarray(obj.gradient(buf))
        assert obj._service.num_fun_ev == 3
        obj.result = (g_moved, g_same)
    for gj, gt in zip(jo.result, to.result):
        np.testing.assert_allclose(gt, gj, atol=TOL, rtol=0)
