"""The plain reference against a dense complex128 statevector of the same
ansatz and target, and against the program's own conventions, on the CPU;
the TF32 control against the program's complex64 numbers."""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from reference import circuit as C  # noqa: E402
from reference import mps as R  # noqa: E402


def _dense_apply_2q(vec, gate, lo, n):
    """A (lo, hi)-ordered 4x4 on qubits lo, lo + 1 of a little-endian vector."""
    v = vec.reshape(2 ** (n - lo - 2), 2, 2, 2**lo)   # (.., s_hi, s_lo, ..)
    g = gate.reshape(2, 2, 2, 2)                      # (s_lo', s_hi', s_lo, s_hi)
    return np.einsum("abij,xjiy->xbay", g, v).reshape(-1)


def _dense_apply_1q(vec, gate, q, n):
    v = vec.reshape(2 ** (n - q - 1), 2, 2**q)
    return np.einsum("ab,xby->xay", gate, v).reshape(-1)


def _neel(n):
    v = np.zeros(2**n, dtype=complex)
    v[sum(1 << q for q, b in enumerate(C.neel_bits(n)) if b)] = 1.0
    return v


def _dense_state(wl, thetas):
    n = wl.num_qubits
    th = torch.as_tensor(thetas, dtype=torch.float64)
    front = C.front_gates(th, n, torch.complex128).numpy()
    trip = C.triplet_gates(th, n, wl.num_layers, torch.complex128).numpy()
    v = _neel(n)
    for q in range(n):
        v = _dense_apply_1q(v, front[q], q, n)
    for k, lo in C.triplet_sequence(n, wl.num_layers, wl.second_order):
        v = _dense_apply_2q(v, trip[k], lo, n)
    return v


def _dense_target(wl):
    n = wl.num_qubits
    v = _neel(n)
    for gate, los in C.trotter_schedule(n, wl.evol_time, wl.trotter_steps, wl.delta, wl.second_order):
        for lo in los:
            v = _dense_apply_2q(v, gate, lo, n)
    return v


def _to_dense(st):
    v = st.B[0]
    for b in st.B[1:]:
        v = torch.einsum("a...b,bsc->a...sc", v, b)
    n = len(st.B)
    return v.reshape([2] * n).permute(*reversed(range(n))).reshape(-1).numpy()


def _point(wl, seed=3):
    base = C.trotter_initial_point(wl.num_qubits, wl.num_layers, wl.evol_time, wl.delta, wl.second_order)
    return base + 0.05 * np.random.default_rng(seed).standard_normal(base.size)


@pytest.mark.parametrize("n", [6, 7, 8])
def test_reference_agrees_with_dense_statevector(n):
    wl = R.Workload(n, 4, 2 ** (n // 2), 1e-14, 1.2, 3, 1.0, True)
    th = _point(wl)
    target = R.target_state(wl, R.EXACT, "cpu")
    np.testing.assert_allclose(_to_dense(target), _dense_target(wl), atol=1e-12)
    np.testing.assert_allclose(_to_dense(R.apply_ansatz(wl, th, R.EXACT, "cpu")), _dense_state(wl, th), atol=1e-12)
    f_dense = 1.0 - abs(np.vdot(_dense_target(wl), _dense_state(wl, th))) ** 2
    f, g = R.objective_and_gradient(wl, th, target)
    assert abs(f - f_dense) < 1e-12
    assert abs(R.objective(wl, th, target) - f_dense) < 1e-12
    # The gradient against central differences of the dense objective.
    rng = np.random.default_rng(n)
    for idx in rng.choice(th.size, 6, replace=False):
        e = np.zeros_like(th)
        e[idx] = 1e-6
        fp = 1.0 - abs(np.vdot(_dense_target(wl), _dense_state(wl, th + e))) ** 2
        fm = 1.0 - abs(np.vdot(_dense_target(wl), _dense_state(wl, th - e))) ** 2
        assert abs(g[idx] - (fp - fm) / 2e-6) < 1e-7


def test_neel_and_trotter_point_follow_the_program():
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.targets import trotter as trotop

    n, layers = 8, 4
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), True)
    assert circ.num_thetas == C.num_thetas(n, layers)
    th = trotop.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=1.2, delta=1.0)
    np.testing.assert_array_equal(th, C.trotter_initial_point(n, layers, 1.2, 1.0, True))
    assert C.neel_bits(n) == tuple(1 if q % 2 == 0 else 0 for q in range(n))


def test_reference_matches_the_program_in_complex128():
    """The same angles, target and truncation in both: the reference and the
    program's own engine (CPU, complex128) agree to rounding, so the
    reference states the program's conventions."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.models.sp_lhs.target_states import first_horizon_mps_target

    config.set_device("cpu")
    config.set_precision("high")
    n, chi = 12, 16
    wl = R.Workload(n, 4, chi, 1e-6, 1.2, 3, 1.0, True)
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, 4), True)
    th = _point(wl)
    tgt = first_horizon_mps_target(num_qubits=n, evol_time=1.2, num_trot_steps=3, delta=1.0, chi_max=chi,
                                   trunc_thr=1e-6, second_order=True, device="cpu").t1
    ref_target = R.target_state(wl, R.EXACT, "cpu")
    assert R.infidelity(R.from_vidal(tgt.gammas, tgt.lambdas), ref_target) < 1e-12
    value, value_and_grad = jit_asp._mps_value_fns(circ, C.neel_bits(n), 1e-6)
    f_p, g_p = value_and_grad(torch.as_tensor(th), tgt)
    f_r, g_r = R.objective_and_gradient(wl, th, ref_target)
    assert abs(float(f_p) - f_r) < 1e-12
    assert abs(float(value(torch.as_tensor(th), tgt)) - f_r) < 1e-12
    assert np.linalg.norm(g_p.numpy() - g_r) / np.linalg.norm(g_r) < 1e-6


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0e-7], dtype=torch.float32)
    y = R.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-10
    assert y[2] == 1.0                      # a tie rounds to even
    assert y[3] == 1.0 + 2**-9              # a tie rounds to even
    assert (y.view(torch.int32) & 0x1FFF == 0).all()


def test_control_separates_from_complex64():
    """At 12 qubits the TF32 control reads far above the program's own
    complex64 arithmetic in every number the control can move."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.models.sp_lhs.target_states import first_horizon_mps_target

    config.set_device("cpu")
    config.set_precision("fast")
    try:
        n, chi = 12, 16
        wl = R.Workload(n, 4, chi, 1e-6, 1.2, 3, 1.0, True)
        th = _point(wl)
        circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, 4), True)
        tgt = first_horizon_mps_target(num_qubits=n, evol_time=1.2, num_trot_steps=3, delta=1.0, chi_max=chi,
                                       trunc_thr=1e-6, second_order=True, device="cpu").t1
        _, value_and_grad = jit_asp._mps_value_fns(circ, C.neel_bits(n), 1e-6)
        f32, g32 = value_and_grad(torch.as_tensor(th, dtype=torch.float32), tgt)
    finally:
        config.set_precision("high")
    ref_target = R.target_state(wl, R.EXACT, "cpu")
    f_r, g_r = R.objective_and_gradient(wl, th, ref_target)
    ctrl_target = R.target_state(wl, R.TF32, "cpu")
    f_c, g_c = R.objective_and_gradient(wl, th, ctrl_target, R.TF32)
    prog = {"fobj_gap": abs(float(f32) - f_r), "grad_gap": np.linalg.norm(g32.numpy() - g_r) / np.linalg.norm(g_r),
            "target_infid": R.infidelity(R.from_vidal(tgt.gammas, tgt.lambdas), ref_target)}
    ctrl = {"fobj_gap": abs(f_c - f_r), "grad_gap": np.linalg.norm(g_c - g_r) / np.linalg.norm(g_r),
            "target_infid": R.infidelity(ctrl_target, ref_target)}
    for name in prog:
        assert ctrl[name] > 30 * abs(prog[name]), (name, prog[name], ctrl[name])
