"""The MPS engine's lane axes on the plain layered and per-gate co-sweeps,
held against the JAX package on the CPU in complex128 on the "native"
route: the same numpy-seeded Θ ``(L=3, P)`` go through the port at once
and through the JAX package lane by lane.

* ``fast_dot_gradient`` with ``(L, P)`` Θ and a ``V† phi`` of L lanes,
  against JAX's per lane within 1e-10: plain layered cx, cz and cp, the
  per-gate sweep on random non-adjacent cz and cp layouts (the swap
  network), and a ``cyclic_spin`` cp ring (the wrap-around block through
  the swap network, the CP two-point difference);
* the value paths on the same ansatze: ``v_mul_mps`` and
  ``v_dagger_mul_mps`` (read through ``mps_dot`` and
  ``mps_flip_amplitudes``) and ``jit_asp._mps_value_fns``' value and
  value_and_grad, per lane within 1e-10;
* one evaluation at L = 8 makes as many aten calls as one at L = 1 (within
  10%) on the plain and the per-gate path: the lanes are not a loop;
* a spy on ``ops/mps._pair_update``: an L-lane evaluation makes as many
  pair updates as one lane, each with the lane axis in its batch (but the
  swaps that open a V† sweep on the lane-free target, shared by all
  lanes);
* ``optimize_horizon_mps_multistart`` on the ring: every evaluation it
  makes takes all lanes at once, and each lane matches the JAX fleet
  (fobj within 1e-8, the same iterations).
"""

import functools

import numpy as np
import pytest
import torch

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.circuit.structures import create_ansatz_structure
from aqc_research_tpu.models.sp_lhs import jit_asp as jja
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.ops import mps_gradient as jg
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu.utils import rand_circuit
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops import mps_gradient as tg

from tests.test_torch_fleet import _AtenCount
from tests import _torch_threads  # noqa: F401

TOL = 1e-10  # c128, one evaluation
TOL_RUN = 1e-8  # c128, a fleet run
LANES = 3
N, CHI = 4, 8  # exact: a 4-qubit bond never exceeds 4
BITS = (1, 0, 1, 0)
KINDS = ["cx-plain", "cz-plain", "cp-plain", "cz-pergate", "cp-pergate", "cp-ring"]


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


def _jansatz(kind: str, n: int = N):
    entangler, layout = kind.split("-")
    if layout == "plain":
        blocks = np.concatenate([create_ansatz_structure(n, "spin", "full", n - 1)] * 2, axis=1)
    elif layout == "ring":
        blocks = create_ansatz_structure(n, "cyclic_spin", "full", 2 * n)
    else:
        np.random.seed(21)
        blocks = rand_circuit(n, 5)
    return JAnsatz.make(n, entangler, blocks)


def _tansatz(jc):
    return interop.ansatz_from_args(interop.ansatz_args(jc))


def _state(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    return v / np.linalg.norm(v)


def _thetas(num_thetas: int, lanes: int = LANES, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (lanes, num_thetas))


@functools.lru_cache(maxsize=None)
def _jax_lanes(kind: str):
    """The JAX package's per-lane results for ``kind``: gradients of
    <lvec|V†|phi>, flip amplitudes of V† phi, <V lvec|phi>, value and
    value_and_grad of the MPS objective."""
    jc = _jansatz(kind)
    th = _thetas(jc.num_thetas)
    jphi = jm.mps_from_dense(_state(N, 1), CHI)
    jlvec = jm.mps_basis_state(BITS, CHI)
    jv, jvg = jja._mps_value_fns(jc, BITS, 1e-16)
    out = {"grad": [], "amps": [], "fwd": [], "value": [], "fobj": [], "ograd": []}
    for x in th:
        jvh = jm.v_dagger_mul_mps(jc, x, jphi)
        out["grad"].append(np.asarray(jg.fast_dot_gradient(jc, x, jlvec, jvh)))
        out["amps"].append(np.asarray(jm.mps_flip_amplitudes(jvh, BITS)))
        out["fwd"].append(complex(jm.mps_dot(jm.v_mul_mps(jc, x, jlvec), jphi)))
        out["value"].append(float(jv(x, jphi)))
        fobj, grad = jvg(x, jphi)
        out["fobj"].append(float(fobj))
        out["ograd"].append(np.asarray(grad))
    return jc, th, {key: np.stack(val) for key, val in out.items()}


def _port_inputs(jc, th):
    tc = _tansatz(jc)
    return tc, torch.tensor(th), tm.mps_from_dense(_state(N, 1), CHI), tm.mps_basis_state(BITS, CHI)


@pytest.mark.parametrize("kind", KINDS)
def test_cosweep_lanes_match_jax_per_lane(kind):
    jc, th, want = _jax_lanes(kind)
    tc, tth, tphi, tlvec = _port_inputs(jc, th)
    assert not tg._layered_eligible(tc)
    assert tg._plain_layered_eligible(tc) == kind.endswith("plain")
    if not kind.endswith("plain"):
        assert np.any(np.abs(jc.blocks[0] - jc.blocks[1]) > 1)  # the swap network runs
    tvh = tm.v_dagger_mul_mps(tc, tth, tphi)
    assert tvh.gammas.shape[0] == LANES
    got = tg.fast_dot_gradient(tc, tth, tlvec, tvh)
    assert got.shape == (LANES, jc.num_thetas) and got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want["grad"], atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_value_paths_take_lanes(kind):
    jc, th, want = _jax_lanes(kind)
    tc, tth, tphi, tlvec = _port_inputs(jc, th)
    amps = tm.mps_flip_amplitudes(tm.v_dagger_mul_mps(tc, tth, tphi), BITS)
    assert amps.shape == (LANES, N + 1)
    np.testing.assert_allclose(amps.numpy(), want["amps"], atol=TOL, rtol=0)
    fwd = tm.mps_dot(tm.v_mul_mps(tc, tth, tlvec), tphi)
    np.testing.assert_allclose(fwd.numpy(), want["fwd"], atol=TOL, rtol=0)
    tv, tvg = tja._mps_value_fns(tc, BITS, 1e-16)
    np.testing.assert_allclose(tv(tth, tphi).numpy(), want["value"], atol=TOL, rtol=0)
    fobj, grad = tvg(tth, tphi)
    assert fobj.shape == (LANES,) and grad.shape == (LANES, jc.num_thetas)
    np.testing.assert_allclose(fobj.numpy(), want["fobj"], atol=TOL, rtol=0)
    np.testing.assert_allclose(grad.numpy(), want["ograd"], atol=TOL, rtol=0)


def _evaluations(kind: str, n: int = 5):
    tc = _tansatz(_jansatz(kind, n))
    phi = tm.mps_from_dense(_state(n, 2), CHI)
    value, value_and_grad = tja._mps_value_fns(tc, tuple(k % 2 for k in range(n)), 1e-16)
    return tc, {"value": lambda x: value(x, phi), "obj+grad": lambda x: value_and_grad(x, phi)}


@pytest.mark.parametrize("fn_name", ["value", "obj+grad"])
@pytest.mark.parametrize("kind", ["cz-plain", "cp-pergate"])
def test_lane_evaluation_is_one_batched_pass(kind, fn_name):
    """An evaluation at L = 8 makes the aten calls of one at L = 1, within
    10%: the lanes ride in the batch, not in a loop."""
    tc, fns = _evaluations(kind)
    x = torch.tensor(_thetas(tc.num_thetas, lanes=8, seed=5))
    counts = {}
    for lanes in (1, 8):
        with _AtenCount() as mode:
            fns[fn_name](x[:lanes])
        counts[lanes] = mode.calls
    assert abs(counts[8] - counts[1]) <= 0.1 * counts[1], counts


@pytest.mark.parametrize("kind", ["cp-plain", "cz-pergate", "cp-ring"])
def test_pair_updates_carry_the_lanes(kind, monkeypatch):
    """Every pair update of an L-lane evaluation (swaps and the CP shift
    included) is one call with the lane axis in its batch, and there are as
    many as for one lane."""
    tc, fns = _evaluations(kind)
    x = torch.tensor(_thetas(tc.num_thetas, lanes=LANES, seed=6))
    real = tm._pair_update
    batches = []

    def spy(lam_l, lam_c, lam_r, g1, *rest):
        batches.append(tuple(g1.shape[:-3]))
        return real(lam_l, lam_c, lam_r, g1, *rest)

    monkeypatch.setattr(tm, "_pair_update", spy)
    for fn in fns.values():
        seen = {}
        for lanes in (1, LANES):
            batches.clear()
            fn(x[0] if lanes == 1 else x)
            seen[lanes] = list(batches)
        one, many = seen[1], seen[LANES]
        assert len(many) == len(one) > 0
        # The V† sweep may open with the swaps of a non-adjacent block on the
        # target, which has no lanes yet: those serve every lane at once.
        shared = next((i for i, (o, m) in enumerate(zip(one, many)) if o != m), len(one))
        assert shared <= tc.num_qubits - 2 and many[:shared] == one[:shared]
        for o, m in zip(one[shared:], many[shared:]):
            assert m == o[:-1] + (LANES,) + o[-1:], (o, m)


def test_ring_fleet_folds_and_matches_jax(monkeypatch):
    """The fleet on the cp ring (per-gate path): each evaluation takes every
    running lane at once; each lane follows the JAX fleet's vmapped lane."""
    n, chi = 4, 4
    ini = jtrot.neel_init_state(n)
    jt = jtrot.Trotter(num_qubits=n, evol_time=0.6, num_steps=20, delta=1.0, second_order=True).as_mps(
        ini, trunc_thr=1e-12, chi_max=chi)
    tt = tm.MPS(torch.tensor(np.array(jt.gammas)), torch.tensor(np.array(jt.lambdas)))
    jc = _jansatz("cp-ring", n)
    tc = _tansatz(jc)
    batch = 0.3 * np.random.default_rng(7).standard_normal((LANES, jc.num_thetas))
    bits = tuple(1 if k % 2 == 0 else 0 for k in range(n))
    jres = jja.optimize_horizon_mps_multistart(jc, batch, jt, base_bits=bits, trunc_thr=1e-10, maxiter=6)

    shapes = []
    real = tja._mps_value_fns

    def spy(*args):
        value, value_and_grad = real(*args)
        return (lambda th, tgt: shapes.append(tuple(th.shape)) or value(th, tgt),
                lambda th, tgt: shapes.append(tuple(th.shape)) or value_and_grad(th, tgt))

    monkeypatch.setattr(tja, "_mps_value_fns", spy)
    tres = tja.optimize_horizon_mps_multistart(tc, batch, tt, base_bits=bits, trunc_thr=1e-10, maxiter=6)
    assert shapes and all(len(s) == 2 for s in shapes) and shapes[0] == (LANES, jc.num_thetas)
    np.testing.assert_allclose(tres.fobj.numpy(), np.asarray(jres.fobj), rtol=0, atol=TOL_RUN)
    np.testing.assert_allclose(tres.thetas.numpy(), np.asarray(jres.thetas), rtol=0, atol=TOL_RUN)
    np.testing.assert_array_equal(tres.num_iters, np.asarray(jres.num_iters))
    assert np.all(tres.fobj.numpy() < 1.0)
