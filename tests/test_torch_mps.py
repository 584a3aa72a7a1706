"""The port's MPS engine and co-sweep gradient held against the JAX package
at n=6, χ=8, 2 Trotter layers (2nd order), trunc_thr 1e-6.

* complex128 on the "native" route on both sides: every state, overlap and
  gradient within 1e-10 (the reference's parity bar, ROADMAP.md).  χ=8 never
  caps a bond at n=6, so both sides keep identical spectra.
* the "jacobi" route: the port's plain twin against the Pallas kernel in
  interpret mode (chunk 1).  The decomposition is f32, so the objective is
  held to 1e-5 and the gradient to 1e-4 * ||g||.

Inputs come from numpy seeds; JAX-side targets cross through interop.py."""

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
from aqc_research_tpu.ops import mps_gradient as jg
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.circuit.program import ProgramBuilder
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops import mps_gradient as tg
from aqc_research_tpu_torch.targets import trotter as ttrot
from tests import _torch_threads  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


N, CHI, LAYERS, THR = 6, 8, 2, 1e-6
PARITY = 1e-10  # complex128, same decomposition route
JAC_F, JAC_G = 1e-5, 1e-4  # f32 decompositions
C128 = torch.complex128
BASE = tuple(1 if q % 2 == 0 else 0 for q in range(N))  # Neel prep bits


def _vec(mps):
    return tm.mps_to_vector(mps).numpy()


def _port(jmps):
    return interop.mps_to_torch(np.asarray(jmps.gammas), np.asarray(jmps.lambdas), C128, "cpu")


@pytest.fixture(scope="module")
def case():
    jc = JTrotterAnsatz.make(N, make_trotter_like_circuit(N, LAYERS), True)
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    th = jtrot.init_ansatz_to_trotter(jc, np.zeros(jc.num_thetas), evol_time=1.2, delta=1.0)
    th = th + 0.1 * np.random.default_rng(3).standard_normal(jc.num_thetas)
    trot = dict(num_qubits=N, evol_time=1.2, num_steps=3, delta=1.0, second_order=True)
    jt = jtrot.Trotter(**trot).as_mps(jtrot.neel_init_state(N), trunc_thr=THR, chi_max=CHI)
    return {
        "jc": jc, "tc": tc, "th": th, "tth": interop.thetas_to_torch(th, torch.float64, "cpu"),
        "jt": jt, "tt": _port(jt), "trot": trot,
    }


@pytest.fixture
def native_routes():
    """Both packages on their CPU default, the LAPACK route."""
    assert jcfg.svd_impl() == "native"
    config.set_svd_impl("native")
    yield
    config.set_svd_impl(None)


@pytest.mark.parametrize("second_order", [False, True])
def test_trotter_evolve_mps_matches_jax(second_order):
    trot = dict(num_qubits=N, evol_time=0.8, num_steps=2, delta=1.0, second_order=second_order)
    jt = jtrot.Trotter(**trot).as_mps(jtrot.neel_init_state(N), trunc_thr=THR, chi_max=CHI)
    tt = ttrot.Trotter(**trot).as_mps(ttrot.neel_init_state(N), trunc_thr=THR, chi_max=CHI, dtype=C128, device="cpu")
    v_j, v_t = np.asarray(jm.mps_to_vector(jt)), _vec(tt)
    np.testing.assert_allclose(v_t, v_j, atol=PARITY)
    assert abs(1.0 - ttrot.fidelity(tt, _port(jt))) <= PARITY
    np.testing.assert_allclose(tt.lambdas.numpy(), np.asarray(jt.lambdas), atol=PARITY)


def test_mps_from_program_matches_jax_with_swap_network():
    from aqc_research_tpu.circuit.program import ProgramBuilder as JPB

    jq, tq = JPB(N), ProgramBuilder(N)
    for qb in (jq, tq):
        qb.h(0).rx(0.3, 1).cx(0, 3).ry(0.7, 4).cp(0.5, 5, 2).cz(1, 4).rz(-0.4, 3).cx(5, 0)
    jmps = jm.mps_from_program(jq.build(), N, chi_max=CHI, dtype=jnp.complex128)
    tmps = tm.mps_from_program(tq.build(), N, chi_max=CHI, dtype=C128, device="cpu")
    np.testing.assert_allclose(_vec(tmps), np.asarray(jm.mps_to_vector(jmps)), atol=PARITY)
    assert tm.mps_basis_state(BASE, CHI, C128, "cpu").gammas.shape == (N, 2, CHI, CHI)


def test_v_dagger_layers_and_cache_match_jax(case, native_routes):
    jvh, jz = jm.v_dagger_mul_mps_layers(case["jc"], jnp.asarray(case["th"]), case["jt"], trunc_thr=THR)
    tvh, tz = tm.v_dagger_mul_mps_layers(case["tc"], case["tth"], case["tt"], trunc_thr=THR)
    jl = jm.mps_basis_state(BASE, CHI, jnp.complex128)
    tl = tm.mps_basis_state(BASE, CHI, C128, "cpu")
    assert abs(complex(tm.mps_dot(tl, tvh)) - complex(jm.mps_dot(jl, jvh))) <= PARITY
    np.testing.assert_allclose(_vec(tvh), np.asarray(jm.mps_to_vector(jvh)), atol=PARITY)
    assert tz.gammas.shape == tuple(jz.gammas.shape)
    for j in range(tz.gammas.shape[0]):
        jj = jm.MPS(jz.gammas[j], jz.lambdas[j])
        np.testing.assert_allclose(_vec(tz[j]), np.asarray(jm.mps_to_vector(jj)), atol=PARITY)
    # The whole-circuit V† twin agrees with the layered sweep.
    np.testing.assert_allclose(_vec(tm.v_dagger_mul_mps(case["tc"], case["tth"], case["tt"], trunc_thr=THR)),
                               _vec(tvh), atol=PARITY)


def test_v_mul_mps_growing_matches_jax(case, native_routes):
    jw = jm.v_mul_mps_growing(case["jc"], jnp.asarray(case["th"]), BASE, CHI, trunc_thr=THR)
    tw = tm.v_mul_mps_growing(case["tc"], case["tth"], BASE, CHI, trunc_thr=THR, dtype=C128)
    assert abs(complex(tm.mps_dot(tw, case["tt"])) - complex(jm.mps_dot(jw, case["jt"]))) <= PARITY
    np.testing.assert_allclose(_vec(tw), np.asarray(jm.mps_to_vector(jw)), atol=PARITY)


def test_flip_amplitudes_match_jax(case):
    jamps = np.asarray(jm.mps_flip_amplitudes(case["jt"], BASE))
    tamps = tm.mps_flip_amplitudes(case["tt"], BASE).numpy()
    np.testing.assert_allclose(tamps, jamps, atol=PARITY)


@pytest.mark.parametrize("grow_w", [False, True])
def test_gradient_with_state_matches_jax(case, native_routes, grow_w):
    jth = jnp.asarray(case["th"])
    jvh, jz = jm.v_dagger_mul_mps_layers(case["jc"], jth, case["jt"], trunc_thr=THR)
    tvh, tz = tm.v_dagger_mul_mps_layers(case["tc"], case["tth"], case["tt"], trunc_thr=THR)
    jl = jm.mps_basis_state(BASE, CHI, jnp.complex128)
    tl = tm.mps_basis_state(BASE, CHI, C128, "cpu")
    jgrad, jw = jg.fast_dot_gradient_with_state(case["jc"], jth, jl, jvh, jz, trunc_thr=THR, grow_w=grow_w)
    tgrad, tw = tg.fast_dot_gradient_with_state(case["tc"], case["tth"], tl, tvh, tz, trunc_thr=THR, grow_w=grow_w)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=PARITY)
    assert tw.chi == CHI
    np.testing.assert_allclose(_vec(tw), np.asarray(jm.mps_to_vector(jw)), atol=PARITY)
    # The z_layers branch of fast_dot_gradient is the same sweep.
    again = tg.fast_dot_gradient(case["tc"], case["tth"], tl, tvh, trunc_thr=THR, z_layers=tz, grow_w=grow_w)
    np.testing.assert_allclose(again.numpy(), tgrad.numpy(), atol=PARITY)


def test_gradient_paths_not_ported_raise(case, native_routes):
    """Without the layer cache the co-sweep no longer raises: it takes the
    uncached layered path, which at no truncation (χ=8 is exact at n=6)
    computes the cached path's function; grow_w on a state that is not a
    product state still raises."""
    tl = tm.mps_basis_state(BASE, CHI, C128, "cpu")
    tvh, tz = tm.v_dagger_mul_mps_layers(case["tc"], case["tth"], case["tt"])
    uncached = tg.fast_dot_gradient(case["tc"], case["tth"], tl, tvh)
    cached = tg.fast_dot_gradient(case["tc"], case["tth"], tl, tvh, z_layers=tz)
    np.testing.assert_allclose(uncached.numpy(), cached.numpy(), atol=PARITY)
    wide = tm.mps_resize(case["tt"], CHI)
    with pytest.raises(ValueError, match="grow_w"):
        tg.fast_dot_gradient_with_state(case["tc"], case["tth"], wide, wide, wide, grow_w=True)


def test_value_fns_match_jax_native(case, native_routes):
    jv, jvg = jja._mps_value_fns(case["jc"], BASE, THR)
    tv, tvg = tja._mps_value_fns(case["tc"], BASE, THR)
    jf, jgrad = jvg(jnp.asarray(case["th"]), case["jt"])
    tf, tgrad = tvg(case["tth"], case["tt"])
    assert abs(float(tf) - float(jf)) <= PARITY
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=PARITY)
    assert abs(float(tv(case["tth"], case["tt"])) - float(jv(jnp.asarray(case["th"]), case["jt"]))) <= PARITY


@pytest.mark.parametrize("criterion", ["entry", "hybrid"])
def test_jacobi_route_engine_matches_pallas_interpret(case, criterion):
    previous = config.jacobi_criterion()
    config.set_svd_impl("jacobi")
    config.set_jacobi_criterion(criterion)
    jcfg.set_svd_impl("jacobi")
    jcfg.set_jacobi_criterion(criterion)
    jcfg.set_svd_chunk(1)
    jax.clear_caches()
    try:
        jv, jvg = jja._mps_value_fns(case["jc"], BASE, THR)
        tv, tvg = tja._mps_value_fns(case["tc"], BASE, THR)
        jf, jgrad = jax.jit(lambda x: jvg(x, case["jt"]))(jnp.asarray(case["th"]))
        tf, tgrad = tvg(case["tth"], case["tt"])
        jgrad = np.asarray(jgrad)
        assert abs(float(tf) - float(jf)) <= JAC_F
        assert np.linalg.norm(tgrad.numpy() - jgrad) <= JAC_G * np.linalg.norm(jgrad)
        jval = float(jax.jit(lambda x: jv(x, case["jt"]))(jnp.asarray(case["th"])))
        assert abs(float(tv(case["tth"], case["tt"])) - jval) <= JAC_F
    finally:
        config.set_svd_impl(None)
        config.set_jacobi_criterion(previous)
        jcfg.set_svd_impl(None)
        jcfg.set_jacobi_criterion(None)
        jcfg.set_svd_chunk(None)
        jax.clear_caches()


def test_truncation_masks_match_jax():
    rng = np.random.default_rng(9)
    s = np.sort(np.abs(rng.standard_normal((4, 16))) * 10.0 ** -rng.uniform(0, 8, (4, 16)))[:, ::-1].copy()
    for thr in (1e-16, 1e-6, 1e-3):
        jmask, jtot = jm._truncation_mask(jnp.asarray(s), 8, thr)
        tmask, ttot = tm._truncation_mask(torch.tensor(s), 8, thr)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(ttot.numpy(), np.asarray(jtot), rtol=1e-14)
        total = np.sqrt((s * s).sum(-1)) * 1.01
        np.testing.assert_array_equal(
            tm._truncation_mask_topk(torch.tensor(s[:, :8]), torch.tensor(total), 8, thr).numpy(),
            np.asarray(jm._truncation_mask_topk(jnp.asarray(s[:, :8]), jnp.asarray(total), 8, thr)),
        )
    lam = np.array([[1.0, 1e-3, 1e-13, 0.0]])
    np.testing.assert_array_equal(tm._safe_inv(torch.tensor(lam)).numpy(), np.asarray(jm._safe_inv(jnp.asarray(lam))))


def test_stacked_pair_update_equals_separate_updates(case, native_routes):
    """A leading batch axis (two states) decomposes as one batch and gives
    the two separate updates."""
    a = case["tt"]
    b = tm.v_dagger_mul_mps(case["tc"], case["tth"], a, trunc_thr=THR)
    gates = ttrot._block_4x4_lo_hi(ttrot.trotter_alphas(0.3, 1.0), C128, "cpu").expand(3, 4, 4)
    los = (0, 2, 4)
    both = tm.apply_pairs_mps(
        tm.MPS(torch.stack([a.gammas, b.gammas]), torch.stack([a.lambdas, b.lambdas])), gates, los, trunc_thr=THR
    )
    for i, single in enumerate((a, b)):
        want = tm.apply_pairs_mps(single, gates, los, trunc_thr=THR)
        np.testing.assert_allclose(_vec(both[i]), _vec(want), atol=PARITY)
    with pytest.raises(ValueError, match="disjoint"):
        tm.apply_pairs_mps(a, gates[:2], (0, 1), trunc_thr=THR)
