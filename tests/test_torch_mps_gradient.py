"""The port's MPS co-sweep gradient on every branch of its dispatch, held
against the JAX package's ``fast_dot_gradient`` and against the port's
dense co-sweep (``ops/gradients.grad_of_dot_product``), in complex128 at no
truncation, within 1e-10 (the JAX package's tests/test_mps_fast_dot_gradient.py
matrix, at the same small sizes; every branch against JAX in one or two
cases — each JAX case compiles its own program — and every case against
dense):

* the layered Trotter path without the layer cache (1st and 2nd order, 1
  and 2 layers, flip bits), and the z-cached one on a staircase layout of
  three pair groups per layer (not a chessboard);
* the plain layered path with cx, cz and cp at 2 and 3 layers;
* the per-gate sweep on random layouts with non-adjacent pairs (the swap
  network), cx, cz and cp;
* ``front_layer`` both ways and a partial ``block_range``: zero outside;
* ``jit_asp._mps_value_fns`` at one layer (no layer cache) against its JAX
  twin: value and value_and_grad."""

import numpy as np
import pytest
import torch

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import create_ansatz_structure, make_trotter_like_circuit
from aqc_research_tpu.models.sp_lhs import jit_asp as jja
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.ops import mps_gradient as jg
from aqc_research_tpu.utils import rand_circuit
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops import mps_gradient as tg
from aqc_research_tpu_torch.ops.gradients import grad_of_dot_product
from tests import _torch_threads  # noqa: F401

TOL = 1e-10


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


def _state(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    return v / np.linalg.norm(v)


def _compare(jc, flip_bit: int = -1, seed: int = 0, branch=None, z_cache: bool = False, vs_jax: bool = True,
             **kw):
    """The port's gradient of <x|V†|phi> against the dense one and, with
    ``vs_jax``, against JAX's; ``branch``: the port function the dispatch
    must reach."""
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    n = jc.num_qubits
    chi = 2**n  # exact
    th = np.random.default_rng(seed + 1).uniform(-np.pi, np.pi, jc.num_thetas)
    phi = _state(n, seed)
    bits = tuple(1 if q == flip_bit else 0 for q in range(n))
    x = np.zeros(2**n, complex)
    x[sum(b << q for q, b in enumerate(bits))] = 1.0
    jphi, tphi = jm.mps_from_dense(phi, chi), tm.mps_from_dense(phi, chi)
    tth = torch.tensor(th)
    if z_cache:
        jvh, jz = jm.v_dagger_mul_mps_layers(jc, th, jphi)
        tvh, tz = tm.v_dagger_mul_mps_layers(tc, tth, tphi)
        kw_j, kw_t = dict(kw, z_layers=jz), dict(kw, z_layers=tz)
    else:
        jvh, tvh = jm.v_dagger_mul_mps(jc, th, jphi), tm.v_dagger_mul_mps(tc, tth, tphi)
        kw_j = kw_t = kw
    want = np.asarray(jg.fast_dot_gradient(jc, th, jm.mps_basis_state(bits, chi), jvh, **kw_j)) if vs_jax else None
    calls = []
    if branch is not None:
        real = getattr(tg, branch)
        setattr(tg, branch, lambda *a, **k: calls.append(1) or real(*a, **k))
    try:
        got = tg.fast_dot_gradient(tc, tth, tm.mps_basis_state(bits, chi), tvh, **kw_t)
    finally:
        if branch is not None:
            setattr(tg, branch, real)
    assert branch is None or calls == [1], f"the dispatch did not take {branch}"
    dense = grad_of_dot_product(tc, tth, torch.tensor(x), tm.mps_to_vector(tvh), **kw)
    assert got.dtype == torch.complex128 and got.shape == (jc.num_thetas,)
    if vs_jax:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=TOL, rtol=0)
    return got.numpy(), tc


@pytest.mark.parametrize(
    "n,layers,second_order,flip_bit,vs_jax",
    [(3, 1, True, -1, False), (4, 1, False, 0, True), (4, 2, True, 2, True), (3, 2, False, 1, False)],
)
def test_layered_trotter_uncached(n, layers, second_order, flip_bit, vs_jax):
    jc = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), second_order)
    _compare(jc, flip_bit, seed=n + layers, branch="_fast_dot_gradient_layered", vs_jax=vs_jax)


def test_zcached_staircase_layout():
    """Triplets ordered (0,1), (1,2), (2,3): three pair groups per layer.
    The z-cached co-sweep takes its general branch (the last group skips the
    z update) instead of refusing the layout."""
    one = np.array([[1, 0, 1, 2, 1, 2, 3, 2, 3], [0, 1, 0, 1, 2, 1, 2, 3, 2]])
    jc = JTrotterAnsatz.make(4, np.concatenate([one, one], axis=1), False)
    assert len(tg._layered_plan(interop.ansatz_from_args(interop.ansatz_args(jc)))) == 3
    _compare(jc, 1, seed=9, branch="_fast_dot_gradient_layered_zcache", z_cache=True)


@pytest.mark.parametrize("entangler", ["cx", "cz", "cp"])
@pytest.mark.parametrize("layers", [2, 3])
def test_layered_plain(entangler, layers):
    one_layer = create_ansatz_structure(3, "spin", "full", 2)
    jc = JAnsatz.make(3, entangler, np.concatenate([one_layer] * layers, axis=1))
    vs_jax = (entangler, layers) in (("cp", 2), ("cz", 3))
    _, tc = _compare(jc, 0, seed=layers, branch="_fast_dot_gradient_layered_plain", vs_jax=vs_jax)
    assert tg._plain_layer_period(tc) == 2 and tg._plain_groups(tc, 2) == [[0], [1]]


@pytest.mark.parametrize("entangler", ["cx", "cz", "cp"])
def test_per_gate_random_layout(entangler):
    np.random.seed(21)
    blocks = rand_circuit(4, 5)
    assert np.any(np.abs(blocks[0] - blocks[1]) > 1)  # the swap network runs
    jc = JAnsatz.make(4, entangler, blocks)
    _compare(jc, 3, seed=4, branch="_fast_dot_gradient_impl", vs_jax=entangler == "cp")


@pytest.mark.parametrize("front_layer", [False, True])
@pytest.mark.parametrize("kind", ["trotter", "plain", "per-gate"])
def test_partial_block_range(kind, front_layer):
    if kind == "trotter":
        jc = JTrotterAnsatz.make(3, make_trotter_like_circuit(3, 2), True)
        block_range = (jc.bpl, 2 * jc.bpl)
    elif kind == "plain":
        jc = JAnsatz.make(3, "cz", np.concatenate([create_ansatz_structure(3, "spin", "full", 2)] * 2, axis=1))
        block_range = (2, 4)
    else:
        np.random.seed(5)
        jc = JAnsatz.make(3, "cp", rand_circuit(3, 4))
        block_range = (1, 3)
    vs_jax = kind == "trotter" and not front_layer
    got, tc = _compare(jc, -1, seed=11, vs_jax=vs_jax, block_range=block_range, front_layer=front_layer)
    g2 = tc.subset2q(got)
    assert np.all(g2[: block_range[0]] == 0) and np.all(g2[block_range[1] :] == 0)
    assert np.any(g2[block_range[0] : block_range[1]] != 0)
    assert np.any(tc.subset1q(got) != 0) == front_layer


def test_bad_arguments():
    tc = interop.ansatz_from_args(interop.ansatz_args(JTrotterAnsatz.make(3, make_trotter_like_circuit(3, 1), True)))
    lvec = tm.mps_zero(3, 8)
    th = torch.zeros(tc.num_thetas, dtype=torch.float64)
    with pytest.raises(ValueError, match="block_range"):
        tg.fast_dot_gradient(tc, th, lvec, lvec, block_range=(2, 2))
    with pytest.raises(ValueError, match="grow_w"):
        tg.fast_dot_gradient(tc, th, tm.mps_from_dense(_state(3, 1), 8), lvec, grow_w=True)


def test_mps_value_fns_one_layer_matches_jax():
    """``_mps_value_fns`` at one layer: no layer cache, so value_and_grad
    takes the V† sweep and the uncached co-sweep (the JAX package's
    jit_asp.py:429-435)."""
    n, chi = 4, 16
    jc = JTrotterAnsatz.make(n, make_trotter_like_circuit(n, 1), True)
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    assert not tm.v_dagger_layer_cache_eligible(tc)
    th = np.random.default_rng(2).uniform(-np.pi, np.pi, jc.num_thetas)
    phi = _state(n, 3)
    bits = (1, 0, 1, 0)
    jv, jvg = jja._mps_value_fns(jc, bits, 1e-16)
    tv, tvg = tja._mps_value_fns(tc, bits, 1e-16)
    jt, tt = jm.mps_from_dense(phi, chi), tm.mps_from_dense(phi, chi)
    jf, jgr = jvg(th, jt)
    tf, tgr = tvg(torch.tensor(th), tt)
    assert abs(float(tf) - float(jf)) <= TOL and abs(float(tv(torch.tensor(th), tt)) - float(jv(th, jt))) <= TOL
    assert abs(float(tf) - float(tv(torch.tensor(th), tt))) <= TOL
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), atol=TOL, rtol=0)
    # Against a central difference of the value (the gradient of the
    # fidelity objective, not only of the dot).
    k, eps = 7, 1e-5
    step = np.zeros_like(th)
    step[k] = eps
    fd = (float(tv(torch.tensor(th + step), tt)) - float(tv(torch.tensor(th - step), tt))) / (2 * eps)
    assert abs(fd - float(tgr[k])) <= 1e-8


# -----------------------------------------------------------------------------
# The port alone (the JAX file's TestMpsLayeredPlainPath,
# TestMpsPartialGradientRandomLayout and TestMpsNumericGradient): the plain
# layered path against the per-gate sweep, a partial gradient against the
# full one on a random layout with inserted blocks, and the gradient
# against central differences of the MPS objective.
# -----------------------------------------------------------------------------

SQRT_EPS = float(np.sqrt(np.finfo(np.float64).eps))


def _port_case(tc, seed: int, chi: int):
    th = torch.tensor(np.random.default_rng(seed).uniform(-np.pi, np.pi, tc.num_thetas))
    phi = tm.mps_from_dense(_state(tc.num_qubits, seed + 1), chi)
    return th, phi, tm.mps_zero(tc.num_qubits, chi)


@pytest.mark.parametrize("entangler", ["cx", "cz", "cp"])
def test_plain_layered_equals_per_gate(entangler):
    one_layer = create_ansatz_structure(4, "spin", "full", 3)
    tc = interop.ansatz_from_args(interop.ansatz_args(
        JAnsatz.make(4, entangler, np.concatenate([one_layer] * 2, axis=1))))
    th, phi, lvec = _port_case(tc, 31, 16)
    vh = tm.v_dagger_mul_mps(tc, th, phi)
    args = (float(tm.no_truncation_threshold()), (0, tc.num_blocks), True)
    layered = tg._fast_dot_gradient_layered_plain(tc, th, lvec, vh, *args)
    per_gate = tg._fast_dot_gradient_impl(tc, th, lvec, vh, *args)
    np.testing.assert_allclose(layered.numpy(), per_gate.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("entangler", ["cz", "cp"])
@pytest.mark.parametrize("front_layer", [False, True])
def test_partial_vs_full_random_layout(entangler, front_layer):
    """Blocks inserted into a random (non-adjacent) layout: the partial
    gradient over them equals the full one there and is zero elsewhere."""
    rng = np.random.default_rng(41)
    np.random.seed(41)
    tc = interop.ansatz_from_args(interop.ansatz_args(JAnsatz.make(3, entangler, rand_circuit(3, 4))))
    new_blocks = rand_circuit(3, 2)
    pos = int(rng.integers(0, tc.num_blocks + 1))
    th = rng.uniform(-np.pi, np.pi, tc.num_thetas)
    tc, th, idx = tc.insert_unit_blocks(pos, new_blocks, th)
    assert np.all(th[idx] == 0)
    block_range = (pos, pos + new_blocks.shape[1])
    phi = tm.mps_from_dense(_state(3, 42), 8)
    lvec = tm.mps_zero(3, 8)
    vh = tm.v_dagger_mul_mps(tc, torch.tensor(th), phi)
    full = tg.fast_dot_gradient(tc, th, lvec, vh).numpy()
    part = tg.fast_dot_gradient(tc, th, lvec, vh, block_range=block_range, front_layer=front_layer).numpy()
    np.testing.assert_allclose(tc.subset1q(part), tc.subset1q(full) if front_layer else 0, atol=SQRT_EPS)
    np.testing.assert_allclose(part[idx], full[idx], atol=SQRT_EPS)
    rows = tc.subset2q(part)
    assert np.all(rows[: block_range[0]] == 0) and np.all(rows[block_range[1] :] == 0)


@pytest.mark.parametrize(
    "kind", ["trotter-uncached", "plain-cp", "per-gate-cz"],
)
def test_gradient_vs_central_differences(kind):
    """d/dθ_k <lvec|V†(θ)|phi> against central differences of the MPS
    objective itself, on every branch (step 1e-5, c128)."""
    if kind == "trotter-uncached":
        jc = JTrotterAnsatz.make(4, make_trotter_like_circuit(4, 1), True)
    elif kind == "plain-cp":
        jc = JAnsatz.make(3, "cp", np.concatenate([create_ansatz_structure(3, "spin", "full", 2)] * 2, axis=1))
    else:
        np.random.seed(8)
        jc = JAnsatz.make(4, "cz", rand_circuit(4, 4))
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    chi = 2**tc.num_qubits
    th, phi, lvec = _port_case(tc, 51, chi)

    def dot(t):
        return complex(tm.mps_dot(lvec, tm.v_dagger_mul_mps(tc, t, phi)))

    grad = tg.fast_dot_gradient(tc, th, lvec, tm.v_dagger_mul_mps(tc, th, phi)).numpy()
    eps = 1e-5
    for k in np.random.default_rng(52).choice(tc.num_thetas, 6, replace=False):
        step = torch.zeros_like(th)
        step[k] = eps
        fd = (dot(th + step) - dot(th - step)) / (2 * eps)
        assert abs(fd - grad[k]) <= 1e-8, (kind, k)
