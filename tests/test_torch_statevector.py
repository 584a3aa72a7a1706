"""The port's dense engine (ops/statevector.py), gate-program appliers
(circuit/program.py) and co-sweep gradient (ops/gradients.py) held against
the JAX package on the CPU in complex128.

* ``v_mul_vec``, ``v_dagger_mul_vec``, ``v_mul_mat``, ``v_dagger_mul_mat``
  and ``ansatz_to_matrix`` within 1e-10 for n = 3–6: Trotter ansatze of 1st
  and 2nd order (1 layer: the unrolled groups; 2 layers: the loop over a
  repeated period) and generic ansatze with cx, cz and cp entanglers on
  full connectivity (non-adjacent pairs take the unfused path); the fusion
  plan and the structure period equal the JAX package's.
* ``apply_program``, ``program_to_state``, ``program_to_matrix`` over every
  gate kind; ``inverse_program`` gives the adjoint.
* ``grad_of_dot_product`` and ``grad_of_matrix_dot_product`` within 1e-10
  of the JAX co-sweep and of ``torch.autograd``
  (``grad_of_dot_product_autodiff``), with ``block_range`` and
  ``front_layer=False`` cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu.circuit import program as jprog
from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.ops import gradients as jgrad
from aqc_research_tpu.ops import statevector as jsv
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.circuit import program as tprog
from aqc_research_tpu_torch.ops import gradients as tgrad
from aqc_research_tpu_torch.ops import statevector as tsv
from tests import _torch_threads  # noqa: F401

TOL = 1e-10
C128 = torch.complex128


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


def _generic_blocks(n: int, seed: int) -> np.ndarray:
    """Full connectivity: random ordered pairs, at least one non-adjacent."""
    rng = np.random.default_rng(seed)
    pairs = [(c, t) for c in range(n) for t in range(n) if c != t]
    chosen = [pairs[i] for i in rng.choice(len(pairs), size=2 * n, replace=True)]
    chosen[0] = (0, n - 1)
    return np.asarray(chosen).T


# (id, builder) — each builds the JAX ansatz.
CASES = {
    "trot1-n3-l1": lambda: JTrotterAnsatz.make(3, make_trotter_like_circuit(3, 1), False),
    "trot2-n3-l2": lambda: JTrotterAnsatz.make(3, make_trotter_like_circuit(3, 2), True),
    "trot1-n4-l2": lambda: JTrotterAnsatz.make(4, make_trotter_like_circuit(4, 2), False),
    "trot2-n4-l1": lambda: JTrotterAnsatz.make(4, make_trotter_like_circuit(4, 1), True),
    "trot2-n5-l2": lambda: JTrotterAnsatz.make(5, make_trotter_like_circuit(5, 2), True),
    "trot2-n6-l2": lambda: JTrotterAnsatz.make(6, make_trotter_like_circuit(6, 2), True),
    "cx-n4": lambda: JAnsatz.make(4, "cx", _generic_blocks(4, 1)),
    "cz-n5": lambda: JAnsatz.make(5, "cz", _generic_blocks(5, 2)),
    "cp-n4": lambda: JAnsatz.make(4, "cp", _generic_blocks(4, 3)),
}


def _case(name: str, seed: int = 0):
    jc = CASES[name]()
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, jc.num_thetas)
    return jc, tc, th, rng


def _rand_complex(rng, shape):
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return a / np.linalg.norm(a)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax(name):
    jc, tc, th, rng = _case(name)
    dim = jc.dimension
    vec = _rand_complex(rng, dim)
    mat = _rand_complex(rng, (dim, dim))  # the width of ansatz_to_matrix: one JAX program for both
    jth, tth = jnp.asarray(th), torch.tensor(th)
    _close(tsv.v_mul_vec(tc, tth, torch.tensor(vec)), jsv.v_mul_vec(jc, jth, jnp.asarray(vec)))
    _close(tsv.v_dagger_mul_vec(tc, tth, torch.tensor(vec)), jsv.v_dagger_mul_vec(jc, jth, jnp.asarray(vec)))
    _close(tsv.v_mul_mat(tc, tth, torch.tensor(mat)), jsv.v_mul_mat(jc, jth, jnp.asarray(mat)))
    _close(tsv.v_dagger_mul_mat(tc, tth, torch.tensor(mat)), jsv.v_dagger_mul_mat(jc, jth, jnp.asarray(mat)))
    v = tsv.ansatz_to_matrix(tc, tth)
    assert v.dtype == C128 and v.device.type == "cpu"
    _close(v, jsv.ansatz_to_matrix(jc, jth))
    # Unitary, and V† undoes V; numpy thetas give the tensor thetas' result.
    _close(v.conj().T @ v, np.eye(dim))
    back = tsv.v_dagger_mul_vec(tc, th, tsv.v_mul_vec(tc, th, torch.tensor(vec)))
    _close(back, vec)


@pytest.mark.parametrize("name", list(CASES))
def test_fusion_plan_matches_jax(name):
    """Same structure period and fusion groups (so the same number of passes
    over the state) as the JAX engine, in both sweep directions."""
    jc, tc, _, _ = _case(name)
    assert tsv.structure_period(tc) == jsv.structure_period(jc)
    assert tsv._split_periods(tc) == jsv._split_periods(jc)
    pattern = tsv._block_pattern(tc)
    for seq in (pattern, pattern[::-1]):
        assert tsv._plan_disjoint_groups(seq) == jsv._plan_disjoint_groups(seq)
    if tc.is_trotterized:  # a triplet-layer half-layer fuses 3 pairs into one pass
        assert max(len(g) for g in tsv._plan_disjoint_groups(pattern)) == 3 * min(3, (tc.num_qubits) // 2)


def test_apply_primitives_match_jax():
    rng = np.random.default_rng(7)
    n = 4
    state = _rand_complex(rng, (2, 2**n))  # a leading batch dim
    g2 = _rand_complex(rng, (2, 2))
    g4 = _rand_complex(rng, (4, 4))
    for q in range(n):
        _close(tsv.apply_1q(torch.tensor(state), torch.tensor(g2), q),
               jsv.apply_1q(jnp.asarray(state), jnp.asarray(g2), q))
    for c, t in ((0, 1), (1, 0), (0, 3), (3, 1)):
        _close(tsv.apply_2q(torch.tensor(state), torch.tensor(g4), c, t),
               jsv.apply_2q(jnp.asarray(state), jnp.asarray(g4), c, t))
    w, z = _rand_complex(rng, 2**n), _rand_complex(rng, 2**n)
    for pauli in "xyz":
        for q in range(n):
            got = tsv.pauli_dot(torch.tensor(w), torch.tensor(z), pauli, q)
            assert abs(complex(got) - complex(jsv.pauli_dot(jnp.asarray(w), jnp.asarray(z), pauli, q))) <= TOL
    with pytest.raises(ValueError):
        tsv.pauli_dot(torch.tensor(w), torch.tensor(z), "q", 0)


def _every_gate_program(builder_cls, n):
    qb = builder_cls(n)
    qb.x(0).y(1).z(2).h(3).rx(0.3, 1).ry(-0.7, 2).rz(1.1, 0).p(0.4, 3)
    qb.cx(0, 1).cx(3, 1).cz(2, 0).cp(0.9, 1, 3).cp(-0.2, 2, 1).h(0)
    return qb.build()


def test_program_appliers_match_jax():
    n = 4
    jp = _every_gate_program(jprog.ProgramBuilder, n)
    tp = _every_gate_program(tprog.ProgramBuilder, n)
    _close(tprog.program_to_state(tp, n), jprog.program_to_state(jp, n))
    mat = tprog.program_to_matrix(tp, n)
    _close(mat, jprog.program_to_matrix(jp, n))
    rng = np.random.default_rng(11)
    cols = _rand_complex(rng, (2**n, 5))
    _close(tprog.apply_program(torch.tensor(cols), tp, tail=5),
           jprog.apply_program(jnp.asarray(cols), jp, tail=5))
    # The adjoint program is the adjoint operator.
    _close(tprog.program_to_matrix(tprog.inverse_program(tp), n), mat.numpy().conj().T)
    assert tprog.inverse_program(tp) == tuple(
        tprog.Gate(g.name, g.qubits, g.param) for g in jprog.inverse_program(jp)
    )
    prep = tprog.state_preparation_program(n, flip_bit=2, state_prep_func=lambda k: tp[:3])
    assert prep == (tprog.Gate("x", (2,)),) + tp[:3]


GRAD_CASES = [
    ("trot2-n4-l1", None, True),
    ("trot2-n5-l2", (3, 12), True),
    ("trot1-n4-l2", None, False),
    ("trot2-n6-l2", (0, 15), False),
    ("cx-n4", None, True),
    ("cz-n5", (2, 7), True),
    ("cp-n4", (1, 6), False),
]


@pytest.mark.parametrize("name,block_range,front_layer", GRAD_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'front' if c[2] else 'nofront'}" for c in GRAD_CASES])
def test_vector_gradient_matches_jax_and_autograd(name, block_range, front_layer):
    jc, tc, th, rng = _case(name, seed=5)
    x = _rand_complex(rng, jc.dimension)
    y = _rand_complex(rng, jc.dimension)
    vh_y = tsv.v_dagger_mul_vec(tc, torch.tensor(th), torch.tensor(y))
    got = tgrad.grad_of_dot_product(tc, torch.tensor(th), torch.tensor(x), vh_y,
                                    block_range=block_range, front_layer=front_layer)
    want = jgrad.grad_of_dot_product(jc, jnp.asarray(th), jnp.asarray(x), jnp.asarray(vh_y.numpy()),
                                     block_range=block_range, front_layer=front_layer)
    assert got.dtype == C128 and got.shape == (jc.num_thetas,)
    _close(got, want)
    # Against autograd: the full derivative inside the range (a half-layer
    # block's entry holds both of its contributions), exactly 0 outside.
    auto = tgrad.grad_of_dot_product_autodiff(tc, torch.tensor(th), torch.tensor(x), torch.tensor(y))
    lo, hi = (0, tc.num_blocks) if block_range is None else block_range
    inside = np.zeros(tc.num_thetas, bool)
    inside[: 3 * tc.num_qubits] = front_layer
    inside[3 * tc.num_qubits + tc.tpb * lo : 3 * tc.num_qubits + tc.tpb * hi] = True
    np.testing.assert_allclose(got.numpy()[inside], auto.numpy()[inside], atol=TOL, rtol=0)
    assert not got.numpy()[~inside].any()


@pytest.mark.parametrize("name", ["trot2-n4-l1", "cp-n4"])
def test_matrix_gradient_matches_jax_and_autograd(name):
    jc, tc, th, rng = _case(name, seed=9)
    x = _rand_complex(rng, (jc.dimension, 3))
    y = _rand_complex(rng, (jc.dimension, 3))
    vh_y = tsv.v_dagger_mul_mat(tc, torch.tensor(th), torch.tensor(y))
    got = tgrad.grad_of_matrix_dot_product(tc, torch.tensor(th), torch.tensor(x), vh_y)
    want = jgrad.grad_of_matrix_dot_product(jc, jnp.asarray(th), jnp.asarray(x), jnp.asarray(vh_y.numpy()))
    _close(got, want)
    _close(tgrad.grad_of_dot_product_autodiff(tc, torch.tensor(th), torch.tensor(x), torch.tensor(y)), want)
    # The dot product itself.
    d = complex(tgrad.dot_product(tc, torch.tensor(th), torch.tensor(x), torch.tensor(y)))
    assert abs(d - complex(jgrad.dot_product(jc, jnp.asarray(th), jnp.asarray(x), jnp.asarray(y)))) <= TOL


def test_gradient_rejects_bad_block_range():
    _, tc, th, rng = _case("trot2-n4-l1")
    x = torch.tensor(_rand_complex(rng, tc.dimension))
    for bad in ((0, 0), (2, 1), (0, tc.num_blocks + 1)):
        with pytest.raises(ValueError, match="block_range"):
            tgrad.grad_of_dot_product(tc, torch.tensor(th), x, x, block_range=bad)
