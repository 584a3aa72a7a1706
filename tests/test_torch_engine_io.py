"""The rest of the port's MPS engine, its circuit export, the solution
program of a result and the checkpoint files, held against the JAX package
on the CPU in complex128:

* ``apply_program_mps`` (non-adjacent gates through the swap network),
  ``mps_from_dense``, ``pair_thetas`` and ``rand_mps_vec`` (the θ drawn by
  numpy and passed to both): bond spectra and overlaps within 1e-10, not
  raw Γ;
* ``ansatz_to_program`` (Trotter 1st and 2nd order, cx/cz/cp, pruning by
  ``tol``) and ``program_from_result``: equal gate lists; the dense
  ``ansatz_to_numpy_*`` matrices within 1e-12;
* ``save_checkpoint`` / ``load_checkpoint`` round trips in the port and
  across packages (a file written by one loads in the other, read with
  numpy), ``save_pytree`` / ``load_pytree`` on nested tensors."""

import numpy as np
import pytest
import torch

from aqc_research_tpu.circuit import export as jexport
from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.program import ProgramBuilder as JPB
from aqc_research_tpu.circuit.structures import create_ansatz_structure, make_trotter_like_circuit
from aqc_research_tpu.io import checkpoint as jck
from aqc_research_tpu.models.sp_lhs import evol_utils as jev
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.circuit import export as texport
from aqc_research_tpu_torch.circuit.program import ProgramBuilder
from aqc_research_tpu_torch.io import checkpoint as tck
from aqc_research_tpu_torch.models.sp_lhs import evol_utils as tev
from aqc_research_tpu_torch.ops import mps as tm
from tests import _torch_threads  # noqa: F401

TOL = 1e-10
N, CHI = 5, 16


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    previous = config._DEVICE
    config.set_device("cpu")
    config.set_svd_impl("native")
    yield
    config.set_svd_impl(None)
    config.set_device(previous)


def _port(jmps) -> tm.MPS:
    return interop.mps_to_torch(np.asarray(jmps.gammas), np.asarray(jmps.lambdas), torch.complex128, "cpu")


def _same_state(tmps: tm.MPS, jmps):
    """Overlap and bond spectra (not raw Γ, which carry a gauge)."""
    theirs = _port(jmps)
    assert abs(float(tm.mps_dot(theirs, tmps).abs()) - 1.0) <= TOL
    np.testing.assert_allclose(tmps.lambdas.numpy(), np.asarray(jmps.lambdas), atol=TOL, rtol=0)
    np.testing.assert_allclose(tm.mps_to_vector(tmps).numpy(), np.asarray(jm.mps_to_vector(jmps)), atol=TOL)


def _gates(program):
    return [(g.name, tuple(g.qubits), None if g.param is None else float(g.param)) for g in program]


def test_apply_program_mps_matches_jax():
    start_j = jm.mps_from_program(JPB(N).h(0).h(3).build(), N, chi_max=CHI)
    start_t = tm.mps_from_program(ProgramBuilder(N).h(0).h(3).build(), N, chi_max=CHI)
    jq, tq = JPB(N), ProgramBuilder(N)
    for qb in (jq, tq):
        qb.rx(0.3, 1).cx(0, 4).ry(0.7, 2).cp(0.5, 4, 1).cz(1, 3).rz(-0.4, 3).cx(3, 0).p(0.2, 2)
    _same_state(tm.apply_program_mps(start_t, tq.build()), jm.apply_program_mps(start_j, jq.build()))


def test_mps_from_dense_matches_jax():
    rng = np.random.default_rng(4)
    vec = rng.standard_normal(2**N) + 1j * rng.standard_normal(2**N)
    vec /= np.linalg.norm(vec)
    got = tm.mps_from_dense(vec, CHI)
    _same_state(got, jm.mps_from_dense(vec, CHI))
    np.testing.assert_allclose(tm.mps_to_vector(got).numpy(), vec, atol=TOL)
    assert tm.check_mps(got) and got.gammas.dtype == torch.complex128
    # A tensor input and a capped χ (4 < the middle bonds' rank 4, 8...).
    capped = tm.mps_from_dense(torch.tensor(vec), 4)
    _same_state(capped, jm.mps_from_dense(vec, 4))
    with pytest.raises(ValueError):
        tm.mps_from_dense(np.ones(6), 4)


def test_pair_thetas_match_jax():
    rng = np.random.default_rng(5)
    vec = rng.standard_normal(2**N) + 1j * rng.standard_normal(2**N)
    vec /= np.linalg.norm(vec)
    gates = rng.standard_normal((2, 4, 4)) + 1j * rng.standard_normal((2, 4, 4))
    got = tm.pair_thetas(tm.mps_from_dense(vec, CHI), torch.tensor(gates), (0, 2))
    want = np.asarray(jm.pair_thetas(jm.mps_from_dense(vec, CHI), gates, (0, 2)))
    assert got.shape == (2, 2 * CHI, 2 * CHI)
    # Gauge-free: the singular values of each pair matrix.
    np.testing.assert_allclose(torch.linalg.svdvals(got).numpy(), np.linalg.svd(want, compute_uv=False), atol=TOL)


@pytest.mark.parametrize("entangler", ["cx", "cz", "cp"])
def test_rand_mps_vec_with_given_thetas_matches_jax(entangler):
    """torch cannot redraw JAX's random stream: the angles come from numpy
    and go to both; the JAX state is rebuilt from the same spin ansatz."""
    layers = 2
    jc = JAnsatz.make(N, entangler, create_ansatz_structure(N, "spin", "full", layers * (N - 1)))
    th = np.random.default_rng(6).uniform(-np.pi, np.pi, jc.num_thetas)
    want = jm.mps_from_program(jexport.ansatz_to_program(jc, th), N, chi_max=CHI)
    got = tm.rand_mps_vec(N, layers, CHI, entangler=entangler, thetas=th)
    _same_state(got, want)
    # Drawn from a generator: reproducible, normalized, bond-limited.
    a = tm.rand_mps_vec(N, layers, CHI, generator=torch.Generator().manual_seed(3))
    b = tm.rand_mps_vec(N, layers, CHI, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.gammas, b.gammas) and abs(float(tm.mps_norm(a)) - 1.0) <= TOL


@pytest.mark.parametrize(
    "kind,tol",
    [("trotter1", 0.0), ("trotter2", 0.0), ("cx", 0.0), ("cz", 0.0), ("cp", 0.3)],
)
def test_ansatz_to_program_matches_jax(kind, tol):
    if kind.startswith("trotter"):
        jc = JTrotterAnsatz.make(4, make_trotter_like_circuit(4, 2), kind == "trotter2")
    else:
        jc = JAnsatz.make(4, kind, create_ansatz_structure(4, "spin", "full", 5))
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    th = np.random.default_rng(8).uniform(-1.0, 1.0, jc.num_thetas)
    want = jexport.ansatz_to_program(jc, th, tol=tol)
    assert _gates(texport.ansatz_to_program(tc, th, tol=tol)) == _gates(want)
    assert _gates(texport.ansatz_to_program(tc, torch.tensor(th), tol=tol)) == _gates(want)
    if tol == 0.0:
        m = np.asarray(jexport.ansatz_to_numpy_fast(jc, th))
        np.testing.assert_allclose(texport.ansatz_to_numpy_fast(tc, th), m, atol=1e-12)
        np.testing.assert_allclose(texport.ansatz_to_numpy_trotter(tc, th), m, atol=1e-12)


def test_program_from_result_matches_jax():
    jc = JTrotterAnsatz.make(4, make_trotter_like_circuit(4, 2), True)
    result = {"entangler": "cx", "num_qubits": 4, "blocks": jc.blocks.copy(), "second_order_trotter": True,
              "thetas": np.random.default_rng(9).uniform(-1, 1, jc.num_thetas)}
    for tol in (0.0, 0.5):
        want = _gates(jev.program_from_result(result, tol=tol))
        assert _gates(tev.program_from_result(result, tol=tol)) == want
        assert _gates(tev.qcircuit_from_result(result, tol=tol)) == want


_CK_VEC = np.random.default_rng(10).standard_normal(16) + 0.5j
_CK_VEC /= np.linalg.norm(_CK_VEC)
_CK_THETAS = np.linspace(-1.0, 1.0, 7)


def _ck_state(mps_pkg):
    return {"thetas": _CK_THETAS.copy(), "horizon": 3, "tag": "run-a", "fobj": 0.125, "best": [1, 2],
            "solution": mps_pkg.mps_from_dense(_CK_VEC, 8)}


def _check_loaded(loaded):
    assert loaded["horizon"] == 3 and loaded["tag"] == "run-a" and loaded["fobj"] == 0.125
    assert loaded["best"] == [1, 2]
    np.testing.assert_array_equal(np.asarray(loaded["thetas"]), _CK_THETAS)
    sol = loaded["solution"]
    sol = tm.MPS(torch.tensor(np.asarray(sol.gammas)), torch.tensor(np.asarray(sol.lambdas)))
    np.testing.assert_allclose(tm.mps_to_vector(sol).numpy(), _CK_VEC, atol=TOL)


def test_checkpoint_round_trip_in_the_port(tmp_path):
    state = _ck_state(tm)
    state["thetas"] = torch.tensor(state["thetas"])  # a tensor goes in, numpy comes out
    path = tck.save_checkpoint(str(tmp_path / "ck"), state)
    assert path.endswith(".npz")
    loaded = tck.load_checkpoint(str(tmp_path / "ck"))
    assert isinstance(loaded["thetas"], np.ndarray) and loaded["solution"].gammas.device.type == "cpu"
    _check_loaded(loaded)
    assert tck.load_checkpoint(str(tmp_path / "absent")) is None
    with pytest.raises(ValueError):
        tck.save_checkpoint(str(tmp_path / "bad"), {"a.b": 1})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_cross_packages(tmp_path, writer):
    """A file one package writes loads in the other; both files hold the
    same arrays under the same keys (read with numpy)."""
    jstate, tstate = _ck_state(jm), _ck_state(tm)
    if writer == "jax":
        path = jck.save_checkpoint(str(tmp_path / "ck"), jstate)
        _check_loaded(tck.load_checkpoint(path))
    else:
        path = tck.save_checkpoint(str(tmp_path / "ck"), tstate)
        _check_loaded(jck.load_checkpoint(path))
    other = (tck if writer == "jax" else jck).save_checkpoint(
        str(tmp_path / "other"), tstate if writer == "jax" else jstate
    )
    with np.load(path) as a, np.load(other) as b:
        assert sorted(a.files) == sorted(b.files) == ["__meta__", "solution.gammas", "solution.lambdas", "thetas"]
        assert bytes(a["__meta__"]) == bytes(b["__meta__"])
        np.testing.assert_array_equal(a["thetas"], b["thetas"])


def test_pytree_round_trip(tmp_path):
    tree = {"lbfgs": {"s": torch.randn(3, 4, dtype=torch.float64), "k": 7, "rho": [torch.ones(2), 0.5]},
            "z": (torch.zeros(2, dtype=torch.complex128) + 1j, np.arange(3))}
    path = tck.save_pytree(str(tmp_path / "tree"), tree)
    like = {"lbfgs": {"s": torch.zeros(3, 4, dtype=torch.float64), "k": 0, "rho": [torch.zeros(2), 0.0]},
            "z": (torch.zeros(2, dtype=torch.complex128), np.zeros(3, dtype=np.int64))}
    back = tck.load_pytree(path, like)
    assert torch.equal(back["lbfgs"]["s"], tree["lbfgs"]["s"]) and back["lbfgs"]["k"] == 7
    assert torch.equal(back["lbfgs"]["rho"][0], tree["lbfgs"]["rho"][0]) and back["lbfgs"]["rho"][1] == 0.5
    assert isinstance(back["z"], tuple) and torch.equal(back["z"][0], tree["z"][0])
    np.testing.assert_array_equal(back["z"][1], np.arange(3))
