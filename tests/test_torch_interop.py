"""The port's interop and tool modules against the JAX package on the CPU:

* ``circuit/qasm.py``: for the same exported ansatz programs the OpenQASM 3
  text is the JAX package's, character for character, and it round-trips
  through the port's parser; the parser refuses what is outside the
  subset;
* ``export.ansatz_to_numpy_by_qiskit`` within 1e-12 of JAX's;
* every ``compat.py`` wrapper within 1e-12 of JAX's on the same inputs;
* ``io/native.py``: ``svd_c128`` and ``mps_pair_update`` against the JAX
  package's bindings and the port's c128 ``_pair_update``;
* ``utils/profiling.py`` on the CPU;
* the kernel-build-once rule under a two-rank Gloo group: one build, and
  every rank loads after it."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu import compat as jcompat
from aqc_research_tpu.circuit import export as jexport
from aqc_research_tpu.circuit import qasm as jqasm
from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import create_ansatz_structure, make_trotter_like_circuit
from aqc_research_tpu.io import native as jnative
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu_torch import compat as tcompat
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.circuit import export as texport
from aqc_research_tpu_torch.circuit.program import Gate
from aqc_research_tpu_torch.circuit import qasm as tqasm
from aqc_research_tpu_torch.io import native as tnative
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.utils import profiling
from tests._torch_gloo import GlooPool

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    previous = config._DEVICE
    config.set_device("cpu")
    config.set_svd_impl("native")
    yield
    config.set_svd_impl(None)
    config.set_device(previous)


def _ansatzes():
    """A 2nd- and a 1st-order Trotter ansatz and generic cx / cp ones, in
    both packages, with angles that include exact multiples of π/2 and
    near-zero ones (the pruning ``tol``)."""
    out = []
    for jc in (JTrotterAnsatz.make(4, make_trotter_like_circuit(4, 2), True),
               JTrotterAnsatz.make(5, make_trotter_like_circuit(5, 1), False),
               JAnsatz.make(4, "cx", create_ansatz_structure(4, "spin", "full", 6)),
               JAnsatz.make(3, "cp", create_ansatz_structure(3, "line", "full", 4))):
        th = np.random.default_rng(jc.num_thetas).uniform(-np.pi, np.pi, jc.num_thetas)
        th[::7] = np.pi / 2
        th[3::11] = 1e-9
        out.append((jc, interop.ansatz_from_args(interop.ansatz_args(jc)), th))
    return out


# -----------------------------------------------------------------------------
# OpenQASM 3.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("tol", [0.0, 1e-6])
def test_qasm_text_is_the_jax_text_and_round_trips(tol):
    for jc, tc, th in _ansatzes():
        n = jc.num_qubits
        tprog = texport.ansatz_to_program(tc, th, tol=tol)
        text = tqasm.program_to_qasm3(tprog, n)
        assert text == jqasm.program_to_qasm3(jexport.ansatz_to_program(jc, th, tol=tol), n)
        back, nq = tqasm.program_from_qasm3(text)
        assert nq == n and len(back) == len(tprog)
        for a, b in zip(back, tprog):
            assert (a.name, a.qubits) == (b.name, b.qubits)
            assert (a.param is None and b.param is None) or a.param == b.param


def test_qasm_parser_subset_and_save(tmp_path):
    prog, n = tqasm.program_from_qasm3(
        'OPENQASM 3.0;\ninclude "stdgates.inc";\nqubit[2] q;\n// comment\nrx(2*pi) q[0];\n'
        "cp(-pi/4) q[0], q[1];\nh q[1];\n")
    assert n == 2 and [g.name for g in prog] == ["rx", "cp", "h"]
    assert prog[0].param == 2 * math.pi and prog[1].param == -math.pi / 4
    for bad in ("qubit[2] q;\nmeasure q[0];\n", "qubit[1] q;\nu3(1,2,3) q[0];\n", "qubit[1] q;\nrx q[0];\n",
                "x q[0];\n"):
        with pytest.raises(ValueError):
            tqasm.program_from_qasm3(bad)
    path = tmp_path / "c.qasm"
    tqasm.save_qasm3(prog, n, path)
    assert path.read_text() == tqasm.program_to_qasm3(prog, n)


def test_ansatz_to_numpy_by_qiskit_matches_jax():
    for jc, tc, th in _ansatzes():
        want = np.asarray(jexport.ansatz_to_numpy_by_qiskit(jc, th, tol=1e-6))
        config.set_precision("high")
        got = texport.ansatz_to_numpy_by_qiskit(tc, th, tol=1e-6)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        np.testing.assert_allclose(got, texport.ansatz_to_numpy_fast(tc, th), atol=1e-5, rtol=0)
        assert texport.ansatz_to_qcircuit is texport.ansatz_to_program


# -----------------------------------------------------------------------------
# compat.py.
# -----------------------------------------------------------------------------


def _np(x):
    if isinstance(x, (tm.MPS, jm.MPS)):
        x = (tm if isinstance(x, tm.MPS) else jm).mps_to_vector(x)
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x)


def _compat_calls():
    """(name, JAX args, port args) of every compat wrapper on a 4-qubit
    state, a (16, 3) matrix and a 4-qubit χ=16 MPS."""
    rng = np.random.default_rng(31)
    n = 4
    vec = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    vec2 = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    mat = rng.standard_normal((2**n, 3)) + 1j * rng.standard_normal((2**n, 3))
    mat2 = rng.standard_normal((2**n, 3)) + 1j * rng.standard_normal((2**n, 3))
    g2 = np.linalg.qr(rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2)))[0]
    jmps, tmps = jm.mps_from_dense(vec / np.linalg.norm(vec), 16), tm.mps_from_dense(vec / np.linalg.norm(vec), 16)
    jmps2, tmps2 = (jm.mps_from_dense(vec2 / np.linalg.norm(vec2), 16),
                    tm.mps_from_dense(vec2 / np.linalg.norm(vec2), 16))
    jcirc = JAnsatz.make(n, "cp", create_ansatz_structure(n, "spin", "full", 3))
    tcirc = interop.ansatz_from_args(interop.ansatz_args(jcirc))
    tht = rng.uniform(-np.pi, np.pi, 5)
    jprog = jexport.ansatz_to_program(jcirc, rng.uniform(-np.pi, np.pi, jcirc.num_thetas))
    tprog = tuple(Gate(g.name, g.qubits, g.param) for g in jprog)
    calls = [("gate2x2_mul_vec", (g2, vec, 2), None), ("derv_cphase_mul_vec", (0.7, 1, 3, vec), None),
             ("proj00_mul_vec", (vec, 1), None), ("proj11_mul_vec", (vec, 3), None),
             ("cx_mul_vec", (3, 0, vec), None), ("cz_mul_vec", (1, 2, vec), None),
             ("cp_mul_vec", (0.3, 2, 0, vec), None), ("gate2x2_mul_mat", (g2, mat, 1), None),
             ("cx_mul_mat", (0, 2, mat), None), ("cz_mul_mat", (2, 3, mat), None),
             ("cp_mul_mat", (-1.1, 1, 0, mat), None), ("derv_cphase", (1, 3, mat, mat2), None),
             ("bit2bit_transform", (5, 1), None), ("np_cx_matrix", (3, 2, 0), None),
             ("np_block_matrix", (3, 0, 2, g2, g2.T, g2.conj()), None),
             ("block_mul_vec", (jcirc, tht, 1, 2, vec, True), (tcirc, tht, 1, 2, vec, True)),
             ("mps_from_circuit", (jprog, n), (tprog, n)),
             ("qcircuit_mul_mps", (jprog, jmps), (tprog, tmps))]
    for axis in "xyz":
        calls += [(f"dot_{axis}", (2, vec, vec2), None), (f"{axis}_dot_mat", (1, mat, mat2), None),
                  (f"{axis}_mul_mps", (3, jmps), (3, tmps)), (f"mps_dot_{axis}", (1, jmps, jmps2), (1, tmps, tmps2)),
                  (f"make_r{axis}", (0.4,), None), (f"r{axis}_mul_vec", (0.9, 2, vec), None),
                  (f"r{axis}_mul_mat", (-0.4, 3, mat), None), (f"r{axis}_mul_mps", (0.6, 1, jmps), (0.6, 1, tmps))]
    calls += [("cx_mul_mps", (2, 0, jmps), (2, 0, tmps)), ("cz_mul_mps", (1, 2, jmps), (1, 2, tmps)),
              ("cp_mul_mps", (0.5, 3, 1, jmps), (0.5, 3, 1, tmps))]
    return calls


def test_compat_wrappers_match_jax():
    calls = _compat_calls()
    public = {name for name in dir(jcompat) if callable(getattr(jcompat, name)) and not name.startswith("_")
              and getattr(getattr(jcompat, name), "__module__", "") == jcompat.__name__}
    assert public <= {name for name, _, _ in calls}, sorted(public - {name for name, _, _ in calls})
    for name, jargs, targs in calls:
        targs = jargs if targs is None else targs
        targs = tuple(torch.as_tensor(a) if isinstance(a, np.ndarray) and a.ndim and name not in
                      ("np_block_matrix",) else a for a in targs)
        want, got = _np(getattr(jcompat, name)(*jargs)), _np(getattr(tcompat, name)(*targs))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=name)
    out = np.zeros((2, 2), complex)
    assert tcompat.make_rx(0.2, out) is out and np.allclose(out, jcompat.make_rx(0.2), atol=TOL)


# -----------------------------------------------------------------------------
# io/native.py.
# -----------------------------------------------------------------------------


def test_native_svd_matches_jax_binding():
    rng = np.random.default_rng(41)
    a = rng.standard_normal((12, 8)) + 1j * rng.standard_normal((12, 8))
    u, s, vh = tnative.svd_c128(a)
    ju, js, jvh = jnative.svd_c128(a)
    np.testing.assert_allclose(s, js, atol=TOL, rtol=0)
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False), atol=1e-10, rtol=0)
    np.testing.assert_allclose((u * s) @ vh, a, atol=1e-10, rtol=0)
    np.testing.assert_allclose(u.conj().T @ u, np.eye(8), atol=1e-10, rtol=0)
    with pytest.raises(ValueError):
        tnative.svd_c128(a.T)


@pytest.mark.parametrize("thr", [1e-16, 1e-3])
def test_native_pair_update_matches_jax_and_the_port(thr):
    rng = np.random.default_rng(43)
    chi = 8
    mps = tm.rand_mps_vec(6, 3, chi, generator=torch.Generator().manual_seed(3), entangler="cx",
                          dtype=torch.complex128, device="cpu")
    gate = np.linalg.qr(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))[0]
    lam_ext = tm._lam_ext(mps).numpy()
    lo = 2
    args = (lam_ext[lo], lam_ext[lo + 1], lam_ext[lo + 2], mps.gammas[lo].numpy(), mps.gammas[lo + 1].numpy(), gate)
    g1, g2, lam = tnative.mps_pair_update(*args, thr)
    jg1, jg2, jlam = jnative.mps_pair_update(*args, thr)
    np.testing.assert_array_equal(lam, jlam)
    np.testing.assert_array_equal(g1, jg1)
    np.testing.assert_array_equal(g2, jg2)
    tg1, tg2, tlam = tm._pair_update(*(torch.as_tensor(x)[None] for x in args), chi, thr, torch.complex128,
                                     torch.float64)
    np.testing.assert_allclose(lam, tlam[0].numpy(), atol=1e-10, rtol=0)

    def two_site(a, b, lam_mid):  # the gauge-invariant pair tensor Γ_lo λ Γ_hi
        return np.einsum("sab,b,tbc->stac", a, lam_mid, b)

    np.testing.assert_allclose(two_site(g1, g2, lam), two_site(tg1[0].numpy(), tg2[0].numpy(), tlam[0].numpy()),
                               atol=1e-10, rtol=0)


# -----------------------------------------------------------------------------
# utils/profiling.py and the kernel build rule.
# -----------------------------------------------------------------------------


def test_profiling_helpers_on_the_cpu(tmp_path):
    x = torch.randn(64, 64, dtype=torch.float64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        y = x @ x
    assert any("matmul" in e.key or "mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert events["traceEvents"]
    results = {}
    with profiling.device_timer("mm", results) as r:
        r["out"] = tm.MPS(y[None, None, None], y[None, :1])
    assert results["mm"] >= 0.0
    secs, out = profiling.time_jitted(torch.matmul, x, x, repeats=3, warmup=1)
    assert secs > 0 and torch.equal(out, y)


def test_kernel_library_is_built_once_per_host(tmp_path):
    """Two Gloo ranks on one host, the library missing: one build (every
    nvcc call from rank 0: one per source and the link), and both ranks
    load after it."""
    pool = GlooPool(2, tmp_path)
    try:
        got = pool.run("tests._torch_dist_tasks:build_once", str(tmp_path))
    finally:
        pool.close()
    callers = (tmp_path / "nvcc.log").read_text().split()
    assert callers == [str(got[0]["pid"])] * (got[0]["sources"] + 1)
    assert got[0]["loads"] == [True] and got[1]["loads"] == [True]
