"""The PyTorch port's IR, gate builders and config, held against the JAX
package: the ansatz layout, theta views, structures, gates and folded block
gates must be identical (gates to 1e-14 in complex128: the same formulas,
different libm)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu.circuit import gates as JG
from aqc_research_tpu.circuit import program as jprog
from aqc_research_tpu.circuit import structures as jstruct
from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.ops import statevector as jsv
from aqc_research_tpu.targets import trotter as jtrot
from aqc_research_tpu_torch import checking, config, interop
from aqc_research_tpu_torch.circuit import gates as TG
from aqc_research_tpu_torch.circuit import program as tprog
from aqc_research_tpu_torch.circuit import structures as tstruct
from aqc_research_tpu_torch.circuit.ansatz import Ansatz, TrotterAnsatz
from aqc_research_tpu_torch.ops import statevector as tsv
from aqc_research_tpu_torch.targets import trotter as ttrot


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


REPO = Path(__file__).resolve().parent.parent
C128 = torch.complex128
GATE_TOL = 1e-14  # same closed forms in complex128


def _np(x):
    return np.asarray(x)


def _ansatz_pair(kind, n, depth):
    """(jax_ansatz, port_ansatz) built independently from the same blocks."""
    if kind == "trotter1":
        blocks = jstruct.make_trotter_like_circuit(n, depth)
        return JTrotterAnsatz.make(n, blocks, False), TrotterAnsatz.make(n, blocks, False)
    if kind == "trotter2":
        blocks = jstruct.make_trotter_like_circuit(n, depth)
        return JTrotterAnsatz.make(n, blocks, True), TrotterAnsatz.make(n, blocks, True)
    blocks = jstruct.create_ansatz_structure(n, "spin", "full", depth)
    return JAnsatz.make(n, kind, blocks), Ansatz.make(n, kind, blocks)


CONFIGS = [("trotter1", 5, 2), ("trotter2", 6, 2), ("trotter2", 7, 3), ("cx", 4, 9), ("cz", 5, 6), ("cp", 6, 7)]


@pytest.mark.parametrize("kind,n,depth", CONFIGS)
def test_ansatz_layout_identical(kind, n, depth):
    ja, ta = _ansatz_pair(kind, n, depth)
    assert ta.num_thetas == ja.num_thetas
    assert ta.tpb == ja.tpb and ta.num_blocks == ja.num_blocks
    np.testing.assert_array_equal(ta.blocks, ja.blocks)
    assert ta.is_trotterized == ja.is_trotterized
    if ja.is_trotterized:
        assert (ta.bpl, ta.num_layers, ta.half_layer_num_blocks) == (
            ja.bpl, ja.num_layers, ja.half_layer_num_blocks
        )
    vec = np.random.default_rng(n).standard_normal(ja.num_thetas)
    np.testing.assert_array_equal(ta.subset1q(vec), ja.subset1q(vec))
    np.testing.assert_array_equal(ta.subset2q(vec), ja.subset2q(vec))
    tvec = torch.tensor(vec)
    np.testing.assert_array_equal(ta.subset2q(tvec).numpy(), ja.subset2q(vec))


@pytest.mark.parametrize("kind,n,depth", CONFIGS)
def test_interop_ansatz_round_trip(kind, n, depth):
    ja, ta = _ansatz_pair(kind, n, depth)
    assert interop.ansatz_from_args(interop.ansatz_args(ja)) == ta
    assert hash(interop.ansatz_from_args(interop.ansatz_args(ta))) == hash(ta)


@pytest.mark.parametrize("layout", ["spin", "line", "cyclic_spin", "cyclic_line"])
def test_structures_identical(layout):
    for n in (3, 4, 7):
        np.testing.assert_array_equal(
            tstruct.create_ansatz_structure(n, layout, "full", 11, 2),
            jstruct.create_ansatz_structure(n, layout, "full", 11, 2),
        )
        np.testing.assert_array_equal(
            tstruct.make_trotter_like_circuit(n, 3), jstruct.make_trotter_like_circuit(n, 3)
        )
    assert tstruct.lower_limit(5) == jstruct.lower_limit(5)


def test_trotter_ansatz_rejects_bad_layout():
    blocks = tstruct.create_ansatz_structure(4, "spin", "full", 6)
    with pytest.raises(ValueError):
        TrotterAnsatz.make(4, blocks, False)


@pytest.mark.parametrize("name", ["rx", "ry", "rz", "phase"])
def test_rotation_gates_match_jax(name):
    angles = np.random.default_rng(7).uniform(-4, 4, size=(5,))
    got = getattr(TG, name)(torch.tensor(angles), C128)
    want = getattr(JG, name)(jnp.asarray(angles), jnp.complex128)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=GATE_TOL)
    np.testing.assert_allclose(
        getattr(TG, name)(float(angles[0]), C128, "cpu").numpy(),
        getattr(JG, "np_" + name)(angles[0]),
        atol=GATE_TOL,
    )


def test_fixed_gates_controlled_kron_match_jax():
    for name in ("x", "y", "z", "eye2", "proj0", "proj1"):
        np.testing.assert_array_equal(
            getattr(TG, name)(C128, "cpu").numpy(), _np(getattr(JG, name)(jnp.complex128))
        )
    angles = np.linspace(-1, 2, 4)
    g = TG.ry(torch.tensor(angles), C128)
    np.testing.assert_allclose(
        TG.controlled(g).numpy(), _np(JG.controlled(JG.ry(jnp.asarray(angles), jnp.complex128))), atol=GATE_TOL
    )
    h = TG.rz(torch.tensor(angles), C128)
    np.testing.assert_allclose(
        TG.kron2(g, h).numpy(),
        _np(JG.kron2(JG.ry(jnp.asarray(angles), jnp.complex128), JG.rz(jnp.asarray(angles), jnp.complex128))),
        atol=GATE_TOL,
    )
    # An unbatched factor broadcasts against a batched one.
    np.testing.assert_allclose(
        TG.kron2(TG.eye2(C128, "cpu"), h).numpy(),
        _np(JG.kron2(JG.eye2(jnp.complex128), JG.rz(jnp.asarray(angles), jnp.complex128))),
        atol=GATE_TOL,
    )
    # controlled keeps the gate's own dtype whatever the global precision.
    assert TG.controlled(TG.x(torch.complex64, "cpu")).dtype == torch.complex64


def test_gate_matrix_matches_jax():
    jq, tq = jprog.ProgramBuilder(3), tprog.ProgramBuilder(3)
    for qb in (jq, tq):
        qb.x(0).y(1).z(2).h(0).rx(0.3, 1).ry(-0.7, 2).rz(1.1, 0).p(0.4, 1)
        qb.cx(0, 2).cz(2, 1).cp(0.9, 1, 0)
    for jg, tg in zip(jq.build(), tq.build()):
        assert (tg.name, tg.qubits, tg.param) == (jg.name, jg.qubits, jg.param)
        np.testing.assert_allclose(
            tprog.gate_matrix(tg, C128, "cpu").numpy(),
            _np(jprog.gate_matrix(jg, jnp.complex128)),
            atol=GATE_TOL,
        )
    with pytest.raises(ValueError):
        tprog.Gate("cx", (0,))


@pytest.mark.parametrize("kind,n,depth", CONFIGS)
@pytest.mark.parametrize("dagger", [False, True])
def test_block_and_front_gates_match_jax(kind, n, depth, dagger):
    ja, ta = _ansatz_pair(kind, n, depth)
    vec = np.random.default_rng(3).uniform(-3, 3, ja.num_thetas)
    got = tsv.block_gates(ta, ta.subset2q(torch.tensor(vec)), C128, dagger=dagger)
    want = jsv.block_gates(ja, ja.subset2q(jnp.asarray(vec)), jnp.complex128, dagger=dagger)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-13)
    got = tsv.front_gates(ta, ta.subset1q(torch.tensor(vec)), C128, dagger=dagger)
    want = jsv.front_gates(ja, ja.subset1q(jnp.asarray(vec)), jnp.complex128, dagger=dagger)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-13)


@pytest.mark.parametrize("second_order", [False, True])
def test_trotter_block_and_perfect_init_match_jax(second_order):
    alphas = jtrot.trotter_alphas(0.4, 1.0)
    np.testing.assert_array_equal(ttrot.trotter_alphas(0.4, 1.0), alphas)
    np.testing.assert_allclose(
        ttrot.trotter_block_4x4(alphas, C128, "cpu").numpy(),
        _np(jtrot.trotter_block_4x4(jnp.asarray(alphas), jnp.complex128)),
        atol=GATE_TOL,
    )
    n = 6
    blocks = jstruct.make_trotter_like_circuit(n, 3)
    ja, ta = JTrotterAnsatz.make(n, blocks, second_order), TrotterAnsatz.make(n, blocks, second_order)
    want = jtrot.init_ansatz_to_trotter(ja, np.ones(ja.num_thetas), evol_time=1.2, delta=1.0)
    got = ttrot.init_ansatz_to_trotter(ta, np.ones(ta.num_thetas), evol_time=1.2, delta=1.0)
    np.testing.assert_array_equal(got, want)
    assert [(g.name, g.qubits) for g in ttrot.neel_init_state(n)] == [
        (g.name, g.qubits) for g in jtrot.neel_init_state(n)
    ]


def test_checking_predicates_take_tensors():
    good = torch.tensor([[0, 1], [1, 2]])
    assert checking.block_structure(3, good) and checking.block_structure(3, good.numpy())
    assert not checking.block_structure(2, good)
    assert not checking.block_structure(3, torch.tensor([[0, 1], [0, 2]]))
    assert not checking.block_structure(3, good.float())
    assert checking.is_int(3) and checking.is_float(0.5) and not checking.is_int(0.5)
    assert checking.is_tuple((1, 2), True) and not checking.is_tuple([1, 2])


def test_config_routes_and_precision():
    assert config.svd_impl(torch.device("cpu")) in ("native", "jacobi", "rand")
    previous = config.svd_impl(torch.zeros(1))
    with config.svd_impl_override("jacobi"):
        assert config.svd_impl(torch.zeros(1)) == "jacobi"
    assert config.svd_impl(torch.zeros(1)) == previous
    config.set_svd_impl(None)
    try:
        assert config.svd_impl(torch.device("cpu")) == "native"
        assert config.svd_impl(torch.device("cuda")) == "rand"
    finally:
        config.set_svd_impl(None)
    with config.svd_impl_override("gram"):  # ported with ops/svd_gram.py
        assert config.svd_impl(torch.zeros(1)) == "gram"
    with pytest.raises(ValueError):
        config.set_svd_impl("embed")  # the JAX package's TPU workaround, not ported
    with pytest.raises(ValueError):
        config.set_precision("medium")
    assert config.real_of(torch.complex64) == torch.float32
    config.require_full_f32_matmul()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_import_leaves_jax_out():
    modules = [
        "aqc_research_tpu_torch",
        "aqc_research_tpu_torch.interop",
        "aqc_research_tpu_torch.models.sp_lhs.jit_asp",
        "aqc_research_tpu_torch.models.sp_lhs.target_states",
        "aqc_research_tpu_torch.models.sp_lhs.time_evol",
        "aqc_research_tpu_torch.models.sp_lhs.run_time_evol",
        "aqc_research_tpu_torch.io.checkpoint",
        "aqc_research_tpu_torch.circuit.export",
        "aqc_research_tpu_torch.ops.gradients",
        "aqc_research_tpu_torch.ops.statevector",
        "aqc_research_tpu_torch.ops.jacobi_kernel",
        "aqc_research_tpu_torch.ops.fused_rand",
        "aqc_research_tpu_torch.kernel_checks",
        "aqc_research_tpu_torch.utils",
        "aqc_research_tpu_torch.targets.generator",
        "aqc_research_tpu_torch.optim.lbfgs",
        "aqc_research_tpu_torch.parallel",
        "aqc_research_tpu_torch.parallel.multistart",
        "aqc_research_tpu_torch.parallel.executor",
        "aqc_research_tpu_torch.ops.coord_descent",
        "aqc_research_tpu_torch.models.sketching",
        "aqc_research_tpu_torch.models.sketching.sk_core",
        "aqc_research_tpu_torch.models.sketching.sk_utils",
        "aqc_research_tpu_torch.models.sketching.aqc_sketching",
        "aqc_research_tpu_torch.models.sketching.aqc_coord_descent",
        "aqc_research_tpu_torch.parallel.distributed",
        "aqc_research_tpu_torch.parallel.mesh",
        "aqc_research_tpu_torch.parallel.mps_sharded",
        "aqc_research_tpu_torch.parallel.mps_chain",
        "aqc_research_tpu_torch.parallel.statevector_tp",
        "aqc_research_tpu_torch.parallel.dryrun",
        "aqc_research_tpu_torch.circuit.qasm",
        "aqc_research_tpu_torch.compat",
        "aqc_research_tpu_torch.io.native",
        "aqc_research_tpu_torch.utils.profiling",
        "aqc_research_tpu_torch.ops.svd_gram",
        "chip_smoke",
    ]
    code = "import sys\n" + "".join(f"import {m}\n" for m in modules) + (
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'aqc_research_tpu.')))\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=False
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """Without CUDA (here), or without the rest of the repository, the smoke
    run exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
