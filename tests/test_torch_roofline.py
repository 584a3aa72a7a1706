"""The port's roofline (ops/roofline.py) and the sweep count behind it
(ops/jacobi_svd.jacobi_sweeps_used) held against the JAX package on the
CPU.

* Counts, exact: the census, every flop and byte function (n on both sides
  of RAND_MIN_N, both routes), ``sweep_flops`` and the GFLOP columns of
  ``roofline_report`` and ``predict`` — counts of the algorithm's work, the
  same whatever implements it.
* The census against the port's own engine: a live capture at the dispatch
  seam ``ops/mps._pair_update`` on the "jacobi" (K1's twin, and K4's), and
  the fused "rand" paths.
* Sweep counts on graded seeded matrices: equal to JAX's in c128; in f32
  within one sweep, and equal on at least 90% of the matrices (all of them
  on these inputs when this test was written).
* The attainable-rate microkernels: their CPU path is the plain twin; on a
  card (marked ``cuda``) each kernel against its twin within the f32 gap of
  one rounding per step against two."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu.ops import jacobi_svd as jjs
from aqc_research_tpu.ops import roofline as jrl
from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit as tmake
from aqc_research_tpu_torch.ops import jacobi_svd as tjs
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops import rand_svd as trs
from aqc_research_tpu_torch.ops import roofline as trl
from tests import _torch_threads  # noqa: F401

ATT = {"vpu_gflops": 5000.0, "mxu_gflops": 40000.0, "hbm_gbps": 2500.0}
SWEEPS = {"vdag": 7.5, "grad": 4.25, "value": 3.0}


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _circs(n: int, layers: int):
    return (JTrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), True),
            TrotterAnsatz.make(n, tmake(n, layers), True))


@pytest.mark.parametrize("grow", [True, False])
@pytest.mark.parametrize("chi", [8, 16])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("n", [6, 8, 12])
def test_census_equals_jax(n, layers, chi, grow):
    jc, tc = _circs(n, layers)
    assert trl.decomposition_census(tc, chi, grow=grow) == jrl.decomposition_census(jc, chi, grow=grow)


@pytest.mark.parametrize("impl", ["jacobi", "rand"])
@pytest.mark.parametrize("n", [8, 64, 126, 128, 256])
def test_flop_and_byte_functions_equal_jax(n, impl):
    assert trs.RAND_MIN_N == 128
    for sweeps, batch in ((1, 1), (4.5, 10), (12, 14)):
        assert trl.jacobi_kernel_flops(n, sweeps, batch) == jrl.jacobi_kernel_flops(n, sweeps, batch)
        assert trl.kernel_flops_for(n, sweeps, batch, impl) == jrl.kernel_flops_for(n, sweeps, batch, impl)
        assert trl.matmul_flops_for(n, batch, impl) == jrl.matmul_flops_for(n, batch, impl)
        assert trl.pair_update_matmul_flops(n // 2, batch) == jrl.pair_update_matmul_flops(n // 2, batch)
        core, blas = trl.matmul_units_for(n, batch, impl)
        assert core + blas == pytest.approx(trl.matmul_flops_for(n, batch, impl), rel=1e-12)
    census = {"vdag": [(10, n), (9, n)], "grad": [(10, 2), (9, n)]}
    assert trl.sweep_hbm_bytes(census) == jrl.sweep_hbm_bytes(census)
    assert trl.sweep_hbm_bytes(census, 16) == jrl.sweep_hbm_bytes(census, 16)
    assert trl.state_bytes(n, n // 2) == jrl.state_bytes(n, n // 2)
    assert trl.sweep_flops(census, SWEEPS, impl) == jrl.sweep_flops(census, SWEEPS, impl)


def test_matmul_units_follow_the_card_dispatch():
    """K4 takes the jacobi route's products at χ ≥ 96 (all on the CUDA
    cores), K2 the fused rand route's θ build (32 χ³); the rest is cuBLAS."""
    assert trl.matmul_units_for(256, 14, "jacobi") == (trl.matmul_flops_for(256, 14, "jacobi"), 0.0)
    assert trl.matmul_units_for(128, 10, "jacobi") == (0.0, trl.matmul_flops_for(128, 10, "jacobi"))
    core, blas = trl.matmul_units_for(128, 10, "rand")
    assert core == 32.0 * 64**3 * 10 and blas > 0
    assert trl.matmul_units_for(64, 10, "rand") == (0.0, trl.matmul_flops_for(64, 10, "rand"))


def _row_numbers(report: str):
    rows = {}
    for line in report.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 6 and cells[0] in ("vdag", "grad", "value"):
            rows[cells[0]] = (cells[1], cells[2], cells[3].split()[0], cells[4], cells[5])
    return rows


@pytest.mark.parametrize("impl", ["jacobi", "rand"])
@pytest.mark.parametrize("n, chi, layers", [(20, 64, 4), (28, 128, 4), (12, 16, 2)])
def test_report_and_predict_gflop_columns_equal_jax(n, chi, layers, impl):
    jc, tc = _circs(n, layers)
    jcen, tcen = jrl.decomposition_census(jc, chi), trl.decomposition_census(tc, chi)
    jrep = jrl.roofline_report(n, chi, layers, 0.5, SWEEPS, ATT, jcen, impl=impl)
    trep = trl.roofline_report(n, chi, layers, 0.5, SWEEPS, ATT, tcen, impl=impl,
                               sweeps_max={"vdag": 12, "grad": 9, "value": 8})
    assert _row_numbers(trep) == _row_numbers(jrep) and len(_row_numbers(trep)) == 3
    jpred = jrl.predict(n, chi, layers, impl=impl, sweeps_by_stage=SWEEPS, attainable=ATT)
    tpred = trl.predict(n, chi, layers, impl=impl, sweeps_by_stage=SWEEPS, attainable=ATT)
    want = re.search(r"kernel ([\d.]+) GFLOP \(VPU\) \+ matmuls ([\d.]+) GFLOP", jpred).groups()
    got = re.search(r"Jacobi ([\d.]+) GFLOP \(CUDA cores\) \+ pair-update products ([\d.]+) GFLOP", tpred).groups()
    assert got == want


def test_report_shares_stay_within_the_roofline():
    tc = TrotterAnsatz.make(20, tmake(20, 4), True)
    census = trl.decomposition_census(tc, 64)
    r = trl.roofline_numbers(20, 64, 0.3, SWEEPS, ATT, census, "rand")
    og = {k: v for k, v in census.items() if k != "value"}
    assert r["jacobi_gflop"] * 1e9 == pytest.approx(trl.sweep_flops(og, SWEEPS, "rand")[0])
    assert r["bound_s"] == pytest.approx(r["t_core_s"] + r["t_blas_s"])
    assert 0 < r["share_composite"] < 1 and 0 < r["share_core"] < 1 and 0 < r["share_hbm"] < 1


def _live_census(route: str, monkeypatch):
    """(the captured stats, the pair-update paths taken) of one obj+grad and
    one value sweep at 8q χ=16, 2 layers, c64, under ``route``."""
    taken = []
    for name in ("fused_pair_update", "fused_rand_pair_update", "_truncated_svd"):
        real = getattr(tm, name)
        monkeypatch.setattr(tm, name, lambda *a, _real=real, _name=name, **k: taken.append(_name) or _real(*a, **k))
    config.set_precision("fast")
    if route == "jacobi-fused" or route == "rand":
        config.set_fused_pair(True)
    if route == "rand":
        monkeypatch.setattr(trs, "RAND_MIN_N", 32)
    try:
        case = trl.make_case(8, 16, 2, torch.device("cpu"))
        with config.svd_impl_override(route.split("-")[0]):
            stats = trl._capture_sweep_counts(*case)
    finally:
        config.set_precision("high")
        config.set_fused_pair(None)
    return stats, set(taken), trl.decomposition_census(case[0], 16, grow=True)


@pytest.mark.parametrize("route, path", [("jacobi", "_truncated_svd"), ("jacobi-fused", "fused_pair_update"),
                                         ("rand", "fused_rand_pair_update")])
def test_census_equals_live_capture(route, path, monkeypatch):
    """The capture at the seam sees every (batch, n) phase whichever update
    the route takes; the full-χ phases take ``path``."""
    stats, taken, census = _live_census(route, monkeypatch)
    assert path in taken
    for stage in ("vdag", "grad", "value"):
        assert stats[stage]["phases"] == census[stage], stage
        assert 1 <= stats[stage]["mean"] <= stats[stage]["max"] <= tjs.DEFAULT_SWEEPS


def _graded(rng, b, n, decades, dtype):
    a = rng.standard_normal((b, n, n)) + 1j * rng.standard_normal((b, n, n))
    u, _, vh = np.linalg.svd(a)
    s = 10.0 ** (-decades * np.arange(n) / (n - 1))
    return ((u * s[None, None, :]) @ vh).astype(dtype)


@pytest.mark.parametrize("decades", [1, 3, 6])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_sweeps_used_equal_jax_in_c128(n, decades):
    m = _graded(np.random.default_rng(100 * n + decades), 6, n, decades, np.complex128)
    want = int(jjs.jacobi_sweeps_used(jnp.asarray(m)))
    assert int(tjs.jacobi_sweeps_used(torch.as_tensor(m))) == want
    per = np.asarray(jax.vmap(jjs.jacobi_sweeps_used)(jnp.asarray(m)))
    np.testing.assert_array_equal(tjs.jacobi_sweeps_per_matrix(torch.as_tensor(m)).numpy(), per)


@pytest.mark.parametrize("criterion", ["entry", "hybrid"])
def test_sweeps_used_within_one_in_f32(criterion):
    """f32: the port counts on the Jacobi rows' twin (K1 on a card), JAX in
    its spec loop; rounding may move a matrix's stop by one sweep."""
    rng = np.random.default_rng(7)
    got, want = [], []
    for n in (8, 16, 32, 64):
        for decades in (1, 3, 6):
            m = _graded(rng, 4, n, decades, np.complex64)
            want += np.asarray(jax.vmap(lambda x: jjs.jacobi_sweeps_used(x, 12, criterion))(jnp.asarray(m))).tolist()
            got += tjs.jacobi_sweeps_per_matrix(torch.as_tensor(m), 12, criterion).tolist()
            assert abs(int(tjs.jacobi_sweeps_used(torch.as_tensor(m), 12, criterion))
                       - int(jjs.jacobi_sweeps_used(jnp.asarray(m), 12, criterion))) <= 1
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.9, (diff.max(), np.mean(diff == 0))


def test_sweeps_used_heads_take_the_spec_loop():
    """Below 8 columns the count runs the spec's loop, as the engine sends
    the χ-growth heads; the rows' twin agrees there too."""
    m = torch.as_tensor(_graded(np.random.default_rng(3), 5, 4, 3, np.complex64))
    spec = tjs.jacobi_sweeps_per_matrix(m, 12, "hybrid")
    from aqc_research_tpu_torch.ops.jacobi_kernel import jacobi_rows_reference

    mt = m.transpose(-1, -2)
    rows = jacobi_rows_reference(mt.real.contiguous(), mt.imag.contiguous(), 12, "hybrid")[2]
    assert (spec - rows).abs().max() <= 1


def test_attainable_runs_on_cpu():
    att = trl.measure_attainable(repeats=2)
    assert set(att) == {"vpu_gflops", "mxu_gflops", "hbm_gbps"}
    assert all(np.isfinite(v) and v > 0 for v in att.values())


def test_microkernel_cpu_paths_are_the_twins():
    x = torch.rand(64, dtype=torch.float32)
    assert torch.equal(trl.fma_chain(x, 50), trl.fma_chain_reference(x, 50))
    assert torch.equal(trl.stream_passes(x, 3), trl.stream_passes_reference(x, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        trl.fma_chain(x.to("meta"), 1)


@pytest.mark.cuda
def test_microkernels_match_twins_on_card(cuda_device):
    x = trl.attainable_inputs(cuda_device)
    before = trl.fma_chain.launches, trl.stream_passes.launches
    got = trl.fma_chain(x["fma"])
    assert float((got - trl.fma_chain_reference(x["fma"])).abs().max()) <= 2e-4
    got = trl.stream_passes(x["stream"])
    assert float((got - trl.stream_passes_reference(x["stream"])).abs().max()) <= 1e-4
    assert (trl.fma_chain.launches, trl.stream_passes.launches) == (before[0] + 1, before[1] + 1)
