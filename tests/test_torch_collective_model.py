"""The port's collective-cost model of the chain-sharded MPS engine
(parallel/collective_model.py) on Gloo CPU ranks, against the JAX package:

* the critical-path census on hand-made logs (a pipeline, a collective, a
  deadlock);
* the census of the production chain obj+grad, taken by the module's own
  Gloo processes, equals the census of the same run's logs from a worker
  pool of tests/_torch_gloo.py;
* the fit at P = 2 and 4 predicts the held-out P = 8 round count exactly and
  its bytes within the JAX tolerance (max(1 KiB, 5%)), at the JAX test's
  case (n = 16, χ = 8, 1 layer); intercept and slope are positive;
* the χ-extrapolation of ``chain_model_at`` is exact, and the pinned
  ``CHAIN28_MODEL`` is what it counts;
* ``predicted_sweep_time`` and ``predicted_speedup`` equal the JAX
  package's for the same model and link parameters."""

import numpy as np
import pytest
import torch

from aqc_research_tpu.parallel import collective_model as jcm
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.parallel import collective_model as cm
from aqc_research_tpu_torch.targets import trotter as trotop
from tests._torch_gloo import GlooPool
from tests import _torch_threads  # noqa: F401

TASKS = "tests._torch_dist_tasks"


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


@pytest.fixture(scope="module")
def case():
    """The JAX test's case: n = 16, χ = 8, one layer, c128."""
    n, chi = 16, 8
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, 1), True)
    th = torch.as_tensor(trotop.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=0.8, delta=1.0))
    ini = trotop.neel_init_state(n)
    phi = trotop.Trotter(num_qubits=n, evol_time=0.8, num_steps=2, delta=1.0, second_order=True).as_mps(
        ini, trunc_thr=1e-10, chi_max=chi, dtype=torch.complex128)
    lvec = tm.mps_from_program(ini, n, chi_max=chi, dtype=torch.complex128)
    return circ, th, lvec, phi


def test_census_follows_the_critical_path():
    """A three-rank pipeline (0 → 1 → 2) is two hops whatever each rank
    counts; a broadcast after it is one more, after the last arrival."""
    b = 64
    logs = [
        [("p2p", [(1, b)], []), ("broadcast", (0, 1, 2), 8)],
        [("p2p", [], [(0, b)]), ("p2p", [(2, b)], []), ("broadcast", (0, 1, 2), 8)],
        [("p2p", [], [(1, b)]), ("broadcast", (0, 1, 2), 8)],
    ]
    got = cm.collective_census(logs)
    assert got == {"rounds": 3, "bytes": 2 * b + 8, "p2p": 2, "all_gather": 0, "all_reduce": 0, "broadcast": 1}
    with pytest.raises(RuntimeError, match="deadlock"):
        cm.collective_census([[("p2p", [], [(1, b)])], [("p2p", [], [(0, b)])]])


def test_census_of_a_pool_run_equals_the_module_census(case, tmp_path):
    circ, th, lvec, phi = case
    pool = GlooPool(2, tmp_path)
    try:
        logs = pool.run(f"{TASKS}:chain_objective_log", interop.ansatz_args(circ), th.numpy(),
                        (lvec.gammas.numpy(), lvec.lambdas.numpy()), (phi.gammas.numpy(), phi.lambdas.numpy()))
        hops = pool.run(f"{TASKS}:ping_pong", 8)
    finally:
        pool.close()
    assert cm.collective_census(logs) == cm.chain_census(circ, th, lvec, phi, 2)
    assert hops[0] == hops[1] and np.isfinite(hops[0]) and hops[0] > 0


def test_fit_and_heldout_validation(case):
    """Fit (a, b) at P in {2, 4}; the affine prediction must match the
    census at the held-out P = 8: rounds exactly, bytes within the JAX
    tolerance."""
    circ, th, lvec, phi = case
    model = cm.fit_chain_model(circ, th, lvec, phi, (2, 4))
    assert model.a > 0 and model.b > 0, model
    assert model.psums == 1
    report = cm.validate_chain_model(model, circ, th, lvec, phi, 8)
    assert report["ppermute_pred"] == report["ppermute_actual"] > 0, report
    assert abs(report["bytes_pred"] - report["bytes_actual"]) <= max(1024, 0.05 * report["bytes_actual"]), report


def test_chi_extrapolation_is_exact(case):
    circ, th = case[0], case[1]
    model = cm.chain_model_at(circ, th, 32)
    bits = tuple(1 if q % 2 == 0 else 0 for q in range(16))
    state = tm.mps_basis_state(bits, 32, torch.complex64, "cpu")
    got = cm.chain_census(circ, th.to(torch.float32), state, state, 2)
    assert (got["rounds"], got["bytes"]) == (model.ppermutes(2), model.bytes_moved(2))


def test_pinned_chain28_model_is_the_count():
    assert cm.chain28_model() == cm.CHAIN28_MODEL


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_speedup_formula_equals_jax(ndev):
    fields = dict(a=40.0, b=12.0, bytes_a=2.0e6, bytes_b=0.5e6, psums=2)
    jm, tmod = jcm.ChainCollectiveModel(**fields), cm.ChainCollectiveModel(**fields)
    for kw in ({}, {"hop_latency_s": 2e-6, "ici_bytes_per_s": 1.0e11},
               {"hop_latency_s": 8e-6, "ici_bytes_per_s": 3.0e11, "svd_batch_efficiency": 1.5}):
        full = {"hop_latency_s": cm.HOP_LATENCY_S, "ici_bytes_per_s": cm.NVLINK_BYTES_PER_S, **kw}
        assert cm.predicted_sweep_time(tmod, ndev, 0.4, **full) == jcm.predicted_sweep_time(jm, ndev, 0.4, **full)
        assert cm.predicted_speedup(tmod, ndev, 0.4, **full) == jcm.predicted_speedup(jm, ndev, 0.4, **full)
        assert tmod.ppermutes(ndev) == jm.ppermutes(ndev) and tmod.bytes_moved(ndev) == jm.bytes_moved(ndev)
    t = cm.predicted_sweep_time(tmod, ndev, 0.4)
    assert t == pytest.approx(0.4 / ndev + (40 + 12 * ndev) * 10e-6 + (2.0e6 + 0.5e6 * ndev) / 450e9)
