"""The MPS fleet on the one-lane horizon's device programs
(models/sp_lhs/jit_asp.py: ``optimize_horizon_mps_multistart``,
``capture_mps_fleet``, ``_mps_fleet_watchdog``), held on the CPU, where a
program is its eager function, at the benchmark's tiny size
(``h100bench/tests/tiny_asp8.json``: 8 qubits, the 4-layer second-order
Trotter ansatz, the first horizon's target) with 3 lanes in complex128:

* each lane's value and gradient from the fleet's programs at (3, P)
  against the benchmark's plain reference (``h100bench/reference/mps.py``):
  values within 1e-10 at χ=8 and at the untruncated χ=16, gradients within
  1e-10 at χ=16 (at χ=8 the two truncated sweeps approximate the gradient
  differently, 1.1e-5 apart: there each lane's gradient is held to its
  one-lane program's);
* a lane of the fleet on "native" gives its one-lane horizon's iteration
  count, objective and θ;
* lane-count keying: the programs at 3, 2 and 1 running lanes are three
  entries of each cache, the ones the fleet replays, and the one-lane
  horizon's keys and θ shape are those it had;
* the per-lane watchdog: a lane whose reference value is forced to
  disagree is flagged and re-run alone under the reference; the other
  lanes' results stay bit for bit;
* the fleet's spans and counters: one ``asp.horizon`` request with its
  ``lanes``, one ``fleet_steps`` a step, ``fleet_lanes`` summing to the
  lanes' iterations, one ``lbfgs.iteration`` span a lane iteration (a
  step's span and an instant for each further lane), the watchdog's
  replay under ``asp.watchdog``."""

import os
import sys

import numpy as np
import pytest
import torch

from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.models.sp_lhs.target_states import first_horizon_mps_target
from aqc_research_tpu_torch.utils import profiling
from tests import _torch_threads  # noqa: F401

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "h100bench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import spec  # noqa: E402
from harness import traffic as T  # noqa: E402
from reference import mps as R  # noqa: E402
from reference.circuit import neel_bits  # noqa: E402

LANES, TOL, SEED = 3, 1e-10, 2**31 + 77
CFG = spec.load_json(spec.HERE / "tests" / "tiny_asp8.json")
TRAFFIC = spec.load_json(spec.HERE / "traffic" / "fleet4_rand.json")
N = int(CFG["num_qubits"])
BITS = neel_bits(N)


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


@pytest.fixture(autouse=True)
def _fresh_programs():
    tja.release_mps_programs()
    tja.watchdog_events.clear()
    yield
    tja.release_mps_programs()
    tja.watchdog_events.clear()


def _case(chi=int(CFG["chi"]), thr=float(CFG["trunc_thr"])):
    """(circuit, complex128 target, the lanes' starts (3, P) in float64)."""
    circ = TrotterAnsatz.make(N, make_trotter_like_circuit(N, int(CFG["num_layers"])), True)
    tgt = CFG["target"]
    target = first_horizon_mps_target(num_qubits=N, evol_time=float(tgt["evol_time"]),
                                      num_trot_steps=int(tgt["trotter_steps"]), delta=float(tgt["delta"]),
                                      chi_max=chi, trunc_thr=thr, second_order=True, device="cpu").t1
    base = T.trotter_point(CFG)
    xs = np.stack([T.start_point(base, TRAFFIC, SEED, i) for i in range(LANES)])
    return circ, target, torch.as_tensor(xs, dtype=torch.float64)


@pytest.mark.parametrize("chi, thr", [(int(CFG["chi"]), float(CFG["trunc_thr"])), (16, 1e-12)])
def test_lane_values_and_gradients_match_the_reference(chi, thr):
    circ, target, xs = _case(chi, thr)
    wl = R.Workload.from_config(dict(CFG, chi=chi, trunc_thr=thr))
    ref_target = R.from_vidal(target.gammas, target.lambdas)
    with config.svd_impl_override("native"):
        programs = tja.capture_mps_fleet(circ, xs, target, base_bits=BITS, trunc_thr=thr)
        value = tja._mps_value_program(circ, BITS, thr, "native")
        value_and_grad = tja._mps_value_and_grad_program(circ, BITS, thr, "native")
        f = value(xs, target)
        fg, g = value_and_grad(xs, target)
        one = [value_and_grad(x, target) for x in xs]
    assert len(programs) == 2 * LANES and all(p in tja.mps_programs() for p in programs)
    for lane in range(LANES):
        f_ref, g_ref = R.objective_and_gradient(wl, xs[lane].numpy(), ref_target)
        assert abs(float(f[lane]) - f_ref) <= TOL and abs(float(fg[lane]) - f_ref) <= TOL
        if thr < 1e-10:
            np.testing.assert_allclose(g[lane].numpy(), g_ref, rtol=0, atol=TOL)
        np.testing.assert_allclose(g[lane].numpy(), one[lane][1].numpy(), rtol=0, atol=TOL)


def test_a_lane_follows_its_one_lane_horizon():
    circ, target, xs = _case()
    with config.svd_impl_override("native"):
        fleet = tja.optimize_horizon_mps_multistart(circ, xs, target, base_bits=BITS, trunc_thr=CFG["trunc_thr"],
                                                    maxiter=6)
        for lane in range(LANES):
            one = tja.optimize_horizon_mps_jit(circ, xs[lane], target, base_bits=BITS,
                                               trunc_thr=CFG["trunc_thr"], maxiter=6)
            assert int(fleet.num_iters[lane]) == one.num_iters and bool(fleet.converged[lane]) == one.converged
            assert abs(float(fleet.fobj[lane]) - float(one.fobj)) <= TOL
            np.testing.assert_allclose(fleet.thetas[lane].numpy(), one.thetas.numpy(), rtol=0, atol=TOL)
    assert np.all(fleet.fobj.numpy() < 1.0) and tja.watchdog_events == []


def _shapes(program) -> set:
    return {sig[0][0][0] for sig in program.cache.programs}


def test_lane_counts_key_programs_and_the_one_lane_keys_stay():
    circ, target, xs = _case()
    thr, p = float(CFG["trunc_thr"]), xs.shape[1]
    with config.svd_impl_override("native"):
        one = tja.optimize_horizon_mps_jit(circ, xs[0], target, base_bits=BITS, trunc_thr=thr, maxiter=2)
        one_keys = set(tja._PROGRAMS)
        value = tja._mps_value_program(circ, BITS, thr, "native")
        value_and_grad = tja._mps_value_and_grad_program(circ, BITS, thr, "native")
        assert one_keys == {("value", circ, BITS, thr, "native"), ("value_and_grad", circ, BITS, thr, "native"),
                            ("chunks", circ, BITS, thr, None, 2, None, "native")}
        assert _shapes(value) == _shapes(value_and_grad) == {(p,)}
        entries = [value.entry(xs[:lanes], target) for lanes in (3, 2, 1)]
        assert len({id(e) for e in entries}) == 3 and entries[0] is value.entry(xs.clone(), target)
        tja.capture_mps_fleet(circ, xs, target, base_bits=BITS, trunc_thr=thr)
        assert _shapes(value) == _shapes(value_and_grad) == {(p,), (1, p), (2, p), (3, p)}
        assert [value.entry(xs[:lanes], target) for lanes in (3, 2, 1)] == entries
        tja.optimize_horizon_mps_multistart(circ, xs, target, base_bits=BITS, trunc_thr=thr, maxiter=2)
        again = tja.optimize_horizon_mps_jit(circ, xs[0], target, base_bits=BITS, trunc_thr=thr, maxiter=2)
    assert set(tja._PROGRAMS) - one_keys == {("fleet_chunks", circ, BITS, thr, None, 2, None, "native")}
    assert _shapes(value) == {(p,), (1, p), (2, p), (3, p)} and len(tja.mps_programs()) == 8
    assert {shape for shape, _ in tja.mps_program_shapes()} == {(p,), (1, p), (2, p), (3, p)}
    assert torch.equal(again.thetas, one.thetas) and again.num_iters == one.num_iters


def test_the_watchdog_reruns_only_the_lane_that_disagrees(monkeypatch):
    """On "rand" (the CPU's reference is "native") every lane passes; with
    lane 1's reference value forced off, lane 1 alone is flagged and re-run
    from its start under "native", and lanes 0 and 2 stay bit for bit."""
    circ, target, xs = _case()
    thr = float(CFG["trunc_thr"])

    def fleet():
        with config.svd_impl_override("rand"):
            return tja.optimize_horizon_mps_multistart(circ, xs, target, base_bits=BITS, trunc_thr=thr, maxiter=3)

    want = fleet()
    assert tja.watchdog_events == []
    real = tja._mps_value_program

    def forced(circ_, bits, thr_, impl):
        program = real(circ_, bits, thr_, impl)
        if impl != "native":
            return program

        def call(th, tgt):
            f = program(th, tgt)
            return f + torch.tensor([0.0, 0.5, 0.0], dtype=f.dtype) if th.dim() == 2 else f

        return call

    monkeypatch.setattr(tja, "_mps_value_program", forced)
    got = fleet()
    monkeypatch.undo()
    assert [(e["lane"], e["svd_impl"], e["reference_impl"]) for e in tja.watchdog_events] == [(1, "rand", "native")]
    for lane in (0, 2):
        assert torch.equal(got.thetas[lane], want.thetas[lane]) and torch.equal(got.fobj[lane], want.fobj[lane])
        assert got.num_iters[lane] == want.num_iters[lane] and got.converged[lane] == want.converged[lane]
    with config.svd_impl_override("native"):
        alone = tja.optimize_horizon_mps_jit(circ, xs[1], target, base_bits=BITS, trunc_thr=thr, maxiter=3)
    assert torch.equal(got.thetas[1], alone.thetas) and torch.equal(got.fobj[1], alone.fobj)
    assert got.num_iters[1] == alone.num_iters and torch.equal(got.fidelity, 1.0 - got.fobj)


def test_the_fleet_records_its_request_steps_and_lanes():
    circ, target, xs = _case()
    thr = float(CFG["trunc_thr"])
    profiling.enable_spans()
    try:
        with config.svd_impl_override("rand"):
            res = tja.optimize_horizon_mps_multistart(circ, xs, target, base_bits=BITS, trunc_thr=thr, maxiter=3,
                                                      fidelity_thr=0.9)
        snap = profiling.snapshot()
    finally:
        profiling.disable_spans()
        profiling.reset_spans()
    spans = snap["spans"]
    requests = [s for s in spans if s["parent"] is None]
    assert [(s["name"], s["attrs"]) for s in requests] == [("asp.horizon", {"lanes": LANES})]
    its = [s for s in spans if s["name"] == "lbfgs.iteration"]
    assert its and all(s["parent"] == requests[0]["id"] for s in its) and len(its) == sum(res.num_iters)
    steps = [s for s in its if s["counts"]]
    assert all(s["counts"]["fleet_steps"] == 1 for s in steps)
    assert sum(s["counts"]["fleet_lanes"] for s in steps) == snap["counters"]["fleet_lanes"] == sum(res.num_iters)
    assert snap["counters"]["fleet_steps"] == len(steps) == max(res.num_iters)
    # Each step's span, then an instant of no wall for each further lane.
    fill = [s["counts"].get("fleet_lanes") for s in sorted(its, key=lambda s: s["id"])]
    assert fill == [n for s in steps for n in [s["counts"]["fleet_lanes"]] + [None] * (s["counts"]["fleet_lanes"] - 1)]
    assert all(s["start_ns"] == s["end_ns"] and s["attrs"]["lane"] > 0 for s in its if s not in steps)
    by_id = {s["id"]: s for s in spans}
    (watchdog,) = [s for s in spans if s["name"] == "asp.watchdog"]
    replays = [s for s in spans if s["name"] == "program.replay" and s["parent"] == watchdog["id"]]
    assert len(replays) == 1 and by_id[watchdog["parent"]] is requests[0]
    assert all(s["request"] == requests[0]["id"] for s in spans)
