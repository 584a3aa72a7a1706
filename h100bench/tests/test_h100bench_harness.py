"""The harness's pieces on the CPU: BENCHMARK.json against the contract's
shape, the traffic generator, the frozen census and the runner's work from
it, the readers on a recorded profiler table, the data-driven lookup of a
metric, and the JAX check."""

import json
import math
import os
import re
import sys
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import run as run_py  # noqa: E402
from harness import cell, spec, traffic  # noqa: E402
from harness.tracetab import TraceTable  # noqa: E402
from work import census as W  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_json_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "h100bench/run.py"] and b["paths"] == ["h100bench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    assert cells == {"asp28-rand-restarts", "asp28-jacobi-restarts"}
    configs = {c["name"]: c for c in b["configs"]}
    assert set(configs) == {"asp28_chi128"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("h100bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as fh:
            body = json.load(fh)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"] == []
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(HERE, "limits", f"{w['name']}.json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["traffic"] for w in b["workloads"]} == {"restarts_rand", "restarts_jacobi"}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"setup_s", "iter_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    names = set()
    layers = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # Every cell that reports the metric reports what it moves.
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]].get("workloads", cells))
        layers.add(m["layer"])
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    with open(os.path.join(ROOT, "PERF.md")) as fh:
        perf = fh.read()
    for layer in layers:
        assert f"| {layer} |" in perf, layer
    assert len(json.dumps(b)) < 64 * 1024


def test_start_points_repeat_per_seed():
    cfg = spec.load_json(spec.ROOT / "h100bench/configs/asp20_chi64.json")
    trf = spec.load_json(spec.HERE / "traffic/restarts_jacobi.json")
    base = traffic.trotter_point(cfg)
    seed = 2**31 + 12345
    a = traffic.start_point(base, trf, seed, 3)
    np.testing.assert_array_equal(a, traffic.start_point(base, trf, seed, 3))
    assert a.shape == (972,) and 0.04 < (a - base).std() < 0.06
    # Every horizon of every run starts from a point of its own.
    points = [traffic.start_point(base, trf, s, k) for s in (seed, seed + 1) for k in range(4)]
    assert len({p.tobytes() for p in points}) == 8
    s = traffic.check_sample(4, [3, 9, 4, 4], trf, seed)
    assert s == traffic.check_sample(4, [3, 9, 4, 4], trf, seed)
    assert 1 in s and len(s) == 3 and s == sorted(s)


@pytest.mark.parametrize("n,chi", [(6, 8), (8, 16), (11, 32), (20, 64)])
def test_frozen_census_equals_the_programs(n, chi):
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.ops import roofline

    for layers in (2, 4):
        circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, layers), True)
        assert W.decomposition_census(n, layers, chi, True) == roofline.decomposition_census(circ, chi)


@pytest.mark.parametrize("config", ["asp28_chi128", "asp20_chi64"])
def test_runner_work_is_the_census(config):
    """The one-lane MPS runner charges each evaluation the frozen census's
    work at the configuration's circuit and chi, exactly."""
    cfg = spec.load_json(spec.HERE / "configs" / f"{config}.json")
    s = spec.CellSpec(config, 1, cfg, {}, None, [], [], spec.runner("horizon_mps"))
    census = W.decomposition_census(cfg["num_qubits"], cfg["num_layers"], cfg["chi"], cfg["second_order"])
    assert s.runner.work(s) == W.evaluation_work(census)
    assert set(s.runner.work(s)) == {"value", "obj_grad"}


def test_work_counts():
    assert W.pair_flops(256) == 8 * (4 * 128**3 + 16 * 128**2) + 84 * 256**3 + 32 * 128**3
    assert W.pair_bytes(256) == 4 * 2 * 128 * 128 * 8 + 4 * 128 * 4 + 128
    work = W.evaluation_work(W.decomposition_census(28, 4, 128, True))
    assert work["obj_grad"][0] > work["value"][0] > 0


def _table():
    """A recorded traced window: 1.0 s, two iterations."""
    dev = [("void fused_pair_cluster_kernel(float const*, int)", 0.00, 0.30),
           ("void jacobi_rows_cluster_kernel<4>(float const*)", 0.30, 0.35),
           ("void geqr2_smem<float2, float, 8, 5>(int, float2*)", 0.35, 0.55),
           ("void at::native::elementwise_kernel<128, 2>(int)", 0.55, 0.60),
           ("Memcpy DtoD (Device -> Device)", 0.58, 0.62),
           ("void theta_build_kernel<32, 2>(float const*)", 0.70, 0.80),
           ("void rand_tail_cluster_kernel<5>(float const*)", 0.80, 0.90)]
    host = [("cudaGraphLaunch", 0.0, 0.01), ("aten::item", 0.62, 0.70), ("aten::copy_", 0.9, 1.0)]
    return TraceTable(dev, host, 1.0)


def _recorded_run():
    cfg = spec.load_json(spec.ROOT / "h100bench/configs/asp28_chi128.json")
    trf = spec.load_json(spec.HERE / "traffic/restarts_rand.json")
    s = spec.CellSpec("asp28-rand-restarts", 1, cfg, trf, None, [], [], spec.runner("horizon_mps"))
    run = cell.Run(s, 1, None)
    run.work = s.runner.work(s)
    run.trace = TraceTable.from_rows(json.loads(json.dumps(_table().to_rows())))
    run.traced_iters = 2
    run.traced_evals = {"value": 1, "obj_grad": 2}
    run.window_s, run.setup_s = 10.0, 40.0
    run.untraced_s, run.untraced_iters = 4.0, 8
    run.untraced_evals = {"value": 2, "obj_grad": 4}
    run.horizons = [cell.Horizon(None, None, 0.004, it, 0) for it in (12, 8)]
    run.programs = [{"name": "mps value", "kind": "value", "warmup_s": 0.5, "capture_s": 1.0, "instantiate_s": 0.25,
                     "window_replays": 6},
                    {"name": "mps obj+grad", "kind": "obj_grad", "warmup_s": 1.0, "capture_s": 2.0,
                     "instantiate_s": 0.5, "window_replays": 24}]
    return run


def test_readers_on_a_recorded_table():
    run = _recorded_run()
    read = {name: spec.reader(name)(run) for name in
            ("pair_kernels_ms_per_iter", "range_finder_ms_per_iter", "engine_ms_per_iter", "idle_pct",
             "sweep_roofline_pct", "evals_per_iter", "capture_s", "setup_s", "iter_s")}
    assert read["pair_kernels_ms_per_iter"] == pytest.approx(1e3 * (0.30 + 0.05 + 0.10 + 0.10) / 2)
    assert read["range_finder_ms_per_iter"] == pytest.approx(1e3 * 0.20 / 2)
    busy = 0.62 + 0.20
    assert run.trace.busy_s() == pytest.approx(busy)
    assert read["engine_ms_per_iter"] == pytest.approx(1e3 * (busy - 0.55 - 0.20) / 2)
    # The untraced part ran twice the traced evaluations in 4 s.
    assert read["idle_pct"] == pytest.approx(100 * (1 - 2 * busy / 4.0))
    work = W.evaluation_work(W.decomposition_census(28, 4, 128, True))
    least = max((work["value"][0] + 2 * work["obj_grad"][0]) / W.PEAK_F32_FLOPS,
                (work["value"][1] + 2 * work["obj_grad"][1]) / W.PEAK_HBM_BYTES)
    assert read["sweep_roofline_pct"] == pytest.approx(100 * least / 1.0)
    assert "bound by flops" in run.notes[-1]
    assert read["evals_per_iter"] == pytest.approx(30 / 20)
    assert read["capture_s"] == pytest.approx(5.25)
    assert (read["setup_s"], read["iter_s"]) == (40.0, 0.5)
    gaps = run.trace.idle_gaps(3)
    assert gaps[0] == ["aten::copy_", pytest.approx(0.10)] and gaps[1][0] == "aten::item"
    ops = dict(run.trace.top_ops(10))
    assert ops["fused_pair_cluster_kernel"] == pytest.approx(0.30)
    assert "geqr2_smem<float2, float, 8, 5>" in ops


def test_readers_find_nothing_without_a_trace():
    run = _recorded_run()
    run.trace, run.traced_iters, run.traced_evals = None, 0, {}
    for name in ("pair_kernels_ms_per_iter", "range_finder_ms_per_iter", "engine_ms_per_iter", "idle_pct",
                 "sweep_roofline_pct"):
        assert spec.reader(name)(run) is None
    run.trace = TraceTable([("void jacobi_rows_kernel<true>(float)", 0.1, 0.2)], [], 1.0)
    run.traced_iters, run.traced_evals = 1, {"value": 0, "obj_grad": 1}
    assert spec.reader("range_finder_ms_per_iter")(run) is None
    assert spec.reader("sweep_roofline_pct")(run) > 0


def test_a_new_metric_is_a_new_file(tmp_path):
    """A later metric is one file and one entry: the harness reads it by name
    and no file it has changes."""
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "horizons_done.py").write_text("def read(run):\n    return float(len(run.horizons))\n")
    folders = (tmp_path, spec.HERE)
    bench = _bench()
    bench["per_layer"].append({"name": "horizons_done", "unit": "horizons", "better": "higher",
                               "source": "program_counter", "layer": "optimizer", "moves": "iter_s",
                               "workloads": ["asp28-jacobi-restarts"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    s = spec.cell_spec("asp28-jacobi-restarts", bench_path=path, folders=folders)
    extra = [m for m in s.per_layer if m.name == "horizons_done"]
    assert len(extra) == 1 and extra[0].read(_recorded_run()) == 2.0
    assert "horizons_done" not in {m.name for m in spec.cell_spec("asp28-rand-restarts", bench_path=path,
                                                                  folders=folders).per_layer}
    assert {m.name for m in s.end_to_end} == {"setup_s", "iter_s"}


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    for name in ("aqc_research_tpu_torch", "aqc_research_tpu_torch.ops", "jaxtyping", "flaxen", "aqc_research_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for name in [m for m in sys.modules if m.split(".")[0] in run_py.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert run_py.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax.linen", "aqc_research_tpu", "aqc_research_tpu.ops.mps"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run_py.forbidden_modules() == sorted(["jax", "jaxlib.xla_client", "flax.linen", "aqc_research_tpu",
                                                 "aqc_research_tpu.ops.mps"])


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run_py.main(["--workload", "asp28-jacobi-restarts", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err


def test_process_age():
    assert 0 < cell.process_age_s() < 1e6
    assert math.isfinite(cell.process_age_s())
