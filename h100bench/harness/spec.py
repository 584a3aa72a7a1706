"""What ``BENCHMARK.json`` says about one cell, and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by its name:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives),
* ``traffic/<traffic>.json``,
* ``limits/<cell>.json`` -- the limits of the numbers that decide
  ``correct``,
* ``metrics/<metric>.py`` -- a reader with ``read(run) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]   # the benchmark's folder
ROOT = HERE.parent                           # the checkout


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Optional[dict]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reader(name: str, folder: Path = HERE / "metrics") -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(cell: str, bench_path: Path = ROOT / "BENCHMARK.json",
              metrics_dir: Path = HERE / "metrics") -> CellSpec:
    bench = load_json(bench_path)
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in {bench_path.name}; have {sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits_path = HERE / "limits" / f"{cell}.json"
    limits = load_json(limits_path) if limits_path.exists() else None

    def metrics(kind):
        return [Metric(m["name"], m["unit"], reader(m["name"], metrics_dir))
                for m in bench[kind] if _reports(m, cell)]

    return CellSpec(cell, int(w["chips"]), config, traffic, limits, metrics("end_to_end"), metrics("per_layer"))
