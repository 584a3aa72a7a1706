"""What ``BENCHMARK.json`` says about one cell, and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by its name:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives); its
  ``runner`` key names the runner, ``horizon_mps`` where it has none,
* ``runners/<runner>.py`` -- the program a cell drives (see
  ``runners/horizon_mps.py`` for what a runner provides),
* ``traffic/<traffic>.json``,
* ``limits/<cell>.json`` -- the limits of the numbers that decide
  ``correct``,
* ``metrics/<metric>.py`` -- a reader with ``read(run) -> float | None``.

Each is looked up in the benchmark's folder; a test may put folders of its
own first in ``folders``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import types
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parents[1]   # the benchmark's folder
ROOT = HERE.parent                           # the checkout

DEFAULT_RUNNER = "horizon_mps"


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
    runner: types.ModuleType


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find(kind: str, name: str, ext: str, folders: Sequence[Path] = (HERE,)) -> Path:
    """``<folder>/<kind>/<name><ext>`` in the first of ``folders`` that has it
    (the last folder's path where none has)."""
    paths = [Path(f) / kind / f"{name}{ext}" for f in folders]
    return next((p for p in paths if p.exists()), paths[-1])


def _module(kind: str, name: str, folders: Sequence[Path]) -> types.ModuleType:
    path = find(kind, name, ".py", folders)
    mod_name = f"h100bench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def reader(name: str, folders: Sequence[Path] = (HERE,)) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module("metrics", name, folders).read


def runner(name: str, folders: Sequence[Path] = (HERE,)) -> types.ModuleType:
    """The module ``runners/<name>.py``."""
    return _module("runners", name, folders)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(cell: str, bench_path: Path = ROOT / "BENCHMARK.json", folders: Sequence[Path] = (HERE,)) -> CellSpec:
    bench = load_json(bench_path)
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in {bench_path.name}; have {sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(find("traffic", w["traffic"], ".json", folders))
    limits_path = find("limits", cell, ".json", folders)
    limits = load_json(limits_path) if limits_path.exists() else None

    def metrics(kind):
        return [Metric(m["name"], m["unit"], reader(m["name"], folders)) for m in bench[kind] if _reports(m, cell)]

    return CellSpec(cell, int(w["chips"]), config, traffic, limits, metrics("end_to_end"), metrics("per_layer"),
                    runner(config.get("runner", DEFAULT_RUNNER), folders))
