"""On the card: one short run of each cell through the command, as the
check runs it, and the control's readings at the cell's own size.

    python -m pytest --noconftest -m cuda h100bench/tests/test_h100bench_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

CELLS = ["asp28-rand-restarts", "asp28-jacobi-restarts"]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell):
    _need_card()
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", cell, "--seed", str(2**31 + 7),
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, out.stderr[-2000:]
    assert list(line)[-1] == "checks" and {"setup_s", "iter_s"} <= set(line["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    """The reference in TF32 put in the program's place fails the cell's
    limits, and the program's own readings pass them."""
    _need_card()
    out = subprocess.run([sys.executable, "h100bench/control.py", "--workload", cell, "--seeds", "5",
                          "--control-seeds", "5"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    row = next(json.loads(line) for line in out.stdout.splitlines() if line.startswith('{"seed"'))
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as fh:
        limits = json.load(fh)
    assert all(row["program"][k] <= limits[k] for k in limits), row
    assert any(row["control"][k] > limits[k] for k in limits), row
