"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 h100bench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

In one process on the card: the cell's set-up once, then per seed a short
window (the seed's first horizons of the cell's traffic, as many as a run's
check compares) and the check's numbers for the program (its lower readings); for each control
seed also the numbers of the control, the reference computed in the
precision below the configuration's (TF32 for the MPS runner) and put in
the program's place (its upper readings).  One JSON line per seed on
standard output, a summary last.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    args = parser.parse_args(argv)
    for path in (HERE, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import cell, check
    from harness.spec import cell_spec

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    spec = cell_spec(args.workload)
    runner = spec.runner
    state = runner.setup(spec, dev)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = cell.Run(spec, seed, dev)
        cell.window(run, state, 0.0, False, int(spec.traffic["sample"]))
        runner.outputs(state, run)
        tic = time.perf_counter()
        row = {"seed": seed, "horizons": len(run.horizons), "iters": [h.iters for h in run.horizons],
               "failed": cell.failed(run), "program": runner.readings(run, dev)}
        row["check_s"] = time.perf_counter() - tic
        if seed in controls:
            row["control"] = runner.readings(run, dev, control=True)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in check.NUMBERS:
        prog_vals = [r["program"][name] for r in rows]
        ctrl_vals = [r["control"][name] for r in rows if "control" in r]
        summary[name] = {"program_max": max(prog_vals), "control_min": min(ctrl_vals) if ctrl_vals else None}
    print(json.dumps({"workload": spec.name, "seeds": len(rows), "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
