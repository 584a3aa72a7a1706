"""The benchmark of the PyTorch/CUDA port on one NVIDIA H100.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process is one run of one cell of
``BENCHMARK.json``: set-up (the kernel library from the port's build cache,
then the set-up of the cell's runner, ``runners/<runner>.py``), a window of
the runner's requests of ``--seconds``, the check against the plain
reference, and one JSON line on standard output.  With ``--trace 0`` the
line holds the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, read from a profiler trace of the window's first requests and
from the program's spans.  The numbers that decide ``correct``
are printed last on standard error and last in the line.

It exits non-zero and prints no result without the CUDA cards the cell
asks for, and if the JAX package or JAX is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

FORBIDDEN = ("jax", "jaxlib", "flax", "aqc_research_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def _card_state() -> str:
    """The card's name and power limit, and its clock, temperature and draw
    just after the window."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu,"
                              "power.draw", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # One process with few threads: the host's other cores stay with the
    # card's launches.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # Build and kernel caches at fixed paths inside the checkout.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache", "torch_extensions")
    for path in (HERE, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch

    from harness import cell, check
    from harness.spec import cell_spec

    spec = cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"run.py: cell {spec.name} needs {spec.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    run = cell.execute(spec, args.seed, args.seconds, bool(args.trace), dev)
    card = _card_state()
    tic = time.perf_counter()
    numbers = spec.runner.readings(run, dev)
    run.notes.append(f"setup {run.setup_s:.3f} s (kernel library {'built' if run.built_kernels else 'loaded'} "
                     f"in {run.library_s:.3f} s), window {run.window_s:.3f} s, {len(run.horizons)} horizons, "
                     f"iterations {[h.iters for h in run.horizons]}, check {time.perf_counter() - tic:.3f} s")
    if run.trace is not None:
        run.notes.append(f"traced {run.trace.window_s:.3f} s over {run.traced_iters} iterations, then untraced "
                         f"{run.untraced_s:.3f} s over {run.untraced_iters} iterations")
    correct, table = check.verdict(numbers, spec.limits)

    metrics = {}
    for m in spec.per_layer if args.trace else spec.end_to_end:
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": spec.chips,
              "memory_peak_bytes": run.memory_peak_bytes, "power": card}
    # A checkout's first run builds the kernel library inside its set-up:
    # the line says so, and how long the library took.
    result = {"correct": bool(correct), "attempted": len(run.horizons), "failed": cell.failed(run),
              "metrics": metrics, "device": device,
              "setup_built_kernels": run.built_kernels, "library_s": run.library_s}
    if args.trace and run.trace is not None:
        busy = run.trace.busy_s()
        device.update(busy_s=busy, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_ops(10), "idle_gaps": run.trace.idle_gaps(10)}

    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 3

    for note in run.notes:
        print(f"note: {note}", file=sys.stderr)
    print(f"card: {device['power']}", file=sys.stderr)
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr)
    result["checks"] = table
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
