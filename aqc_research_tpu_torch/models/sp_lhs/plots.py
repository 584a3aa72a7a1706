"""Fidelity-profile plots of the ASP time-evolution driver (twin of
``aqc_research_tpu/models/sp_lhs/plots.py``): fidelity vs time horizon with
secondary axes for ansatz layers and Trotter steps, one PNG per
block-repeat count.

matplotlib is the port's one optional import (not a dependency of the
port): where it is missing, the plot is skipped with one log line, so a
finished schedule does not fail on its last step.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ...utils import create_logger

_logger = create_logger(__file__)


def plot_fidelity_profiles(
    *,
    results: List[Dict],
    output_dir: str,
    no_print_block_rep: bool = False,
) -> List[str]:
    """Plots fidelity-vs-horizon profiles; returns the saved file paths
    (none without matplotlib)."""
    try:
        import matplotlib
    except ImportError:
        _logger.info("matplotlib is not installed: no fidelity plot in %s", output_dir)
        return []

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    saved = []
    block_reps = sorted({r.get("block_reps", 3) for r in results})
    for rep in block_reps:
        subset = [r for r in results if r.get("block_reps", 3) == rep]
        if not subset:
            continue
        times = np.asarray([r["evol_time1"] for r in subset])
        fid_a1_gt = np.asarray([r["fid_a1_vs_gt"] for r in subset])
        fid_t1_gt = np.asarray([r["fid_t1_vs_gt"] for r in subset])
        fid_a1_t1 = np.asarray([r["fid_a1_vs_t1"] for r in subset])
        layers = [r["num_layers"] for r in subset]
        steps = [r["num_trotter_steps"] for r in subset]
        num_qubits = subset[0]["num_qubits"]

        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(times, fid_a1_gt, "o-", label="fid(|a1>, |t1_gt>) — ansatz")
        ax.plot(times, fid_t1_gt, "s--", label="fid(|t1>, |t1_gt>) — Trotter")
        ax.plot(times, fid_a1_t1, "^:", label="fid(|a1>, |t1>)")
        ax.set_xlabel("evolution time")
        ax.set_ylabel("fidelity")
        title = f"ASP fidelity profiles, n={num_qubits}"
        if not no_print_block_rep:
            title += f", block_reps={rep}"
        ax.set_title(title)
        ax.grid(True, alpha=0.3)
        ax.legend(loc="lower left")

        # Secondary axes: ansatz layers and Trotter steps per horizon.
        ax2 = ax.secondary_xaxis("top")
        ax2.set_xticks(times)
        ax2.set_xticklabels([str(l) for l in layers])
        ax2.set_xlabel("ansatz layers")
        ax3 = ax.secondary_xaxis(1.15)
        ax3.set_xticks(times)
        ax3.set_xticklabels([str(s) for s in steps])
        ax3.set_xlabel("Trotter steps")

        fname = os.path.join(output_dir, f"fidelity_profiles_n{num_qubits}_rep{rep}.png")
        fig.tight_layout()
        fig.savefig(fname, dpi=120)
        plt.close(fig)
        saved.append(fname)
        _logger.info("saved fidelity plot: %s", fname)
    return saved
