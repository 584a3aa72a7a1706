"""The one traffic generator: the jobs a traffic mix describes.

A mix is a JSON file of parameters:

* ``route`` -- the pair-update route the horizons run on;
* ``maxiter``, ``fidelity_thr`` -- each horizon's stopping rules;
* ``start_sigma`` -- the start points: horizon k of a run with seed s
  starts at the configuration's Trotter initial point plus
  ``start_sigma`` rad times N(0, 1) per angle, drawn from
  ``numpy.random.default_rng((s, k))``, so every horizon of every run
  starts from a point of its own;
* ``warm_iters`` -- the iterations of the set-up's warm horizon, which
  starts at the Trotter point itself;
* ``sample`` -- how many horizons of a window the correctness check
  compares with the reference.

The loop is closed with one client: the next horizon starts when the last
has returned, and none starts once the window's seconds have passed.
"""

from __future__ import annotations

import numpy as np

from reference import circuit as C


def trotter_point(config: dict) -> np.ndarray:
    tgt = config["target"]
    return C.trotter_initial_point(int(config["num_qubits"]), int(config["num_layers"]),
                                   float(tgt["evol_time"]), float(tgt["delta"]), bool(config["second_order"]))


def start_point(base: np.ndarray, traffic: dict, seed: int, k: int) -> np.ndarray:
    """The start point of horizon k of a run with this seed, around the
    configuration's Trotter point ``base``."""
    rng = np.random.default_rng((int(seed) % 2**64, int(k)))
    return base + float(traffic["start_sigma"]) * rng.standard_normal(base.size)


def check_sample(num_horizons: int, iters, traffic: dict, seed: int) -> list:
    """The horizons the check compares, drawn from the seed among the
    window's ``num_horizons``: the one with the most iterations and others
    at random, in window order."""
    count = min(int(traffic["sample"]), num_horizons)
    if count == 0:
        return []
    longest = int(np.argmax(iters))
    rest = [k for k in range(num_horizons) if k != longest]
    rng = np.random.default_rng((int(seed) % 2**64, 2**32))
    picked = list(rng.permutation(rest)[: count - 1]) if rest else []
    return sorted([longest] + [int(k) for k in picked])
