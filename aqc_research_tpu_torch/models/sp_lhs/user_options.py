"""User-supplied settings of the ASP time-evolution driver (twin of
``aqc_research_tpu/models/sp_lhs/user_options.py``: the same tunables and
defaults, among them ``chi_max``, the static MPS working bond dimension, and
``use_jit_lbfgs``, the optimization loop on the tensors' device).

One default differs: ``result_dir`` is ``results/trotter_evol_torch``.  Both
packages pickle their own classes into the target cache and the horizon
checkpoint of that folder, so a shared folder would make each package
unpickle — and so import — the other.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import numpy as np

from ... import config
from ...ops.mps import no_truncation_threshold
from ...targets import trotter as trotop


class UserOptions:
    """All user-supplied settings of the ASP simulation."""

    def __init__(self, cargs: Optional[Any] = None):
        # Number of qubits in simulation, n >= 2.
        self.num_qubits = int(cargs.num_qubits) if cargs else 5

        # Pre-compute the target states and exit, if True.
        self.target_only = bool(cargs.target_only) if cargs else False

        # Tag-string that helps to identify the simulation results.
        self.tag = str(cargs.tag) if cargs else ""

        # File to load pre-computed target states from ("" = default path).
        self.targets_file = str(cargs.targets_file) if cargs else ""

        # Output folder of simulation results.
        self.result_dir = os.path.join(os.getcwd(), "results", "trotter_evol_torch")

        # Parameter "delta" in the Hamiltonian — scale of z-terms.
        self.delta = 1.0

        # MPS truncation thresholds: working accuracy and ground-truth
        # target accuracy (reference user_options.py:55-56).
        self.trunc_thr = 1e-6
        self.trunc_thr_target = no_truncation_threshold()

        # Static working bond dimension of the MPS engine (padded).
        self.chi_max = 64

        # Time grid: big steps define the horizons; dt is the small Trotter
        # step (reference user_options.py:59-76).
        small_step = 0.4
        big_step = 1.2
        num_big_steps = 6
        step_range = 1 + np.arange(num_big_steps)
        self.trotter_steps = step_range * int(round(big_step / small_step))
        self.evol_times = np.round(step_range * big_step, 3)

        # Ansatz layers added per big step, or a manual schedule.
        self.num_layers_inc = 2
        self.manual_num_layers = None  # e.g. [2, 4, 6, 7, 8, 9]

        # Objective: "sur_max" (full vectors) or "sur_fast_mps_trotter" (MPS).
        self.objective = "sur_fast_mps_trotter"

        # Initial-state program factory (1-tuple, reference convention).
        self.ini_state_func = (trotop.neel_init_state,)

        # Maximum number of optimization iterations.
        self.maxiter = 40

        # Time limit for optimization in seconds; -1 means no limit.
        self.time_limit = -1

        # Seed for the pseudo-random generator.
        self.seed = int(round(time.time()))

        # Desired least fidelity (None = automatic selection).
        self.fidelity_thr = 0.995

        # Enables the 2nd-order Trotter circuit (recommended).
        self.second_order_trotter = True

        # Verbosity.
        self.verbose = True

        # Experimental: gradient amplification on barren plateaus.
        self.enable_grad_scaling = True

        # Debugging: store intermediate optimization results.
        self.save_intermediate_results = False

        # Resume an interrupted simulation: path to an existing results
        # folder of a PREVIOUS run with the same schedule.  Completed
        # horizons are restored from its horizon checkpoint
        # (``horizon_checkpoint.pkl``, written after every horizon) and
        # skipped; the remaining horizons run into the SAME folder.  The
        # schedule fingerprint (qubits/objective/thresholds/time grid) must
        # match, otherwise the resume is refused.  Empty string = fresh run.
        # (The reference driver has no resume: a crash at horizon k of 6
        # loses all completed horizons, time_evol_best_init.py:385.)
        self.resume_dir = str(getattr(cargs, "resume", "")) if cargs else ""

        # Maximal number of ansatz expansions per horizon: when the optimized
        # fidelity falls short of the threshold, up to this many extra layers
        # are inserted and the horizon re-optimized (the reference implements
        # the loop, time_evol_best_init.py:259-298, but hardcodes 0 at the
        # call site :378; exposed here as a knob).
        self.num_expansions = 0

        # The optimization loop of models/sp_lhs/jit_asp.py with the
        # objective, the gradient and the L-BFGS state on the tensors'
        # device — the card's production path.  The host path (the SciPy
        # protocol objectives) is the reference-parity path of the JAX
        # package; in this package it is not ported yet.  None = auto: on
        # with a CUDA default device, off on the CPU.  time_limit is
        # enforced by running the loop in chunks (the host checks the clock
        # every ``jit_chunk_iters`` iterations).
        self.use_jit_lbfgs = None

        # L-BFGS iterations per chunk of that loop; only matters when
        # time_limit > 0 (smaller chunks check the clock more often).
        self.jit_chunk_iters = 25

        # Warm-start each horizon from the previous one's optimized angles:
        # the first L_prev layers copy the previous solution, the appended
        # layers take the perfect Trotter init for the REMAINING time.
        # MEASURED (6q A/B, benchmarks history): the composed tail is
        # effectively 1st-order (the 2nd-order half-layer structure cannot
        # be replicated mid-circuit), so the warm init's objective is
        # WORSE than the cold perfect init (3.1e-3 vs 1.4e-3) — the
        # reference's perfect initialization is already excellent.  Kept as
        # an option (exact-consistency tested); default off.
        self.warm_start_horizons = False

    @property
    def use_mps(self) -> bool:
        """MPS vs full vectors, derived from the objective name."""
        return self.objective.find("mps") >= 0

    def resolve_use_jit_lbfgs(self) -> bool:
        """The effective switch: ``use_jit_lbfgs`` when set explicitly, else
        auto — True when the default device is the CUDA card, False on the
        CPU (the JAX package's rule, with the card in the TPU's place)."""
        if self.use_jit_lbfgs is not None:
            return bool(self.use_jit_lbfgs)
        return config.device().type == "cuda"
