#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain-torch twin, then drives ASP horizons
of the 20-qubit χ=64 and the 28-qubit χ=128 MPS configurations on the jacobi
route and on the default (rand) route, the ASP driver over a schedule of
20-qubit χ=64 horizons, the dense statevector path (bench.py's 12-qubit
flagship and the driver's dense objective), approximate quantum compiling
and the multi-start fleets (dense and MPS), and the multi-GPU engines on
torch.distributed (one process per card).

Usage:  python3 chip_smoke.py        (from the root of a checkout; one card)

Phases, one line each:
  1. device   — the card's name and power limit; build and load the kernels
                (one nvcc per source, all started together); ptxas's
                registers and spill bytes per kernel.
  2. kernel   — K1 jacobi_rows vs plain twin at B=10, c=r in {8..128} and
                at B=4, c=r=256, on the home its rule picks
                (ops/jacobi_kernel.plane_home) and on the cluster home
                wherever the rule keeps another: singular values,
                reconstruction, orthogonality, sweep counts; then timed at
                B=10 128x128 and B=14 256x256 beside its twin,
                torch.linalg.svd, its old home (one block with the planes
                in shared memory at 128, in device memory at 256) and every
                cluster size on the same inputs; the heads c=r in {8..64}
                at the one-block home and every cluster size.  µs per phase
                (device-only ms over the slowest matrix's sweeps x (c - 1)
                phases), the home, cluster size, threads, shared bytes per
                CTA and the clusters the card keeps resident.
  2b. kernels — K2 theta_build and K3 rand_tail vs their plain twins at
                B=10, χ in {8, 16, 32, 64, 96, 128} on rand-route inputs
                (graded bond values; K3 at trunc 1e-6 and 1e-2 on its
                rule's home, ops/fused_rand.tail_plane_home, and on the
                cluster home); timed at B=10 χ=64 and B=14 χ=128 beside
                their twins and a library call (K2: one einsum of the gated
                θ, and the four products' batched matmul; K3 also at its
                old home, one block with the planes in shared memory at
                χ=64 and in device memory at χ=128, and every cluster size,
                with µs per phase as for K1); K2 at both tile edges (the
                A/B behind ops/fused_pair.theta_tile_edge).  Also the
                range-finder on zero-padded pair matrices of 128 and 256
                rows, where torch's batched CUDA QR returns NaN.
  2c. fused   — K4 fused_pair vs its plain twin at B=10, χ in {8, 16, 32,
                64} (planes in one block's shared memory), {96, 100, 128}
                (the cluster path: planes in the distributed shared memory
                of 8 CTAs) and on zero-padded θ (bonds of rank 20 at
                χ=128), bonds graded over 2 decades, trunc 1e-6 and 1e-2:
                λ, keep masks, kept uᵀ and vh projectors (weighted by
                s_k / s_max), reconstruction, sweep counts; at χ=128 with
                bonds graded over 6 decades λ, keep masks and sweep counts
                only (see K4_DECADES); the cluster size, the clusters the
                card keeps resident, ptxas's numbers for K2 and K4; timed at
                B=14 χ=128 beside its twin, torch.linalg.svd and its own
                device-memory home (the one-block design that preceded the
                cluster path) on the same inputs.
  3. slice    — 20 qubits, χ=64, 4-layer Trotter ansatz, trunc 1e-6, Neel
                prep, target Trotter(1.2, 3 steps, delta 1, 2nd order);
                perfect init + 0.05 rad perturbation (seed 5); one L-BFGS
                horizon of 10 iterations under precision "fast" and the
                jacobi route.
  4. rand     — the same horizon and target under the default route, which
                must be "rand" (K2 + range-finder + K3, K1 for the χ-growth
                heads and the watchdog).
  5. routes   — objective+gradient sweeps/s of both routes at the start
                point, timed in turns in this process (rand, jacobi, jacobi,
                rand, twice), then one profiled sweep each: device busy
                time, idle share, launches, host aten calls.
  5b. driver  — the ASP driver users start, time_evol.run_simulation, at
                20 qubits χ=64 under the default options (route "rand",
                use_jit_lbfgs resolving to True): horizons at t = 1.2 and
                2.4 of 2 and 4 layers, 10 iterations each (a fidelity bar
                no horizon reaches), the targets generated on the card.
                Run 1 checks each horizon's fobj below its start, the
                fidelities, the no-truncation re-evaluation within
                TOL_FINAL of 1 - fobj, horizon 1 against its f64
                re-evaluation on the host, no watchdog event, K1-K3
                launched and K4 not; run 2 resumes run 1's folder (no
                horizon again, the target cache hits); run 3 runs one
                horizon on an expired clock (time_limit 1e-9, chunks of
                2): is_timeout after 2 iterations.
  5b'. host20 — the driver's host protocol (use_jit_lbfgs=False): SciPy's
                L-BFGS-B over the sur_fast_mps_trotter surrogate, every
                evaluation on the card, at 20 qubits χ=64, one layer per
                step (horizons t = 1.2 and 2.4 of 1 and 2 layers), maxiter
                10: each horizon's first objective and gradient within 1e-4
                and 1e-3 (relative) of the device loop's value_and_grad at
                the same θ, the final fobj below its start and within
                TOL_FINAL of its c128 re-evaluation on the card, the
                1-layer horizon on the uncached co-sweep and the 2-layer one
                on the z-cached co-sweep (counted by spies), K2 and K3
                launched and K4 not; SciPy's nit, nfev and message, s/iter
                and evaluations per iteration; one evaluation per horizon
                profiled at its final θ (wall, device busy, idle share,
                aten calls, linalg_qr calls, launches).  The record's
                host20 path.
  5c. dense12 — the dense statevector path, which launches none of the
                hand-written kernels (checked): (a) bench.py's 12-qubit
                flagship (2-layer Trotter ansatz, perfect init + 0.2 rad,
                seed 12345; target Trotter(1.2, 30 steps)) through
                jit_asp.optimize_horizon_jit to infidelity 1e-3 in c64/f32:
                one warm-up counting the evaluations, 3 timed runs (min,
                median), one profiled run (aten calls per evaluation, idle
                share, over a run cut at 8 iterations), one profiled
                obj+grad and value; fobj <= 1e-3,
                47-85 iterations, the final θ re-evaluated in c128 on the
                card within 1e-5; (b) the co-sweep gradient against
                autograd at the start point: c128 within 1e-10 relative, c64
                within 1e-4 of c128; (c) run_simulation(objective="sur_max")
                at 12 qubits, horizons t = 1.2 and 2.4 of 2 and 4 layers,
                maxiter 40, the default fidelity bar: fid_a1_vs_gt within
                1e-5 of each result's fidelity.  The record's dense12 path.
  5d. aqc5   — approximate quantum compiling, which launches none of the
                hand-written kernels (checked), fast precision: (a) BASELINE
                config 1 (benchmarks/bench_aqc_multistart.py:52-183): 5
                qubits, spin ansatz of depth 160, cx, target
                exact_evolution(H(5, 1), I, 1) in c64; the fused objective
                and co-sweep gradient 1 - Re<V, U>/32 timed at one lane and
                at 16 lanes in one call (evaluations/s, aten calls, idle
                share); (b) the README's aqc_sketching call (5q, 40 layers,
                32 sketching vectors = full range, "spin", target "random",
                maxiter 300, lr 0.1) with 16 restarts, which run as one
                lane-batched compact L-BFGS: every lane's cost below its
                start, each lane's f32 cost within 1e-4 of the c128
                objective at its θ on the card (the reported fidelity is
                scored in c128 and re-read), 2 lanes against the one-lane loop
                from the same starts at maxiter 20 (within 1e-4, the same
                iterations); wall time, iterations, best cost; (c) the
                sketched driver (skvecs "rand", 8 vectors, maxiter 100, 2
                restarts through run_jobs); (d) aqc_coordinate_descent (5q,
                40 layers, maxiter 20, 2 restarts).  The record's aqc5 path.
  5e. fleet12 — BASELINE config 4 (bench_aqc_multistart.py:184-287): 12
                qubits, 2-layer Trotter ansatz, 8 starts at perfect init +
                0.2 N(0,1) (seed 3), target Trotter(1.2, 6 steps) of the Neel
                state, maxiter 150; optimize_horizon_jit on start 0 and
                optimize_horizon_multistart (batch_linesearch 2, unfused and
                fused) timed in turns (single, fleet, fused, single); fleet
                efficiency 8 t_single / t_fleet, the evaluation-batch
                overhead t_eb / t_e1 (one obj+grad at B=1 and B=8 in turns
                1, 8, 8, 1; medians), aten
                calls per fleet evaluation beside one lane's, the idle share
                of one profiled fleet iteration, the best fidelity against
                its c128 re-evaluation (1e-5), lane 0 of a sequential-
                backtracking fleet against the one-lane loop after 20
                iterations (1e-4); no kernel launch.  The record's fleet12
                path.
  5f. fleet20 — the MPS fleet: phase 3's case with 4 lanes (perfect init +
                0.05 rad from seeds 5..8), maxiter 10, route "rand": every
                lane's final fobj within TOL_FINAL of its f64 re-evaluation
                on the card, lane 0 within 1e-4 of the single-lane horizon,
                K1-K3 launched and K4 not, K2 and K3 launched as often per
                fleet evaluation (value, and obj+grad) as per one lane's;
                lane-sweeps/s against one lane's sweeps/s in turns,
                linalg_qr calls per evaluation (a spy on torch.linalg.qr), one
                profiled fleet evaluation; K2 and K3 at the folded batch B=40 χ=64 against
                their twins and timed device-only beside B=10, with bounds.
                The record's fleet20 path.
  6. slice28 — phase 3 at 28 qubits, χ=128 (BASELINE config 5): the jacobi
                route runs K4 for every pair update at χ=128 and K1 for the
                χ-growth heads; the final objective is re-evaluated in c128
                under "native" on the card.
  7. rand28   — the same horizon under the default route, "rand": K2 and K3
                (K3 at χ=64 and χ=128), K1 for the heads, K4 in the
                watchdog's "jacobi" re-check.
  8. routes28 — phase 5 at 28 qubits: rand, jacobi (K4) and jacobi with K4
                off (K1 at 256x256) in turns (rand, jacobi, unfused,
                unfused, jacobi, rand; 3 sweeps each), then one
                profiled sweep each.
  9. mesh28   — the multi-GPU engines on torch.distributed: one process per
                card (at most four; one on a one-card machine, where every
                check runs the sharded code on a group of one), NCCL, the
                kernel library phase 1 built: (a) phase 7's horizon with
                every half-layer pair-sharded over tp (fobj within 1e-4 of
                phase 7's, within TOL_FINAL of its c128 re-evaluation, K2
                and K3 launched, the all_gathers of one obj+grad and their
                elements, θ and fobj bitwise equal on every rank); (b) the
                chain-sharded obj+grad at 28q χ=128 over sp against the
                replicated value_and_grad (1e-4, gradient 1e-3 relative),
                the state bytes per rank, and a 20q χ=64 chain horizon
                (maxiter 10) against the replicated one (1e-4); (c) the
                tp-sharded statevector on bench.py's 12q flagship (1e-5);
                (d) fleet12's 8 starts through multistart_minimize over dp
                (maxiter 40), each lane within 1e-4 of the unsharded
                fleet's.  A rank that fails or hangs fails the phase.  Its
                launches (from (a)) are the record's mesh28 path.  Alone:
                ``mesh28_alone()`` (phases 1, 7 and 9).
Phases 5 and 8 time the routes over one round of turns (two before this
phase was added, to keep the script near half its time limit).
The λ checks of K3 and K4 (kernel_checks.lambda_check) hold λ on the values
both sides keep, allowing for the rescale change of the keep flips that
kernel_checks.near_threshold allows, and fail on any flip outside that set.
Every kernel and library time is read twice with CUDA events: device-only
(back-to-back calls queued behind a sleep kernel, so the wrappers' host time
stays out; the record's ``ms`` and ``library_ms``) and per call on an idle
device (``call_ms``, ``library_call_ms``: the method of the earlier records).
The last three lines are the kernel record, the card's name and power limit,
and ``{"ok": true, "device": ...}``.  Exits non-zero, printing no result,
when CUDA is missing or any check fails.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import logging
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
SHAPES = (8, 16, 32, 64, 128)
BIG_SHAPE, BIG_BATCH = 256, 4  # K1 with its planes in device memory
RAND_CHIS = (8, 16, 32, 64, 96, 128)
FUSED_CHIS = (8, 16, 32, 64, 96, 100, 128)  # 96, 100 (ragged), 128: K4's cluster path
PATH_CHI = 64
BATCH = 10
PATH28_CHI, PATH28_BATCH = 128, 14  # the 28q half-layer: 14 disjoint pairs
PAD_RANK = 20  # zero-padded θ: bonds far below χ, as on the MPS path
# K4's inputs grade each bond over 2 decades, so that the kept spectrum of
# θ stays above the 32 eps s_max guard floor.  With the rand route's 6
# decades, trunc 1e-6 keeps values within a few times that floor, whose
# directions the f32 Jacobi does not fix within its 12 sweeps: kernel and
# twin agree on λ and the keep masks there, but not on those values' vh
# rows, so that case is checked on λ, masks and sweeps only and its other
# differences are reported.
K4_DECADES = 2.0
MAX_SWEEPS = 12
CRITERIA = ("hybrid", "entry")  # the port's default first
# Tolerances of the kernel-vs-twin checks, relative to s_max / ||m||_F: the
# f32 Jacobi's convergence floor is 1e-6 * s_max per entry.
TOL_S = 1e-5
TOL_RECON = 2e-5
TOL_ORTH = 1e-5
TOL_THETA = 1e-5  # θ build, per-matrix relative Frobenius (f32, two orders)
TOL_PROJ = 2e-5  # kept vh projector of the rand tail; K4's weighted uᵀ and vh projectors
# The rand tail's truncation thresholds: the slice's, and a coarse one whose
# cut sits far above the f32 noise of the unseen remainder.
TAIL_THRESHOLDS = (1e-6, 1e-2)
# Route vs native objective at the same iterate: f32 decompositions.
TOL_ROUTES = 1e-4
# Final objective vs its f64 re-evaluation: f32 engine + decomposition noise
# (7.2e-5 measured on an H100 at the 20q iterate); the collapse class the
# check exists for is O(1).
TOL_FINAL = 3e-4
# The driver phase: horizons at t = 1.2 and 2.4 (3 and 6 Trotter steps) from
# the Neel state, as UserOptions' first two big steps.
DRIVER_QUBITS, DRIVER_TIMES, DRIVER_STEPS = 20, (1.2, 2.4), (3, 6)
# Fidelities of f32 states may exceed 1 by rounding (norms kept to ~1e-7).
TOL_FID_ROUND = 1e-6
# The dense phase: bench.py's flagship (bench.py:41-46) — 12 qubits, 2
# layers, 0.2 rad perturbation of the perfect init (seed 12345), infidelity
# 1e-3 within 300 iterations.  The JAX package on a CPU takes 63 iterations
# in c64 and 61 in c128; the band allows other f32 rounding paths.
DENSE_QUBITS, DENSE_LAYERS, DENSE_PERTURBATION, DENSE_SEED = 12, 2, 0.2, 12345
DENSE_INFIDELITY, DENSE_MAXITER, DENSE_ITERS = 1e-3, 300, (47, 85)
DENSE_PROFILE_ITERS = 8
TOL_DENSE_RECHECK = 1e-5  # f32 fobj vs its c128 re-evaluation
TOL_COSWEEP_C128 = 1e-10  # co-sweep vs autograd, relative, c128
TOL_COSWEEP_C64 = 1e-4  # c64 gradients vs the c128 co-sweep, relative
TOL_DENSE_FID = 1e-5  # the driver's fid_a1_vs_gt vs the result's fidelity (f32)
DENSE_DRIVER_MAXITER = 40
# The host-protocol phase: the driver phase's horizons at one layer per
# step (1 and 2 layers), SciPy's L-BFGS-B over the surrogate on the card.
# At each horizon's start point the surrogate (its leading flip state |0>,
# the amplifier's first estimate 1) is the fidelity objective: its fobj and
# gradient against the device loop's value_and_grad, both f32.
HOST_MAXITER = 10
TOL_HOST_F = 1e-4
TOL_HOST_G = 1e-3  # relative l2

# Peak rates of one H100 SXM for the bounds: f32 outside the tensor cores and
# HBM3 bandwidth (NVIDIA's data sheet, at the 700 W limit).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
EPS32 = float(np.finfo(np.float32).eps)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the least time of the work on the card."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def jacobi_flops(c: int, r: int, sweeps) -> float:
    """One-sided Jacobi work: per sweep c-1 phases of c/2 pairs, each pair 16
    flops per entry for its Gram entries and 20 for the rotation (every pair
    counted as rotating): 18 c (c-1) r per sweep, summed over matrices."""
    return 18.0 * c * (c - 1) * r * float(np.sum(sweeps))


def graded_matrices(rng, batch: int, n: int) -> np.ndarray:
    """Complex matrices with a graded spectrum 1 .. 1e-2 (log-spaced).

    Two decades: the entry criterion bounds a small column's contamination
    by 1e-6 * s_max / s_j, so deeper spectra test rounding luck, not the
    kernel (at 1 .. 1e-3 most 64x64 matrices stop at the 12-sweep cap)."""
    a = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    u, _, vh = np.linalg.svd(a)
    s = 10.0 ** (-2.0 * np.arange(n) / (n - 1))
    return ((u * s[None, None, :]) @ vh).astype(np.complex64)


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median time per call of ``fn`` over ``runs`` calls, each between its
    own pair of CUDA events on an idle device: the wrapper's host time (checks,
    allocations, the launch itself) counts in it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per device millisecond, timed once."""
    cycles = 20_000_000
    torch.cuda._sleep(cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, calls: int = 10, repeats: int = 5):
    """Device time per call of ``fn`` with the host's time kept out: ``calls``
    back-to-back calls between one pair of CUDA events, queued behind a sleep
    kernel that outlasts twice their enqueue, so the device runs them without
    waiting for the host; median over ``repeats``.  Returns (ms, queued):
    ``queued`` is False when the device reached the start event before the
    host had enqueued every call (``fn`` synchronises, as a cuSOLVER call
    that checks its info does), and the time then includes host time."""
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = 1e3 * (time.perf_counter() - tic)
    torch.cuda.synchronize()
    cycles = int(sleep_cycles_per_ms() * (2.0 * host_ms + 1.0))
    times, queued = [], True
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = queued and not start.query()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times)), queued


def timings(fn, calls: int = 10, repeats: int = 5, runs: int = 20) -> dict:
    """Both times of ``fn``: device-only (:func:`device_ms`) and per call
    (:func:`median_ms`, the method of the earlier records)."""
    ms, queued = device_ms(fn, calls, repeats)
    return {"ms": ms, "queued": queued, "call_ms": median_ms(fn, runs=runs)}


def fmt(t: dict) -> str:
    return (f"{t['ms']:.4f} ms device-only{'' if t['queued'] else ' (host-bound: not queued)'}, "
            f"{t['call_ms']:.4f} ms per call")


def record_times(kernel: dict, library: dict) -> dict:
    """The kernel record's time keys: ``ms`` and ``library_ms`` device-only,
    the per-call times beside them."""
    return {"ms": kernel["ms"], "call_ms": kernel["call_ms"], "queued": kernel["queued"],
            "library_ms": library["ms"], "library_call_ms": library["call_ms"],
            "library_queued": library["queued"]}


def kernel_counters():
    from aqc_research_tpu_torch.ops.fused_pair import fused_pair, theta_build
    from aqc_research_tpu_torch.ops.fused_rand import rand_tail
    from aqc_research_tpu_torch.ops.jacobi_kernel import jacobi_rows

    return {"jacobi_rows": jacobi_rows, "theta_build": theta_build, "rand_tail": rand_tail,
            "fused_pair": fused_pair}


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0
        fn.launches_at = {}
        if hasattr(fn, "launches_home"):
            fn.launches_home = {}


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def read_counts_at() -> dict:
    """Launches by pair-matrix size n = 2χ (K1: its row count)."""
    return {name: dict(sorted(fn.launches_at.items())) for name, fn in kernel_counters().items()}


def read_counts_home() -> dict:
    """K1's and K3's launches by plane home."""
    return {name: dict(sorted(fn.launches_home.items())) for name, fn in kernel_counters().items()
            if hasattr(fn, "launches_home")}


def ptxas_usage(report: str) -> dict:
    """Registers and spill bytes per kernel from the build's ``-Xptxas -v``
    report: {"theta_build_kernel<32>": "40 regs, spill 0/0 B", ...}."""
    usage, current = {}, None
    for ln in report.splitlines():
        named = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if named:
            m = re.search(r"([a-z_]+_kernel)(?:IL[a-z](\d+)E)?", named.group(1))
            current = None if m is None else m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if spill:
            usage.setdefault(current, {})["spill"] = f"{spill.group(1)}/{spill.group(2)} B"
        regs = re.search(r"Used (\d+) registers", ln)
        if regs:
            usage.setdefault(current, {})["regs"] = int(regs.group(1))
    return {k: f"{v.get('regs', '?')} regs, spill {v.get('spill', '?')}" for k, v in usage.items()}


PTXAS: dict = {}


def phase_device():
    from aqc_research_tpu_torch.ops import cuda_build

    card = subprocess.run(CARD_QUERY, capture_output=True, text=True, timeout=60, check=True)
    card_line = card.stdout.strip().splitlines()[0]
    tic = time.perf_counter()
    lib = cuda_build.build_kernel_library()
    cuda_build.load()
    build_s = time.perf_counter() - tic
    PTXAS.update(ptxas_usage(lib.with_suffix(".ptxas.txt").read_text()))
    print(f"[device] {torch.cuda.get_device_name(0)} | {card_line} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | kernels built+loaded in {build_s:.2f} s | "
          f"ptxas: {'; '.join(f'{k} {v}' for k, v in sorted(PTXAS.items()))}", flush=True)
    return card_line


def _factor(w_re, w_im, m):
    """(s, u, vh) of the full factorization from the rotated rows."""
    from aqc_research_tpu_torch.ops.jacobi_kernel import _sort_guard_top_k

    n = m.shape[-1]
    w, s, inv = _sort_guard_top_k(w_re, w_im, n, m.dtype)
    u = (w * inv[..., :, None].to(w.dtype)).transpose(-1, -2)
    vh = inv[..., :, None].to(u.dtype) * torch.matmul(u.conj().transpose(-1, -2), m)
    return s, u, vh


def cluster_candidates(c: int):
    """Every cluster size the loop takes on c rows with no idle CTA (the
    A/B behind jacobi_kernel.cluster_size and CLUSTER_MIN_ROWS)."""
    from aqc_research_tpu_torch.ops import jacobi_kernel as jk

    return [k for k in range(1, jk.CLUSTER_MAX + 1)
            if jk.cluster_pairs(c, k) <= jk.CLUSTER_MAX_PAIRS and (k - 1) * jk.cluster_pairs(c, k) < c // 2]


def home_ab(fn, c: int, old_home: str, sweeps_at: int, calls: int = 5, repeats: int = 3) -> dict:
    """Device-only ms, the slowest matrix's sweeps and µs per phase (ms over
    sweeps x (c - 1) phases) of ``fn(home, cluster)`` at ``old_home`` and at
    every candidate cluster size, on the caller's inputs; ``sweeps_at``
    indexes the sweep counts in ``fn``'s result.  Keys: the home, or
    "cluster kxP" (k CTAs of P pairs)."""
    from aqc_research_tpu_torch.ops import jacobi_kernel as jk

    out = {}
    variants = [(old_home, None)] + [("cluster", k) for k in cluster_candidates(c)]
    for home, k in variants:
        sweeps = int(fn(home, k)[sweeps_at].max())
        ms, _ = device_ms(lambda: fn(home, k), calls, repeats)
        label = home if k is None else f"cluster {k}x{jk.cluster_pairs(c, k)}"
        out[label] = {"ms": ms, "max_sweeps": sweeps, "us_per_phase": 1e3 * ms / max(sweeps * (c - 1), 1)}
    return out


def fmt_ab(ab: dict) -> str:
    return ", ".join(f"{k} {v['ms']:.4f} ms ({v['us_per_phase']:.2f} us/phase)" for k, v in ab.items())


def cluster_info(home: str, c: int, r: int, extra_bytes: int, resident) -> dict:
    """The record's description of a kernel's home at one shape."""
    from aqc_research_tpu_torch.ops import jacobi_kernel as jk

    if home != "cluster":
        return {"home": home}
    k = jk.cluster_size(c)
    return {"home": home, "cluster": k, "pairs_per_cta": jk.cluster_pairs(c, k),
            "threads": jk.cluster_threads(c, k), "smem_bytes_per_cta": jk.cluster_smem_bytes(c, r, k, extra_bytes),
            "clusters_resident": resident(k)}


def phase_kernel(dev):
    from aqc_research_tpu_torch.ops import cuda_build
    from aqc_research_tpu_torch.ops import jacobi_kernel as jk
    from aqc_research_tpu_torch.ops.jacobi_kernel import jacobi_rows, jacobi_rows_reference

    rng = np.random.default_rng(1234)
    max_smem = cuda_build.max_smem(0)
    worst = {}
    cases = [(n, BATCH) for n in SHAPES] + [(BIG_SHAPE, BIG_BATCH)]
    for (n, batch), criterion in ((nb, c) for nb in cases for c in CRITERIA):
        if criterion == CRITERIA[0]:
            m = torch.tensor(graded_matrices(rng, batch, n), device=dev)
            mt = m.transpose(-1, -2)
            re, im = mt.real.contiguous(), mt.imag.contiguous()
        p_re, p_im, p_sw = jacobi_rows_reference(re, im, MAX_SWEEPS, criterion)
        ps, pu, _ = _factor(p_re, p_im, m)
        rule = jk.plane_home(n, n, max_smem)
        # The rule's home, and the cluster home wherever the rule keeps another.
        for home in dict.fromkeys((rule, "cluster")):
            k_re, k_im, k_sw = jacobi_rows(re, im, MAX_SWEEPS, criterion, home=home)
            torch.cuda.synchronize()
            ks, ku, kvh = _factor(k_re, k_im, m)
            smax = ps[:, :1]
            err_s = float(((ks - ps).abs() / smax).max())
            rec = torch.matmul(ku * ks[:, None, :].to(ku.dtype), kvh)
            err_rec = float((torch.linalg.matrix_norm(rec - m) / torch.linalg.matrix_norm(m)).max())
            kept = ks > (32.0 * EPS32) * ks[:, :1]
            both = kept[:, :, None] & kept[:, None, :]
            eye = torch.eye(n, dtype=ku.dtype, device=dev)

            def orth(u):
                return float(((torch.matmul(u.conj().transpose(-1, -2), u) - eye).abs() * both).max())

            err_orth = orth(ku)
            d_sweeps = int((k_sw - p_sw).abs().max())
            worst[(n, criterion, home)] = (err_s, err_rec, err_orth, orth(pu), d_sweeps, k_sw.tolist())
            at = f"n={n} {criterion} {home}"
            check(np.isfinite(err_s) and err_s <= TOL_S, f"{at}: |ds|/s_max {err_s:.3g} > {TOL_S}")
            check(err_rec <= TOL_RECON, f"{at}: reconstruction {err_rec:.3g} > {TOL_RECON}")
            check(err_orth <= TOL_ORTH, f"{at}: orthogonality {err_orth:.3g} > {TOL_ORTH}")
            check(d_sweeps <= 1, f"{at}: sweep counts differ by {d_sweeps} "
                                 f"(kernel {k_sw.tolist()}, plain {p_sw.tolist()})")

    def resident(n):
        return lambda k: jk.cluster_occupancy(n, n, k)

    def timed(n, batch, plain_runs, old_home):
        m = torch.tensor(graded_matrices(rng, batch, n), device=dev)
        mt = m.transpose(-1, -2)
        re, im = mt.real.contiguous(), mt.imag.contiguous()
        home = jk.plane_home(n, n, max_smem)
        sweeps = jacobi_rows(re, im, MAX_SWEEPS)[2].cpu().numpy()
        kern = timings(lambda: jacobi_rows(re, im, MAX_SWEEPS), calls=5, repeats=3)
        ab = home_ab(lambda h, k: jacobi_rows(re, im, MAX_SWEEPS, home=h, cluster=k), n, old_home, 2)
        plain_ms = median_ms(lambda: jacobi_rows_reference(re, im, MAX_SWEEPS), runs=plain_runs, warmup=1)
        lib = timings(lambda: torch.linalg.svd(m, full_matrices=False), calls=3, repeats=3, runs=5)
        bound_ms, bound_by = bound(jacobi_flops(n, n, sweeps), 4 * 4 * batch * n * n + 4 * batch)
        info = cluster_info(home, n, n, 0, resident(n))
        us_phase = 1e3 * kern["ms"] / (int(sweeps.max()) * (n - 1))
        if home == "cluster":
            check(info["clusters_resident"] >= batch,
                  f"K1 at {n}x{n}: {info['clusters_resident']} clusters resident < B={batch} (not one wave)")
        line = (f"B={batch} {n}x{n} ({CRITERIA[0]}, sweeps {sweeps.tolist()}): kernel {fmt(kern)}, "
                f"{us_phase:.2f} us/phase, {info}; plain {plain_ms:.4f} ms, torch.linalg.svd {fmt(lib)}, bound "
                f"{bound_ms:.4f} ms ({bound_by}); by home on the same inputs (device-only): {fmt_ab(ab)}")
        return line, {"shape": f"B={batch} {n}x{n}", **record_times(kern, lib), "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, **info, "us_per_phase": us_phase,
                      "old_home": old_home, "old_home_ms": ab[old_home]["ms"],
                      "old_home_us_per_phase": ab[old_home]["us_per_phase"],
                      "by_home_ms": {k: v["ms"] for k, v in ab.items()}}

    line, stats = timed(SHAPES[-1], BATCH, 3, "shared")
    line28, stats28 = timed(BIG_SHAPE, PATH28_BATCH, 2, "global")
    # The χ-growth heads: the one-block home against every cluster size
    # (the A/B behind CLUSTER_MIN_ROWS), B=10 graded matrices.
    heads = {}
    for n in SHAPES[:-1]:
        m = torch.tensor(graded_matrices(rng, BATCH, n), device=dev).transpose(-1, -2)
        re, im = m.real.contiguous(), m.imag.contiguous()
        heads[n] = home_ab(lambda h, k: jacobi_rows(re, im, MAX_SWEEPS, home=h, cluster=k), n, "shared", 2,
                           calls=10, repeats=3)
    detail = "; ".join(
        f"c=r={n} {crit} {home}: ds {e[0]:.2e} rec {e[1]:.2e} orth {e[2]:.2e} (plain {e[3]:.2e}) "
        f"dsweeps {e[4]} sweeps {e[5]}"
        for (n, crit, home), e in worst.items()
    )
    rule = {n: jk.plane_home(n, n, max_smem) for n in (*SHAPES, BIG_SHAPE)}
    print(f"[kernel] jacobi_rows vs plain twin, B={BATCH} (c=r={BIG_SHAPE}: B={BIG_BATCH}); homes by the rule "
          f"{rule} (cluster sizes {({n: jk.cluster_size(n) for n, h in rule.items() if h == 'cluster'})}): "
          f"{detail} | {line} | {line28} | heads at B={BATCH}, device-only by home: "
          f"{'; '.join(f'{n}x{n}: {fmt_ab(ab)}' for n, ab in heads.items())} | ptxas: "
          f"{'; '.join(f'{k} {v}' for k, v in sorted(PTXAS.items()) if k.startswith('jacobi_rows'))} "
          f"(CUDA events; device-only: 5 queued calls (heads: 10), median of 3 repeats; per call: median of 20; "
          f"plain: of 3, at 256: of 2)", flush=True)
    max_err = max(e[0] for (n, _, _), e in worst.items() if n != BIG_SHAPE)
    err256 = max(e[0] for (n, _, _), e in worst.items() if n == BIG_SHAPE)
    heads_ms = {f"B={BATCH} {n}x{n}": {k: v["ms"] for k, v in ab.items()} for n, ab in heads.items()}
    return {"max_abs_err": max_err, **stats, "heads_by_home_ms": heads_ms,
            "shapes": [{"max_abs_err": err256, **stats28}]}


def phase_rand_kernels(dev):
    """K2 and K3 against their plain twins on the card, then timed."""
    from aqc_research_tpu_torch.kernel_checks import lambda_check, near_threshold, padded_pair_batch, path_planes
    from aqc_research_tpu_torch.ops import cuda_build, rand_svd
    from aqc_research_tpu_torch.ops import fused_rand as fr
    from aqc_research_tpu_torch.ops import jacobi_kernel as jk
    from aqc_research_tpu_torch.ops.fused_pair import theta_build, theta_build_reference, theta_tile_edge
    from aqc_research_tpu_torch.ops.fused_rand import rand_tail, rand_tail_reference

    rng = np.random.default_rng(4321)
    max_smem = cuda_build.max_smem(0)
    err_theta, err_lam, details, homes = 0.0, 0.0, [], {}
    flips = {thr: 0 for thr in TAIL_THRESHOLDS}
    allowed = {thr: 0 for thr in TAIL_THRESHOLDS}
    values = {thr: 0 for thr in TAIL_THRESHOLDS}
    for chi in RAND_CHIS:
        planes = path_planes(rng, BATCH, chi, dev)
        k_re, k_im = theta_build(*planes)
        p_re, p_im = theta_build_reference(*planes)
        torch.cuda.synchronize()
        rel = torch.linalg.matrix_norm(torch.complex(k_re - p_re, k_im - p_im)) / torch.linalg.matrix_norm(
            torch.complex(p_re, p_im))
        e_theta = float(rel.max())
        err_theta = max(err_theta, float((torch.complex(k_re - p_re, k_im - p_im)).abs().max()))
        check(np.isfinite(e_theta) and e_theta <= TOL_THETA,
              f"theta_build chi={chi}: relative error {e_theta:.3g} > {TOL_THETA}")

        a = torch.complex(p_re, p_im).transpose(-1, -2)
        ell = rand_svd.rand_ell(2 * chi, chi)
        bm = rand_svd._range_project(a, ell, rand_svd._POWER_ITERS)
        m_re, m_im = bm.real.contiguous(), (-bm.imag).contiguous()
        tot2 = (p_re * p_re + p_im * p_im).sum((-2, -1))
        s_b = torch.linalg.svdvals(bm)
        rule = fr.tail_plane_home(ell, 2 * chi, chi, max_smem)
        homes[chi] = rule
        for trunc_thr in TAIL_THRESHOLDS:
            thr2 = trunc_thr**2
            pv_re, pv_im, p_lam, _, p_sw = rand_tail_reference(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS)
            near = near_threshold(s_b, tot2, thr2, chi)
            # The rule's home, and the cluster home wherever the rule keeps another.
            for home in dict.fromkeys((rule, "cluster")):
                kv_re, kv_im, k_lam, _, k_sw = rand_tail(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS, home=home)
                torch.cuda.synchronize()
                lc = lambda_check(k_lam, p_lam, near, TOL_S)
                err_lam = max(err_lam, lc.d_lam)
                k_keep, p_keep = k_lam > 0, p_lam > 0
                both = (k_keep & p_keep)[..., None].to(torch.complex64)
                kv = torch.complex(kv_re, kv_im) * both
                pv = torch.complex(pv_re, pv_im) * both
                d_proj = float((kv.conj().transpose(-1, -2) @ kv - pv.conj().transpose(-1, -2) @ pv).abs().max())
                d_sweeps = int((k_sw - p_sw).abs().max())
                if home == rule:
                    flips[trunc_thr] += lc.flips
                    allowed[trunc_thr] += int(near.sum())
                    values[trunc_thr] += near.numel()
                at = f"rand_tail chi={chi} thr={trunc_thr:g} {home}"
                smax = float(p_lam.max())
                check(lc.mask_ok, f"{at}: keep masks differ away from the threshold")
                check(lc.lam_ok, f"{at}: |dlam| {lc.d_lam:.3g} on values both keep > {TOL_S} s_max + "
                                 f"lam x {lc.rescale:.3g} (the rescale change of {lc.flips} flips)")
                check(d_proj <= TOL_PROJ, f"{at}: kept vh projector differs by {d_proj:.3g}")
                check(d_sweeps <= 1, f"{at}: sweep counts differ by {d_sweeps} "
                                     f"(kernel {k_sw.tolist()}, plain {p_sw.tolist()})")
                details.append(f"chi={chi} thr={trunc_thr:g} {home}: dlam {lc.d_lam / smax:.2e} proj {d_proj:.2e} "
                               f"kept {int(k_keep.sum())}/{int(p_keep.sum())} flips {lc.flips} "
                               f"(rescale {lc.rescale:.1e}) dsweeps {d_sweeps}")
        details.append(f"chi={chi} theta rel {e_theta:.2e}")

    # The range-finder on pair matrices in the θ layout's zero padding
    # (bonds of rank 4 of χ=64; rank 20 of χ=128): torch's batched CUDA QR
    # returns NaN there, so rand_svd._orth factors chunks of qr_chunk(rows)
    # matrices (7 at 128 rows, 15 at 256), which stay on cuSOLVER's
    # one-matrix path; 16 matrices of 256 rows are one chunk past it.
    pads = []
    for n, batch, rank in ((2 * PATH_CHI, BATCH, 4), (2 * PATH28_CHI, 16, PAD_RANK)):
        ell = rand_svd.rand_ell(n, n // 2)
        pad = padded_pair_batch(rng, batch, n, rank)
        y = torch.matmul(pad.to(dev), rand_svd.sketch(batch, n, ell, pad.dtype, dev))
        batched_nan = int((~torch.isfinite(torch.view_as_real(torch.linalg.qr(y, mode="reduced")[0])))
                          .flatten(1).any(-1).sum())
        got = rand_svd._range_project(pad.to(dev), ell, rand_svd._POWER_ITERS)
        check(bool(torch.isfinite(torch.view_as_real(got)).all()),
              f"range-finder: non-finite B on padded pairs of {n} rows")
        s_got = torch.linalg.svdvals(got).cpu()
        s_want = torch.linalg.svdvals(rand_svd._range_project(pad, ell, rand_svd._POWER_ITERS))
        d_pad = float((s_got - s_want).abs().max() / s_want.max())
        check(d_pad <= TOL_S, f"range-finder on padded pairs of {n} rows: |ds|/s_max {d_pad:.3g} vs LAPACK > {TOL_S}")
        pads.append(f"{batch}x{n}x{n} ({2 * rank} nonzero rows, qr_chunk {rand_svd.qr_chunk(n)}): batched "
                    f"torch.linalg.qr NaN in {batched_nan}/{batch} matrices, rand_svd._orth finite, "
                    f"|ds|/s_max vs LAPACK {d_pad:.2e}")

    def timed(chi, batch, plain_runs, old_home):
        """K2 and K3 at one path shape, inputs as above; K3 also at its
        ``old_home`` and every cluster size on the same inputs."""
        n, ell = 2 * chi, rand_svd.rand_ell(2 * chi, chi)
        planes = path_planes(rng, batch, chi, dev)
        th = timings(lambda: theta_build(*planes))
        th_plain = median_ms(lambda: theta_build_reference(*planes))
        gate, a_re, a_im, b_re, b_im = planes
        a_c = torch.complex(a_re, a_im)  # [b, u, x, a']
        b_c = torch.complex(b_re, b_im)  # [b, v, c, x]
        g_c = torch.complex(gate[:, :16], gate[:, 16:]).reshape(batch, 2, 2, 2, 2)  # [b, s, t, u, v]
        # The yardstick: one call for the whole gated θ; beside it the four
        # products alone (one batched matmul, the earlier records' yardstick).
        th_lib = timings(lambda: torch.einsum("bstuv,bvcx,buxa->btcsa", g_c, b_c, a_c))
        th_mm = timings(lambda: torch.matmul(b_c[:, None], a_c[:, :, None]))
        th_flops = batch * (32.0 * chi**3 + 128.0 * chi**2)
        th_bytes = 4 * batch * (4 * 2 * chi * chi + 32 + 2 * n * n)
        th_bound, th_by = bound(th_flops, th_bytes)

        w_re, w_im = theta_build(*planes)
        a = torch.complex(w_re, w_im).transpose(-1, -2)
        bm = rand_svd._range_project(a, ell, rand_svd._POWER_ITERS)
        m_re, m_im = bm.real.contiguous(), (-bm.imag).contiguous()
        tot2 = (w_re * w_re + w_im * w_im).sum((-2, -1))
        thr2 = TAIL_THRESHOLDS[0] ** 2
        sweeps = rand_tail(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS)[4].cpu().numpy()
        tail = timings(lambda: rand_tail(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS))
        # No sweep: the load, the epilogue (rank, one-thread rule) and the vh rows.
        tail_rest, _ = device_ms(lambda: rand_tail(m_re, m_im, tot2, thr2, chi, 0))
        ab = home_ab(lambda h, k: rand_tail(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS, home=h, cluster=k), ell,
                     old_home, 4)
        tail_plain = median_ms(lambda: rand_tail_reference(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS),
                               runs=plain_runs, warmup=1)
        tail_lib = timings(lambda: torch.linalg.svd(bm, full_matrices=False), calls=5, repeats=3)
        tail_flops = jacobi_flops(ell, n, sweeps) + batch * 2.0 * chi * n
        tail_bytes = 4 * batch * (2 * ell * n + 1 + 2 * chi * n + 2 * chi + 1)
        tail_bound, tail_by = bound(tail_flops, tail_bytes)
        home = fr.tail_plane_home(ell, n, chi, max_smem)
        info = cluster_info(home, ell, n, fr.tail_extra_bytes(ell, chi),
                            lambda k: fr.tail_cluster_occupancy(ell, n, chi, k))
        us_phase = 1e3 * tail["ms"] / (int(sweeps.max()) * (ell - 1))
        if home == "cluster":
            check(info["clusters_resident"] >= batch,
                  f"K3 at chi={chi}: {info['clusters_resident']} clusters resident < B={batch} (not one wave)")
        edge = theta_tile_edge(batch, chi, cuda_build.sm_count(0))
        line = (f"B={batch} chi={chi}: theta_build (tiles {edge}x{edge}) {fmt(th)}, "
                f"plain {th_plain:.4f} ms, one einsum of the gated theta {fmt(th_lib)}, batched matmul of the "
                f"four products {fmt(th_mm)}, bound {th_bound:.5f} ms ({th_by}); rand_tail ({ell}x{n}, "
                f"sweeps {sweeps.tolist()}) {fmt(tail)} (without the sweeps {tail_rest:.4f} ms device-only), "
                f"{us_phase:.2f} us/phase, {info}; plain {tail_plain:.4f} ms, torch.linalg.svd {fmt(tail_lib)}, "
                f"bound {tail_bound:.5f} ms ({tail_by}); by home on the same inputs (device-only): {fmt_ab(ab)}")
        return line, (
            {"shape": f"B={batch} chi={chi}", **record_times(th, th_lib), "plain_ms": th_plain,
             "bound_ms": th_bound, "bound_by": th_by, "matmul4_ms": th_mm["ms"],
             "matmul4_call_ms": th_mm["call_ms"]},
            {"shape": f"B={batch} chi={chi} ({ell}x{n})", **record_times(tail, tail_lib),
             "plain_ms": tail_plain, "bound_ms": tail_bound, "bound_by": tail_by, **info,
             "us_per_phase": us_phase, "no_sweep_ms": tail_rest, "old_home": old_home,
             "old_home_ms": ab[old_home]["ms"], "old_home_us_per_phase": ab[old_home]["us_per_phase"],
             "by_home_ms": {k: v["ms"] for k, v in ab.items()}},
        )

    line, (th, tail) = timed(PATH_CHI, BATCH, 5, "shared")
    line28, (th28, tail28) = timed(PATH28_CHI, PATH28_BATCH, 3, "global")

    def edge_ms(batch, chi, edge):
        """K2 at a tile edge of the caller's choosing (the rule's A/B; a
        direct launch, not counted)."""
        planes = path_planes(rng, batch, chi, dev)
        w_re = torch.empty((batch, 2 * chi, 2 * chi), device=dev)
        w_im = torch.empty_like(w_re)
        ptrs = [t.data_ptr() for t in (*planes, w_re, w_im)]
        return device_ms(lambda: cuda_build.launch("theta_build_launch", 0, *ptrs, batch, chi, edge))[0]

    edges = {f"B={b} chi={c}": {e: edge_ms(b, c, e) for e in (16, 32)}
             for b, c in ((BATCH, PATH_CHI), (PATH28_BATCH, PATH28_CHI), (1, PATH28_CHI))}
    th["tile_edges_ms"] = edges
    sizes = {c: jk.cluster_size(rand_svd.rand_ell(2 * c, c)) for c, h in homes.items() if h == "cluster"}
    print(f"[kernels] theta_build and rand_tail vs plain twins, B={BATCH}; rand_tail's homes by the rule {homes} "
          f"(cluster sizes {sizes}): {'; '.join(details)} | "
          f"keep-mask flips / values near the threshold / values: "
          f"{'; '.join(f'thr {t:g}: {flips[t]} / {allowed[t]} / {values[t]}' for t in TAIL_THRESHOLDS)} | "
          f"range-finder on zero-padded pairs: {'; '.join(pads)} | {line} | {line28} | theta_build by tile "
          f"edge (device-only ms; theta_tile_edge picks one): "
          f"{'; '.join(f'{k}: ' + ', '.join(f'{e}: {t:.4f}' for e, t in v.items()) for k, v in edges.items())} "
          f"| ptxas: {'; '.join(f'{k} {v}' for k, v in sorted(PTXAS.items()) if k.startswith('rand_tail'))} "
          f"(CUDA events; device-only: 10 queued calls, median of 5 repeats (by home: 5, of 3); per call: median "
          f"of 20; rand_tail plain: of 5, at chi=128: of 3)", flush=True)
    return (
        {"max_abs_err": err_theta, **th, "shapes": [{"max_abs_err": err_theta, **th28}]},
        {"max_abs_err": err_lam, **tail, "shapes": [{"max_abs_err": err_lam, **tail28}]},
    )


def phase_fused(dev):
    """K4 against its plain twin on the card, then timed at the 28q shape."""
    from aqc_research_tpu_torch.kernel_checks import lambda_check, near_threshold, path_planes
    from aqc_research_tpu_torch.ops import cuda_build
    from aqc_research_tpu_torch.ops import fused_pair as fp
    from aqc_research_tpu_torch.ops.fused_pair import fused_pair, fused_pair_reference, theta_build_reference

    max_smem = cuda_build.max_smem(0)
    homes = {chi: fp.fused_plane_home(chi, max_smem) for chi in FUSED_CHIS}
    for chi in FUSED_CHIS:
        check(homes[chi] == ("cluster" if chi >= 96 else "shared"), f"K4's home at chi={chi} is {homes[chi]}")
    resident = fp.fused_cluster_occupancy(PATH28_CHI)
    check(resident > 0, "the card keeps no cluster of K4's cluster path resident")
    cluster_line = (f"cluster path at chi={PATH28_CHI}: {fp.FUSED_CLUSTER} CTAs per matrix x "
                    f"{fp.fused_cluster_threads(PATH28_CHI)} threads, {fp.fused_cluster_smem_bytes(PATH28_CHI)} B "
                    f"dynamic shared memory per CTA, {resident} clusters resident at once "
                    f"(cudaOccupancyMaxActiveClusters; a B={PATH28_BATCH} half-layer has {PATH28_BATCH}); ptxas: "
                    + "; ".join(f"{k} {v}" for k, v in sorted(PTXAS.items())
                                if k.startswith(("theta_build", "fused_pair"))))
    rng = np.random.default_rng(2468)
    err_lam, details = 0.0, []
    flips = {thr: 0 for thr in TAIL_THRESHOLDS}
    allowed = {thr: 0 for thr in TAIL_THRESHOLDS}
    values = {thr: 0 for thr in TAIL_THRESHOLDS}

    def proj(rows, w):
        kept = rows * w[..., None]
        return kept.conj().transpose(-1, -2) @ kept

    cases = ([(chi, None, K4_DECADES) for chi in FUSED_CHIS] + [(PATH28_CHI, PAD_RANK, K4_DECADES)]
             + [(PATH28_CHI, None, 6.0)])
    for chi, rank, decades in cases:
        planes = path_planes(rng, BATCH, chi, dev, rank=rank, decades=decades)
        w0_re, w0_im = theta_build_reference(*planes)
        theta = torch.complex(w0_re, w0_im)
        s_theta = torch.linalg.svdvals(theta)
        tot2 = (w0_re * w0_re + w0_im * w0_im).sum((-2, -1))
        for trunc_thr in TAIL_THRESHOLDS:
            thr2 = trunc_thr**2
            k_ut_re, k_ut_im, k_vh_re, k_vh_im, k_lam, k_sw = fused_pair(*planes, thr2, MAX_SWEEPS)
            p_ut_re, p_ut_im, p_vh_re, p_vh_im, p_lam, p_sw = fused_pair_reference(*planes, thr2, MAX_SWEEPS)
            torch.cuda.synchronize()
            smax = float(p_lam.max())
            near = near_threshold(s_theta, tot2, thr2, chi)
            lc = lambda_check(k_lam, p_lam, near, TOL_S)
            err_lam = max(err_lam, lc.d_lam)
            k_keep, p_keep = k_lam > 0, p_lam > 0
            both = (k_keep & p_keep).to(torch.complex64)
            # Projectors weighted by s_k / s_max: the Jacobi's stopping rule
            # fixes a kept direction only to ~1e-6 s_max / s_k, so one sweep
            # more or less moves the small ones that far, and vh = diag(1/s)
            # u^H m multiplies the product's rounding by s_max / s_k.
            weight = both * (p_lam / smax)
            k_ut, p_ut = torch.complex(k_ut_re, k_ut_im), torch.complex(p_ut_re, p_ut_im)
            k_vh, p_vh = torch.complex(k_vh_re, k_vh_im), torch.complex(p_vh_re, p_vh_im)
            d_ut = float((proj(k_ut, weight) - proj(p_ut, weight)).abs().max())
            d_ut_flat = float((proj(k_ut, both) - proj(p_ut, both)).abs().max())
            d_vh = float((proj(k_vh, weight) - proj(p_vh, weight)).abs().max())
            rec = k_ut.transpose(-1, -2) @ (k_vh * (k_lam * both)[..., None])
            p_rec = p_ut.transpose(-1, -2) @ (p_vh * (p_lam * both)[..., None])
            d_rec = float((rec - p_rec).abs().max()) / smax
            vh_norm = float(torch.linalg.vector_norm(k_vh, dim=-1).max())
            d_sweeps = int((k_sw - p_sw).abs().max())
            flips[trunc_thr] += lc.flips
            allowed[trunc_thr] += int(near.sum())
            values[trunc_thr] += near.numel()
            label = f"chi={chi}{'' if rank is None else f' rank {rank}'} {decades:g} decades thr={trunc_thr:g}"
            details.append(f"{label}: dlam {lc.d_lam / smax:.2e} u {d_ut:.2e} (unweighted {d_ut_flat:.2e}) vh "
                           f"{d_vh:.2e} rec {d_rec:.2e} max |vh row| {vh_norm:.3g} kept "
                           f"{int(k_keep.sum())}/{int(p_keep.sum())} dsweeps {d_sweeps}")
            at = f"fused_pair {label}"
            check(lc.mask_ok, f"{at}: keep masks differ away from the threshold")
            check(lc.lam_ok, f"{at}: |dlam| {lc.d_lam:.3g} on values both keep > {TOL_S} s_max + "
                             f"lam x {lc.rescale:.3g} (the rescale change of {lc.flips} flips)")
            check(d_sweeps <= 1, f"{at}: sweep counts differ by {d_sweeps} "
                                 f"(kernel {k_sw.tolist()}, plain {p_sw.tolist()})")
            if decades == K4_DECADES:
                check(d_ut <= TOL_PROJ, f"{at}: weighted kept u projector differs by {d_ut:.3g} ({details[-1]})")
                check(d_vh <= TOL_PROJ, f"{at}: weighted kept vh projector differs by {d_vh:.3g} ({details[-1]})")
                check(d_rec <= TOL_S, f"{at}: reconstruction differs by {d_rec:.3g} s_max ({details[-1]})")

    chi, batch = PATH28_CHI, PATH28_BATCH
    n = 2 * chi
    planes = path_planes(rng, batch, chi, dev, decades=K4_DECADES)
    thr2 = TAIL_THRESHOLDS[0] ** 2
    sweeps = fused_pair(*planes, thr2, MAX_SWEEPS)[5].cpu().numpy()
    kern = timings(lambda: fused_pair(*planes, thr2, MAX_SWEEPS), calls=5, repeats=3)
    # No sweep: the θ build, the copy, the epilogue and the uᵀ and vh rows.
    rest_ms, _ = device_ms(lambda: fused_pair(*planes, thr2, 0))
    plain_ms = median_ms(lambda: fused_pair_reference(*planes, thr2, MAX_SWEEPS), runs=2, warmup=1)
    # The one-block design that preceded the cluster path, on the same
    # inputs: the planes in device memory (a direct launch at the "global"
    # home; not counted).
    scratch = [torch.empty((batch, rows, n), device=dev) for rows in (n, n, n, n, chi, chi, chi, chi)]
    lam, sw = torch.empty((batch, chi), device=dev), torch.empty(batch, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (*planes, *scratch, lam, sw)]
    global_ms, _ = device_ms(lambda: cuda_build.launch(
        "fused_pair_launch", 0, *ptrs, batch, chi, MAX_SWEEPS, 1, thr2, fp._HOME_CODES["global"],
        fp.FUSED_CLUSTER), calls=3, repeats=3)
    w0_re, w0_im = theta_build_reference(*planes)
    theta = torch.complex(w0_re, w0_im).transpose(-1, -2)
    lib = timings(lambda: torch.linalg.svd(theta, full_matrices=False), calls=3, repeats=3, runs=5)
    flops = (batch * (32.0 * chi**3 + 128.0 * chi**2) + jacobi_flops(n, n, sweeps)
             + batch * (8.0 * chi * n * n + 4.0 * chi * n))
    nbytes = 4 * batch * (4 * 2 * chi * chi + 32 + 4 * chi * n + chi + 1)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[fused] fused_pair vs plain twin, B={BATCH} (homes {homes}): {'; '.join(details)} | {cluster_line} | "
          f"keep-mask flips / values near the threshold / values: "
          f"{'; '.join(f'thr {t:g}: {flips[t]} / {allowed[t]} / {values[t]}' for t in TAIL_THRESHOLDS)} | "
          f"B={batch} chi={chi} (sweeps {sweeps.tolist()}): kernel {fmt(kern)} (without the sweeps "
          f"{rest_ms:.4f} ms device-only; the device-memory home on the same inputs {global_ms:.4f} ms "
          f"device-only), plain {plain_ms:.4f} ms, "
          f"torch.linalg.svd of theta {fmt(lib)}, bound {bound_ms:.5f} ms ({bound_by}) "
          f"(CUDA events; device-only: 5 queued calls, median of 3 repeats; per call: median of 20; plain of 2)",
          flush=True)
    return {"max_abs_err": err_lam, "shape": f"B={batch} chi={chi}", **record_times(kern, lib),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "home": homes[chi],
            "cluster": fp.FUSED_CLUSTER, "clusters_resident": resident, "global_home_ms": global_ms}


def f64_objective(circ, thetas, target, base_bits, trunc_thr, dev) -> float:
    """The objective at ``thetas`` in f64 (complex128) under "native" on
    ``dev``: the reference the horizon's result is held against — LAPACK
    on the host at 20 qubits, cuSOLVER on the card at 28 (the host's LAPACK
    takes tens of seconds per sweep at 28q χ=128)."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.ops.mps import MPS

    tgt = MPS(target.gammas.to(dev, torch.complex128), target.lambdas.to(dev, torch.float64))
    value, _ = jit_asp._mps_value_fns(circ, base_bits, trunc_thr)
    with config.svd_impl_override("native"):
        return float(value(thetas.to(dev, torch.float64), tgt))


def run_horizon(case, route: str):
    """One horizon of ``case`` under the route in effect, checked as the
    slice's contract says; returns the line's numbers and the launches (in
    total, by pair size n = 2χ and, for K1 and K3, by plane home)."""
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp

    circ, x0, target, base_bits, trunc_thr, f_native, maxiter = (
        case[k] for k in ("circ", "x0", "target", "base_bits", "trunc_thr", "f_native", "maxiter"))
    value, value_and_grad = jit_asp._mps_value_fns(circ, base_bits, trunc_thr)
    f_start = float(value(x0, target))
    check(abs(f_start - f_native) <= TOL_ROUTES,
          f"start objective: {route} {f_start} vs native {f_native}")

    jit_asp.watchdog_events.clear()
    reset_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    res = jit_asp.optimize_horizon_mps_jit(
        circ, x0, target, base_bits=base_bits, trunc_thr=trunc_thr, maxiter=maxiter
    )
    fobj = float(res.fobj)
    torch.cuda.synchronize()
    horizon_s = time.perf_counter() - tic
    launches, launches_at, launches_home = read_counts(), read_counts_at(), read_counts_home()

    check(np.isfinite(fobj) and fobj < f_start, f"{route} horizon did not lower fobj: {f_start} -> {fobj}")
    case[f"fobj_{route}"] = fobj
    check(not jit_asp.watchdog_events, f"watchdog fired: {jit_asp.watchdog_events}")
    check(res.thetas.shape == x0.shape and bool(torch.isfinite(res.thetas).all()),
          "non-finite or misshapen thetas")
    tic = time.perf_counter()
    f_check = f64_objective(circ, res.thetas, target, base_bits, trunc_thr, case["f64_device"])
    check_s = time.perf_counter() - tic
    where = "LAPACK on the host" if case["f64_device"].type == "cpu" else "cuSOLVER on the card"
    check(abs(f_check - fobj) <= TOL_FINAL,
          f"final objective: {route} {fobj} vs f64 re-evaluation ({where}) {f_check}")

    line = (f"start fobj {route} {f_start:.7g} native {f_native:.7g} | horizon maxiter={maxiter}: "
            f"fobj {fobj:.7g} (f64 re-eval, {where}, {check_s:.1f} s: {f_check:.7g}), {res.num_iters} iters, "
            f"{horizon_s:.2f} s = {horizon_s / max(res.num_iters, 1):.3f} s/iter, launches {launches} "
            f"(by n: {launches_at}; by home: {launches_home}), watchdog events {len(jit_asp.watchdog_events)}")
    return line, launches, launches_at, launches_home


def make_case(dev, num_qubits: int, chi: int, maxiter: int, f64_device, layers: int = 4):
    """The slice's configuration (BASELINE.json configs 3 and 5, as
    benchmarks/bench_mps.py builds them) under precision "fast" and the
    jacobi route: ansatz, perturbed perfect init, the first horizon's
    target (built on the jacobi route) and the native start objective."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.models.sp_lhs.target_states import first_horizon_mps_target
    from aqc_research_tpu_torch.targets import trotter as trotop

    trunc_thr = 1e-6
    evol_time, delta = 1.2, 1.0
    config.set_precision("fast")
    config.set_svd_impl("jacobi")
    config.require_full_f32_matmul()

    circ = TrotterAnsatz.make(num_qubits, make_trotter_like_circuit(num_qubits, layers), True)
    thetas = trotop.init_ansatz_to_trotter(
        circ, np.zeros(circ.num_thetas), evol_time=evol_time, delta=delta
    )
    thetas = thetas + 0.05 * np.random.default_rng(5).standard_normal(circ.num_thetas)
    x0 = torch.tensor(thetas, dtype=config.real_dtype(), device=dev)
    tic = time.perf_counter()
    targets = first_horizon_mps_target(
        num_qubits=num_qubits, evol_time=evol_time, num_trot_steps=3, delta=delta,
        chi_max=chi, trunc_thr=trunc_thr, second_order=True, device=dev,
    )
    torch.cuda.synchronize()
    target_s = time.perf_counter() - tic
    base_bits = tuple(1 if q % 2 == 0 else 0 for q in range(num_qubits))  # Neel prep
    case = {"circ": circ, "x0": x0, "target": targets.t1, "base_bits": base_bits,
            "trunc_thr": trunc_thr, "maxiter": maxiter, "f64_device": torch.device(f64_device),
            "layers": layers, "chi": chi}
    value, _ = jit_asp._mps_value_fns(circ, base_bits, trunc_thr)
    with config.svd_impl_override("native"):
        case["f_native"] = float(value(x0, targets.t1))
    case["about"] = (f"{num_qubits}q chi={chi} {layers}-layer Trotter ansatz ({circ.num_thetas} thetas), "
                     f"fast/jacobi/{config.jacobi_criterion()}: targets {target_s:.2f} s "
                     f"(fid(t1, t1_gt) {trotop.fidelity(targets.t1_gt, targets.t1):.6f})")
    return case


def phase_slice(case, tag: str):
    """One horizon of ``case`` forced onto "jacobi": K1 on every pair update
    below χ=96 and K4 at χ >= 96 (the auto rule), no rand-route kernel."""
    from aqc_research_tpu_torch.ops import cuda_build
    from aqc_research_tpu_torch.ops import jacobi_kernel as jk

    line, launches, launches_at, launches_home = run_horizon(case, "jacobi")
    check(launches["jacobi_rows"] > 0, "the jacobi horizon never launched the Jacobi kernel")
    if case["chi"] < 96:  # K1 takes the full-χ pair updates: 2χ rows on the rule's home
        n = 2 * case["chi"]
        home = jk.plane_home(n, n, cuda_build.max_smem(0))
        check(launches_at["jacobi_rows"].get(n, 0) > 0 and launches_home["jacobi_rows"].get(home, 0) > 0,
              f"the jacobi horizon never ran K1 at {n}x{n} on its home {home!r}: {launches_at}, {launches_home}")
    check(launches["theta_build"] == 0 and launches["rand_tail"] == 0,
          f"the jacobi horizon launched rand-route kernels: {launches}")
    if case["chi"] >= 96:
        check(launches["fused_pair"] > 0, f"the jacobi horizon at chi={case['chi']} never launched K4: {launches}")
    else:
        check(launches["fused_pair"] == 0, f"the jacobi horizon at chi={case['chi']} launched K4: {launches}")
    print(f"[{tag}] {case['about']} | {line}", flush=True)
    return launches, launches_at, launches_home


def phase_rand(case, tag: str):
    """The slice's horizon again, under the default route, which must be
    rand; at χ=128 K3 must run at χ=128 and the watchdog's "jacobi"
    re-check must run K4."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.ops import cuda_build, rand_svd
    from aqc_research_tpu_torch.ops.fused_rand import tail_plane_home

    config.set_svd_impl(None)
    route = config.svd_impl(case["target"].device)
    check(route == "rand", f"the default route on the card is {route!r}, not 'rand'")
    line, launches, launches_at, launches_home = run_horizon(case, route)
    for name in ("jacobi_rows", "theta_build", "rand_tail"):
        check(launches[name] > 0, f"the rand horizon never launched {name}: {launches}")
    n = 2 * case["chi"]
    check(launches_at["rand_tail"].get(n, 0) > 0, f"the rand horizon never ran K3 at n={n}: {launches_at}")
    home = tail_plane_home(rand_svd.rand_ell(n, case["chi"]), n, case["chi"], cuda_build.max_smem(0))
    check(launches_home["rand_tail"].get(home, 0) > 0,
          f"the rand horizon never ran K3 on its home {home!r} at n={n}: {launches_home}")
    if case["chi"] >= 96:
        check(launches["fused_pair"] > 0, f"the watchdog's jacobi re-check never launched K4: {launches}")
    print(f"[{tag}] same case, default route {route}/{config.jacobi_criterion()}: {line} | rand_tail launches at "
          f"chi={case['chi']} (n={n}): {launches_at['rand_tail'].get(n, 0)}, home there {home!r}", flush=True)
    return launches, launches_at, launches_home


@contextmanager
def route_override(route: str):
    """A route of the timing turns: "rand", "jacobi" (K4 by the auto rule
    at χ >= 96) or "unfused" (the jacobi route with K4 off: K1 everywhere)."""
    from aqc_research_tpu_torch import config

    fused = config._FUSED_PAIR
    if route == "unfused":
        config.set_fused_pair(False)
    try:
        with config.svd_impl_override("jacobi" if route == "unfused" else route):
            yield
    finally:
        config.set_fused_pair(fused)


def sweep_ms(value_and_grad, case, route: str, calls: int) -> float:
    """Mean host wall of ``calls`` objective+gradient sweeps at the start
    point under ``route``, ending in ``synchronize()``."""
    with route_override(route):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(calls):
            f, g = value_and_grad(case["x0"], case["target"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(f)), f"{route}: non-finite gradient")
    return 1e3 * wall / calls


def _own_us(evt) -> float:
    """A profiler event's own device time in µs (the attribute's name
    differs between torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_calls(fn) -> dict:
    """``fn()`` under ``torch.profiler``: wall, device busy time (the sum of
    the device-side events' own times: kernels, copies, fills), the idle
    share 1 - busy / wall of that call, the host's aten calls and the
    events."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - tic)
    events = prof.key_averages()
    busy_ms = sum(_own_us(e) for e in events if e.device_type == DeviceType.CUDA) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": 1.0 - busy_ms / wall_ms, "aten_calls": aten,
            "events": events}


def profile_sweep(value_and_grad, case, route: str) -> dict:
    """One objective+gradient sweep under ``torch.profiler``
    (:func:`profile_calls`), with each hand-written kernel's launches, the
    linalg_qr calls and the heaviest device kernels."""
    from torch.autograd import DeviceType

    before = read_counts()
    with route_override(route):
        prof = profile_calls(lambda: value_and_grad(case["x0"], case["target"]))
    launches = {name: n - before[name] for name, n in read_counts().items()}
    events = prof.pop("events")
    device = sorted(((e.key, _own_us(e), e.count) for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda t: -t[1])
    qr_calls = sum(e.count for e in events if e.key == "aten::linalg_qr")
    return {**prof, "launches": launches, "qr_calls": qr_calls,
            "top": [(k[:48], us / 1e3, n) for k, us, n in device[:6]]}


def phase_routes(case, tag: str, routes, repeats: int, calls: int):
    """The routes' sweeps side by side in one process: warmed up, then timed
    in turns (the routes, then the same in reverse, ``repeats`` times; mean
    of ``calls`` sweeps each), since host timings drift within a process;
    then one profiled sweep each."""
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp

    _, value_and_grad = jit_asp._mps_value_fns(case["circ"], case["base_bits"], case["trunc_thr"])
    for route in routes:
        sweep_ms(value_and_grad, case, route, 1)
    walls = {route: [] for route in routes}
    order = repeats * (tuple(routes) + tuple(routes[::-1]))
    for route in order:
        walls[route].append(sweep_ms(value_and_grad, case, route, calls))
    parts = []
    for route in routes:
        p = profile_sweep(value_and_grad, case, route)
        top = ", ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in p["top"])
        parts.append(
            f"{route}: obj+grad {' / '.join(f'{1e3 / w:.3f}' for w in walls[route])} sweeps/s | profiled "
            f"sweep {p['wall_ms']:.1f} ms wall, device busy {p['busy_ms']:.1f} ms (idle {p['idle']:.1%}), "
            f"launches {p['launches']}, {p['aten_calls']} aten calls ({p['qr_calls']} linalg_qr); "
            f"top device: {top}")
    print(f"[{tag}] same case and start point, timed in turns ({', '.join(order[:2 * len(routes)])}) x {repeats}, "
          f"{calls} sweeps each: " + " || ".join(parts), flush=True)


@contextmanager
def driver_spies():
    """Records what one ``run_simulation`` does, through the driver module's
    own names: the targets and the seconds of ``get_target_states``, the
    seconds of each ``generate_all_mps_targets`` (none on a cache hit), each
    horizon's ``_optimize_jit`` result and each ``_time_evolution`` call.
    The driver's log lines are held back to warnings meanwhile."""
    from aqc_research_tpu_torch.models.sp_lhs import target_states, time_evol

    seen = {"targets": None, "targets_s": [], "generate_s": [], "optimized": [], "horizons": 0}
    real = {"get": time_evol.get_target_states, "gen": target_states.generate_all_mps_targets,
            "opt": time_evol._optimize_jit, "evol": time_evol._time_evolution}

    def timed(fn, into):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - tic)
            return out
        return call

    get = timed(real["get"], seen["targets_s"])

    def get_targets(opts):
        seen["targets"] = get(opts)
        return seen["targets"]

    def optimize(**kwargs):
        seen["optimized"].append(real["opt"](**kwargs))
        return seen["optimized"][-1]

    def evolve(**kwargs):
        seen["horizons"] += 1
        return real["evol"](**kwargs)

    loggers = [logging.getLogger(f"{name}.py") for name in ("time_evol", "target_states", "evol_utils", "plots")]
    levels = [lg.level for lg in loggers]
    time_evol.get_target_states = get_targets
    target_states.generate_all_mps_targets = timed(real["gen"], seen["generate_s"])
    time_evol._optimize_jit, time_evol._time_evolution = optimize, evolve
    for lg in loggers:
        lg.setLevel(logging.WARNING)
    try:
        yield seen
    finally:
        time_evol.get_target_states = real["get"]
        target_states.generate_all_mps_targets = real["gen"]
        time_evol._optimize_jit, time_evol._time_evolution = real["opt"], real["evol"]
        for lg, level in zip(loggers, levels):
            lg.setLevel(level)


def driver_options(result_dir: str, **changes):
    """The driver phase's options: 20 qubits, χ=64, horizons at t = 1.2 and
    2.4 (3 and 6 Trotter steps) of 2 and 4 layers, 10 iterations, the
    default route and loop switch; a fidelity bar no horizon reaches, so
    each runs its 10 iterations."""
    from aqc_research_tpu_torch.models.sp_lhs.user_options import UserOptions

    opts = UserOptions()
    opts.num_qubits, opts.chi_max = DRIVER_QUBITS, PATH_CHI
    opts.evol_times, opts.trotter_steps = np.array(DRIVER_TIMES), np.array(DRIVER_STEPS)
    opts.num_layers_inc, opts.maxiter = 2, 10
    opts.fidelity_thr = 0.9999999
    opts.result_dir, opts.verbose = result_dir, False
    for key, value in changes.items():
        setattr(opts, key, value)
    return opts


def phase_driver():
    """The ASP driver a user starts (``time_evol.run_simulation``) on the
    card: run 1 fresh, run 2 resuming run 1's folder (no horizon again, the
    target cache hits), run 3 one horizon on an expired clock."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp, time_evol

    tic_phase = time.perf_counter()
    config.set_precision("fast")
    config.set_svd_impl(None)
    config.set_fused_pair(None)
    route = config.svd_impl(torch.device("cuda"))
    check(route == "rand", f"the default route on the card is {route!r}, not 'rand'")
    result_dir = tempfile.mkdtemp(prefix="aqc_driver_")
    try:
        opts = driver_options(result_dir)
        check(opts.use_jit_lbfgs is None and opts.resolve_use_jit_lbfgs() is True,
              "use_jit_lbfgs=None does not resolve to True on the card")
        jit_asp.watchdog_events.clear()
        reset_counts()
        with driver_spies() as run1:
            out1 = time_evol.run_simulation(opts)
        torch.cuda.synchronize()
        counts, counts_at, homes = read_counts(), read_counts_at(), read_counts_home()
        with open(os.path.join(out1, "all_results.pkl"), "rb") as fld:
            results = pickle.load(fld)
        check(not jit_asp.watchdog_events, f"watchdog fired: {jit_asp.watchdog_events}")
        check(len(results) == 2 and len(run1["optimized"]) == 2 and len(run1["generate_s"]) == 1,
              f"run 1: {len(results)} horizons, {len(run1['optimized'])} optimized, "
              f"{len(run1['generate_s'])} target generations")
        for name in ("jacobi_rows", "theta_build", "rand_tail"):
            check(counts[name] > 0, f"the driver never launched {name}: {counts}")
        check(counts["fused_pair"] == 0, f"the driver launched K4 at chi={PATH_CHI}: {counts}")

        base_bits = tuple(1 if q % 2 == 0 else 0 for q in range(DRIVER_QUBITS))  # Neel prep
        horizons = []
        for res, opt, targ in zip(results, run1["optimized"], run1["targets"]):
            circ = TrotterAnsatz.make(opts.num_qubits, np.asarray(res["blocks"]), True)
            value, _ = jit_asp._mps_value_fns(circ, base_bits, float(opts.trunc_thr))
            f_start = float(value(torch.tensor(opt["ini_thetas"], device=targ.t1_gt.device), targ.t1_gt))
            fobj = opt["cost"]
            fids = [res[k] for k in ("fid_a1_vs_gt", "fid_t1_vs_gt", "fid_a1_vs_t1")]
            gap = abs(res["fid_a1_vs_gt"] - (1.0 - fobj))
            at = f"driver horizon t={res['evol_time1']}"
            check(np.isfinite(fobj) and fobj < f_start, f"{at}: fobj {fobj} not below its start {f_start}")
            check(all(np.isfinite(f) and 0.0 < f <= 1.0 + TOL_FID_ROUND for f in fids), f"{at}: fidelities {fids}")
            check(gap <= TOL_FINAL, f"{at}: no-truncation fid_a1_vs_gt {res['fid_a1_vs_gt']} vs 1 - fobj "
                                    f"{1.0 - fobj}: gap {gap:.3g} > {TOL_FINAL}")
            check(res["num_iters"] == opt["num_iters"] and not res["is_timeout"], f"{at}: {res['num_iters']} iters")
            horizons.append({"t": res["evol_time1"], "layers": res["num_layers"], "iters": res["num_iters"],
                             "s_per_iter": opt["time"] / max(res["num_iters"], 1), "f_start": f_start,
                             "fobj": fobj, "gap": gap, "fids": fids, "circ": circ, "opt": opt, "target": targ})
        first = horizons[0]
        tic = time.perf_counter()
        f_check = f64_objective(first["circ"], torch.tensor(first["opt"]["thetas"]), first["target"].t1_gt,
                                base_bits, float(opts.trunc_thr), torch.device("cpu"))
        check_s = time.perf_counter() - tic
        check(abs(f_check - first["fobj"]) <= TOL_FINAL,
              f"driver horizon 1: fobj {first['fobj']} vs f64 re-evaluation (LAPACK on the host) {f_check}")

        # Run 2: resume run 1's folder.
        with driver_spies() as run2:
            out2 = time_evol.run_simulation(driver_options(result_dir, resume_dir=out1))
        check(out2 == out1 and run2["horizons"] == 0, f"run 2 ran {run2['horizons']} horizons again")
        check(not run2["generate_s"], "run 2: the target cache missed")
        # Run 3: one horizon on an expired clock.
        with driver_spies() as run3:
            out3 = time_evol.run_simulation(driver_options(
                result_dir, evol_times=np.array(DRIVER_TIMES[:1]), trotter_steps=np.array(DRIVER_STEPS[:1]),
                time_limit=1e-9, jit_chunk_iters=2))
        with open(os.path.join(out3, "all_results.pkl"), "rb") as fld:
            timed = pickle.load(fld)
        check(not run3["generate_s"], "run 3: the target cache missed")
        check(len(timed) == 1 and timed[0]["is_timeout"] and timed[0]["num_iters"] == 2,
              f"run 3: is_timeout {timed[0]['is_timeout']}, {timed[0]['num_iters']} iters (want True, 2)")
        check(not jit_asp.watchdog_events, f"watchdog fired: {jit_asp.watchdog_events}")
    finally:
        shutil.rmtree(result_dir, ignore_errors=True)
    wall = time.perf_counter() - tic_phase
    per_horizon = "; ".join(
        f"t={h['t']}: {h['layers']} layers, {h['iters']} iters, {h['s_per_iter']:.3f} s/iter, fobj "
        f"{h['f_start']:.6g} -> {h['fobj']:.6g}, fid_a1_vs_gt {h['fids'][0]:.6f} (no truncation; gap to 1 - fobj "
        f"{h['gap']:.2e}), fid_t1_vs_gt {h['fids'][1]:.6f}, fid_a1_vs_t1 {h['fids'][2]:.6f}" for h in horizons)
    print(f"[driver] run_simulation, {DRIVER_QUBITS}q chi={PATH_CHI}, horizons t={list(DRIVER_TIMES)} (steps "
          f"{list(DRIVER_STEPS)}), fast/{route}/{config.jacobi_criterion()}, maxiter 10: run 1 targets generated in "
          f"{run1['generate_s'][0]:.3f} s (get_target_states {run1['targets_s'][0]:.3f} s) | {per_horizon} | horizon "
          f"1 vs f64 re-evaluation (LAPACK on the host, {check_s:.1f} s): {f_check:.7g} | launches {counts} (by n: "
          f"{counts_at}; by home: {homes}), watchdog events 0 | run 2 (resume): 0 horizons again, target cache "
          f"loaded in {run2['targets_s'][0]:.3f} s (generation {run1['generate_s'][0]:.3f} s) | run 3 (time_limit "
          f"1e-9, chunks of 2): is_timeout, {timed[0]['num_iters']} iters, cache loaded in "
          f"{run3['targets_s'][0]:.3f} s | phase wall {wall:.1f} s", flush=True)
    return counts, counts_at, homes


@contextmanager
def host_spies():
    """Records what one host-protocol ``run_simulation`` does, through the
    names it calls: per horizon the objective ``_create_objective`` made
    (its ansatz and target), the first objective and gradient call's θ and
    values (and the leading flip state then), SciPy's result (``nit``,
    ``nfev``, ``njev``, message), the ``_model_function`` result, and the
    co-sweep branch each gradient took (uncached layered, or z-cached).  The
    driver's log lines are held back to warnings meanwhile."""
    from aqc_research_tpu_torch.models.sp_lhs import time_evol
    from aqc_research_tpu_torch.ops import mps_gradient
    from aqc_research_tpu_torch.optim import optimizer

    horizons = []
    real = {"create": time_evol._create_objective, "model": time_evol._model_function,
            "scipy": optimizer.AQCOptimResult.update_from_scipy,
            "uncached": mps_gradient._fast_dot_gradient_layered,
            "cached": mps_gradient._fast_dot_gradient_layered_zcache}

    def create(**kwargs):
        objv = real["create"](**kwargs)
        h = {"circ": kwargs["circ"], "target": kwargs["target"], "objv": objv, "first_f": None,
             "first_g": None, "uncached": 0, "cached": 0}
        horizons.append(h)
        fun, jac = objv.objective, objv.gradient

        def objective(th):
            f = fun(th)
            if h["first_f"] is None:
                h["first_f"] = (np.array(th, copy=True), f)
            return f

        def gradient(th):
            max_no = objv._max_no
            g = jac(th)
            if h["first_g"] is None:
                h["first_g"] = (np.array(th, copy=True), np.array(g, copy=True), max_no)
            return g

        objv.objective, objv.gradient = objective, gradient
        return objv

    def model(**kwargs):
        out = real["model"](**kwargs)
        horizons[-1]["result"] = out
        return out

    def scipy_result(self, res, blocks):
        horizons[-1]["scipy"] = {"nit": int(res.nit), "nfev": int(res.nfev), "njev": int(res.njev),
                                 "message": str(res.message)}
        return real["scipy"](self, res, blocks)

    def counted(name):
        def call(*args, **kwargs):
            horizons[-1][name] += 1
            return real[name](*args, **kwargs)
        return call

    loggers = [logging.getLogger(f"{name}.py") for name in ("time_evol", "target_states", "evol_utils", "plots")]
    levels = [lg.level for lg in loggers]
    time_evol._create_objective, time_evol._model_function = create, model
    optimizer.AQCOptimResult.update_from_scipy = scipy_result
    mps_gradient._fast_dot_gradient_layered = counted("uncached")
    mps_gradient._fast_dot_gradient_layered_zcache = counted("cached")
    for lg in loggers:
        lg.setLevel(logging.WARNING)
    try:
        yield horizons
    finally:
        time_evol._create_objective, time_evol._model_function = real["create"], real["model"]
        optimizer.AQCOptimResult.update_from_scipy = real["scipy"]
        mps_gradient._fast_dot_gradient_layered = real["uncached"]
        mps_gradient._fast_dot_gradient_layered_zcache = real["cached"]
        for lg, level in zip(loggers, levels):
            lg.setLevel(level)


def phase_host(card_line: str, dev):
    """The driver's host protocol on the card (``use_jit_lbfgs=False``):
    SciPy's L-BFGS-B over ``sur_fast_mps_trotter`` at 20 qubits χ=64,
    horizons of 1 layer (no layer cache: the uncached co-sweep) and 2 layers
    (the z-cached one), each evaluation on the card."""
    import contextlib
    import io

    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp, time_evol

    tic_phase = time.perf_counter()
    config.set_precision("fast")
    config.set_svd_impl(None)
    config.set_fused_pair(None)
    route = config.svd_impl(dev)
    check(route == "rand", f"the default route on the card is {route!r}, not 'rand'")
    result_dir = tempfile.mkdtemp(prefix="aqc_host_")
    try:
        opts = driver_options(result_dir, num_layers_inc=1, use_jit_lbfgs=False, maxiter=HOST_MAXITER)
        check(not opts.resolve_use_jit_lbfgs() and opts.objective == "sur_fast_mps_trotter",
              "the host phase does not resolve to the host protocol over the MPS objective")
        reset_counts()
        # The objectives' progress dots go to stdout: keep them off this
        # script's lines.
        with host_spies() as horizons, contextlib.redirect_stdout(io.StringIO()):
            out = time_evol.run_simulation(opts)
        torch.cuda.synchronize()
        counts, counts_at, homes = read_counts(), read_counts_at(), read_counts_home()
        run_s = time.perf_counter() - tic_phase
        with open(os.path.join(out, "all_results.pkl"), "rb") as fld:
            results = pickle.load(fld)
    finally:
        shutil.rmtree(result_dir, ignore_errors=True)

    check(len(results) == len(horizons) == 2, f"host run: {len(results)} horizons, {len(horizons)} objectives")
    for name in ("theta_build", "rand_tail"):
        check(counts[name] > 0, f"the host path never launched {name}: {counts}")
    check(counts["fused_pair"] == 0, f"the host path launched K4 at chi={PATH_CHI}: {counts}")
    base_bits = tuple(1 if q % 2 == 0 else 0 for q in range(DRIVER_QUBITS))  # Neel prep
    lines = []
    for layers, (res, h) in enumerate(zip(results, horizons), start=1):
        at = f"host horizon t={res['evol_time1']}"
        opt, sci, objv = h["result"], h["scipy"], h["objv"]
        check(res["num_layers"] == layers and h["circ"].num_layers == layers, f"{at}: {res['num_layers']} layers")
        want = (1, 0) if layers == 1 else (0, 1)
        check((h["uncached"] > 0, h["cached"] > 0) == (want[0] > 0, want[1] > 0),
              f"{at}: co-sweeps uncached {h['uncached']}, z-cached {h['cached']} (want only "
              f"{'uncached' if layers == 1 else 'z-cached'})")
        # The start point: SciPy's first call is at x0.
        th0, f0 = h["first_f"]
        th_g, g0, max_no0 = h["first_g"]
        check(np.array_equal(th0, opt["ini_thetas"]) and np.array_equal(th_g, th0),
              f"{at}: the first calls are not at the start point")
        check(max_no0 == 0, f"{at}: leading flip state {max_no0} at the start point")
        _, value_and_grad = jit_asp._mps_value_fns(h["circ"], base_bits, float(opts.trunc_thr))
        f_ref, g_ref = value_and_grad(torch.tensor(th0, dtype=config.real_dtype(), device=dev), h["target"])
        f_ref, g_ref = float(f_ref), g_ref.double().cpu().numpy()
        df, dg = abs(f0 - f_ref), float(np.linalg.norm(g0 - g_ref) / np.linalg.norm(g_ref))
        check(df <= TOL_HOST_F, f"{at}: start fobj host {f0} vs device loop {f_ref}: {df:.3g} > {TOL_HOST_F}")
        check(dg <= TOL_HOST_G, f"{at}: start gradient host vs device loop: relative {dg:.3g} > {TOL_HOST_G}")
        fobj = float(opt["cost"])
        check(np.isfinite(fobj) and fobj < f0, f"{at}: fobj {fobj} not below its start {f0}")
        thetas = torch.tensor(opt["thetas"], dtype=torch.float64)
        f64 = f64_objective(h["circ"], thetas, h["target"], base_bits, float(opts.trunc_thr), dev)
        check(abs(f64 - fobj) <= TOL_FINAL, f"{at}: final fobj {fobj} vs c128 re-evaluation on the card {f64}")
        # One evaluation (objective + gradient) at the final θ, profiled:
        # where a host-protocol evaluation spends its time.
        th_fin = np.asarray(opt["thetas"])
        # The run's state and counters, before the profiled call moves them.
        weight, max_no = objv._weight, objv._max_no
        n_fun, n_grad = objv._service.num_fun_ev, objv._service.num_grad_ev
        before = read_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            prof = profile_calls(lambda: (objv.objective(th_fin), objv.gradient(th_fin)))
        per_eval = {name: n - before[name] for name, n in read_counts().items()}
        qr_calls = sum(e.count for e in prof["events"] if e.key == "aten::linalg_qr")
        nit = max(sci["nit"], 1)
        lines.append(
            f"t={res['evol_time1']}: {layers} layer(s), nit {sci['nit']}, nfev {sci['nfev']}, njev {sci['njev']}, "
            f"SciPy: {sci['message']!r}, {opt['time']:.3f} s = {opt['time'] / nit:.3f} s/iter, objective calls "
            f"{n_fun} and gradients {n_grad} ({n_fun / nit:.2f} / {n_grad / nit:.2f} per iteration), "
            f"co-sweeps uncached {h['uncached']} / z-cached {h['cached']}, fobj {f0:.7g} -> {fobj:.7g} "
            f"(c128 re-evaluation on the card {f64:.7g}), start vs device loop: fobj {df:.2e}, gradient "
            f"{dg:.2e} relative, weight {weight:.4g}, max_no {max_no}, fid_a1_vs_gt "
            f"{res['fid_a1_vs_gt']:.6f}; one evaluation at the final theta, profiled: {prof['wall_ms']:.1f} ms "
            f"wall, device busy {prof['busy_ms']:.1f} ms (idle {prof['idle']:.1%}), {prof['aten_calls']} aten "
            f"calls, {qr_calls} linalg_qr, launches {per_eval}")
    wall = time.perf_counter() - tic_phase
    print(f"[host20] run_simulation use_jit_lbfgs=False objective=sur_fast_mps_trotter, {DRIVER_QUBITS}q "
          f"chi={PATH_CHI}, num_layers_inc 1, horizons t={list(DRIVER_TIMES)}, maxiter {HOST_MAXITER}, "
          f"fast/{route}/{config.jacobi_criterion()} | {'; '.join(lines)} | launches {counts} (by n: {counts_at}; "
          f"by home: {homes}) | run_simulation {run_s:.1f} s, phase wall {wall:.1f} s | {card_line}", flush=True)
    return counts, counts_at, homes


@contextmanager
def dense_spies():
    """Counts the flagship run's evaluations through the names it calls:
    every surrogate-loss call and every autograd value-and-gradient call
    (values = loss calls - value-and-gradient calls)."""
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.optim import lbfgs

    seen = {"loss": 0, "value_and_grad": 0}
    real_loss, real_vg = jit_asp.make_surrogate_loss, lbfgs.autograd_value_and_grad

    def make_loss(*args, **kwargs):
        loss = real_loss(*args, **kwargs)

        def counted(*a):
            seen["loss"] += 1
            return loss(*a)
        return counted

    def make_vg(fun):
        vg = real_vg(fun)

        def counted(x):
            seen["value_and_grad"] += 1
            return vg(x)
        return counted

    jit_asp.make_surrogate_loss, lbfgs.autograd_value_and_grad = make_loss, make_vg
    try:
        yield seen
    finally:
        jit_asp.make_surrogate_loss, lbfgs.autograd_value_and_grad = real_loss, real_vg


def dense_flagship(dev, dtype):
    """bench.py's configuration (``__graft_entry__._flagship(12, 2)`` plus
    its perturbation), rebuilt in the port: 2-layer 2nd-order Trotter
    ansatz, perfect init at t=1.2, δ=1, plus 0.2·N(0,1) rad (seed 12345);
    target Trotter(1.2, 30 steps, 2nd order) of the Néel state in
    ``dtype`` on ``dev``; the Néel index and its one-bit flips."""
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.targets import trotter as trotop

    n = DENSE_QUBITS
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, DENSE_LAYERS), True)
    thetas = trotop.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=1.2, delta=1.0)
    thetas = thetas + DENSE_PERTURBATION * np.random.default_rng(DENSE_SEED).standard_normal(thetas.shape)
    target = trotop.Trotter(num_qubits=n, evol_time=1.2, num_steps=30, delta=1.0, second_order=True).as_vector(
        trotop.neel_init_state(n), dtype=dtype, device=dev)
    idx = jit_asp.flip_state_indices(n, trotop.neel_init_state(n))
    return circ, thetas, target, idx


def wall_s(fn) -> float:
    torch.cuda.synchronize()
    tic = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - tic


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def phase_dense(dev):
    """The dense statevector path on the card (no hand-written kernel on it):
    (a) bench.py's 12-qubit flagship through ``optimize_horizon_jit`` to
    infidelity 1e-3 in c64/f32 — one warm-up, 3 timed runs, one profiled;
    (b) the co-sweep gradient against autograd at the flagship start point
    in c128 and in c64; (c) ``run_simulation(objective="sur_max")`` at 12
    qubits over two horizons.  K1-K4 must not launch."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp, time_evol
    from aqc_research_tpu_torch.models.sp_lhs.user_options import UserOptions
    from aqc_research_tpu_torch.ops.gradients import grad_of_dot_product, grad_of_dot_product_autodiff
    from aqc_research_tpu_torch.ops.statevector import v_dagger_mul_vec
    from aqc_research_tpu_torch.optim.lbfgs import autograd_value_and_grad

    tic_phase = time.perf_counter()
    config.set_precision("fast")
    reset_counts()

    # (a) The flagship, fast precision.
    circ, thetas, target, idx = dense_flagship(dev, torch.complex64)
    x0 = torch.tensor(thetas, dtype=torch.float32, device=dev)

    def run():
        return jit_asp.optimize_horizon_jit(circ, x0, target, state_idx=idx, fidelity_thr=1.0 - DENSE_INFIDELITY,
                                            maxiter=DENSE_MAXITER)

    with dense_spies() as evals:
        res = run()
    torch.cuda.synchronize()
    n_vg = evals["value_and_grad"]
    n_value = evals["loss"] - n_vg
    times = [wall_s(run) for _ in range(3)]
    fobj, iters = float(res.fobj), res.num_iters
    check(np.isfinite(fobj) and fobj <= DENSE_INFIDELITY, f"dense flagship: fobj {fobj} > {DENSE_INFIDELITY}")
    check(DENSE_ITERS[0] <= iters <= DENSE_ITERS[1], f"dense flagship: {iters} iterations outside {DENSE_ITERS}")
    flagship_s = time.perf_counter() - tic_phase
    # The profiled run is cut at DENSE_PROFILE_ITERS iterations: a steady
    # window (the profiler's digest of a whole run's ~450 k host events took
    # most of a 133 s phase on the H100).
    tic = time.perf_counter()
    with dense_spies() as prof_evals:
        run_prof = profile_calls(lambda: jit_asp.optimize_horizon_jit(
            circ, x0, target, state_idx=idx, fidelity_thr=1.0 - DENSE_INFIDELITY, maxiter=DENSE_PROFILE_ITERS))
    prof_evaluations = prof_evals["loss"]
    loss = jit_asp.make_surrogate_loss(circ, idx)
    vg = autograd_value_and_grad(lambda x: loss(x, target))
    vg_prof = profile_calls(lambda: vg(x0))
    with torch.no_grad():
        value_prof = profile_calls(lambda: loss(x0, target))
    # The engine re-evaluated in c128 at the final θ against the run's own
    # target; then against the target built in c128 (the c64 target loses
    # norm over its 330 f32 block applications, as the JAX package's does).
    target128 = dense_flagship(dev, torch.complex128)[2]
    with torch.no_grad():
        f128 = float(1.0 - v_dagger_mul_vec(circ, res.thetas.double(), target.to(torch.complex128))[int(idx[0])]
                     .abs() ** 2)
        f128_target128 = float(1.0 - v_dagger_mul_vec(circ, res.thetas.double(), target128)[int(idx[0])].abs() ** 2)
    norm_gap = 1.0 - float(target.abs().pow(2).sum())
    check(abs(f128 - fobj) <= TOL_DENSE_RECHECK, f"dense flagship: fobj {fobj} vs c128 re-evaluation {f128}")
    profile_s = time.perf_counter() - tic

    # (b) The co-sweep against autograd at the start point.
    tic = time.perf_counter()
    grads = {}
    for dtype in (torch.complex128, torch.complex64):
        tgt = target128.to(dtype)
        th = torch.tensor(thetas, dtype=config.real_of(dtype), device=dev)
        x = torch.zeros_like(tgt)
        x[int(idx[0])] = 1.0
        with torch.no_grad():
            vh = v_dagger_mul_vec(circ, th, tgt)
        cs_s = wall_s(lambda: grad_of_dot_product(circ, th, x, vh))
        ad_s = wall_s(lambda: grad_of_dot_product_autodiff(circ, th, x, tgt))
        grads[dtype] = (grad_of_dot_product(circ, th, x, vh), grad_of_dot_product_autodiff(circ, th, x, tgt),
                        cs_s, ad_s)
    g_cs, g_ad = grads[torch.complex128][:2]
    err128 = rel_err(g_cs, g_ad)
    check(err128 <= TOL_COSWEEP_C128, f"co-sweep vs autograd in c128: relative {err128:.3g}")
    err64 = {name: rel_err(g.to(torch.complex128), ref)
             for name, g, ref in (("co-sweep", grads[torch.complex64][0], g_cs),
                                  ("autograd", grads[torch.complex64][1], g_ad))}
    check(max(err64.values()) <= TOL_COSWEEP_C64, f"c64 gradients vs c128: {err64}")

    cosweep_s = time.perf_counter() - tic

    # (c) The dense driver.
    tic = time.perf_counter()
    result_dir = tempfile.mkdtemp(prefix="aqc_dense_")
    try:
        opts = driver_options(result_dir, num_qubits=DENSE_QUBITS, objective="sur_max", maxiter=DENSE_DRIVER_MAXITER,
                              fidelity_thr=UserOptions().fidelity_thr)
        check(not opts.use_mps, "objective 'sur_max' resolves to the MPS engine")
        with driver_spies() as seen:
            out = time_evol.run_simulation(opts)
        torch.cuda.synchronize()
        with open(os.path.join(out, "all_results.pkl"), "rb") as fld:
            results = pickle.load(fld)
    finally:
        shutil.rmtree(result_dir, ignore_errors=True)
    check(len(results) == 2 and len(seen["optimized"]) == 2, f"dense driver: {len(results)} horizons")
    horizons = []
    for res_h, opt in zip(results, seen["optimized"]):
        at = f"dense driver horizon t={res_h['evol_time1']}"
        gap = abs(res_h["fid_a1_vs_gt"] - opt["fidelity"])
        check(np.isfinite(opt["cost"]) and not res_h["use_mps"], f"{at}: fobj {opt['cost']}")
        check(gap <= TOL_DENSE_FID, f"{at}: fid_a1_vs_gt {res_h['fid_a1_vs_gt']} vs the result's fidelity "
                                    f"{opt['fidelity']}: gap {gap:.3g} > {TOL_DENSE_FID}")
        horizons.append(f"t={res_h['evol_time1']}: {res_h['num_layers']} layers, {opt['num_iters']} iters, "
                        f"{opt['time'] / max(opt['num_iters'], 1):.4f} s/iter ({opt['time']:.3f} s), fobj "
                        f"{opt['cost']:.7g}, weight {opt['stats']['weight']:.5g}, fidelity {opt['fidelity']:.7f}, "
                        f"fid_a1_vs_gt {res_h['fid_a1_vs_gt']:.7f} (gap {gap:.2e}), fid_t1_vs_gt "
                        f"{res_h['fid_t1_vs_gt']:.7f}")
    driver_s = time.perf_counter() - tic
    counts, counts_at, homes = read_counts(), read_counts_at(), read_counts_home()
    check(not any(counts.values()), f"the dense path launched a hand-written kernel: {counts}")
    wall = time.perf_counter() - tic_phase
    evals_per_run = n_value + n_vg
    print(f"[dense12] flagship {DENSE_QUBITS}q {DENSE_LAYERS}-layer Trotter ansatz ({circ.num_thetas} thetas), "
          f"0.2 rad seed {DENSE_SEED}, fast (c64/f32), optimize_horizon_jit (autograd gradient) to infidelity "
          f"{DENSE_INFIDELITY}: {iters} iters, fobj {fobj:.7g} (c128 re-evaluation {f128:.7g}; against the target "
          f"built in c128 {f128_target128:.7g}, the c64 target's 1 - norm^2 {norm_gap:.3g}), "
          f"{n_value} values + {n_vg} value+grads per run | 3 timed runs {', '.join(f'{t:.4f}' for t in times)} s: "
          f"min {min(times):.4f} s, median {float(np.median(times)):.4f} s "
          f"({float(np.median(times)) / evals_per_run * 1e3:.3f} ms per evaluation, "
          f"{float(np.median(times)) / iters * 1e3:.3f} ms per iteration) | profiled run cut at {DENSE_PROFILE_ITERS} "
          f"iterations ({prof_evaluations} evaluations): {run_prof['wall_ms']:.1f} ms wall, device busy "
          f"{run_prof['busy_ms']:.1f} ms (idle {run_prof['idle']:.1%}), {run_prof['aten_calls']} aten calls "
          f"({run_prof['aten_calls'] / prof_evaluations:.0f} per evaluation) | one obj+grad: "
          f"{vg_prof['aten_calls']} aten calls, {vg_prof['wall_ms']:.2f} ms wall, idle {vg_prof['idle']:.1%}; one "
          f"value: {value_prof['aten_calls']} aten calls, {value_prof['wall_ms']:.2f} ms wall", flush=True)
    print(f"[dense12] co-sweep vs autograd at the start point: c128 relative {err128:.3e} (co-sweep "
          f"{grads[torch.complex128][2] * 1e3:.2f} ms, autograd {grads[torch.complex128][3] * 1e3:.2f} ms); c64 vs "
          f"c128: co-sweep {err64['co-sweep']:.3e}, autograd {err64['autograd']:.3e} (co-sweep "
          f"{grads[torch.complex64][2] * 1e3:.2f} ms, autograd {grads[torch.complex64][3] * 1e3:.2f} ms)", flush=True)
    print(f"[dense12] run_simulation objective=sur_max, {DENSE_QUBITS}q, horizons t={list(DRIVER_TIMES)} (steps "
          f"{list(DRIVER_STEPS)}), maxiter {DENSE_DRIVER_MAXITER}, fidelity bar from fidelity_thr "
          f"{opts.fidelity_thr}: targets {seen['targets_s'][0]:.3f} s | {'; '.join(horizons)} | launches {counts} | "
          f"phase wall {wall:.1f} s (flagship runs {flagship_s:.1f}, profiles and c128 re-check {profile_s:.1f}, "
          f"gradients {cosweep_s:.1f}, driver {driver_s:.1f})", flush=True)
    return counts, counts_at, homes


# The AQC phase: BASELINE config 1 (benchmarks/bench_aqc_multistart.py:52-183)
# and the README's aqc_sketching call, rebuilt in the port.
AQC_QUBITS, AQC_DEPTH = 5, 160
AQC_LANES, AQC_LAYERS, AQC_MAXITER, AQC_SEED = 16, 40, 300, 2024
AQC_PARITY_LANES, AQC_PARITY_ITERS = 2, 20
TOL_AQC_FID = 1e-5  # a lane's reported fidelity vs its c128 recomputation (both c128: an identity)
# A lane's f32 cost vs the c128 objective at its θ: f32 noise over 160
# blocks; a c64 V(Θ) put the fidelity 1.3e-5 off c128 on the H100.
TOL_AQC_COST = 1e-4
TOL_LANE = 1e-4  # a fleet lane vs the one-lane loop from the same start (f32)
# The dense fleet: BASELINE config 4 (bench_aqc_multistart.py:184-287).
FLEET_QUBITS, FLEET_LAYERS, FLEET_STARTS, FLEET_MAXITER, FLEET_SEED = 12, 2, 8, 150, 3
FLEET_PARITY_ITERS = 20
# The MPS fleet: phase 3's case, 4 lanes from seeds 5..8.
MPS_FLEET_SEEDS = (5, 6, 7, 8)


def count_qr_calls(fn) -> int:
    """The ``torch.linalg.qr`` calls ``fn()`` makes (the range-finder's,
    ops/rand_svd._orth), counted by a spy on the function."""
    real, calls = torch.linalg.qr, [0]

    def spy(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    torch.linalg.qr = spy
    try:
        fn()
    finally:
        torch.linalg.qr = real
    return calls[0]


def evals_per_s(fn, reps: int = 10) -> float:
    """Calls per second of ``fn`` (host wall of ``reps`` calls ending in
    ``synchronize()``, after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return reps / (time.perf_counter() - tic)


def phase_aqc(dev):
    """Full AQC and the sketching drivers on the card, fast precision; no
    hand-written kernel may launch (checked)."""
    import importlib

    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.circuit.ansatz import Ansatz
    from aqc_research_tpu_torch.circuit.structures import create_ansatz_structure
    from aqc_research_tpu_torch.models.sketching import aqc_coordinate_descent
    from aqc_research_tpu_torch.models.sketching import sk_core
    from aqc_research_tpu_torch.ops.statevector import v_mul_mat
    from aqc_research_tpu_torch.optim.lbfgs import lbfgs_fleet_programs, minimize_lbfgs_compact, stateless_lanes
    from aqc_research_tpu_torch.targets import trotter as trotop
    from aqc_research_tpu_torch.utils import rand_thetas

    aqs = importlib.import_module("aqc_research_tpu_torch.models.sketching.aqc_sketching")
    tic_phase = time.perf_counter()
    config.set_precision("fast")
    reset_counts()

    # (a) The fused objective+gradient, one lane and 16 lanes in one call.
    n, dim = AQC_QUBITS, 2**AQC_QUBITS
    circ = Ansatz.make(n, "cx", create_ansatz_structure(n, "spin", depth=AQC_DEPTH))
    u = trotop.exact_evolution(trotop.make_hamiltonian(n, 1.0), np.eye(dim, dtype=complex), 1.0)
    x = torch.eye(dim, dtype=torch.complex64, device=dev)
    y = torch.tensor(u, dtype=torch.complex64, device=dev)
    np.random.seed(0)
    th1 = torch.tensor(rand_thetas(circ.num_thetas), dtype=torch.float32, device=dev)
    np.random.seed(1)
    th16 = torch.tensor(np.stack([rand_thetas(circ.num_thetas) for _ in range(AQC_LANES)]), dtype=torch.float32,
                        device=dev)
    _, fused_l = aqs.fleet_objective(circ, x, y)
    with torch.no_grad():
        f1, g1 = sk_core.objective_and_gradient(circ, th1, x, y)
        f16, g16 = fused_l(th16)
        f16_0, g16_0 = sk_core.objective_and_gradient(circ, th16[0], x, y)
    check(0.0 < float(f1) < 2.0 and bool(torch.isfinite(g1).all()), f"aqc5 (a): fobj {float(f1)}")
    lane_gap = max(abs(float(f16[0]) - float(f16_0)), float((g16[0] - g16_0).abs().max()))
    check(lane_gap <= TOL_LANE, f"aqc5 (a): lane 0 of the 16-lane call vs one lane: {lane_gap:.3g}")
    with torch.no_grad():
        rate1 = evals_per_s(lambda: sk_core.objective_and_gradient(circ, th1, x, y))
        rate16 = AQC_LANES * evals_per_s(lambda: fused_l(th16))
        prof1 = profile_calls(lambda: sk_core.objective_and_gradient(circ, th1, x, y))
        prof16 = profile_calls(lambda: fused_l(th16))
    fused_s = time.perf_counter() - tic_phase

    # (b) The full-AQC fleet: the README's call with 16 restarts.
    tic = time.perf_counter()
    result_dir = tempfile.mkdtemp(prefix="aqc_sketch_")
    quiet = logging.getLogger("aqc5")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = aqs.aqc_sketching(
                num_qubits=n, num_layers=AQC_LAYERS, num_skvecs=dim, circ_layout="spin", maxiter=AQC_MAXITER,
                learn_rate=0.1, skvecs_type="full", target_name_or_func="random", result_folder=result_dir,
                seed=AQC_SEED, num_simulations=AQC_LANES, logger=quiet,
            )
        with open(os.path.join(out, "simulation_results.pkl"), "rb") as fld:
            payload = pickle.load(fld)
    finally:
        shutil.rmtree(result_dir, ignore_errors=True)
    fleet_wall = time.perf_counter() - tic
    lanes = sorted(payload["sorted_results"], key=lambda r: r["job_index"])
    check(len(lanes) == AQC_LANES and all(r["stats"].get("fleet") for r in lanes),
          f"aqc5 (b): {len(lanes)} lanes, not the fleet's {AQC_LANES}")
    target = payload["target_matrix"]
    circ40 = aqs.sku.create_ansatz(num_qubits=n, num_layers=AQC_LAYERS, circuit_layout="spin")
    x64, y64 = aqs.skc.sketch_tensors(np.eye(dim), aqs.sku.targen.make_su_matrix(target))
    value40, _ = aqs.fleet_objective(circ40, x64, y64)
    starts = torch.tensor(np.stack([r["ini_thetas"] for r in lanes]), dtype=torch.float32, device=dev)
    with torch.no_grad():
        f_start = value40(starts).cpu().numpy()
    costs = np.array([r["cost"] for r in lanes])
    check(bool(np.all(np.isfinite(costs)) and np.all(costs < f_start)),
          f"aqc5 (b): a lane did not lower its cost: starts {f_start.tolist()}, costs {costs.tolist()}")
    # The drivers score V(Θ) in c128 (models/sketching/sk_utils.circuit_matrix),
    # so the reported fidelity re-reads the lane's θ; the f32 cost that ranks
    # the lanes is held against the c128 objective at the same θ.
    fid_gap = 0.0
    for r in lanes:
        with torch.no_grad():
            v128 = v_mul_mat(circ40, torch.tensor(r["thetas"], dtype=torch.float64, device=dev),
                             torch.eye(dim, dtype=torch.complex128, device=dev)).cpu().numpy()
        fid_gap = max(fid_gap, abs(aqs.sku.fidelity(v128, target) - r["fidelity"]))
    check(fid_gap <= TOL_AQC_FID, f"aqc5 (b): reported fidelity vs c128 recomputation: {fid_gap:.3g}")
    value128, _ = aqs.fleet_objective(
        circ40, *(torch.as_tensor(np.asarray(a), device=dev).to(torch.complex128)
                  for a in (np.eye(dim), aqs.sku.targen.make_su_matrix(target))))
    with torch.no_grad():
        cost128 = value128(torch.tensor(np.stack([r["thetas"] for r in lanes]), dtype=torch.float64,
                                        device=dev)).cpu().numpy()
    cost_gap = float(np.abs(cost128 - costs).max())
    check(cost_gap <= TOL_AQC_COST, f"aqc5 (b): lanes' f32 costs {costs.tolist()} vs c128 {cost128.tolist()}")
    iters = [r["nit"] for r in lanes]
    outcomes = {k: sum(r["exit_status"] == k for r in lanes) for k in ("early", "normal", "timeout")}
    best = min(lanes, key=lambda r: r["cost"])

    # Two lanes against the one-lane loop from the same starts.
    programs = lbfgs_fleet_programs(*stateless_lanes(value40, aqs.fleet_objective(circ40, x64, y64)[1]),
                                    maxiter=AQC_PARITY_ITERS, fobj_thr=aqs._SMALL_FOBJ)
    init, chunk, extract = programs
    fleet20, _ = extract(chunk(init(starts), AQC_PARITY_ITERS))
    lane_diffs = []
    for k in range(AQC_PARITY_LANES):
        def one(th):
            return sk_core.objective_and_gradient(circ40, th, x64, y64)
        single = minimize_lbfgs_compact(lambda th: one(th)[0], starts[k], maxiter=AQC_PARITY_ITERS,
                                        fobj_thr=aqs._SMALL_FOBJ, value_and_grad_fn=one)
        lane_diffs.append(abs(float(single.fobj) - float(fleet20.fobj[k])))
        check(single.num_iters == int(fleet20.num_iters[k]),
              f"aqc5 (b): lane {k}: {int(fleet20.num_iters[k])} fleet iterations vs {single.num_iters} alone")
    check(max(lane_diffs) <= TOL_LANE, f"aqc5 (b): fleet lanes vs the one-lane loop: {lane_diffs}")
    fleet_s = time.perf_counter() - tic

    # (c) Sketched AQC through the executor; (d) coordinate descent.
    tic = time.perf_counter()
    result_dir = tempfile.mkdtemp(prefix="aqc_sketched_")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = aqs.aqc_sketching(
                num_qubits=n, num_layers=AQC_LAYERS, num_skvecs=8, circ_layout="spin", maxiter=100,
                learn_rate=0.1, skvecs_type="rand", target_name_or_func="random", result_folder=result_dir,
                seed=AQC_SEED, num_simulations=2, logger=quiet,
            )
        with open(os.path.join(out, "simulation_results.pkl"), "rb") as fld:
            sketched = pickle.load(fld)["sorted_results"]
    finally:
        shutil.rmtree(result_dir, ignore_errors=True)
    check(len(sketched) == 2 and all(r["status"] == "ok" and np.isfinite(r["cost"]) for r in sketched),
          f"aqc5 (c): {[(r['status'][:40], r.get('cost')) for r in sketched]}")
    sketched_s = time.perf_counter() - tic
    tic = time.perf_counter()
    result_dir = tempfile.mkdtemp(prefix="aqc_cd_")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = aqc_coordinate_descent(
                num_qubits=n, num_layers=AQC_LAYERS, circ_layout="spin", maxiter=20, target_name_or_func="random",
                result_folder=result_dir, seed=AQC_SEED, num_simulations=2, logger=quiet,
            )
        with open(os.path.join(out, "simulation_results.pkl"), "rb") as fld:
            descents = pickle.load(fld)["sorted_results"]
    finally:
        shutil.rmtree(result_dir, ignore_errors=True)
    check(len(descents) == 2 and all(r["status"] == "ok" and np.isfinite(r["cost"]) for r in descents),
          f"aqc5 (d): {[(r['status'][:40], r.get('cost')) for r in descents]}")
    for r in descents:
        prof = r["stats"]["convergence_profile"]
        check(r["cost"] <= float(prof[0]) + 1e-6, f"aqc5 (d): best cost {r['cost']} above the first sweep's {prof[0]}")
    cd_s = time.perf_counter() - tic

    counts, counts_at, homes = read_counts(), read_counts_at(), read_counts_home()
    check(not any(counts.values()), f"the AQC paths launched a hand-written kernel: {counts}")
    print(f"[aqc5] (a) {n}q spin depth {AQC_DEPTH} cx ({circ.num_thetas} thetas), target exact_evolution(H(5, 1), "
          f"I, 1) c64: fused obj+grad one lane {rate1:.1f} evals/s ({prof1['aten_calls']} aten calls, idle "
          f"{prof1['idle']:.1%}), {AQC_LANES} lanes in one call {rate16:.1f} evals/s aggregate "
          f"({rate16 / rate1:.2f}x; {prof16['aten_calls']} aten calls, idle {prof16['idle']:.1%}), lane 0 vs one "
          f"lane {lane_gap:.1e} | (b) aqc_sketching {n}q {AQC_LAYERS} layers spin, full range ({dim} skvecs), "
          f"target random, maxiter {AQC_MAXITER}, lr 0.1, {AQC_LANES} restarts, seed {AQC_SEED}: wall "
          f"{fleet_wall:.2f} s (fleet {lanes[0]['time']:.2f} s), iterations {iters}, exits {outcomes}, best cost "
          f"{best['cost']:.6g} (fidelity {best['fidelity']:.6f}), costs {min(costs):.4g}..{max(costs):.4g} from "
          f"starts {f_start.min():.4g}..{f_start.max():.4g}, reported fidelities vs c128 {fid_gap:.1e}, f32 "
          f"costs vs c128 {cost_gap:.1e}; "
          f"{AQC_PARITY_LANES} lanes at maxiter {AQC_PARITY_ITERS} vs the one-lane loop: "
          f"{', '.join(f'{d:.1e}' for d in lane_diffs)} | (c) sketched rand, 8 skvecs, maxiter 100, 2 restarts: "
          f"costs {[round(r['cost'], 5) for r in sketched]}, {sketched_s:.2f} s | (d) coordinate descent, maxiter "
          f"20, 2 restarts: costs {[round(r['cost'], 5) for r in descents]}, sweeps "
          f"{[r['nit'] for r in descents]}, {cd_s:.2f} s | launches {counts} | phase wall "
          f"{time.perf_counter() - tic_phase:.1f} s ((a) {fused_s:.1f}, (b) {fleet_s:.1f})", flush=True)
    return counts, counts_at, homes


def phase_fleet_dense(dev):
    """BASELINE config 4 on the card: the dense fleet against its single
    start, fast precision; no hand-written kernel may launch (checked)."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.ops.statevector import v_dagger_mul_vec
    from aqc_research_tpu_torch.optim.lbfgs import lane_objective, lbfgs_fleet_programs, stateless_lanes
    from aqc_research_tpu_torch.targets import trotter as trotop

    tic_phase = time.perf_counter()
    config.set_precision("fast")
    reset_counts()
    n = FLEET_QUBITS
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, FLEET_LAYERS), True)
    thetas0 = trotop.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=1.2, delta=1.0)
    rng = np.random.default_rng(FLEET_SEED)
    batch0 = thetas0[None, :] + 0.2 * rng.standard_normal((FLEET_STARTS, circ.num_thetas))
    xb = torch.tensor(batch0, dtype=torch.float32, device=dev)
    ini = trotop.neel_init_state(n)
    target = trotop.Trotter(num_qubits=n, evol_time=1.2, num_steps=6, delta=1.0, second_order=True).as_vector(
        ini, dtype=torch.complex64, device=dev)
    idx = jit_asp.flip_state_indices(n, ini)

    def single():
        return jit_asp.optimize_horizon_jit(circ, xb[0], target, state_idx=idx, maxiter=FLEET_MAXITER)

    def fleet(fuse=False, batch_linesearch=2, maxiter=FLEET_MAXITER):
        return jit_asp.optimize_horizon_multistart(circ, xb, target, state_idx=idx, maxiter=maxiter,
                                                   batch_linesearch=batch_linesearch, fuse_linesearch_grad=fuse)

    runs = {"single": single, "fleet": fleet, "fused": lambda: fleet(fuse=True)}
    # Warm-up: a few iterations of each (torch compiles nothing; this
    # settles the allocator and the library handles).
    jit_asp.optimize_horizon_jit(circ, xb[0], target, state_idx=idx, maxiter=3)
    fleet(maxiter=3), fleet(fuse=True, maxiter=3)
    walls, results = {name: [] for name in runs}, {}
    for name in ("single", "fleet", "fused", "single"):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        results[name] = runs[name]()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - tic)
    t = {name: float(np.median(w)) for name, w in walls.items()}
    efficiency = FLEET_STARTS * t["single"] / t["fleet"]
    efficiency_fused = FLEET_STARTS * t["single"] / t["fused"]

    loss = jit_asp.make_surrogate_loss(circ, idx)
    _, vg = lane_objective(lambda th: loss(th, target))
    x1 = xb[:1]
    # One obj+grad at B=1 and at B=8, in turns (1, 8, 8, 1); medians.
    t_eval = {1: [], FLEET_STARTS: []}
    for lanes_b in (1, FLEET_STARTS, FLEET_STARTS, 1):
        xs_b = x1 if lanes_b == 1 else xb
        t_eval[lanes_b].append(1.0 / evals_per_s(lambda: vg(xs_b), reps=20))
    t_e1, t_eb = (float(np.median(t_eval[b])) for b in (1, FLEET_STARTS))
    overhead = t_eb / t_e1
    prof1, prof8 = profile_calls(lambda: vg(x1)), profile_calls(lambda: vg(xb))
    value, _ = lane_objective(lambda th: loss(th, target))
    init, chunk, _ = lbfgs_fleet_programs(*stateless_lanes(value, vg), maxiter=FLEET_MAXITER, batch_linesearch=2)
    carry = chunk(init(xb), 1)
    prof_iter = profile_calls(lambda: chunk(carry, 2))

    res = results["fleet"]
    best = int(torch.argmax(res.fidelity))
    fid_best = float(res.fidelity[best])
    with torch.no_grad():
        fid128 = float(v_dagger_mul_vec(circ, res.thetas[best].double(), target.to(torch.complex128))[int(idx[0])]
                       .abs() ** 2)
    check(abs(fid128 - fid_best) <= TOL_DENSE_RECHECK,
          f"fleet12: best fidelity {fid_best} vs its c128 re-evaluation {fid128}")
    check(bool(torch.isfinite(res.fobj).all()), f"fleet12: non-finite fobj {res.fobj.tolist()}")
    # Lane 0 of the lock-step fleet (sequential backtracking) follows the
    # one-lane loop from the same start.
    seq = fleet(batch_linesearch=None, maxiter=FLEET_PARITY_ITERS)
    one = jit_asp.optimize_horizon_jit(circ, xb[0], target, state_idx=idx, maxiter=FLEET_PARITY_ITERS)
    lane_gap = abs(float(seq.fobj[0]) - float(one.fobj))
    check(lane_gap <= TOL_LANE, f"fleet12: lane 0 vs the one-lane loop after {FLEET_PARITY_ITERS} iterations: "
                                f"{lane_gap:.3g}")
    counts, counts_at, homes = read_counts(), read_counts_at(), read_counts_home()
    check(not any(counts.values()), f"the dense fleet launched a hand-written kernel: {counts}")
    fmt_w = {name: ", ".join(f"{w:.4f}" for w in ws) for name, ws in walls.items()}
    print(f"[fleet12] {n}q {FLEET_LAYERS}-layer Trotter ansatz ({circ.num_thetas} thetas), {FLEET_STARTS} starts "
          f"perfect init + 0.2 N(0,1) (seed {FLEET_SEED}), target Trotter(1.2, 6 steps), maxiter {FLEET_MAXITER}, "
          f"fast: optimize_horizon_jit on start 0 {fmt_w['single']} s ({results['single'].num_iters} iters), "
          f"fleet batch_linesearch=2 {fmt_w['fleet']} s (iters {res.num_iters.tolist()}), fused "
          f"{fmt_w['fused']} s (iters {results['fused'].num_iters.tolist()}) | fleet efficiency "
          f"{FLEET_STARTS} t_single / t_fleet = {efficiency:.2f} (fused {efficiency_fused:.2f}) | one obj+grad: "
          f"B=1 {1e3 * t_e1:.3f} ms, B={FLEET_STARTS} {1e3 * t_eb:.3f} ms (medians of turns 1, {FLEET_STARTS}, "
          f"{FLEET_STARTS}, 1: {', '.join(f'{1e3 * t:.3f}' for t in t_eval[1])} / "
          f"{', '.join(f'{1e3 * t:.3f}' for t in t_eval[FLEET_STARTS])} ms), evaluation-batch overhead t_eb/t_e1 "
          f"{overhead:.2f}; aten calls B=1 {prof1['aten_calls']}, B={FLEET_STARTS} {prof8['aten_calls']}, idle "
          f"{prof1['idle']:.1%} / {prof8['idle']:.1%} | one profiled fleet iteration: {prof_iter['wall_ms']:.1f} ms "
          f"wall, device busy {prof_iter['busy_ms']:.2f} ms (idle {prof_iter['idle']:.1%}), "
          f"{prof_iter['aten_calls']} aten calls | best fidelity {fid_best:.7f} (lane {best}; c128 {fid128:.7f}), "
          f"single fobj {float(results['single'].fobj):.6g}, fleet fobj {res.fobj.min().item():.6g}, fused "
          f"{results['fused'].fobj.min().item():.6g} | lane 0 (sequential backtracking) vs the one-lane loop after "
          f"{FLEET_PARITY_ITERS} iterations {lane_gap:.1e} | launches {counts} | phase wall "
          f"{time.perf_counter() - tic_phase:.1f} s", flush=True)
    return counts, counts_at, homes


def phase_fleet_mps(dev, card_line: str):
    """The MPS fleet: phase 3's case, 4 lanes on the default route; the
    lanes fold into the batch of every pair update (checked: K2 and K3
    launch as often per fleet evaluation as per one lane's)."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.kernel_checks import lambda_check, near_threshold, path_planes
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.ops import rand_svd
    from aqc_research_tpu_torch.ops import fused_rand as fr
    from aqc_research_tpu_torch.ops.fused_pair import theta_build, theta_build_reference
    from aqc_research_tpu_torch.ops.mps import MPS
    from aqc_research_tpu_torch.targets import trotter as trotop

    tic_phase = time.perf_counter()
    case = make_case(dev, 20, PATH_CHI, maxiter=10, f64_device=dev)
    config.set_svd_impl(None)
    check(config.svd_impl(case["target"].device) == "rand", "the default route on the card is not 'rand'")
    circ, target, base_bits, trunc_thr = (case[k] for k in ("circ", "target", "base_bits", "trunc_thr"))
    perfect = trotop.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=1.2, delta=1.0)
    xs = torch.tensor(np.stack([perfect + 0.05 * np.random.default_rng(s).standard_normal(circ.num_thetas)
                                for s in MPS_FLEET_SEEDS]), dtype=torch.float32, device=dev)
    check(bool(torch.equal(xs[0], case["x0"])), "fleet20: lane 0 does not start where phase 3 starts")
    lanes = len(MPS_FLEET_SEEDS)
    value, value_and_grad = jit_asp._mps_value_fns(circ, base_bits, trunc_thr)

    reset_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    res = jit_asp.optimize_horizon_mps_multistart(circ, xs, target, base_bits=base_bits, trunc_thr=trunc_thr,
                                                  maxiter=10)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - tic
    counts, counts_at, homes = read_counts(), read_counts_at(), read_counts_home()
    for name in ("jacobi_rows", "theta_build", "rand_tail"):
        check(counts[name] > 0, f"fleet20: the fleet never launched {name}: {counts}")
    check(counts["fused_pair"] == 0, f"fleet20: the fleet launched K4: {counts}")
    fobj = res.fobj.cpu().numpy()
    target128 = MPS(target.gammas.to(torch.complex128), target.lambdas.to(torch.float64))
    with torch.no_grad(), config.svd_impl_override("native"):
        f64 = value(res.thetas.double(), target128).cpu().numpy()
    gaps = np.abs(f64 - fobj)
    check(bool(np.all(np.isfinite(fobj))) and float(gaps.max()) <= TOL_FINAL,
          f"fleet20: lanes' fobj {fobj.tolist()} vs f64 re-evaluations {f64.tolist()}")
    with torch.no_grad():
        f_start = value(xs, target).cpu().numpy()
    check(bool(np.all(fobj < f_start)), f"fleet20: a lane did not lower fobj: {f_start.tolist()} -> {fobj.tolist()}")
    check_s = time.perf_counter() - tic - fleet_s
    tic = time.perf_counter()
    one = jit_asp.optimize_horizon_mps_jit(circ, xs[0], target, base_bits=base_bits, trunc_thr=trunc_thr, maxiter=10)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - tic
    lane_gap = abs(float(one.fobj) - float(fobj[0]))
    check(lane_gap <= TOL_LANE, f"fleet20: lane 0 {fobj[0]} vs the single-lane horizon {float(one.fobj)}")

    # Launches per evaluation: the lanes fold into each pair group's batch.
    tic = time.perf_counter()
    per_eval = {}
    for label, fn in (("fleet value", lambda: value(xs, target)), ("one value", lambda: value(xs[0], target)),
                      ("fleet obj+grad", lambda: value_and_grad(xs, target)),
                      ("one obj+grad", lambda: value_and_grad(xs[0], target))):
        reset_counts()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        per_eval[label] = read_counts()
    for kind in ("value", "obj+grad"):
        fl, on = per_eval[f"fleet {kind}"], per_eval[f"one {kind}"]
        check(fl["theta_build"] == on["theta_build"] > 0 and fl["rand_tail"] == on["rand_tail"] > 0,
              f"fleet20: K2/K3 launches per {kind}: fleet {fl} vs one lane {on}")

    # Lane-sweeps/s of the fleet against one lane's sweeps/s, in turns.
    def sweep_wall(x):
        torch.cuda.synchronize()
        tic_ = time.perf_counter()
        with torch.no_grad():
            value_and_grad(x, target)
        torch.cuda.synchronize()
        return time.perf_counter() - tic_

    sweep_wall(xs), sweep_wall(xs[0])
    walls = {"fleet": [], "one": []}
    for label in ("fleet", "one", "one", "fleet", "fleet", "one"):
        walls[label].append(sweep_wall(xs if label == "fleet" else xs[0]))
    lane_rate = [lanes / w for w in walls["fleet"]]
    one_rate = [1.0 / w for w in walls["one"]]
    with torch.no_grad():
        qr = {label: count_qr_calls(lambda: value_and_grad(x, target)) for label, x in (("fleet", xs), ("one", xs[0]))}
        prof_f = profile_calls(lambda: value_and_grad(xs, target))
    prof_f.pop("events")
    sweeps_s = time.perf_counter() - tic
    tic = time.perf_counter()

    # K2 and K3 at the folded batch: against their twins, then timed beside
    # the one-lane batch of a half-layer (B=10).
    rng = np.random.default_rng(977)
    chi, n = PATH_CHI, 2 * PATH_CHI
    ell = rand_svd.rand_ell(n, chi)
    folded = lanes * BATCH
    rows = {}
    for batch in (BATCH, folded):
        planes = path_planes(rng, batch, chi, dev)
        k_re, k_im = theta_build(*planes)
        p_re, p_im = theta_build_reference(*planes)
        rel = float((torch.linalg.matrix_norm(torch.complex(k_re - p_re, k_im - p_im))
                     / torch.linalg.matrix_norm(torch.complex(p_re, p_im))).max())
        check(rel <= TOL_THETA, f"theta_build at B={batch}: relative error {rel:.3g}")
        a = torch.complex(p_re, p_im).transpose(-1, -2)
        bm = rand_svd._range_project(a, ell, rand_svd._POWER_ITERS)
        m_re, m_im = bm.real.contiguous(), (-bm.imag).contiguous()
        tot2 = (p_re * p_re + p_im * p_im).sum((-2, -1))
        thr2 = TAIL_THRESHOLDS[0] ** 2
        kv = fr.rand_tail(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS)
        pv = fr.rand_tail_reference(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS)
        lc = lambda_check(kv[2], pv[2], near_threshold(torch.linalg.svdvals(bm), tot2, thr2, chi), TOL_S)
        check(lc.mask_ok and lc.lam_ok, f"rand_tail at B={batch}: masks {lc.mask_ok}, |dlam| {lc.d_lam:.3g}")
        sweeps = kv[4].cpu().numpy()
        th_ms, _ = device_ms(lambda: theta_build(*planes))
        tail_ms, _ = device_ms(lambda: fr.rand_tail(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS))
        th_plain = median_ms(lambda: theta_build_reference(*planes), runs=5, warmup=1)
        tail_plain = median_ms(lambda: fr.rand_tail_reference(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS), runs=1,
                               warmup=0)
        th_bound = bound(batch * (32.0 * chi**3 + 128.0 * chi**2), 4 * batch * (4 * 2 * chi * chi + 32 + 2 * n * n))
        tail_bound = bound(jacobi_flops(ell, n, sweeps) + batch * 2.0 * chi * n,
                           4 * batch * (2 * ell * n + 1 + 2 * chi * n + 2 * chi + 1))
        g_c = torch.complex(planes[0][:, :16], planes[0][:, 16:]).reshape(batch, 2, 2, 2, 2)
        a_c, b_c = torch.complex(planes[1], planes[2]), torch.complex(planes[3], planes[4])
        th_lib, _ = device_ms(lambda: torch.einsum("bstuv,bvcx,buxa->btcsa", g_c, b_c, a_c))
        tail_lib, _ = device_ms(lambda: torch.linalg.svd(bm, full_matrices=False), calls=5, repeats=3)
        rows[batch] = {
            "theta_build": {"shape": f"B={batch} chi={chi}", "ms": th_ms, "plain_ms": th_plain, "bound_ms": th_bound[0],
                            "bound_by": th_bound[1], "library_ms": th_lib, "max_abs_err": rel},
            "rand_tail": {"shape": f"B={batch} chi={chi} ({ell}x{n})", "ms": tail_ms, "plain_ms": tail_plain,
                          "bound_ms": tail_bound[0], "bound_by": tail_bound[1], "library_ms": tail_lib,
                          "max_abs_err": lc.d_lam, "sweeps_max": int(sweeps.max())},
        }
    folded_line = "; ".join(
        f"{name} B={b}: {r[name]['ms']:.4f} ms device-only ({r[name]['ms'] / b * 1e3:.2f} us per matrix), plain "
        f"{r[name]['plain_ms']:.3f} ms, library {r[name]['library_ms']:.4f} ms, bound {r[name]['bound_ms']:.5f} ms "
        f"({r[name]['bound_by']})" for name in ("theta_build", "rand_tail") for b, r in rows.items())
    print(f"[fleet20] {case['about']} | {lanes} lanes (seeds {list(MPS_FLEET_SEEDS)}), maxiter 10, route "
          f"{config.svd_impl(target.device)}: fleet {fleet_s:.2f} s ({fleet_s / max(int(res.num_iters.max()), 1):.3f} "
          f"s/iter, iters {res.num_iters.tolist()}), fobj {', '.join(f'{f:.6g}' for f in fobj)} from "
          f"{', '.join(f'{f:.6g}' for f in f_start)} (f64 on the card: max gap {gaps.max():.2e}) | single-lane "
          f"horizon from lane 0's start {single_s:.2f} s ({single_s / max(one.num_iters, 1):.3f} s/iter), fobj "
          f"{float(one.fobj):.6g} (lane 0 gap {lane_gap:.1e}) | launches per evaluation {per_eval} | obj+grad in "
          f"turns: fleet {', '.join(f'{r:.3f}' for r in lane_rate)} lane-sweeps/s, one lane "
          f"{', '.join(f'{r:.3f}' for r in one_rate)} sweeps/s | linalg_qr calls per evaluation: fleet {qr['fleet']}, "
          f"one lane {qr['one']} | profiled fleet obj+grad: {prof_f['wall_ms']:.1f} ms wall, device busy "
          f"{prof_f['busy_ms']:.1f} ms (idle {prof_f['idle']:.1%}), {prof_f['aten_calls']} aten calls (one lane's "
          f"profiled sweep: the [routes] line) | folded batch vs one lane's half-layer, checked against the twins: "
          f"{folded_line} | {card_line} | launches (fleet run) {counts} | phase wall "
          f"{time.perf_counter() - tic_phase:.1f} s (fleet {fleet_s:.1f}, f64 and start checks {check_s:.1f}, "
          f"single horizon {single_s:.1f}, launches, turns and profiles {sweeps_s:.1f}, folded kernels "
          f"{time.perf_counter() - tic:.1f})", flush=True)
    return (counts, counts_at, homes), rows[folded]



MESH_WORLD_MAX = 4  # ranks of the mesh28 phase: one per card, at most four
MESH_TIMEOUT_S = 420.0  # a collective that waits this long fails; the phase's deadline
MESH_CHAIN20_MAXITER = 10
MESH_FLEET_MAXITER = 40  # fleet12's 8 starts, cut from 150 iterations
TOL_MESH_F = 1e-4  # a sharded fobj vs the replicated one (f32 sketch noise)
TOL_MESH_G = 1e-3  # relative l2 of the chain gradient vs the replicated one
TOL_MESH_TP = 1e-5  # the sharded statevector vs the replicated one (c64)


@contextmanager
def gather_spy():
    """Counts ``torch.distributed.all_gather`` calls and the elements each
    rank contributes to each."""
    import torch.distributed as dist

    original, seen = dist.all_gather, []

    def spy(outputs, tensor, *args, **kwargs):
        seen.append(int(tensor.numel()))
        return original(outputs, tensor, *args, **kwargs)

    dist.all_gather = spy
    try:
        yield seen
    finally:
        dist.all_gather = original


def _mps_payload(case) -> dict:
    t = case["target"]
    return {"x0": case["x0"].cpu().numpy(), "gammas": t.gammas.cpu().numpy(), "lambdas": t.lambdas.cpu().numpy(),
            "base_bits": case["base_bits"], "trunc_thr": case["trunc_thr"], "layers": case["layers"],
            "chi": case["chi"], "maxiter": case["maxiter"], "f_rand": case.get("fobj_rand")}


def _mesh_case(payload: dict, dev):
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.ops.mps import MPS

    n = payload["gammas"].shape[0]
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, payload["layers"]), True)
    target = MPS(torch.as_tensor(payload["gammas"], device=dev), torch.as_tensor(payload["lambdas"], device=dev))
    return circ, torch.as_tensor(payload["x0"], device=dev), target


def _mesh_pair_sharded(payload, mesh_tp, ax_tp, dev):
    """(a) phase 7's 28q χ=128 horizon with every half-layer sharded over tp."""
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.ops import mps as mpsop
    from aqc_research_tpu_torch.parallel.comm import all_gather

    circ, x0, target = _mesh_case(payload, dev)
    bits, thr, chi = tuple(payload["base_bits"]), payload["trunc_thr"], payload["chi"]
    _, value_and_grad = jit_asp._mps_value_fns(circ, bits, thr)
    mpsop.set_pair_sharding(mesh_tp, "tp")
    try:
        value_and_grad(x0, target)  # warm-up
        torch.cuda.synchronize()
        with gather_spy() as gathers:
            tic = time.perf_counter()
            value_and_grad(x0, target)
            torch.cuda.synchronize()
            sweep_s = time.perf_counter() - tic
        jit_asp.watchdog_events.clear()
        reset_counts()
        tic = time.perf_counter()
        res = jit_asp.optimize_horizon_mps_jit(circ, x0, target, base_bits=bits, trunc_thr=thr,
                                               maxiter=payload["maxiter"])
        fobj = float(res.fobj)
        torch.cuda.synchronize()
        horizon_s = time.perf_counter() - tic
        counts = (read_counts(), read_counts_at(), read_counts_home())
        rows = all_gather(torch.cat([res.thetas.reshape(-1), res.fobj.reshape(1).to(res.thetas.dtype)]), ax_tp)
    finally:
        mpsop.set_pair_sharding(None)
    tic = time.perf_counter()
    f_check = f64_objective(circ, res.thetas, target, bits, thr, dev)
    check_s = time.perf_counter() - tic
    whole_gamma = circ.num_qubits * 2 * chi * chi * 2  # the whole Γ as reals
    per_pair = 8 * chi * chi + chi  # Γ_lo, Γ_hi (reals) and λ' of one pair
    check(all(bool(torch.equal(rows[0], r)) for r in rows), "pair-sharded θ/fobj differ across ranks")
    check(abs(fobj - payload["f_rand"]) <= TOL_MESH_F,
          f"pair-sharded fobj {fobj} vs phase 7's unsharded {payload['f_rand']}")
    check(abs(f_check - fobj) <= TOL_FINAL, f"pair-sharded fobj {fobj} vs its c128 re-evaluation {f_check}")
    check(counts[0]["theta_build"] > 0 and counts[0]["rand_tail"] > 0, f"K2/K3 not launched: {counts[0]}")
    check(not jit_asp.watchdog_events, f"watchdog fired: {jit_asp.watchdog_events}")
    most = -(-(circ.num_qubits // 2) // ax_tp.size) * per_pair  # a rank's share of a full half-layer
    check(gathers and max(gathers) <= most, f"an all_gather moved more than the updated slices: {gathers}")
    return {"fobj": fobj, "f_unsharded": payload["f_rand"], "diff": abs(fobj - payload["f_rand"]),
            "f_check": f_check, "check_s": check_s, "iters": int(res.num_iters), "horizon_s": horizon_s,
            "s_per_iter": horizon_s / max(int(res.num_iters), 1), "sweep_s": sweep_s, "gathers": len(gathers),
            "gather_elements_max": max(gathers), "gather_elements_sum": sum(gathers), "whole_gamma": whole_gamma,
            "counts": counts}


def _mesh_chain(payload28, payload20, mesh_sp, dev):
    """(b) the chain-sharded obj+grad at 28q χ=128 against the replicated
    value_and_grad, then a 20q χ=64 chain horizon against the replicated
    one (the same compact L-BFGS)."""
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.ops import mps as mpsop
    from aqc_research_tpu_torch.ops.mps_gradient import fast_dot_gradient
    from aqc_research_tpu_torch.optim.lbfgs import minimize_lbfgs_compact
    from aqc_research_tpu_torch.parallel import mps_chain as mc

    out = {}
    circ, x0, target = _mesh_case(payload28, dev)
    bits, thr = tuple(payload28["base_bits"]), payload28["trunc_thr"]
    _, value_and_grad = jit_asp._mps_value_fns(circ, bits, thr)
    f_r, g_r = value_and_grad(x0, target)
    lvec = mpsop.mps_basis_state(bits, target.chi, target.gammas.dtype, dev)
    cl, cphi = mc.chain_from_mps(lvec, mesh_sp, axis="sp"), mc.chain_from_mps(target, mesh_sp, axis="sp")
    mc.chain_asp_objective_and_gradient(circ, x0, cl, cphi, mesh_sp, axis="sp", trunc_thr=thr)  # warm-up
    torch.cuda.synchronize()
    tic = time.perf_counter()
    f_c, g_c = mc.chain_asp_objective_and_gradient(circ, x0, cl, cphi, mesh_sp, axis="sp", trunc_thr=thr)
    torch.cuda.synchronize()
    out["sweep_s"] = time.perf_counter() - tic
    out["bytes"] = mc.chain_bytes_per_device(cphi, mesh_sp, axis="sp")
    out["f_diff"] = abs(float(f_c) - float(f_r))
    out["g_rel"] = rel_err(g_c, g_r)
    check(out["f_diff"] <= TOL_MESH_F and out["g_rel"] <= TOL_MESH_G,
          f"chain obj+grad vs replicated: fobj {float(f_c)} vs {float(f_r)}, gradient rel {out['g_rel']:.3g}")

    circ, x0, phi = _mesh_case(payload20, dev)
    bits, thr = tuple(payload20["base_bits"]), payload20["trunc_thr"]
    lvec = mpsop.mps_basis_state(bits, phi.chi, phi.gammas.dtype, dev)

    def value(x):
        vh = mpsop.v_dagger_mul_mps_layers(circ, x, phi, trunc_thr=thr)[0]
        return (1.0 - mpsop.mps_dot(lvec, vh).abs() ** 2).to(x.dtype)

    def vgrad(x):
        vh = mpsop.v_dagger_mul_mps_layers(circ, x, phi, trunc_thr=thr)[0]
        dot = mpsop.mps_dot(lvec, vh)
        g = fast_dot_gradient(circ, x, lvec, vh, trunc_thr=thr)
        return (1.0 - dot.abs() ** 2).to(x.dtype), (-2.0 * dot.conj() * g).real.to(x.dtype)

    tic = time.perf_counter()
    res_c = mc.chain_optimize_horizon(circ, x0, mc.chain_from_mps(lvec, mesh_sp, axis="sp"),
                                      mc.chain_from_mps(phi, mesh_sp, axis="sp"), mesh_sp, axis="sp",
                                      trunc_thr=thr, maxiter=MESH_CHAIN20_MAXITER)
    torch.cuda.synchronize()
    out["chain20_s"] = time.perf_counter() - tic
    tic = time.perf_counter()
    res_r = minimize_lbfgs_compact(value, x0, maxiter=MESH_CHAIN20_MAXITER, value_and_grad_fn=vgrad)
    torch.cuda.synchronize()
    out["repl20_s"] = time.perf_counter() - tic
    out.update(f20_start=float(value(x0)), f20_chain=float(res_c.fobj), f20_repl=float(res_r.fobj),
               iters20=(int(res_c.num_iters), int(res_r.num_iters)))
    check(abs(out["f20_chain"] - out["f20_repl"]) <= TOL_MESH_F and out["f20_chain"] < out["f20_start"],
          f"20q chain horizon {out['f20_chain']} vs replicated {out['f20_repl']} (start {out['f20_start']})")
    return out


def _mesh_tp_and_fleet(mesh_tp, mesh_dp, ax_tp, dev):
    """(c) bench.py's 12q flagship V† on the tp-sharded state; (d) fleet12's
    8 starts sharded over dp against the unsharded fleet."""
    from aqc_research_tpu_torch.circuit.ansatz import TrotterAnsatz
    from aqc_research_tpu_torch.circuit.structures import make_trotter_like_circuit
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.ops.statevector import v_dagger_mul_vec
    from aqc_research_tpu_torch.parallel.comm import all_gather
    from aqc_research_tpu_torch.parallel.mesh import shard_state
    from aqc_research_tpu_torch.parallel.multistart import multistart_minimize
    from aqc_research_tpu_torch.parallel.statevector_tp import v_dagger_mul_vec_tp
    from aqc_research_tpu_torch.targets import trotter as trotop

    out = {}
    circ, thetas, target, _ = dense_flagship(dev, torch.complex64)
    th = torch.tensor(thetas, dtype=torch.float32, device=dev)
    tic = time.perf_counter()
    local = v_dagger_mul_vec_tp(circ, th, shard_state(target, mesh_tp, "tp"), mesh_tp, "tp")
    full = all_gather(local, ax_tp).reshape(-1)
    torch.cuda.synchronize()
    out["tp_s"] = time.perf_counter() - tic
    out["tp_err"] = float((full - v_dagger_mul_vec(circ, th, target)).abs().max())
    check(out["tp_err"] <= TOL_MESH_TP, f"tp statevector vs replicated: {out['tp_err']:.3g}")

    n = FLEET_QUBITS
    circ = TrotterAnsatz.make(n, make_trotter_like_circuit(n, FLEET_LAYERS), True)
    thetas0 = trotop.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=1.2, delta=1.0)
    batch = thetas0[None, :] + 0.2 * np.random.default_rng(FLEET_SEED).standard_normal((FLEET_STARTS, circ.num_thetas))
    xb = torch.tensor(batch, dtype=torch.float32, device=dev)
    ini = trotop.neel_init_state(n)
    tgt = trotop.Trotter(num_qubits=n, evol_time=1.2, num_steps=6, delta=1.0, second_order=True).as_vector(
        ini, dtype=torch.complex64, device=dev)
    loss = jit_asp.make_surrogate_loss(circ, jit_asp.flip_state_indices(n, ini))
    tic = time.perf_counter()
    sharded = multistart_minimize(lambda x: loss(x, tgt), xb, maxiter=MESH_FLEET_MAXITER, mesh=mesh_dp)
    torch.cuda.synchronize()
    out["fleet_s"] = time.perf_counter() - tic
    alone = multistart_minimize(lambda x: loss(x, tgt), xb, maxiter=MESH_FLEET_MAXITER)
    out["fleet_lane_diff"] = float((sharded.fobj - alone.fobj).abs().max())
    out["fleet_best"] = (sharded.best_index, float(sharded.fobj.min()))
    check(out["fleet_lane_diff"] <= TOL_MESH_F and sharded.best_index == alone.best_index,
          f"sharded fleet vs unsharded: lanes differ by {out['fleet_lane_diff']:.3g}")
    return out


def _mesh_rank(rank: int, world: int, port: int, payload28: dict, payload20: dict, results) -> None:
    """One rank of the mesh28 phase: joins the NCCL group, loads the kernel
    library phase 1 built, runs checks (a)-(d) and sends its numbers back."""
    import traceback

    os.environ["LOCAL_RANK"] = str(rank)
    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import torch.distributed as dist

        from aqc_research_tpu_torch import config
        from aqc_research_tpu_torch.parallel import distributed as td
        from aqc_research_tpu_torch.parallel.comm import axis_of

        config.set_precision("fast")
        config.set_svd_impl(None)
        config.require_full_f32_matmul()
        check(td.initialize_distributed(f"127.0.0.1:{port}", world, rank, timeout_s=MESH_TIMEOUT_S),
              "the process group did not start")
        dev = torch.device("cuda", torch.cuda.current_device())
        td.build_kernels_once()
        mesh_tp = td.global_mesh((world,), ("tp",))
        mesh_sp = td.global_mesh((world,), ("sp",))
        mesh_dp = td.global_mesh((world,), ("dp",))
        walls, out = {}, {"backend": dist.get_backend(), "device": str(dev)}
        tic = time.perf_counter()
        out["a"] = _mesh_pair_sharded(payload28, mesh_tp, axis_of(mesh_tp, "tp"), dev)
        walls["a"] = time.perf_counter() - tic
        tic = time.perf_counter()
        out["b"] = _mesh_chain(payload28, payload20, mesh_sp, dev)
        walls["b"] = time.perf_counter() - tic
        tic = time.perf_counter()
        out["cd"] = _mesh_tp_and_fleet(mesh_tp, mesh_dp, axis_of(mesh_tp, "tp"), dev)
        walls["cd"] = time.perf_counter() - tic
        out["walls"] = walls
        results.put((rank, True, out))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def phase_mesh28(case28, case20):
    """The multi-GPU engines on one NCCL process per card (at most four):
    (a) phase 7's horizon pair-sharded, (b) the chain-sharded obj+grad at
    28q and a 20q chain horizon, (c) the tp-sharded statevector, (d) the
    dp-sharded fleet.  A rank that fails or hangs fails the phase."""
    import multiprocessing
    import queue
    import socket

    tic = time.perf_counter()
    world = min(torch.cuda.device_count(), MESH_WORLD_MAX)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    payload28, payload20 = _mps_payload(case28), _mps_payload(case20)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, port, payload28, payload20, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + MESH_TIMEOUT_S
    try:
        while len(got) < world:
            try:
                rank, ok, val = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise SmokeFailure(f"mesh28: ranks {sorted(set(range(world)) - set(got))} sent nothing within "
                                   f"{MESH_TIMEOUT_S:.0f} s") from None
            check(ok, f"mesh28 rank {rank} failed:\n{val}")
            got[rank] = val
        for p in procs:
            p.join(timeout=60)
            check(p.exitcode == 0, f"mesh28: a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    r0 = got[0]
    a, b, cd = r0["a"], r0["b"], r0["cd"]
    check(r0["backend"] == "nccl", f"mesh28 ran on {r0['backend']}, not NCCL")
    one = ("one rank: every check runs the sharded code on a group of one — the pair axis unsplit (one "
           "all_gather of each whole half-layer), the chain in one block (m = 28), no qubit sharded (no "
           "exchange), one dp rank with all 8 lanes" if world == 1 else f"{world} ranks")
    print(f"[mesh28] world {world}, backend {r0['backend']} ({one}) | (a) pair-sharded 28q chi=128 rand "
          f"horizon: fobj {a['fobj']:.7g} vs phase 7's unsharded {a['f_unsharded']:.7g} (diff {a['diff']:.3g}), "
          f"c128 re-eval {a['f_check']:.7g} ({a['check_s']:.1f} s), {a['iters']} iters, {a['horizon_s']:.2f} s = "
          f"{a['s_per_iter']:.3f} s/iter, one sharded obj+grad {a['sweep_s']:.3f} s with {a['gathers']} all_gathers "
          f"(max {a['gather_elements_max']} elements per rank, {a['gather_elements_sum']} in all; the whole Γ is "
          f"{a['whole_gamma']}), θ and fobj bitwise equal on every rank, launches {a['counts'][0]} | (b) chain "
          f"obj+grad 28q chi=128 over sp={world}: {b['sweep_s']:.3f} s, fobj diff {b['f_diff']:.3g}, gradient rel "
          f"{b['g_rel']:.3g}, state bytes per rank {b['bytes'][0]} of {b['bytes'][1]}; 20q chi=64 chain horizon "
          f"(maxiter {MESH_CHAIN20_MAXITER}) {b['f20_start']:.6g} -> {b['f20_chain']:.7g} vs replicated "
          f"{b['f20_repl']:.7g}, iters {b['iters20']}, {b['chain20_s']:.1f} / {b['repl20_s']:.1f} s | (c) tp "
          f"statevector 12q V†: max err {cd['tp_err']:.3g}, {cd['tp_s']:.3f} s | (d) fleet12 over dp={world} "
          f"(maxiter {MESH_FLEET_MAXITER}): lanes within {cd['fleet_lane_diff']:.3g} of the unsharded fleet, best "
          f"{cd['fleet_best']}, {cd['fleet_s']:.1f} s | rank 0 walls (a) {r0['walls']['a']:.1f} s, (b) "
          f"{r0['walls']['b']:.1f} s, (c+d) {r0['walls']['cd']:.1f} s, phase {time.perf_counter() - tic:.1f} s",
          flush=True)
    return a["counts"]


def mesh28_alone():
    """Phases 1, 7 and 9 alone (the kernel build, phase 7's horizon, the
    mesh28 phase): ``python3 -c "import sys; sys.path.insert(0, '.');
    import chip_smoke as cs; cs.mesh28_alone()"``."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_device()
    case20 = make_case(dev, 20, PATH_CHI, maxiter=10, f64_device="cpu")
    case28 = make_case(dev, 28, PATH28_CHI, maxiter=10, f64_device=dev)
    phase_rand(case28, "rand28")
    return phase_mesh28(case28, case20)


KERNELS = (
    ("jacobi_rows", "aqc_research_tpu_torch/csrc/jacobi_rows.cu",
     "aqc_research_tpu/ops/pallas_jacobi.py:244", "jacobi20"),
    ("theta_build", "aqc_research_tpu_torch/csrc/theta_build.cu",
     "aqc_research_tpu/ops/fused_pair.py:327", "rand20"),
    ("rand_tail", "aqc_research_tpu_torch/csrc/rand_tail.cu",
     "aqc_research_tpu/ops/fused_rand.py:164", "rand20"),
    ("fused_pair", "aqc_research_tpu_torch/csrc/fused_pair.cu",
     "aqc_research_tpu/ops/fused_pair.py:238", "jacobi28"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tic = time.perf_counter()
    try:
        card_line = phase_device()
        stats = {"jacobi_rows": phase_kernel(dev)}
        stats["theta_build"], stats["rand_tail"] = phase_rand_kernels(dev)
        stats["fused_pair"] = phase_fused(dev)
        paths = {}
        case20 = make_case(dev, 20, PATH_CHI, maxiter=10, f64_device="cpu")
        paths["jacobi20"] = phase_slice(case20, "slice")
        paths["rand20"] = phase_rand(case20, "rand")
        phase_routes(case20, "routes", ("rand", "jacobi"), repeats=1, calls=5)
        paths["driver20"] = phase_driver()
        paths["host20"] = phase_host(card_line, dev)
        paths["dense12"] = phase_dense(dev)
        paths["aqc5"] = phase_aqc(dev)
        paths["fleet12"] = phase_fleet_dense(dev)
        paths["fleet20"], folded = phase_fleet_mps(dev, card_line)
        for name in ("theta_build", "rand_tail"):
            stats[name]["shapes"].append(folded[name])
        case = make_case(dev, 28, PATH28_CHI, maxiter=10, f64_device=dev)
        paths["jacobi28"] = phase_slice(case, "slice28")
        paths["rand28"] = phase_rand(case, "rand28")
        phase_routes(case, "routes28", ("rand", "jacobi", "unfused"), repeats=1, calls=3)
        paths["mesh28"] = phase_mesh28(case, case20)
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as exc:
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(f"[wall] {time.perf_counter() - tic:.1f} s from the device phase to the last check", flush=True)
    # Each kernel's launches come from the path it belongs to (K1 the 20q
    # jacobi horizon, K2 and K3 the 20q rand horizon, K4 the 28q jacobi
    # horizon); every path's counts, in total, by pair size n = 2χ and (K1,
    # K3) by plane home, are in launches_per_path.
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": paths[own][0][name],
         "launches_per_path": {path: {"total": counts[name], "by_n": counts_at[name],
                                      **({"by_home": homes[name]} if name in homes else {})}
                               for path, (counts, counts_at, homes) in paths.items()},
         **stats[name]}
        for name, source, replaces, own in KERNELS
    ]}
    print(json.dumps(record))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
