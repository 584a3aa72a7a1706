#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain-torch twin, then drives ASP horizons
of the 20-qubit χ=64 and the 28-qubit χ=128 MPS configurations on the jacobi
route and on the default (rand) route, and the ASP driver over a schedule
of 20-qubit χ=64 horizons.

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
  6. slice28 — phase 3 at 28 qubits, χ=128 (BASELINE config 5): the jacobi
                route runs K4 for every pair update at χ=128 and K1 for the
                χ-growth heads; the final objective is re-evaluated in c128
                under "native" on the card.
  7. rand28   — the same horizon under the default route, "rand": K2 and K3
                (K3 at χ=64 and χ=128), K1 for the heads, K4 in the
                watchdog's "jacobi" re-check.
  8. routes28 — phase 5 at 28 qubits: rand, jacobi (K4) and jacobi with K4
                off (K1 at 256x256) in turns (rand, jacobi, unfused,
                unfused, jacobi, rand, twice; 3 sweeps each), then one
                profiled sweep each.
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

import functools
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


def profile_sweep(value_and_grad, case, route: str) -> dict:
    """One objective+gradient sweep under ``torch.profiler``: device busy
    time (the sum of the device-side events' own times: kernels, copies,
    fills), the idle share 1 - busy / wall of that call, each hand-written
    kernel's launches, the heaviest device kernels and the host's aten calls."""
    from torch.autograd import DeviceType

    before = read_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with route_override(route), torch.profiler.profile(activities=acts) as prof:
        tic = time.perf_counter()
        value_and_grad(case["x0"], case["target"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - tic)
    launches = {name: n - before[name] for name, n in read_counts().items()}
    events = prof.key_averages()

    def own_us(evt):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    device = sorted(((e.key, own_us(e), e.count) for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda t: -t[1])
    busy_ms = sum(t[1] for t in device) / 1e3
    check(busy_ms > 0, f"{route}: the profiler saw no device time")
    aten = {e.key: e.count for e in events if e.key.startswith("aten::")}
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": 1.0 - busy_ms / wall_ms, "launches": launches,
            "aten_calls": sum(aten.values()), "qr_calls": aten.get("aten::linalg_qr", 0),
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
        case = make_case(dev, 20, PATH_CHI, maxiter=10, f64_device="cpu")
        paths["jacobi20"] = phase_slice(case, "slice")
        paths["rand20"] = phase_rand(case, "rand")
        phase_routes(case, "routes", ("rand", "jacobi"), repeats=2, calls=5)
        paths["driver20"] = phase_driver()
        case = make_case(dev, 28, PATH28_CHI, maxiter=10, f64_device=dev)
        paths["jacobi28"] = phase_slice(case, "slice28")
        paths["rand28"] = phase_rand(case, "rand28")
        phase_routes(case, "routes28", ("rand", "jacobi", "unfused"), repeats=2, calls=3)
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
