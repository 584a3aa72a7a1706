#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain-torch twin, then drives one ASP
horizon of the 20-qubit χ=64 MPS configuration on the jacobi route and one
on the default (rand) route.

Usage:  python3 chip_smoke.py        (from the root of a checkout; one card)

Phases, one line each:
  1. device   — the card's name and power limit; build and load the kernels
                (one nvcc per source, all started together).
  2. kernel   — K1 jacobi_rows vs plain twin at B=10, c=r in {8..128}:
                singular values, reconstruction, orthogonality, sweep counts;
                then timed at B=10, 128x128 with CUDA events beside its twin
                and torch.linalg.svd.
  2b. kernels — K2 theta_build and K3 rand_tail vs their plain twins at
                B=10, χ in {8, 16, 32, 64, 96} on rand-route inputs (graded
                bond values); timed at B=10, χ=64 beside their twins and a
                library call; rand_tail must refuse χ=128.
                Also the range-finder on zero-padded pair matrices, where
                torch's batched CUDA QR returns NaN.
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
The last three lines are the kernel record, the card's name and power limit,
and ``{"ok": true, "device": ...}``.  Exits non-zero, printing no result,
when CUDA is missing or any check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
SHAPES = (8, 16, 32, 64, 128)
RAND_CHIS = (8, 16, 32, 64, 96)
PATH_CHI = 64
BATCH = 10
MAX_SWEEPS = 12
CRITERIA = ("hybrid", "entry")  # the port's default first
# Tolerances of the kernel-vs-twin checks, relative to s_max / ||m||_F: the
# f32 Jacobi's convergence floor is 1e-6 * s_max per entry.
TOL_S = 1e-5
TOL_RECON = 2e-5
TOL_ORTH = 1e-5
TOL_THETA = 1e-5  # θ build, per-matrix relative Frobenius (f32, two orders)
TOL_PROJ = 2e-5  # kept vh projector of the rand tail
# The rand tail's truncation thresholds: the slice's, and a coarse one whose
# cut sits far above the f32 noise of the unseen remainder.
TAIL_THRESHOLDS = (1e-6, 1e-2)
# Route vs native objective at the same iterate: f32 decompositions.
TOL_ROUTES = 1e-4
# Final objective vs its f64 LAPACK re-evaluation: f32 engine + decomposition
# noise (7.2e-5 measured on an H100 at this iterate); the collapse class the
# check exists for is O(1).
TOL_FINAL = 3e-4
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
    """Median device time of ``fn`` over ``runs`` calls, by CUDA events."""
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


def kernel_counters():
    from aqc_research_tpu_torch.ops.fused_pair import theta_build
    from aqc_research_tpu_torch.ops.fused_rand import rand_tail
    from aqc_research_tpu_torch.ops.jacobi_kernel import jacobi_rows

    return {"jacobi_rows": jacobi_rows, "theta_build": theta_build, "rand_tail": rand_tail}


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def phase_device():
    from aqc_research_tpu_torch.ops import cuda_build

    card = subprocess.run(CARD_QUERY, capture_output=True, text=True, timeout=60, check=True)
    card_line = card.stdout.strip().splitlines()[0]
    tic = time.perf_counter()
    lib = cuda_build.build_kernel_library()
    cuda_build.load()
    build_s = time.perf_counter() - tic
    ptxas = [ln.strip() for ln in lib.with_suffix(".ptxas.txt").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[device] {torch.cuda.get_device_name(0)} | {card_line} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | kernels built+loaded in {build_s:.2f} s | "
          f"ptxas: {' ; '.join(ptxas)}", flush=True)
    return card_line


def _factor(w_re, w_im, m):
    """(s, u, vh) of the full factorization from the rotated rows."""
    from aqc_research_tpu_torch.ops.jacobi_kernel import _sort_guard_top_k

    n = m.shape[-1]
    w, s, inv = _sort_guard_top_k(w_re, w_im, n, m.dtype)
    u = (w * inv[..., :, None].to(w.dtype)).transpose(-1, -2)
    vh = inv[..., :, None].to(u.dtype) * torch.matmul(u.conj().transpose(-1, -2), m)
    return s, u, vh


def phase_kernel(dev, shapes=SHAPES):
    from aqc_research_tpu_torch.ops.jacobi_kernel import jacobi_rows, jacobi_rows_reference

    rng = np.random.default_rng(1234)
    max_err = 0.0
    worst = {}
    for n, criterion in ((n, c) for n in shapes for c in CRITERIA):
        if criterion == CRITERIA[0]:
            m = torch.tensor(graded_matrices(rng, BATCH, n), device=dev)
            mt = m.transpose(-1, -2)
            re, im = mt.real.contiguous(), mt.imag.contiguous()
        k_re, k_im, k_sw = jacobi_rows(re, im, MAX_SWEEPS, criterion)
        p_re, p_im, p_sw = jacobi_rows_reference(re, im, MAX_SWEEPS, criterion)
        torch.cuda.synchronize()
        ks, ku, kvh = _factor(k_re, k_im, m)
        ps, pu, _ = _factor(p_re, p_im, m)
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
        worst[(n, criterion)] = (err_s, err_rec, err_orth, orth(pu), d_sweeps, k_sw.tolist())
        max_err = max(max_err, err_s)
        at = f"n={n} {criterion}"
        check(np.isfinite(err_s) and err_s <= TOL_S, f"{at}: |ds|/s_max {err_s:.3g} > {TOL_S}")
        check(err_rec <= TOL_RECON, f"{at}: reconstruction {err_rec:.3g} > {TOL_RECON}")
        check(err_orth <= TOL_ORTH, f"{at}: orthogonality {err_orth:.3g} > {TOL_ORTH}")
        check(d_sweeps <= 1, f"{at}: sweep counts differ by {d_sweeps} "
                             f"(kernel {k_sw.tolist()}, plain {p_sw.tolist()})")

    n = shapes[-1]
    m = torch.tensor(graded_matrices(rng, BATCH, n), device=dev)
    mt = m.transpose(-1, -2)
    re, im = mt.real.contiguous(), mt.imag.contiguous()
    sweeps = jacobi_rows(re, im, MAX_SWEEPS)[2].cpu().numpy()
    ms = median_ms(lambda: jacobi_rows(re, im, MAX_SWEEPS))
    plain_ms = median_ms(lambda: jacobi_rows_reference(re, im, MAX_SWEEPS))
    library_ms = median_ms(lambda: torch.linalg.svd(m, full_matrices=False))
    bound_ms, bound_by = bound(jacobi_flops(n, n, sweeps), 4 * 4 * BATCH * n * n + 4 * BATCH)
    detail = "; ".join(
        f"c=r={n} {crit}: ds {e[0]:.2e} rec {e[1]:.2e} orth {e[2]:.2e} (plain {e[3]:.2e}) "
        f"dsweeps {e[4]} sweeps {e[5]}"
        for (n, crit), e in worst.items()
    )
    print(f"[kernel] jacobi_rows vs plain twin, B={BATCH}: {detail} | B={BATCH} {n}x{n} "
          f"({CRITERIA[0]}, sweeps {sweeps.tolist()}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.linalg.svd {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
          f"(CUDA events, median of 20)", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_rand_kernels(dev):
    """K2 and K3 against their plain twins on the card, then timed."""
    from aqc_research_tpu_torch.kernel_checks import near_threshold, padded_pair_batch, path_planes
    from aqc_research_tpu_torch.ops import rand_svd
    from aqc_research_tpu_torch.ops.fused_pair import theta_build, theta_build_reference
    from aqc_research_tpu_torch.ops.fused_rand import rand_tail, rand_tail_reference

    rng = np.random.default_rng(4321)
    err_theta, err_lam, details = 0.0, 0.0, []
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
        for trunc_thr in TAIL_THRESHOLDS:
            thr2 = trunc_thr**2
            kv_re, kv_im, k_lam, _, k_sw = rand_tail(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS)
            pv_re, pv_im, p_lam, _, p_sw = rand_tail_reference(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS)
            torch.cuda.synchronize()
            smax = float(p_lam.max())
            d_lam = float((k_lam - p_lam).abs().max())
            err_lam = max(err_lam, d_lam)
            k_keep, p_keep = k_lam > 0, p_lam > 0
            near = near_threshold(s_b, tot2, thr2, chi)
            differ = k_keep != p_keep
            both = (k_keep & p_keep)[..., None].to(torch.complex64)
            kv = torch.complex(kv_re, kv_im) * both
            pv = torch.complex(pv_re, pv_im) * both
            d_proj = float((kv.conj().transpose(-1, -2) @ kv - pv.conj().transpose(-1, -2) @ pv).abs().max())
            d_sweeps = int((k_sw - p_sw).abs().max())
            flips[trunc_thr] += int(differ.sum())
            allowed[trunc_thr] += int(near.sum())
            values[trunc_thr] += near.numel()
            at = f"rand_tail chi={chi} thr={trunc_thr:g}"
            check(np.isfinite(d_lam) and d_lam <= TOL_S * smax, f"{at}: |dlam| {d_lam:.3g} > {TOL_S} s_max")
            check(not bool((differ & ~near).any()), f"{at}: keep masks differ away from the threshold")
            check(d_proj <= TOL_PROJ, f"{at}: kept vh projector differs by {d_proj:.3g}")
            check(d_sweeps <= 1, f"{at}: sweep counts differ by {d_sweeps} "
                                 f"(kernel {k_sw.tolist()}, plain {p_sw.tolist()})")
            details.append(f"chi={chi} thr={trunc_thr:g}: dlam {d_lam / smax:.2e} proj {d_proj:.2e} "
                           f"kept {int(k_keep.sum())}/{int(p_keep.sum())} dsweeps {d_sweeps}")
        details.append(f"chi={chi} theta rel {e_theta:.2e}")

    big = torch.zeros((1, 136, 256), device=dev)
    try:
        rand_tail(big, big, torch.ones(1, device=dev), 1e-12, 128)
    except ValueError as exc:
        check("shared memory" in str(exc), f"rand_tail refused chi=128 for another reason: {exc}")
    else:
        raise SmokeFailure("rand_tail took the chi=128 shape it cannot hold")

    # The range-finder on pair matrices in the θ layout's zero padding
    # (bonds of rank 4 of χ=64): torch's batched CUDA QR returns NaN there.
    chi = PATH_CHI
    n, ell = 2 * chi, rand_svd.rand_ell(2 * chi, chi)
    pad = padded_pair_batch(rng, BATCH, n, 4)
    y = torch.matmul(pad.to(dev), rand_svd.sketch(BATCH, n, ell, pad.dtype, dev))
    batched_nan = int((~torch.isfinite(torch.view_as_real(torch.linalg.qr(y, mode="reduced")[0])))
                      .flatten(1).any(-1).sum())
    got = rand_svd._range_project(pad.to(dev), ell, rand_svd._POWER_ITERS)
    check(bool(torch.isfinite(torch.view_as_real(got)).all()), "range-finder: non-finite B on padded pairs")
    s_got = torch.linalg.svdvals(got).cpu()
    s_want = torch.linalg.svdvals(rand_svd._range_project(pad, ell, rand_svd._POWER_ITERS))
    d_pad = float((s_got - s_want).abs().max() / s_want.max())
    check(d_pad <= TOL_S, f"range-finder on padded pairs: |ds|/s_max {d_pad:.3g} vs LAPACK > {TOL_S}")

    # Timing at the path shape (B=10, χ=64), inputs as above.
    planes = path_planes(rng, BATCH, chi, dev)
    th_ms = median_ms(lambda: theta_build(*planes))
    th_plain = median_ms(lambda: theta_build_reference(*planes))
    gate, a_re, a_im, b_re, b_im = planes
    a_c = torch.complex(a_re, a_im)[:, :, None]  # [b, u, 1, x, a']
    b_c = torch.complex(b_re, b_im)[:, None]  # [b, 1, v, c, x]
    th_lib = median_ms(lambda: torch.matmul(b_c, a_c))  # the four products only
    th_flops = BATCH * (32.0 * chi**3 + 128.0 * chi**2)
    th_bytes = 4 * BATCH * (4 * 2 * chi * chi + 32 + 2 * n * n)
    th_bound, th_by = bound(th_flops, th_bytes)

    w_re, w_im = theta_build(*planes)
    a = torch.complex(w_re, w_im).transpose(-1, -2)
    bm = rand_svd._range_project(a, ell, rand_svd._POWER_ITERS)
    m_re, m_im = bm.real.contiguous(), (-bm.imag).contiguous()
    tot2 = (w_re * w_re + w_im * w_im).sum((-2, -1))
    thr2 = TAIL_THRESHOLDS[0] ** 2
    sweeps = rand_tail(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS)[4].cpu().numpy()
    tail_ms = median_ms(lambda: rand_tail(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS))
    tail_plain = median_ms(lambda: rand_tail_reference(m_re, m_im, tot2, thr2, chi, MAX_SWEEPS))
    tail_lib = median_ms(lambda: torch.linalg.svd(bm, full_matrices=False))
    tail_flops = jacobi_flops(ell, n, sweeps) + BATCH * 2.0 * chi * n
    tail_bytes = 4 * BATCH * (2 * ell * n + 1 + 2 * chi * n + 2 * chi + 1)
    tail_bound, tail_by = bound(tail_flops, tail_bytes)
    print(f"[kernels] theta_build and rand_tail vs plain twins, B={BATCH}: {'; '.join(details)} | "
          f"keep-mask flips / values near the threshold / values: "
          f"{'; '.join(f'thr {t:g}: {flips[t]} / {allowed[t]} / {values[t]}' for t in TAIL_THRESHOLDS)} | "
          f"rand_tail refuses chi=128 | range-finder on zero-padded pairs ({BATCH}x{n}x{n}, 8 nonzero "
          f"rows): batched torch.linalg.qr NaN in {batched_nan}/{BATCH} matrices, rand_svd._orth finite, "
          f"|ds|/s_max vs LAPACK {d_pad:.2e} | B={BATCH} chi={chi}: theta_build {th_ms:.4f} ms, plain {th_plain:.4f} ms, "
          f"batched matmul of the four products {th_lib:.4f} ms, bound {th_bound:.5f} ms ({th_by}); "
          f"rand_tail ({ell}x{n}, sweeps {sweeps.tolist()}) {tail_ms:.4f} ms, plain {tail_plain:.4f} ms, "
          f"torch.linalg.svd {tail_lib:.4f} ms, bound {tail_bound:.5f} ms ({tail_by}) "
          f"(CUDA events, median of 20)", flush=True)
    return (
        {"max_abs_err": err_theta, "ms": th_ms, "plain_ms": th_plain, "bound_ms": th_bound,
         "bound_by": th_by, "library_ms": th_lib},
        {"max_abs_err": err_lam, "ms": tail_ms, "plain_ms": tail_plain, "bound_ms": tail_bound,
         "bound_by": tail_by, "library_ms": tail_lib},
    )


def f64_objective(circ, thetas, target, base_bits, trunc_thr) -> float:
    """The objective at ``thetas`` in f64 with LAPACK on the host: the
    reference the slice's result is held against."""
    from aqc_research_tpu_torch import config
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp
    from aqc_research_tpu_torch.ops.mps import MPS

    cpu = torch.device("cpu")
    tgt = MPS(target.gammas.to(cpu, torch.complex128), target.lambdas.to(cpu, torch.float64))
    value, _ = jit_asp._mps_value_fns(circ, base_bits, trunc_thr)
    with config.svd_impl_override("native"):
        return float(value(thetas.to(cpu, torch.float64), tgt))


def run_horizon(case, route: str, f_native: float):
    """One horizon of ``case`` under the route in effect, checked as the
    slice's contract says; returns the line's numbers and the launches."""
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp

    circ, x0, target, base_bits, trunc_thr = (
        case[k] for k in ("circ", "x0", "target", "base_bits", "trunc_thr"))
    value, value_and_grad = jit_asp._mps_value_fns(circ, base_bits, trunc_thr)
    f_start = float(value(x0, target))
    check(abs(f_start - f_native) <= TOL_ROUTES,
          f"start objective: {route} {f_start} vs native {f_native}")

    jit_asp.watchdog_events.clear()
    reset_counts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    res = jit_asp.optimize_horizon_mps_jit(
        circ, x0, target, base_bits=base_bits, trunc_thr=trunc_thr, maxiter=10
    )
    fobj = float(res.fobj)
    torch.cuda.synchronize()
    horizon_s = time.perf_counter() - tic
    launches = read_counts()

    check(np.isfinite(fobj) and fobj < f_start, f"{route} horizon did not lower fobj: {f_start} -> {fobj}")
    check(not jit_asp.watchdog_events, f"watchdog fired: {jit_asp.watchdog_events}")
    check(res.thetas.shape == x0.shape and bool(torch.isfinite(res.thetas).all()),
          "non-finite or misshapen thetas")
    f_check = f64_objective(circ, res.thetas, target, base_bits, trunc_thr)
    check(abs(f_check - fobj) <= TOL_FINAL,
          f"final objective: {route} {fobj} vs f64 LAPACK re-evaluation {f_check}")

    line = (f"start fobj {route} {f_start:.7g} native {f_native:.7g} | horizon maxiter=10: "
            f"fobj {fobj:.7g} (f64 LAPACK re-eval {f_check:.7g}), {res.num_iters} iters, "
            f"{horizon_s:.2f} s = {horizon_s / max(res.num_iters, 1):.3f} s/iter, launches {launches}, "
            f"watchdog events {len(jit_asp.watchdog_events)}")
    return line, launches


def phase_slice(dev, num_qubits=20, chi=64, layers=4):
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
            "trunc_thr": trunc_thr}
    value, _ = jit_asp._mps_value_fns(circ, base_bits, trunc_thr)
    with config.svd_impl_override("native"):
        case["f_native"] = float(value(x0, targets.t1))

    line, launches = run_horizon(case, "jacobi", case["f_native"])
    check(launches["jacobi_rows"] > 0, "the jacobi horizon never launched the Jacobi kernel")
    check(launches["theta_build"] == 0 and launches["rand_tail"] == 0,
          f"the jacobi horizon launched rand-route kernels: {launches}")
    print(f"[slice] {num_qubits}q chi={chi} {layers}-layer Trotter ansatz ({circ.num_thetas} thetas), "
          f"fast/jacobi/{config.jacobi_criterion()}: targets {target_s:.2f} s "
          f"(fid(t1, t1_gt) {trotop.fidelity(targets.t1_gt, targets.t1):.6f}) | {line}", flush=True)
    return case, launches


def phase_rand(case):
    """Phase 3's horizon again, under the default route, which must be rand."""
    from aqc_research_tpu_torch import config

    config.set_svd_impl(None)
    route = config.svd_impl(case["target"].device)
    check(route == "rand", f"the default route on the card is {route!r}, not 'rand'")
    line, launches = run_horizon(case, route, case["f_native"])
    for name, count in launches.items():
        check(count > 0, f"the rand horizon never launched {name}: {launches}")
    print(f"[rand] same case, default route {route}/{config.jacobi_criterion()}: {line}", flush=True)
    return launches


def sweep_ms(value_and_grad, case, route: str, calls: int) -> float:
    """Mean host wall of ``calls`` objective+gradient sweeps at the start
    point under ``route``, ending in ``synchronize()``."""
    from aqc_research_tpu_torch.config import svd_impl_override

    with svd_impl_override(route):
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

    from aqc_research_tpu_torch.config import svd_impl_override

    before = read_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with svd_impl_override(route), torch.profiler.profile(activities=acts) as prof:
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


def phase_routes(case):
    """The rand and the jacobi sweep side by side in one process: warmed up,
    then timed in turns (rand, jacobi, jacobi, rand, twice; mean of 5 sweeps
    each), since host timings drift within a process; then one profiled
    sweep each."""
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp

    _, value_and_grad = jit_asp._mps_value_fns(case["circ"], case["base_bits"], case["trunc_thr"])
    routes = ("rand", "jacobi")
    for route in routes:
        sweep_ms(value_and_grad, case, route, 1)
    walls = {route: [] for route in routes}
    for route in 2 * (routes + routes[::-1]):
        walls[route].append(sweep_ms(value_and_grad, case, route, 5))
    parts = []
    for route in routes:
        p = profile_sweep(value_and_grad, case, route)
        top = ", ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in p["top"])
        parts.append(
            f"{route}: obj+grad {' / '.join(f'{1e3 / w:.3f}' for w in walls[route])} sweeps/s | profiled "
            f"sweep {p['wall_ms']:.1f} ms wall, device busy {p['busy_ms']:.1f} ms (idle {p['idle']:.1%}), "
            f"launches {p['launches']}, {p['aten_calls']} aten calls ({p['qr_calls']} linalg_qr); "
            f"top device: {top}")
    print("[routes] same case and start point, timed in turns (rand, jacobi, jacobi, rand) x 2: "
          + " || ".join(parts), flush=True)


KERNELS = (
    ("jacobi_rows", "aqc_research_tpu_torch/csrc/jacobi_rows.cu",
     "aqc_research_tpu/ops/pallas_jacobi.py:244"),
    ("theta_build", "aqc_research_tpu_torch/csrc/theta_build.cu",
     "aqc_research_tpu/ops/fused_pair.py:327"),
    ("rand_tail", "aqc_research_tpu_torch/csrc/rand_tail.cu",
     "aqc_research_tpu/ops/fused_rand.py:164"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        card_line = phase_device()
        stats = {"jacobi_rows": phase_kernel(dev)}
        stats["theta_build"], stats["rand_tail"] = phase_rand_kernels(dev)
        case, jacobi_launches = phase_slice(dev)
        rand_launches = phase_rand(case)
        phase_routes(case)
    except (SmokeFailure, ImportError, RuntimeError, ValueError) as exc:
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    # Each kernel's launches come from the path it belongs to: K1 from the
    # jacobi horizon, K2 and K3 from the rand horizon (both paths' counts
    # are in launches_per_path).
    own_path = {"jacobi_rows": jacobi_launches, "theta_build": rand_launches, "rand_tail": rand_launches}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": own_path[name][name],
         "launches_per_path": {"jacobi": jacobi_launches[name], "rand": rand_launches[name]},
         **stats[name]}
        for name, source, replaces in KERNELS
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
