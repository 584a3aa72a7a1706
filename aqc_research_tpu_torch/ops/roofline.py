"""Roofline accounting for the MPS engine on the card (twin of
``aqc_research_tpu/ops/roofline.py``).

It counts the work one production objective+gradient sweep executes and
holds the measured sweep against the attainable rates of the card it runs
on, measured there, and against the card's published peaks:

* :func:`decomposition_census` — the batched truncated-SVD phases of one
  obj+grad sweep (V† layer-cache sweep + z-free layered gradient) plus one
  forward value sweep, from the group structure the engine runs
  (``ops/mps_gradient._layered_plan``).
* :func:`sweep_flops` — the flop model, a count of the algorithm's work and
  so the JAX package's numbers whatever implements it: the one-sided Jacobi
  takes ~18·n² flop per Brent-Luk phase per matrix, (n-1) phases per sweep,
  times the ADAPTIVE sweep count; the pair update ~64·χ³ flop for the θ
  build and the vh recovery (8·χ³ complex MACs), the rand route also its
  range-finder.  :func:`matmul_units_for` says which unit of the card runs
  the pair update's products on each route (the CUDA cores inside K2 or K4,
  or cuBLAS/cuSOLVER).
* :func:`measure_attainable` — the attainable f32 FMA rate of the CUDA
  cores, the c64 ``torch.matmul`` rate with TF32 off and the HBM stream
  rate of the current device: the roofline denominators.  The first and
  the last come from the microkernels of ``csrc/attainable.cu``
  (:func:`fma_chain`, :func:`stream_passes`); each has its plain twin.
* ``python -m aqc_research_tpu_torch.ops.roofline [n] [chi] [layers]`` —
  measures a real sweep on the card (the CPU with ``AQC_TORCH_DEVICE=cpu``),
  captures the adaptive sweep counts on its real pair matrices and prints
  the roofline table; ``--predict`` prints the model-only prediction.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import config
from . import cuda_build

# Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W
# limit): f32 outside the tensor cores, and HBM3.
PEAK_F32_GFLOPS = 67_000.0
PEAK_HBM_GBPS = 3_350.0


# ------------------------------------------------------------------ census


def _chessboard_groups(circ) -> List[List[int]]:
    """Per-layer disjoint pair groups (lists of lo sites), mirroring
    ops/mps_gradient._layered_plan."""
    from .mps_gradient import _layered_plan

    return [[lo for _, lo in g] for g in _layered_plan(circ)]


def decomposition_census(circ, chi: int, grow: bool = True):
    """Every truncated-SVD phase of ONE production obj+grad sweep plus one
    forward value sweep, keyed by stage: lists of ``(batch, matrix_n)``.

    Stages (layered Trotter CX path — the production configuration):
      vdag  — ``v_dagger_mul_mps_layers``: trailing half-layer group, then
              per layer the two chessboard groups in reverse order; the z
              side is always at full chi (matrix_n = 2 chi).
      grad  — z-free layered gradient: per layer both groups applied to the
              w side only, plus the trailing half-layer w update.  With
              ``grow`` (χ-growth scheduling) the head phases run at
              matrix_n = 2·χ_p, χ_p = min(chi, 2^p).
      value — forward ``v_mul_mps_growing``: per layer both groups +
              trailing half, same χ-growth head.
    """
    groups = _chessboard_groups(circ)
    sizes = [len(g) for g in groups]
    layers = circ.num_blocks // circ.bpl
    half = [sizes[0]] if circ.half_layer_num_blocks else []

    vdag = [(b, 2 * chi) for b in half + list(reversed(sizes)) * layers]

    def growing(batches):
        out, chi_w = [], 1
        for b in batches:
            chi_w = min(chi, 2 * chi_w) if grow else chi
            out.append((b, 2 * chi_w))
        return out

    fwd = sizes * layers + half
    return {"vdag": vdag, "grad": growing(fwd), "value": growing(fwd)}


# ------------------------------------------------------------------ flops


def jacobi_kernel_flops(n: int, sweeps: float, batch: int) -> float:
    """Flops of the one-sided Jacobi: ~18 n^2 per phase per matrix (4
    pair-Gram reductions ~16·p·n plus 4 rotated planes ~20·p·n, p = n/2),
    (n-1) phases per sweep."""
    return 18.0 * n * n * (n - 1) * float(sweeps) * batch


def pair_update_matmul_flops(chi: int, batch: int) -> float:
    """Product flops per batched pair update outside the Jacobi: theta build
    (~4 chi^3 complex MACs) + vh recovery (~4 chi^3 complex MACs), at 8
    flops per complex MAC."""
    return 64.0 * chi**3 * batch


def _rand_active(n: int, impl: str) -> bool:
    if impl != "rand":
        return False
    from .rand_svd import RAND_MIN_N

    return n >= RAND_MIN_N


def kernel_flops_for(n: int, sweeps: float, batch: int, impl: str) -> float:
    """Jacobi flops per batched decomposition under ``impl``: the plain
    route orthogonalizes n columns of length n ((n-1) phases); the rand
    route runs the same loop on the projected (l, n) problem — l columns of
    length n, (l-1) phases (ops/rand_svd.py, K3)."""
    if not _rand_active(n, impl):
        return jacobi_kernel_flops(n, sweeps, batch)
    from .rand_svd import rand_ell

    ell = rand_ell(n, n // 2)
    return 18.0 * ell * n * (ell - 1) * float(sweeps) * batch


def matmul_flops_for(n: int, batch: int, impl: str) -> float:
    """Product flops per batched pair update under ``impl``.  The rand route
    swaps the vh recovery for a u recovery of the same cost and ADDS the
    range-finder: sketch + 1 power iteration (3 matmuls ~ 8 n^2 l each) and
    3 Householder QRs (~16 n l^2 each, complex)."""
    chi = n // 2
    if not _rand_active(n, impl):
        return pair_update_matmul_flops(chi, batch)
    from .rand_svd import rand_ell

    ell = rand_ell(n, chi)
    return (64.0 * chi**3 + 24.0 * n * n * ell + 48.0 * n * ell * ell) * batch


def matmul_units_for(n: int, batch: int, impl: str) -> Tuple[float, float]:
    """(CUDA-core flops, cuBLAS/cuSOLVER flops) of :func:`matmul_flops_for`
    as the card's dispatch runs a c64 pair update at matrix size n
    (ops/mps._pair_update under the current ``config`` overrides): on the
    jacobi route K4 (χ ≥ 96 by the auto rule) builds θ and recovers vh on
    the CUDA cores; on the fused rand route K2 builds θ there (32 χ³) and
    the u recovery and the range-finder run in cuBLAS/cuSOLVER; every other
    pair update builds θ and recovers its factor with torch products."""
    from .mps import _rand_route_update

    chi = n // 2
    total = matmul_flops_for(n, batch, impl)
    cuda = torch.device("cuda")
    if impl == "jacobi" and chi >= 8 and config.fused_pair_enabled(chi, cuda):
        return total, 0.0
    if impl == "rand" and _rand_route_update(chi, torch.complex64, cuda) == "fused":
        return 32.0 * chi**3 * batch, total - 32.0 * chi**3 * batch
    return 0.0, total


def sweep_flops(census, sweeps_by_stage, impl: str = "jacobi"):
    """(jacobi_flops, matmul_flops) of one obj+grad sweep + one value sweep
    given per-stage mean adaptive sweep counts ``sweeps_by_stage[stage]``."""
    vpu = mxu = 0.0
    for stage, phases in census.items():
        s = float(sweeps_by_stage[stage])
        for b, n in phases:
            vpu += kernel_flops_for(n, s, b, impl)
            mxu += matmul_flops_for(n, b, impl)
    return vpu, mxu


def sweep_matmul_units(census, impl: str = "jacobi") -> Tuple[float, float]:
    """(CUDA-core, cuBLAS) split of :func:`sweep_flops`'s matmul flops."""
    core = blas = 0.0
    for phases in census.values():
        for b, n in phases:
            c, x = matmul_units_for(n, b, impl)
            core += c
            blas += x
    return core, blas


def state_bytes(num_qubits: int, chi: int, itemsize: int = 8) -> float:
    """Resident MPS state bytes (gammas + lambdas, c64/f32)."""
    return num_qubits * 2 * chi * chi * itemsize + (num_qubits - 1) * chi * (
        itemsize // 2
    )


def sweep_hbm_bytes(census, itemsize: int = 8):
    """Bytes moved through HBM per sweep, assuming each phase reads and
    writes its pair slices + the theta matrix once (generous)."""
    return sum(
        b * 4 * n * n * itemsize
        for phases in census.values()
        for b, n in phases
    )


# ------------------------------------------------------- attainable rates

# The work of the JAX package's loops: an FMA chain over a 4 MB f32 block,
# 4000 iterations; a stream over 256 MB, 20 passes; 200 chained c64
# products of 1024 x 1024.
FMA_SHAPE, FMA_ITERS, FMA_A, FMA_B = (1024, 8, 128), 4000, 0.999, 0.001
STREAM_ELEMS, STREAM_PASSES, STREAM_A, STREAM_B = 64 * 1024 * 1024, 20, 1.0001, 1.0
MATMUL_N, MATMUL_ITERS = 1024, 200
# The CPU runs the plain twins on this fraction of each size and count: a
# CPU's rates are no device metric, the run only exercises the code.
CPU_CUT = 16
STREAM_BLOCKS_PER_SM = 8


def fma_chain_reference(x: torch.Tensor, iters: int = FMA_ITERS):
    """Plain twin of the FMA microkernel: ``iters`` steps of
    x <- FMA_A x + FMA_B (a multiply and an add, where the kernel rounds
    once per step)."""
    for _ in range(iters):
        x = FMA_A * x + FMA_B
    return x


def fma_chain(x: torch.Tensor, iters: int = FMA_ITERS) -> torch.Tensor:
    """``iters`` steps of x <- FMA_A x + FMA_B on every element of the f32
    tensor ``x`` (its element count a multiple of 8): CPU tensors run the
    plain twin, CUDA tensors the kernel ``fma_chain_kernel``
    (csrc/attainable.cu), each launch adding one to ``fma_chain.launches``;
    any other device raises, and so does a refused launch."""
    if x.device.type == "cpu":
        return fma_chain_reference(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"fma_chain: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() % 8:
        raise ValueError(f"fma_chain takes a contiguous f32 tensor of 8k elements, got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    cuda_build.launch("fma_chain_launch", cuda_build.device_index(x), x.data_ptr(), out.data_ptr(), x.numel(),
                      int(iters), FMA_A, FMA_B)
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


def stream_passes_reference(x: torch.Tensor, passes: int = STREAM_PASSES):
    """Plain twin of the stream microkernel: ``passes`` passes of
    x <- STREAM_A x + STREAM_B over the whole tensor."""
    for _ in range(passes):
        x = x * STREAM_A + STREAM_B
    return x


def stream_passes(x: torch.Tensor, passes: int = STREAM_PASSES) -> torch.Tensor:
    """``passes`` passes of x <- STREAM_A x + STREAM_B over the f32 tensor
    ``x`` (its element count a multiple of 4), each reading and writing every element
    once: CPU tensors run the plain twin, CUDA tensors the kernel
    ``stream_kernel`` (csrc/attainable.cu), each launch adding one to
    ``stream_passes.launches``; any other device raises, and so does a
    refused launch."""
    if x.device.type == "cpu":
        return stream_passes_reference(x, passes)
    if x.device.type != "cuda":
        raise ValueError(f"stream_passes: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() % 4:
        raise ValueError(f"stream_passes takes a contiguous f32 tensor of 4k elements, got {x.dtype} "
                         f"{tuple(x.shape)}")
    dev = cuda_build.device_index(x)
    out = torch.empty_like(x)
    cuda_build.launch("stream_launch", dev, x.data_ptr(), out.data_ptr(), x.numel(), int(passes), STREAM_A,
                      STREAM_B, STREAM_BLOCKS_PER_SM * cuda_build.sm_count(dev))
    stream_passes.launches += 1
    return out


stream_passes.launches = 0


def attainable_inputs(dev) -> Dict[str, torch.Tensor]:
    """The microbenchmarks' inputs on ``dev`` (seed 0), at the JAX loops'
    sizes on the card and cut by ``CPU_CUT`` on the CPU: the FMA block, the
    stream array, and the matmul's start matrix and fixed unitary factor
    (a product by a unitary keeps the chain finite at the same work as
    squaring)."""
    dev = torch.device(dev)
    cut = 1 if dev.type == "cuda" else CPU_CUT
    rng = np.random.default_rng(0)
    nm = MATMUL_N // cut
    m = rng.standard_normal((nm, nm)) + 1j * rng.standard_normal((nm, nm))
    q, _ = np.linalg.qr(rng.standard_normal((nm, nm)) + 1j * rng.standard_normal((nm, nm)))
    return {
        "fma": torch.as_tensor(rng.random(FMA_SHAPE)[: FMA_SHAPE[0] // cut], dtype=torch.float32, device=dev),
        "stream": torch.as_tensor(rng.random(STREAM_ELEMS // cut), dtype=torch.float32, device=dev),
        "mat": torch.as_tensor(m / np.sqrt(nm), dtype=torch.complex64, device=dev),
        "unitary": torch.as_tensor(q, dtype=torch.complex64, device=dev),
    }


def _per_call_s(fn, repeats: int, dev) -> float:
    """Seconds per call of ``fn`` over ``repeats`` calls after one warm-up:
    CUDA events around the queued calls on the card, the host clock on the
    CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / repeats
    tic = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - tic) / repeats


def measure_attainable(repeats: int = 20) -> Dict[str, float]:
    """Measured attainable rates of the current device — the roofline
    denominators.  Returns {vpu_gflops, mxu_gflops, hbm_gbps}, named as in
    the JAX package; on the card they are the CUDA cores' f32 FMA rate
    (:func:`fma_chain`), the c64 ``torch.matmul`` rate with TF32 off
    (``config.require_full_f32_matmul``; cuBLAS) and the HBM stream rate
    (:func:`stream_passes`).  On the CPU the plain twins run at the cut
    sizes of :func:`attainable_inputs`."""
    dev = config.device()
    if dev.type == "cuda":
        config.require_full_f32_matmul()
    cut = 1 if dev.type == "cuda" else CPU_CUT
    x = attainable_inputs(dev)
    iters, passes, mm_iters = FMA_ITERS // cut, max(STREAM_PASSES // cut, 1), MATMUL_ITERS // cut

    def chained():
        y = x["mat"]
        for _ in range(mm_iters):
            y = torch.matmul(y, x["unitary"])
        return y

    y = chained()
    if not bool(torch.isfinite(torch.view_as_real(y)).all()):
        raise RuntimeError("the chained complex products went non-finite")
    nm = x["mat"].shape[-1]
    rates = {
        "vpu_gflops": 2.0 * x["fma"].numel() * iters / _per_call_s(lambda: fma_chain(x["fma"], iters), repeats, dev),
        "mxu_gflops": 8.0 * nm**3 * mm_iters / _per_call_s(chained, repeats, dev),
        "hbm_gbps": passes * 2.0 * 4 * x["stream"].numel()
        / _per_call_s(lambda: stream_passes(x["stream"], passes), repeats, dev),
    }
    rates = {k: v / 1e9 for k, v in rates.items()}
    if not all(np.isfinite(v) and v > 0 for v in rates.values()):
        raise RuntimeError(f"non-positive attainable rates: {rates}")
    return rates


# ------------------------------------------------------------------ report


def _floors(census, sweeps_by_stage: Dict[str, float], attainable: Dict[str, float], impl: str):
    """Work and floors of one obj+grad sweep (the census's vdag and grad
    stages): flops per unit, HBM bytes, and the time each takes at the
    ``attainable`` rates and at the published peaks."""
    og = {k: v for k, v in census.items() if k in ("vdag", "grad")}
    jac, mm = sweep_flops(og, sweeps_by_stage, impl)
    mm_core, mm_blas = sweep_matmul_units(og, impl)
    hbm = sweep_hbm_bytes(og)
    t_core = (jac + mm_core) / (attainable["vpu_gflops"] * 1e9)
    t_blas = mm_blas / (attainable["mxu_gflops"] * 1e9)
    return {
        "og": og, "jac": jac, "mm": mm, "mm_core": mm_core, "mm_blas": mm_blas, "hbm": hbm,
        "t_core": t_core, "t_blas": t_blas, "t_hbm": hbm / (attainable["hbm_gbps"] * 1e9),
        # The kernels and the library products do not overlap in this design.
        "bound": t_core + t_blas,
        "peak_bound": (jac + mm_core + mm_blas) / (PEAK_F32_GFLOPS * 1e9),
        "peak_hbm": hbm / (PEAK_HBM_GBPS * 1e9),
    }


def roofline_numbers(
    num_qubits: int,
    chi: int,
    measured_sweep_s: float,
    sweeps_by_stage: Dict[str, float],
    attainable: Dict[str, float],
    census,
    impl: str = "jacobi",
) -> Dict[str, float]:
    """The report's numbers for one obj+grad sweep (the vdag and grad
    stages; the value stage is the linesearch's and is counted apart):
    work, floors at the measured attainable rates and at the published
    peaks, and each share of the measured sweep.  A share above 1 is a
    counting error, not a result."""
    f = _floors(census, sweeps_by_stage, attainable, impl)
    achieved = f["jac"] / measured_sweep_s / 1e9
    return {
        "jacobi_gflop": f["jac"] / 1e9, "matmul_gflop": f["mm"] / 1e9, "matmul_core_gflop": f["mm_core"] / 1e9,
        "matmul_blas_gflop": f["mm_blas"] / 1e9, "hbm_mb": f["hbm"] / 1e6,
        "state_mb": state_bytes(num_qubits, chi) / 1e6,
        "t_core_s": f["t_core"], "t_blas_s": f["t_blas"], "t_hbm_s": f["t_hbm"], "bound_s": f["bound"],
        "peak_bound_s": f["peak_bound"], "peak_hbm_s": f["peak_hbm"],
        "achieved_gflops": achieved,
        "share_core": achieved / attainable["vpu_gflops"],
        "share_core_peak": achieved / PEAK_F32_GFLOPS,
        "share_composite": f["bound"] / measured_sweep_s,
        "share_composite_peak": f["peak_bound"] / measured_sweep_s,
        "share_hbm": f["t_hbm"] / measured_sweep_s,
        "share_hbm_peak": f["peak_hbm"] / measured_sweep_s,
        "attainable_vs_peak_core": attainable["vpu_gflops"] / PEAK_F32_GFLOPS,
        "attainable_vs_peak_hbm": attainable["hbm_gbps"] / PEAK_HBM_GBPS,
    }


def roofline_report(
    num_qubits: int,
    chi: int,
    layers: int,
    measured_sweep_s: float,
    sweeps_by_stage: Dict[str, float],
    attainable: Dict[str, float],
    census,
    impl: str = "jacobi",
    *,
    card: str = "not measured",
    sweeps_max: Dict[str, int] | None = None,
) -> str:
    """Markdown roofline table for one (obj+grad [+ value]) sweep; ``card``
    names the card and its power limit (nvidia-smi), ``sweeps_max`` the
    captured maxima printed beside the means."""
    lines = [
        f"### Roofline: {num_qubits}q chi={chi}, {layers}-layer Trotter "
        f"ansatz (svd impl: {impl}; {card})",
        "",
        "Decomposition phases per obj+grad sweep, as (batch, matrix_n) — "
        "the grad/value heads run at growing χ (χ-growth scheduling):",
        "",
    ]
    for stage, phases in census.items():
        lines.append(f"* {stage}: {phases}")
    lines += [
        "",
        "| stage | phases | matrices | mean adaptive sweeps | Jacobi GFLOP (CUDA cores) | pair-update "
        "product GFLOP |",
        "|---|---|---|---|---|---|",
    ]
    for stage, phases in census.items():
        s = float(sweeps_by_stage[stage])
        v = sum(kernel_flops_for(n, s, b, impl) for b, n in phases)
        x = sum(matmul_flops_for(n, b, impl) for b, n in phases)
        mx = f" (max {sweeps_max[stage]})" if sweeps_max else ""
        lines.append(
            f"| {stage} | {len(phases)} | {sum(b for b, _ in phases)} "
            f"| {s:.1f}{mx} | {v / 1e9:.2f} | {x / 1e9:.2f} |"
        )
    r = roofline_numbers(num_qubits, chi, measured_sweep_s, sweeps_by_stage, attainable, census, impl)
    lines += [
        "",
        f"Measured sweep: {measured_sweep_s * 1e3:.2f} ms "
        f"({1.0 / measured_sweep_s:.2f} sweeps/s).",
        f"Attainable (measured on this device): CUDA cores "
        f"{attainable['vpu_gflops']:.0f} GFLOP/s f32 FMA, cuBLAS "
        f"{attainable['mxu_gflops']:.0f} GFLOP/s c64 (TF32 off), HBM "
        f"{attainable['hbm_gbps']:.0f} GB/s; {100 * r['attainable_vs_peak_core']:.0f}% and "
        f"{100 * r['attainable_vs_peak_hbm']:.0f}% of the H100's published 67 TFLOP/s f32 and 3.35 TB/s "
        f"(at 700 W).",
        f"Executed work per obj+grad sweep: Jacobi {r['jacobi_gflop']:.2f} GFLOP "
        f"(CUDA cores: K1, K3, K4), pair-update products {r['matmul_gflop']:.2f} GFLOP "
        f"({r['matmul_core_gflop']:.2f} on the CUDA cores inside K2/K4, {r['matmul_blas_gflop']:.2f} in "
        f"cuBLAS/cuSOLVER), ~{r['hbm_mb']:.1f} MB HBM traffic (state {r['state_mb']:.2f} MB).",
        f"Roofline floors: CUDA cores {r['t_core_s'] * 1e3:.2f} ms + cuBLAS "
        f"{r['t_blas_s'] * 1e3:.2f} ms = {r['bound_s'] * 1e3:.2f} ms "
        f"({1.0 / r['bound_s']:.1f} sweeps/s ceiling); at the published peak "
        f"{r['peak_bound_s'] * 1e3:.2f} ms; HBM floor {r['t_hbm_s'] * 1e3:.3f} ms "
        f"({100 * r['share_hbm']:.2f}% of the sweep; NOT bandwidth-bound).",
        f"Achieved Jacobi throughput: {r['achieved_gflops']:.0f} GFLOP/s = "
        f"{100 * r['share_core']:.1f}% of the attainable CUDA-core rate "
        f"({100 * r['share_core_peak']:.1f}% of the published peak); the composite roofline is "
        f"{100 * r['share_composite']:.1f}% of the measured sweep "
        f"({100 * r['share_composite_peak']:.1f}% at the published peaks).",
        "",
        "The decomposition is a ONE-SIDED JACOBI — an iterative "
        "orthogonalization whose per-phase work is elementwise and "
        "reduction work on the CUDA cores, not a matrix product for the "
        "tensor cores.  The speed-of-light for this algorithm on this card "
        "is the CUDA-core line above; a sweep far below it is held back by "
        "what the floors do not count: the host's dispatch and the "
        "kernels' per-phase latency.",
    ]
    return "\n".join(lines)


# ------------------------------------------------------------------ CLI


def _capture_sweep_counts(circ, thetas, target, bits, trunc_thr):
    """Mean/max adaptive Jacobi sweep counts per stage, measured on the REAL
    pair matrices of one production obj+grad sweep and one value sweep.

    The capture sits at the dispatch seam ``ops/mps._pair_update``, before
    the route's choice, so every route records: it rebuilds each update's θ
    (``_pair_theta``) and counts its sweeps per matrix
    (``jacobi_svd.jacobi_sweeps_per_matrix``: K1 on the card).  The counts
    are per matrix, as the engine's kernels stop each matrix at its own."""
    from . import mps as mpsmod
    from .jacobi_svd import jacobi_sweeps_per_matrix
    from .mps_gradient import fast_dot_gradient_with_state

    phases, counts = [], []
    orig = mpsmod._pair_update

    def capturing(lam_l, lam_c, lam_r, g1, g2, gate4, chi, thr, dtype, rdtype):
        m = mpsmod._pair_theta(lam_l, lam_c, lam_r, g1, g2, gate4, chi, dtype)
        mb = m.reshape((-1,) + tuple(m.shape[-2:]))
        phases.append((int(mb.shape[0]), int(mb.shape[-1])))
        counts.append(jacobi_sweeps_per_matrix(mb).cpu())
        return orig(lam_l, lam_c, lam_r, g1, g2, gate4, chi, thr, dtype, rdtype)

    chi = target.chi
    lvec = mpsmod.mps_basis_state(bits, chi, target.gammas.dtype, target.device)
    stages = {}
    mpsmod._pair_update = capturing
    try:
        vh, zc = mpsmod.v_dagger_mul_mps_layers(circ, thetas, target, trunc_thr=trunc_thr)
        stages["vdag"] = (phases[:], counts[:])
        phases.clear()
        counts.clear()
        fast_dot_gradient_with_state(circ, thetas, lvec, vh, zc, trunc_thr=trunc_thr, grow_w=True)
        stages["grad"] = (phases[:], counts[:])
        phases.clear()
        counts.clear()
        mpsmod.v_mul_mps_growing(circ, thetas, bits, chi, trunc_thr=trunc_thr, dtype=target.gammas.dtype)
        stages["value"] = (phases[:], counts[:])
    finally:
        mpsmod._pair_update = orig

    out = {}
    for stage, (ph, cs) in stages.items():
        every = torch.cat(cs).numpy()
        out[stage] = {"mean": float(np.mean(every)), "max": int(np.max(every)), "phases": ph}
    return out


def _card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    got = subprocess.run(query, capture_output=True, text=True, timeout=60, check=True)
    return got.stdout.strip().splitlines()[0]


def make_case(num_qubits: int, chi: int, layers: int, dev):
    """BASELINE configs 3 and 5's case (benchmarks/bench_mps.py): the
    4-layer 2nd-order Trotter ansatz at perfect init + 0.05 rad (seed 5),
    the Néel prep, target Trotter(1.2, 3 steps, δ=1) at trunc 1e-6.
    Returns (circ, thetas, target, bits, trunc_thr)."""
    from ..circuit.ansatz import TrotterAnsatz
    from ..circuit.structures import make_trotter_like_circuit
    from ..targets import trotter as trotop

    trunc_thr = 1e-6
    circ = TrotterAnsatz.make(num_qubits, make_trotter_like_circuit(num_qubits, layers), True)
    th = trotop.init_ansatz_to_trotter(circ, np.zeros(circ.num_thetas), evol_time=1.2, delta=1.0)
    th = th + 0.05 * np.random.default_rng(5).standard_normal(circ.num_thetas)
    thetas = torch.tensor(th, dtype=config.real_dtype(), device=dev)
    target = trotop.Trotter(num_qubits=num_qubits, evol_time=1.2, num_steps=3, delta=1.0, second_order=True).as_mps(
        trotop.neel_init_state(num_qubits), trunc_thr=trunc_thr, chi_max=chi, dtype=config.complex_dtype(),
        device=dev)
    bits = tuple(1 if q % 2 == 0 else 0 for q in range(num_qubits))
    return circ, thetas, target, bits, trunc_thr


def measure_sweep(circ, thetas, target, bits, trunc_thr, attainable, *, repeats: int = 5,
                  card: str = "not measured") -> dict:
    """One roofline run on a built case under the current route: the mean
    obj+grad sweep over ``repeats`` calls after a warm-up (host clock,
    ending in a synchronize on the card), the captured sweep counts, the
    census, the report's numbers and its text."""
    from ..models.sp_lhs.jit_asp import _mps_value_fns

    dev = thetas.device
    _, value_and_grad = _mps_value_fns(circ, bits, trunc_thr)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    f, g = value_and_grad(thetas, target)
    sync()
    if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(f))):
        raise RuntimeError("non-finite obj+grad")
    tic = time.perf_counter()
    for _ in range(repeats):
        value_and_grad(thetas, target)
    sync()
    measured = (time.perf_counter() - tic) / repeats
    stats = _capture_sweep_counts(circ, thetas, target, bits, trunc_thr)
    census = decomposition_census(circ, target.chi, grow=True)
    impl = config.svd_impl(dev)
    sweeps = {k: stats[k]["mean"] for k in census}
    maxima = {k: stats[k]["max"] for k in census}
    layers = circ.num_blocks // circ.bpl
    return {
        "measured_s": measured, "grad_norm": float(torch.linalg.vector_norm(g)), "stats": stats,
        "census": census, "impl": impl, "sweeps": sweeps, "sweeps_max": maxima,
        "numbers": roofline_numbers(circ.num_qubits, target.chi, measured, sweeps, attainable, census, impl),
        "report": roofline_report(circ.num_qubits, target.chi, layers, measured, sweeps, attainable, census,
                                  impl=impl, card=card, sweeps_max=maxima),
    }


def main(num_qubits=20, chi=64, layers=4):
    dev = config.device()
    config.set_precision("fast" if dev.type == "cuda" else "high")
    card = _card_line() if dev.type == "cuda" else "the CPU: no device metric"
    case = make_case(num_qubits, chi, layers, dev)
    print("measuring attainable rates ...", flush=True)
    att = measure_attainable()
    print(f"  {att}", flush=True)
    run = measure_sweep(*case, att, card=card)
    print(f"measured obj+grad sweep: {run['measured_s'] * 1e3:.2f} ms "
          f"({1 / run['measured_s']:.2f} sweeps/s), grad_norm {run['grad_norm']:.6f}", flush=True)
    for stage, st in run["stats"].items():
        print(f"  {stage}: mean {st['mean']:.2f}, max {st['max']}, phases {st['phases']}", flush=True)
    print()
    print(run["report"])
    return run


# Attainable rates measured on an NVIDIA H100 80GB HBM3 at its 700 W limit
# by measure_attainable (chip_smoke.py's [roofline] phase; PERF.md §5):
# 89.4% of the published f32 rate, 82.9% of the HBM rate.  Used by
# :func:`predict` when no card is at hand.
PINNED_ATTAINABLE = {"vpu_gflops": 59917.3, "mxu_gflops": 51959.3, "hbm_gbps": 2776.6}
# Mean adaptive sweeps per matrix and stage captured on the 28q chi=128
# case's real pair matrices in the same run (jacobi route).
PINNED_SWEEPS = {"vdag": 9.55, "grad": 6.09, "value": 6.09}


def predict(
    num_qubits: int,
    chi: int,
    layers: int = 4,
    *,
    impl: str = "jacobi",
    sweeps_by_stage: Dict[str, float] | None = None,
    attainable: Dict[str, float] | None = None,
    ndev: int = 1,
) -> str:
    """Model-only roofline PREDICTION at a shape (no card required): the
    census and flop model of the measured report, with the pinned
    attainable rates and stage sweep counts (pass ``attainable`` and
    ``sweeps_by_stage`` to override).  ``ndev`` reports the chain-sharded
    per-card state memory (parallel/mps_chain.py) next to the single-card
    footprint."""
    from ..circuit.ansatz import TrotterAnsatz
    from ..circuit.structures import make_trotter_like_circuit

    att = dict(PINNED_ATTAINABLE, **(attainable or {}))
    sbs = sweeps_by_stage or PINNED_SWEEPS
    circ = TrotterAnsatz.make(
        num_qubits, make_trotter_like_circuit(num_qubits, layers), True
    )
    f = _floors(decomposition_census(circ, chi), sbs, att, impl)
    st = state_bytes(num_qubits, chi)
    # Working set of one decomposition phase: theta batch + factors + the
    # kernel's seat planes (~6x theta in f32 planes).
    worst_phase = max(
        (b * (2 * (n**2)) * 8 * 4 for b, n in sum(f["og"].values(), [])),
        default=0.0,
    )
    lines = [
        f"### Roofline PREDICTION: {num_qubits}q chi={chi}, {layers}-layer "
        f"Trotter (impl {impl}; pinned attainable rates of an H100 at 700 W, "
        f"assumed sweeps {sbs})",
        f"Executed work per obj+grad sweep (model): Jacobi "
        f"{f['jac'] / 1e9:.1f} GFLOP (CUDA cores) + pair-update products {f['mm'] / 1e9:.1f} GFLOP "
        f"({f['mm_core'] / 1e9:.1f} on the CUDA cores, {f['mm_blas'] / 1e9:.1f} in cuBLAS); HBM traffic "
        f"~{f['hbm'] / 1e6:.0f} MB.",
        f"Ceilings: CUDA cores {f['t_core'] * 1e3:.1f} ms + cuBLAS {f['t_blas'] * 1e3:.1f} ms = "
        f"{f['bound'] * 1e3:.1f} ms -> {1.0 / f['bound']:.2f} sweeps/s; HBM floor "
        f"{f['t_hbm'] * 1e3:.2f} ms.",
        f"Memory: state (2 copies w/z + grads ~4x) "
        f"{4 * st / 1e6:.0f} MB single card; worst phase working set "
        f"~{worst_phase / 1e6:.0f} MB; chain-sharded per-card state "
        f"(~1/{ndev}) {4 * st / ndev / 1e6:.0f} MB."
        if ndev > 1
        else f"Memory: state (w/z + grad copies ~4x) {4 * st / 1e6:.0f} MB "
        f"single card; worst phase working set ~{worst_phase / 1e6:.0f} MB.",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    if "--predict" in sys.argv:
        args = [int(a) for a in sys.argv[1:] if a.isdigit()]
        print(predict(*args[:3]))
    else:
        main(*[int(a) for a in sys.argv[1:4]])
