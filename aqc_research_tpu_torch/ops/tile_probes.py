"""The tile-precision probe: the Hopper counterpart of the JAX package's two
Pallas compiler probes, ``benchmarks/probe_mosaic_precision.py`` (P1: A·B
and A·Bᵀ of (128, 128) f32 at Precision.HIGHEST inside one kernel) and
``benchmarks/probe_mosaic_ops.py`` (P2: over a chunk of two (128, 128)
pairs, s·(A·B) with s from scalar memory, A·Bᵀ and Aᵀ).

On the TPU those probes found that an f32 product inside a kernel truncated
its inputs to bf16 (2e-3 relative error) unless it asked for HIGHEST.  On
this card the same trap is TF32: a tensor-core product of f32 inputs keeps
10 mantissa bits (≈1e-3).  The kernels ``csrc/tile_probe.cu`` compute the
probes' results in three precision modes, named as the JAX probes name
theirs:

* ``"fma"``: the tile scheme of ``csrc/theta_tiles.cuh`` (K2's and K4's
  products: 2x2 register micro-tiles, k-tiles of 16 by ``cp.async`` into
  two stages, plain f32 FMA on the CUDA cores), true f32;
* ``"highest"``: ``wgmma`` on the tensor cores in split 3xTF32 (each operand
  x = big + small, both rounded to TF32; the three products big·big,
  big·small and small·big), the counterpart of HIGHEST;
* ``"default"``: ``wgmma`` in one TF32 pass of the rounded operands, the
  counterpart of the TPU's default precision.

The probe holds ``"fma"``, ``"highest"`` and ``torch.matmul`` in f32 under
the port's precision settings (``config.require_full_f32_matmul``: TF32 off
for cuBLAS and cuDNN) to the probes' bar, 1e-5 relative (max-abs error over
max-abs value) against f64, on the probes' own inputs
(``np.random.default_rng(0)``).  ``"default"`` must miss that bar and stay
under 1e-2: the proof that the probe sees TF32, as P2 saw bf16 on the TPU.
The bar for every mode a kernel may use stays 1e-5.  Each mode's kernel is
also held to its plain twin :func:`tile_probe_reference`, which emulates
the mode's rounding exactly.

Run it on the card, or the plain twins on the CPU::

    python -m aqc_research_tpu_torch.ops.tile_probes
    python -m aqc_research_tpu_torch.ops.tile_probes --cpu

It prints one line per result and mode and exits 1 if a mode misses what
it must meet.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from .. import config
from . import cuda_build

PROBE_N = 128  # the probes' matrix edge
PROBE_CHUNK = 2  # P2's chunk of pairs
PROBE_SCALE = 2.5  # P2's scalar
PROBE_TOL = 1e-5  # the probes' bar: relative to f64


def p1_inputs() -> Tuple[np.ndarray, np.ndarray]:
    """P1's A and B, (128, 128) f32, drawn as the probe draws them."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((PROBE_N, PROBE_N)).astype(np.float32)
    b = rng.standard_normal((PROBE_N, PROBE_N)).astype(np.float32)
    return a, b


def p2_inputs() -> Tuple[np.ndarray, np.ndarray, float]:
    """P2's (chunk, 2, 128, 128) f32 planes and its scalar; the probe
    multiplies plane 0 of ``a`` by plane 1 of ``b``."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((PROBE_CHUNK, 2, PROBE_N, PROBE_N)).astype(np.float32)
    b = rng.standard_normal((PROBE_CHUNK, 2, PROBE_N, PROBE_N)).astype(np.float32)
    return a, b, PROBE_SCALE


PRECISIONS = ("fma", "highest", "default")
TC_PASSES = {"highest": 3, "default": 1}  # tensor-core modes: wgmma passes
TC_MULTIPLE = 64  # the tensor-core kernel's n must be a multiple of this
# Each mode's kernel, as the launch counts name it: the CUDA-core kernel and
# the tensor-core one (csrc/tile_probe.cu).
KERNEL_OF = {"fma": "tile_probe", "highest": "tile_probe_tc", "default": "tile_probe_tc"}
TF32_CEILING = 1e-2  # "default" must stay under this: TF32, not garbage
# Kernel against its twin, relative: the twin emulates each mode's rounding,
# so the two differ only in how the f32 sums are taken.  Measured on an H100
# (chip_smoke.py [probes]): ≤ 8.3e-7 at the probes' shapes, (10, 128) and
# (14, 256), most of it the twin's own f32 summation (cuBLAS: 5e-7 to 7e-7
# against f64 there).
TWIN_TOL = 2e-6


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: on the int32 view,
    add half of the dropped 13 bits' range and clear them.  NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) with big = round_tf32(x), small = round_tf32(x - big):
    big + small equals x within 2^-22 |x|."""
    big = round_tf32(x)
    return big, round_tf32(x - big)


def check_precision(precision: str, n: int) -> None:
    """Raises ValueError unless ``precision`` is a mode of the probe and the
    tensor-core modes get n a multiple of :data:`TC_MULTIPLE`."""
    if precision not in PRECISIONS:
        raise ValueError(f"tile_probe: precision must be one of {PRECISIONS}, got {precision!r}")
    if precision in TC_PASSES and n % TC_MULTIPLE:
        raise ValueError(f"tile_probe: precision {precision!r} takes n a multiple of {TC_MULTIPLE}, got {n}")


def tile_probe_reference(
    a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, precision: str = "fma"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernels: ``(s·(A_c·B_c), A_c·B_cᵀ, A_cᵀ)`` for
    ``a``, ``b`` (c, n, n) f32 and the one-element ``scale``, in f32 with
    TF32 off (set and asserted here).  ``precision`` emulates the mode's
    operands: ``"fma"`` the f32 values, ``"default"`` their TF32 roundings
    (one product), ``"highest"`` the split (the sum of big·big, big·small
    and small·big).  Products of two TF32 values are exact in f32."""
    check_precision(precision, a.shape[-1])
    config.require_full_f32_matmul()
    if precision == "fma":
        dot, dgt = torch.matmul(a, b), torch.matmul(a, b.transpose(-1, -2))
    elif precision == "default":
        ar, br = round_tf32(a), round_tf32(b)
        dot, dgt = torch.matmul(ar, br), torch.matmul(ar, br.transpose(-1, -2))
    else:
        (a_big, a_small), (b_big, b_small) = split_tf32(a), split_tf32(b)

        def three(right_big, right_small):
            return (torch.matmul(a_big, right_big) + torch.matmul(a_big, right_small)
                    + torch.matmul(a_small, right_big))

        dot, dgt = three(b_big, b_small), three(b_big.transpose(-1, -2), b_small.transpose(-1, -2))
    return dot * scale.reshape(()), dgt, a.transpose(-1, -2).contiguous()


def check_probe_args(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, precision: str = "fma") -> None:
    """Raises ValueError unless the inputs are what the kernel takes: f32
    (c, n, n) with row-major matrices (any matrix stride), a one-element
    f32 scale, all on one device, a known ``precision`` (the tensor-core
    modes: n a multiple of 64, 16-byte aligned matrices)."""
    if any(t.dtype != torch.float32 for t in (a, b, scale)):
        raise ValueError("tile_probe takes float32 matrices and scale")
    if a.ndim != 3 or a.shape[-1] != a.shape[-2] or b.shape != a.shape:
        raise ValueError(f"tile_probe takes two (c, n, n) stacks, got {tuple(a.shape)} and {tuple(b.shape)}")
    n = a.shape[-1]
    if any(t.stride(-1) != 1 or t.stride(-2) != n for t in (a, b)):
        raise ValueError("tile_probe takes row-major matrices (unit column stride, row stride n)")
    if scale.numel() != 1:
        raise ValueError(f"tile_probe takes a one-element scale, got {tuple(scale.shape)}")
    if b.device != a.device or scale.device != a.device:
        raise ValueError("tile_probe: inputs on different devices")
    if not 1 <= a.shape[0] <= 65535:
        raise ValueError(f"tile_probe takes 1 to 65535 matrices, got {a.shape[0]}")
    check_precision(precision, n)
    if precision in TC_PASSES and any(t.data_ptr() % 16 or t.stride(0) % 4 for t in (a, b)):
        raise ValueError("tile_probe: the tensor-core modes take 16-byte aligned matrices")


def tile_probe(
    a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, precision: str = "fma"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(s·(A_c·B_c), A_c·B_cᵀ, A_cᵀ)`` in the mode ``precision`` — see
    :func:`tile_probe_reference`.

    CPU tensors run the plain twin; CUDA tensors launch the mode's kernel
    (one launch for all three results and every matrix: ``"fma"`` the
    CUDA-core kernel, ``"highest"`` and ``"default"`` the tensor-core one).
    Every launch adds one to ``tile_probe.launches`` and one to its
    kernel's count in ``tile_probe.launches_by_kernel`` (keys as
    :data:`KERNEL_OF`); any other device raises, as do arguments the
    mode's kernel does not take."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tile_probe: unsupported device {a.device}")
    check_probe_args(a, b, scale, precision)
    if a.device.type == "cpu":
        return tile_probe_reference(a, b, scale, precision)
    c, n = a.shape[0], a.shape[-1]
    outs = [torch.empty((c, n, n), dtype=torch.float32, device=a.device) for _ in range(3)]
    scale = scale.contiguous()
    args = (a.data_ptr(), b.data_ptr(), scale.data_ptr(), *(o.data_ptr() for o in outs), c, n,
            a.stride(0), b.stride(0))
    if precision == "fma":
        cuda_build.launch("tile_probe_launch", cuda_build.device_index(a), *args)
    else:
        cuda_build.launch("tile_probe_tc_launch", cuda_build.device_index(a), *args, TC_PASSES[precision])
    tile_probe.launches += 1
    tile_probe.launches_by_kernel[KERNEL_OF[precision]] += 1
    return tuple(outs)


tile_probe.launches = 0
tile_probe.launches_by_kernel = dict.fromkeys(KERNEL_OF.values(), 0)


def rel_err(got: torch.Tensor, ref: np.ndarray) -> float:
    """The probes' measure: max |got - ref| over max |ref| (in f64)."""
    g = got.detach().cpu().double().numpy()
    return float(np.max(np.abs(g - ref)) / max(float(np.max(np.abs(ref))), 1e-30))


def probe_cases(dev) -> dict:
    """P1's and P2's operands on ``dev``, in the kernel's layout: P1 as a
    chunk of one with s = 1; P2's pair planes read in place (A = a[:, 0],
    B = b[:, 1], matrix stride 2 n^2)."""
    a1, b1 = p1_inputs()
    a2, b2, s2 = p2_inputs()
    a2_t, b2_t = torch.tensor(a2, device=dev), torch.tensor(b2, device=dev)
    return {
        "P1": (torch.tensor(a1, device=dev)[None], torch.tensor(b1, device=dev)[None],
               torch.ones(1, dtype=torch.float32, device=dev)),
        "P2": (a2_t[:, 0], b2_t[:, 1], torch.full((1,), s2, dtype=torch.float32, device=dev)),
    }


def f64_results(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """The three results in f64 on the host: the probes' NumPy reference."""
    a64, b64 = a.detach().cpu().double().numpy(), b.detach().cpu().double().numpy()
    s = float(scale.reshape(()))
    return a64 @ b64 * s, a64 @ np.swapaxes(b64, -1, -2), np.swapaxes(a64, -1, -2)


FORMS = {"P1": ("dot HIGHEST", "dotT HIGHEST"), "P2": ("dot", "dot_general_T", "transpose")}


def meets(precision: str, form: str, err: float) -> bool:
    """What a result must meet against f64: the probes' bar, except a
    product of ``"default"``, which must miss it and stay under
    :data:`TF32_CEILING` (the transpose is exact in every mode)."""
    if precision == "default" and form != "transpose":
        return PROBE_TOL < err < TF32_CEILING
    return err <= PROBE_TOL


def run_probes(dev) -> List[dict]:
    """Both probes on ``dev`` in every mode: :func:`tile_probe` (the kernel
    on the card, the twin on the CPU) and the mode's twin, each result
    against f64, and ``torch.matmul`` (f32, TF32 off) against f64.  One row
    per probe, mode and result: probe, precision, form, ``rel_err``
    (tile_probe vs f64), ``matmul_rel_err`` (torch.matmul vs f64),
    ``twin_rel_err`` (tile_probe vs the mode's twin) and ``ok`` (``rel_err``
    meets :func:`meets`, torch.matmul the bar, the twin within
    :data:`TWIN_TOL`)."""
    config.require_full_f32_matmul()
    rows = []
    for probe, (a, b, s) in probe_cases(dev).items():
        refs = f64_results(a, b, s)
        matmul = tile_probe_reference(a, b, s, "fma")
        m_errs = [rel_err(m, ref) for m, ref in zip(matmul, refs)]
        for precision in PRECISIONS:
            got = tile_probe(a, b, s, precision)
            twin = tile_probe_reference(a, b, s, precision)
            for form, g, t, ref, m_err in zip(FORMS[probe], got, twin, refs, m_errs):
                err = rel_err(g, ref)
                t_err = rel_err(g, t.detach().cpu().double().numpy())
                rows.append({"probe": probe, "precision": precision, "form": form, "rel_err": err,
                             "matmul_rel_err": m_err, "twin_rel_err": t_err,
                             "ok": meets(precision, form, err) and m_err <= PROBE_TOL and t_err <= TWIN_TOL})
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run the plain twins on the CPU")
    args = parser.parse_args(argv)
    if args.cpu:
        config.set_device("cpu")
    dev = config.device()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU (plain twins)"
    config.require_full_f32_matmul()
    print(f"tile probe on {where}: allow_tf32 (cuBLAS) {torch.backends.cuda.matmul.allow_tf32}, "
          f"(cuDNN) {torch.backends.cudnn.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}; bar {PROBE_TOL:g} vs f64 (\"default\": above it, "
          f"under {TF32_CEILING:g}), kernel vs twin {TWIN_TOL:g}")
    rows = run_probes(dev)
    for r in rows:
        print(f"{r['probe']} {r['form']} [{r['precision']}]: rel err {r['rel_err']:.2e} "
              f"(torch.matmul {r['matmul_rel_err']:.2e}, vs twin {r['twin_rel_err']:.2e}) "
              f"{'OK' if r['ok'] else 'FAIL'}")
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
