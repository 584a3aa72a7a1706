"""The tile-precision probe: the Hopper counterpart of the JAX package's two
Pallas compiler probes, ``benchmarks/probe_mosaic_precision.py`` (P1: A·B
and A·Bᵀ of (128, 128) f32 at Precision.HIGHEST inside one kernel) and
``benchmarks/probe_mosaic_ops.py`` (P2: over a chunk of two (128, 128)
pairs, s·(A·B) with s from scalar memory, A·Bᵀ and Aᵀ).

On the TPU those probes found that an f32 product inside a kernel truncated
its inputs to bf16 (2e-3 relative error) unless it asked for HIGHEST.  On
this card the same trap is TF32: a tensor-core product of f32 inputs keeps
10 mantissa bits (≈1e-3).  The probe therefore holds two things to the
probes' bar, 1e-5 relative (max-abs error over max-abs value) against f64,
on the probes' own inputs (``np.random.default_rng(0)``):

* the kernel ``csrc/tile_probe.cu``, which computes the three results with
  the tile scheme of ``csrc/theta_tiles.cuh`` (K2's and K4's products:
  2x2 register micro-tiles, k-tiles of 16 by ``cp.async`` into two stages,
  plain f32 FMA), P1 being its case s = 1, c = 1;
* ``torch.matmul`` in f32 under the port's precision settings
  (``config.require_full_f32_matmul``: TF32 off for cuBLAS and cuDNN), which
  is what the plain twin :func:`tile_probe_reference` computes.

Run it on the card, or its plain twin on the CPU::

    python -m aqc_research_tpu_torch.ops.tile_probes
    python -m aqc_research_tpu_torch.ops.tile_probes --cpu

It prints one line per result and exits 1 if any misses the bar.
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


def tile_probe_reference(
    a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel: ``(s·(A_c·B_c), A_c·B_cᵀ, A_cᵀ)`` for
    ``a``, ``b`` (c, n, n) f32 and the one-element ``scale``, in f32 with
    TF32 off (set and asserted here)."""
    config.require_full_f32_matmul()
    dot = torch.matmul(a, b) * scale.reshape(())
    dgt = torch.matmul(a, b.transpose(-1, -2))
    return dot, dgt, a.transpose(-1, -2).contiguous()


def check_probe_args(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> None:
    """Raises ValueError unless the inputs are what the kernel takes: f32
    (c, n, n) with row-major matrices (any matrix stride), a one-element
    f32 scale, all on one device."""
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


def tile_probe(
    a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(s·(A_c·B_c), A_c·B_cᵀ, A_cᵀ)`` — see :func:`tile_probe_reference`.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (one
    launch for all three results and every matrix) and every launch adds
    one to ``tile_probe.launches``; any other device raises."""
    if a.device.type == "cpu":
        return tile_probe_reference(a, b, scale)
    if a.device.type != "cuda":
        raise ValueError(f"tile_probe: unsupported device {a.device}")
    check_probe_args(a, b, scale)
    c, n = a.shape[0], a.shape[-1]
    outs = [torch.empty((c, n, n), dtype=torch.float32, device=a.device) for _ in range(3)]
    scale = scale.contiguous()
    cuda_build.launch(
        "tile_probe_launch", cuda_build.device_index(a),
        a.data_ptr(), b.data_ptr(), scale.data_ptr(), *(o.data_ptr() for o in outs), c, n,
        a.stride(0), b.stride(0),
    )
    tile_probe.launches += 1
    return tuple(outs)


tile_probe.launches = 0


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


def run_probes(dev) -> List[dict]:
    """Both probes on ``dev``: :func:`tile_probe` (the kernel on the card,
    the twin on the CPU) and the twin (``torch.matmul`` in f32), each
    result against f64, and the kernel against the twin.  One row per
    result: probe, form, ``rel_err`` (tile_probe vs f64), ``matmul_rel_err``
    (the twin vs f64), ``twin_rel_err`` (tile_probe vs the twin) and
    ``ok`` (every one within :data:`PROBE_TOL`)."""
    config.require_full_f32_matmul()
    rows = []
    for probe, (a, b, s) in probe_cases(dev).items():
        got = tile_probe(a, b, s)
        twin = tile_probe_reference(a, b, s)
        refs = f64_results(a, b, s)
        for form, g, t, ref in zip(FORMS[probe], got, twin, refs):
            err, m_err = rel_err(g, ref), rel_err(t, ref)
            t_err = rel_err(g, t.detach().cpu().double().numpy())
            rows.append({"probe": probe, "form": form, "rel_err": err, "matmul_rel_err": m_err,
                         "twin_rel_err": t_err, "ok": max(err, m_err, t_err) < PROBE_TOL})
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run the plain twin on the CPU")
    args = parser.parse_args(argv)
    if args.cpu:
        config.set_device("cpu")
    dev = config.device()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU (plain twin)"
    config.require_full_f32_matmul()
    print(f"tile probe on {where}: allow_tf32 (cuBLAS) {torch.backends.cuda.matmul.allow_tf32}, "
          f"(cuDNN) {torch.backends.cudnn.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}")
    rows = run_probes(dev)
    for r in rows:
        print(f"{r['probe']} {r['form']}: rel err {r['rel_err']:.2e} (torch.matmul {r['matmul_rel_err']:.2e}, "
              f"vs twin {r['twin_rel_err']:.2e}) {'OK' if r['ok'] else 'FAIL'}")
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
