"""Builds the port's hand-written CUDA kernels and launches them (ctypes).

Every ``csrc/*.cu`` is compiled by its own ``nvcc -c`` for sm_90a, all
started together, and the objects are linked into one shared library with
a plain C interface, ``_build/libaqc_kernels_<digest>.so``.  The digest
hashes every source and every shared device header (``csrc/*.cuh``), so an
edit to either rebuilds instead of loading a stale library.  The build runs
at first use, never at import: machines without ``nvcc`` import the port
and run the plain twins on CPU tensors.

The kernel wrappers (ops/jacobi_kernel.py, ops/fused_pair.py,
ops/fused_rand.py, ops/householder_qr.py, ops/tile_probes.py,
ops/roofline.py) call
:func:`launch`, which runs one C entry point on the current stream of the
tensors' device and raises on a refused launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_COMPILE_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> (argtypes, restype).  Pointers and the stream are
# void* (ctypes would cut a Python int to 32 bits otherwise).
_SIGNATURES = {
    # in_re, in_im, out_re, out_im, sweeps, batch, c, r, max_sweeps,
    # hybrid, threads, home, cluster, stream
    "jacobi_rows_launch": ([_VP] * 5 + [_CI] * 8 + [_VP], _CI),
    # c, r, cluster
    "jacobi_rows_cluster_occupancy": ([_CI] * 3, _CI),
    # gate, a_re, a_im, b_re, b_im, w0_re, w0_im, batch, chi, edge, stream
    "theta_build_launch": ([_VP] * 7 + [_CI] * 3 + [_VP], _CI),
    # m_re, m_im, tot2, wk_re, wk_im, vh_re, vh_im, lam, inv, sweeps, batch,
    # ell, n, chi, max_sweeps, hybrid, thr2, threads, home, cluster, stream
    "rand_tail_launch": ([_VP] * 10 + [_CI] * 6 + [_CF, _CI, _CI, _CI, _VP], _CI),
    # ell, n, chi, cluster
    "rand_tail_cluster_occupancy": ([_CI] * 4, _CI),
    # gate, a_re, a_im, b_re, b_im, w0_re, w0_im, wk_re, wk_im, ut_re, ut_im,
    # vh_re, vh_im, lam, sweeps, batch, chi, max_sweeps, hybrid, thr2,
    # home, cluster, stamps (null on the path), stream
    "fused_pair_launch": ([_VP] * 15 + [_CI] * 4 + [_CF, _CI, _CI, _VP, _VP], _CI),
    # chi, cluster
    "fused_pair_cluster_occupancy": ([_CI, _CI], _CI),
    # a, b, scale, o_dot, o_dgt, o_tr, batch, n, a_stride, b_stride, stream
    "tile_probe_launch": ([_VP] * 6 + [_CI] * 2 + [ctypes.c_longlong] * 2 + [_VP], _CI),
    # the same, then passes (3: split 3xTF32, 1: one TF32 pass), stream
    "tile_probe_tc_launch": ([_VP] * 6 + [_CI] * 2 + [ctypes.c_longlong] * 2 + [_CI, _VP], _CI),
    # y, q, batch, n, l, cluster, nb (panel width: 16 or 8), stream
    "householder_qr_launch": ([_VP, _VP] + [_CI] * 5 + [_VP], _CI),
    # in, out, n, iters, a, b, stream
    "fma_chain_launch": ([_VP, _VP, ctypes.c_longlong, _CI, _CF, _CF, _VP], _CI),
    # in, out, n, passes, a, b, blocks, stream
    "stream_launch": ([_VP, _VP, ctypes.c_longlong, _CI, _CF, _CF, _CI, _VP], _CI),
    "aqc_max_smem_optin": ([_CI], _CI),
    "aqc_error_string": ([_CI], ctypes.c_char_p),
}

_LIB = None
_MAX_SMEM: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def source_digest() -> str:
    """Hash of the kernel sources and the device headers they share."""
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:12]


def build_kernel_library() -> Path:
    """Compiles the sources in parallel and links them into one shared
    library keyed by :func:`source_digest`; returns its path.  The ptxas
    report (registers, shared memory, spills per kernel) is kept beside it."""
    lib = BUILD_DIR / f"libaqc_kernels_{source_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    work = BUILD_DIR / f"objs_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    sources = sorted(_CSRC.glob("*.cu"))
    jobs = []
    for src in sources:
        cmd = [nvcc, *_COMPILE_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    report = []
    failed = []
    for cmd, proc in jobs:
        out, err = proc.communicate()
        report.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *(str(work / f"{s.stem}.o") for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{proc.stderr}")
    lib.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def load():
    """The kernel library, built on first use, with its C signatures set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_kernel_library()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB


def device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def max_smem(dev: int) -> int:
    """Largest dynamic shared memory one block may opt into on card ``dev``."""
    if dev not in _MAX_SMEM:
        _MAX_SMEM[dev] = int(load().aqc_max_smem_optin(dev))
    return _MAX_SMEM[dev]


def sm_count(dev: int) -> int:
    """Streaming multiprocessors of card ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def launch(name: str, dev: int, *args) -> None:
    """Runs the C entry point ``name`` with ``args`` and the current stream
    of card ``dev``; raises when the launch was refused."""
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.aqc_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
