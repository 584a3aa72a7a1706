"""ctypes bindings of the native C++ MPS kernels (twin of
``aqc_research_tpu/io/native.py``), a numpy-only oracle for the pair update.

The shared library is built from the repository's ``native/mps_kernels.cpp``
with g++ on first use, into ``aqc_research_tpu_torch/_build/`` (keyed by the
source's hash), and exposes:

* :func:`svd_c128` — complex SVD by one-sided Jacobi;
* :func:`mps_pair_update` — the Vidal two-qubit pair update (contraction,
  gate, truncated SVD, re-split), the twin of ``ops.mps._pair_update`` for
  one pair.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG.parent / "native" / "mps_kernels.cpp"
BUILD_DIR = _PKG / "_build"
_LIB: Optional[ctypes.CDLL] = None


def build_library() -> Path:
    """Compiles the source once per content; returns the library's path."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libaqcmps_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", str(_SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.aqc_svd_c128.restype = ctypes.c_int
        lib.aqc_svd_c128.argtypes = [ctypes.c_int, ctypes.c_int, dptr, dptr, dptr, dptr]
        lib.aqc_mps_pair_update.restype = ctypes.c_int
        lib.aqc_mps_pair_update.argtypes = [ctypes.c_int, ctypes.c_double] + [dptr] * 9
        _LIB = lib
    return _LIB


def _as_c128(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.complex128))


def _as_f64(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.float64))


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def svd_c128(a) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``a = U @ diag(s) @ Vh`` for an (m, n) complex matrix, m >= n."""
    a = _as_c128(a)
    if a.ndim != 2 or a.shape[0] < a.shape[1]:
        raise ValueError(f"svd_c128 needs an (m, n) matrix with m >= n, got {a.shape}")
    m, n = a.shape
    u = np.zeros((m, n), np.complex128)
    s = np.zeros(n, np.float64)
    vh = np.zeros((n, n), np.complex128)
    if _lib().aqc_svd_c128(m, n, _ptr(a), _ptr(u), _ptr(s), _ptr(vh)) < 0:
        raise RuntimeError("native SVD failed")
    return u, s, vh


def mps_pair_update(lam_l, lam_c, lam_r, g1, g2, gate4, trunc_thr: float
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native Vidal pair update of one pair (``g1``, ``g2``: (2, χ, χ);
    the λ: (χ,); ``gate4`` in (lo, hi) order); returns (new_g1, new_g2,
    new_lam)."""
    g1, g2, gate4 = _as_c128(g1), _as_c128(g2), _as_c128(gate4)
    chi = int(g1.shape[-1])
    lams = [_as_f64(x) for x in (lam_l, lam_c, lam_r)]
    if g1.shape != (2, chi, chi) or g2.shape != g1.shape or gate4.shape != (4, 4) \
            or any(x.shape != (chi,) for x in lams):
        raise ValueError("mps_pair_update needs g1, g2 (2, chi, chi), gate4 (4, 4) and three (chi,) bonds")
    out_g1, out_g2, out_lam = np.zeros_like(g1), np.zeros_like(g2), np.zeros(chi, np.float64)
    ret = _lib().aqc_mps_pair_update(
        chi, float(trunc_thr), *(_ptr(x) for x in lams), _ptr(g1), _ptr(g2), _ptr(gate4),
        _ptr(out_g1), _ptr(out_g2), _ptr(out_lam),
    )
    if ret < 0:
        raise RuntimeError("native MPS pair update failed")
    return out_g1, out_g2, out_lam
