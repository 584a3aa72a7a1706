"""Lightweight argument-validation predicates (twin of
``aqc_research_tpu/checking.py``).  Predicates accept numpy arrays and
torch tensors; they run on static Python values and shapes."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_INT_TYPES = (int, np.int8, np.int16, np.int32, np.int64)
_FLOAT_TYPES = (float, np.float16, np.float32, np.float64)


def _is_array(obj: Any) -> bool:
    return isinstance(obj, (np.ndarray, torch.Tensor))


def _kind(obj: Any) -> str:
    """numpy-style dtype kind: 'i', 'f', 'c', 'b', ..."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bool:
            return "b"
        if obj.dtype.is_complex:
            return "c"
        if obj.dtype.is_floating_point:
            return "f"
        return "i"
    return np.dtype(obj.dtype).kind


def is_int(val: Any, extra_cond: bool = True) -> bool:
    return isinstance(val, _INT_TYPES) and bool(extra_cond)


def is_float(val: Any, extra_cond: bool = True) -> bool:
    return isinstance(val, _FLOAT_TYPES) and bool(extra_cond)


def is_str(val: Any, extra_cond: bool = True) -> bool:
    return isinstance(val, str) and bool(extra_cond)


def is_list(val: Any, extra_cond: bool = True) -> bool:
    return isinstance(val, list) and bool(extra_cond)


def is_tuple(val: Any, extra_cond: bool = True) -> bool:
    return isinstance(val, tuple) and bool(extra_cond)


def is_dict(val: Any, extra_cond: bool = True) -> bool:
    return isinstance(val, dict) and bool(extra_cond)


def complex_2d(arr: Any, extra_cond: bool = True) -> bool:
    """True for a 2D complex array."""
    return _is_array(arr) and arr.ndim == 2 and _kind(arr) == "c" and bool(extra_cond)


def complex_2d_square(arr: Any, extra_cond: bool = True) -> bool:
    """True for a square 2D complex array."""
    return complex_2d(arr) and arr.shape[0] == arr.shape[1] and bool(extra_cond)


def float_1d(arr: Any, extra_cond: bool = True) -> bool:
    """True for a 1D real floating array."""
    return _is_array(arr) and arr.ndim == 1 and _kind(arr) == "f" and bool(extra_cond)


def block_structure(num_qubits: int, blocks: Any) -> bool:
    """True for a valid ``(2, depth)`` unit-block placement array: integer
    dtype, control != target, all indices within ``[0, num_qubits)``."""
    if not (_is_array(blocks) and _kind(blocks) == "i" and blocks.ndim == 2):
        return False
    b = np.asarray(blocks)
    return (
        b.shape[0] == 2
        and bool(np.all((0 <= b) & (b < num_qubits)))
        and bool(np.all(b[0, :] != b[1, :]))
    )
