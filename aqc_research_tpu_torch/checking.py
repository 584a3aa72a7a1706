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


def is_bool(val: Any, extra_cond: bool = True) -> bool:
    return isinstance(val, (bool, np.bool_)) and bool(extra_cond)


def is_complex(val: Any, extra_cond: bool = True) -> bool:
    """True for a complex scalar."""
    return isinstance(val, (complex, np.complex64, np.complex128)) and bool(extra_cond)


def none_or_type(val: Any, cls: type) -> bool:
    return val is None or isinstance(val, cls)


def _nd_kind(arr: Any, ndim, kinds: str, extra_cond) -> bool:
    return _is_array(arr) and (ndim is None or arr.ndim == ndim) and _kind(arr) in kinds and bool(extra_cond)


def int_1d(arr: Any, extra_cond: bool = True) -> bool:
    return _nd_kind(arr, 1, "i", extra_cond)


def int_2d(arr: Any, extra_cond: bool = True) -> bool:
    return _nd_kind(arr, 2, "i", extra_cond)


def bool_1d(arr: Any, extra_cond: bool = True) -> bool:
    return _nd_kind(arr, 1, "b", extra_cond)


def float_2d(arr: Any, extra_cond: bool = True) -> bool:
    return _nd_kind(arr, 2, "f", extra_cond)


def complex_1d(arr: Any, extra_cond: bool = True) -> bool:
    return _nd_kind(arr, 1, "c", extra_cond)


def complex_3d(arr: Any, extra_cond: bool = True) -> bool:
    return _nd_kind(arr, 3, "c", extra_cond)


def complex_array(arr: Any, extra_cond: bool = True) -> bool:
    return _nd_kind(arr, None, "c", extra_cond)


def complex_or_float_1d(arr: Any, extra_cond: bool = True) -> bool:
    return _nd_kind(arr, 1, "fc", extra_cond)


def complex_or_float_2d(arr: Any, extra_cond: bool = True) -> bool:
    return _nd_kind(arr, 2, "fc", extra_cond)


def check_sim_complex_vecs4(a, b, c, d) -> bool:
    """True when four complex vectors have the same size."""
    vecs = (a, b, c, d)
    return all(complex_1d(v) for v in vecs) and all(v.shape == a.shape for v in vecs)


def check_permutation(arr: Any) -> bool:
    """True when the array is an index permutation of 0..n-1."""
    if not int_1d(arr):
        return False
    x = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr)
    return bool(np.array_equal(np.sort(x), np.arange(x.size)))


def no_overlap(a, b) -> bool:
    """True when two arrays (numpy or tensors) do not share memory."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.device != b.device or a.numel() == 0 or b.numel() == 0:
            return True
        sa, sb = a.untyped_storage(), b.untyped_storage()
        return sa.data_ptr() != sb.data_ptr()
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return not np.shares_memory(a, b)
    return True
