"""Checkpoint / resume of optimization state (twin of
``aqc_research_tpu/io/checkpoint.py``).

:func:`save_checkpoint` writes the JAX package's layout — one ``.npz``
archive, scalars and strings in a JSON side channel ``__meta__``, an MPS as
``<key>.gammas`` / ``<key>.lambdas`` — so a file written by either package
loads in the other.  :func:`save_pytree` / :func:`load_pytree` keep nested
dicts, lists and tuples of tensors in one ``.npz`` (the JAX package uses
Orbax there, which has no torch counterpart).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import config
from ..ops.mps import MPS
from ..utils import create_logger

_logger = create_logger(__file__)

_SEP = "/"  # joins the keys of a nested tree in the pytree archive


def _as_numpy(val) -> np.ndarray:
    return val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """Atomic write (tmp + rename) of a compressed archive."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return path


def save_checkpoint(path: str, state: Dict[str, Any]) -> str:
    """Saves a flat dict of arrays (numpy or tensors), scalars, strings and
    MPS states to ``<path>.npz``; returns the file's path."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    for key, val in state.items():
        if "." in key:
            raise ValueError(f"checkpoint keys must not contain '.': {key}")
        if isinstance(val, MPS):
            arrays[f"{key}.gammas"] = _as_numpy(val.gammas)
            arrays[f"{key}.lambdas"] = _as_numpy(val.lambdas)
            meta[key] = "__mps__"
        elif isinstance(val, (np.ndarray, torch.Tensor)):
            arrays[key] = _as_numpy(val)
        else:
            meta[key] = val
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    path = _write_npz(path, arrays)
    _logger.info("checkpoint saved: %s", path)
    return path


def load_checkpoint(path: str, device=None) -> Optional[Dict[str, Any]]:
    """Loads a checkpoint written by :func:`save_checkpoint` (of either
    package); None if absent.  Arrays come back as numpy, MPS states as
    tensors on ``device`` (default ``config.device()``) in their stored
    dtypes."""
    path = _npz_path(path)
    if not os.path.isfile(path):
        return None
    device = config.device() if device is None else device
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        state: Dict[str, Any] = dict(meta)
        for key in data.files:
            if key != "__meta__" and "." not in key:
                state[key] = data[key]
        for key, val in meta.items():
            if val == "__mps__":
                state[key] = MPS(
                    torch.as_tensor(data[f"{key}.gammas"], device=device),
                    torch.as_tensor(data[f"{key}.lambdas"], device=device),
                )
    _logger.info("checkpoint loaded: %s", path)
    return state


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = _as_numpy(tree)
        return
    for key, sub in items:
        key = str(key)
        if _SEP in key:
            raise ValueError(f"pytree keys must not contain {_SEP!r}: {key}")
        _flatten(sub, f"{prefix}{_SEP}{key}" if prefix else key, out)


def _unflatten(like: Any, prefix: str, data) -> Any:
    def at(key):
        return f"{prefix}{_SEP}{key}" if prefix else str(key)

    if isinstance(like, dict):
        return {key: _unflatten(sub, at(key), data) for key, sub in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, at(i), data) for i, sub in enumerate(like))
    arr = data[prefix]
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr, device=like.device).to(like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr.item())


def save_pytree(path: str, tree: Any) -> str:
    """Saves a nested dict / list / tuple of tensors, arrays and scalars to
    ``<path>.npz``; returns the file's path."""
    arrays: Dict[str, np.ndarray] = {}
    _flatten(tree, "", arrays)
    return _write_npz(path, arrays)


def load_pytree(path: str, like: Any) -> Any:
    """Restores a :func:`save_pytree` archive in the structure of ``like``:
    each tensor leaf on ``like``'s device and in its dtype."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        return _unflatten(like, "", data)
