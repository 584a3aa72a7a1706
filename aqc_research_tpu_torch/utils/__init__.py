"""Helpers of the drivers (twin of ``aqc_research_tpu/utils/__init__.py``):
random circuits, angles and states drawn from numpy's global stream (the
same seed gives the JAX package's numbers), a module logger, the
graceful-exit sentinel, an accumulating timer, the script entry point, a
file copy, an options printout and the results summary.  The profiling
helpers are in ``utils/profiling.py``."""

from __future__ import annotations

import logging
import numbers
import os
import shutil
import sys
import traceback
from pprint import pformat, pprint
from time import perf_counter
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import checking as chk
from ..config import complex_dtype


def num_qubits_from_size(size: int) -> int:
    """Number of qubits for a state of ``size`` amplitudes (must be 2**n)."""
    if not chk.is_int(size, size >= 0):
        raise ValueError(f"'size' must be a non-negative int, got {size!r}")
    n = int(round(np.log2(float(max(size, 1)))))
    if size != 2**n:
        raise ValueError("'size' argument is not a power of 2 value")
    return n


def num_cpus() -> int:
    """Number of CPUs available on this host (>= 1)."""
    n = os.cpu_count()
    return int(n) if isinstance(n, int) else 1


def rand_circuit(num_qubits: int, depth: int) -> np.ndarray:
    """Random unit-block structure: per column a random pair of distinct qubits."""
    assert chk.is_int(num_qubits, num_qubits >= 2)
    assert chk.is_int(depth, depth >= 0)
    cols = np.tile(np.arange(num_qubits)[:, None], depth)
    for i in range(depth):
        np.random.shuffle(cols[:, i])
    return cols[0:2, :].copy()


def rand_thetas(num_thetas: int) -> np.ndarray:
    """Uniform random angles in ``(-pi, pi)``."""
    assert chk.is_int(num_thetas, num_thetas > 0)
    return np.pi * (2 * np.random.rand(num_thetas) - 1)


def rand_thetas_gen(generator: torch.Generator, num_thetas: int, dtype=torch.float64) -> torch.Tensor:
    """:func:`rand_thetas` from an explicit ``torch.Generator`` (the JAX
    package's ``rand_thetas_key`` draws from a JAX key, which torch cannot
    replay), on the generator's device."""
    assert chk.is_int(num_thetas, num_thetas > 0)
    u = torch.rand(num_thetas, generator=generator, dtype=dtype, device=generator.device)
    return torch.pi * (2 * u - 1)


def _np_complex_dtype() -> np.dtype:
    return np.dtype(np.complex128 if complex_dtype() == torch.complex128 else np.complex64)


def rand_state(num_qubits: int) -> np.ndarray:
    """Random normalized complex state of ``2**num_qubits`` amplitudes."""
    assert chk.is_int(num_qubits, num_qubits >= 2)
    dim = 2**num_qubits
    state = np.random.rand(dim) + 1j * np.random.rand(dim)
    state /= np.linalg.norm(state)
    return state.astype(_np_complex_dtype())


def zero_state(num_qubits: int) -> np.ndarray:
    """The ``|0...0>`` basis state as a dense vector."""
    assert chk.is_int(num_qubits, num_qubits >= 2)
    state = np.zeros(2**num_qubits, dtype=_np_complex_dtype())
    state[0] = 1
    return state


def create_logger(module_name: str) -> logging.Logger:
    """Module-scoped stdout logger (idempotent — no duplicate handlers)."""
    logger = logging.getLogger(os.path.basename(str(module_name)))
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setLevel(logging.INFO)
        handler.setFormatter(
            logging.Formatter(
                fmt="%(asctime)s | %(name)s | %(levelname)s | %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def print_dot() -> None:
    """Progress indicator for long computations."""
    print(".", end="", flush=True)


def logi(logger: logging.Logger, message: str) -> None:
    logger.info(str(message))


class UserExit:
    """Graceful early termination: the user creates a file ``aqc_exit`` in the
    working directory; long-running drivers poll :meth:`terminate` between
    stages."""

    def __init__(self, print_banner: bool = False):
        self._indicator_file = "aqc_exit"
        if os.path.isfile(self._indicator_file):
            os.remove(self._indicator_file)
        if print_banner:
            print(
                f"\n{'*' * 100}\n"
                f"touch '{self._indicator_file}' to stop the run "
                f"gracefully at the next horizon boundary"
                f"\n{'*' * 100}\n"
            )

    def terminate(self) -> bool:
        if os.path.isfile(self._indicator_file):
            print("!!!!! WARNING: user requested early termination !!!!!")
            return True
        return False


class _TimedSection:
    """One timed region; folds its duration into the owning :class:`MyTimer`
    on exit."""

    __slots__ = ("_owner", "_label", "_start")

    def __init__(self, owner: "MyTimer", label: str):
        self._owner = owner
        self._label = label
        self._start: Optional[float] = None

    def __enter__(self) -> "_TimedSection":
        self._start = perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        self._owner._record(self._label, perf_counter() - self._start)
        return False  # never swallow exceptions


class MyTimer:
    """Named wall-clock accumulator: repeated sections under the same label
    sum their durations (and count their calls, for mean-mode reporting).
    ``full_time=True`` reports accumulated totals, ``False`` the mean per
    call.  CUDA work is asynchronous: synchronise inside a region that
    should measure it."""

    def __init__(self, full_time: bool = True):
        self._acc: Dict[str, List[float]] = {}  # label -> [seconds, calls]
        self._open: Optional[_TimedSection] = None
        self._report_totals = bool(full_time)

    def _record(self, label: str, seconds: float) -> None:
        slot = self._acc.setdefault(label, [0.0, 0])
        slot[0] += seconds
        slot[1] += 1

    def __call__(self, metric_name: str) -> _TimedSection:
        return _TimedSection(self, metric_name)

    def tic(self, metric_name: str) -> None:
        assert self._open is None, "tic() without a matching toc()"
        self._open = _TimedSection(self, metric_name).__enter__()

    def toc(self) -> None:
        assert self._open is not None, "toc() without a matching tic()"
        section, self._open = self._open, None
        section.__exit__(None, None, None)

    def metric(self, metric_name: str) -> float:
        seconds, calls = self._acc[metric_name]
        return seconds if self._report_totals else seconds / float(max(calls, 1))

    def all_metrics(self) -> dict:
        return {label: self.metric(label) for label in self._acc}

    def rounded_metrics(self, decimals: int = 6) -> dict:
        """All metrics as fixed-width strings aligned on the largest value."""
        assert chk.is_int(decimals, decimals >= 0)
        metrics = self.all_metrics()
        if not metrics:
            return {}
        width = len(str(int(max(max(metrics.values()), 1.0)))) + 1 + decimals
        return {k: f"{v:{width}.{decimals}f}" for k, v in metrics.items()}


def script_entry_point(
    main_func: Callable[..., Any],
    options: Optional[Any] = None,
    logger: Optional[logging.Logger] = None,
    **kwargs,
) -> None:
    """Wraps a driver's main function with exception and timing reporting."""
    tic = perf_counter()
    try:
        assert callable(main_func)
        main_func(options, **kwargs)
        msg = "finished normally"
        logger.info(msg) if logger else print(msg)
    except Exception:  # noqa: BLE001 — entry-point boundary, report and exit
        msg = f"\n{traceback.format_exc()}\n"
        logger.error(msg) if logger else print(msg)
    finally:
        msg = f"wall-clock total: {perf_counter() - tic:0.2f}"
        logger.info(msg) if logger else print(msg)


def prepare_output_folder(result_dir: str, num_qubits: int, script_path: str, tag: str = "") -> str:
    """Creates a timestamped results folder ``result_dir/<n>qubits/<time>``
    (``_tag`` appended) and copies the launching script into it."""
    import datetime

    assert isinstance(result_dir, str)
    assert chk.is_int(num_qubits, num_qubits >= 2)
    now = str(datetime.datetime.now().replace(microsecond=0))
    now = now.replace(":", ".").replace(" ", "_")
    output_dir = os.path.join(result_dir, f"{num_qubits}qubits", now)
    if isinstance(tag, str) and len(tag) > 0:
        output_dir = output_dir + "_" + tag
    os.makedirs(output_dir, exist_ok=True)
    if isinstance(script_path, str) and os.path.isfile(script_path):
        shutil.copy(script_path, os.path.join(output_dir, os.path.basename(script_path)))
    return output_dir


def copy_file_to_folder(directory: str, filename: str) -> None:
    if not os.path.isdir(directory):
        raise IOError("cannot copy: the target directory is missing")
    if not os.path.isfile(filename):
        raise IOError("source file does not exist")
    shutil.copy(filename, os.path.join(directory, os.path.basename(filename)))


def print_options(
    opts: dict, logger: Optional[logging.Logger] = None, numeric_or_str: bool = False
) -> None:
    """Pretty-prints an options dictionary (filters dunder / non-scalar keys)."""

    def _keep(key: str, val: Any) -> bool:
        return not key.startswith("__") and (
            not numeric_or_str or isinstance(val, (str, numbers.Number))
        )

    opts = {k: v for k, v in opts.items() if _keep(k, v)}
    txt = f"\n{'-' * 80}\nOptions:\n{'-' * 80}\n{pformat(opts)}\n{'-' * 80}\n"
    if isinstance(logger, logging.Logger):
        logger.info(txt)
    else:
        pprint(txt)


def sort_and_print_summary(num_qubits: int, results: List[Dict]) -> List[Dict]:
    """Sorts results by cost in place and prints a pandas summary table."""
    import pandas as pd

    assert chk.is_int(num_qubits)
    assert chk.is_list(results) and chk.is_dict(results[0])
    results.sort(key=lambda x: x["cost"])
    assert chk.float_1d(np.asarray(results[0]["thetas"]))
    pd.set_option("display.max_rows", None)
    summary = pd.DataFrame(results, columns=["cost", "num_iters", "time"])
    print(f"\n{'-' * 24}\nSorted valid results:\n{summary}\n")
    return results


def temporary_code(func):
    """Marks temporary or scaffolding code (the reference's decorator): logs
    a warning on the first call and passes through."""
    import functools

    warned = []

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if not warned:
            warned.append(True)
            logging.getLogger(__name__).warning("temporary code path: %s", getattr(func, "__name__", func))
        return func(*args, **kwargs)

    return wrapper
