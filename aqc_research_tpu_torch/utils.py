"""Logging, timing and entry-point helpers of the ASP driver (the parts of
``aqc_research_tpu/utils/__init__.py`` the driver uses): a module logger,
the graceful-exit sentinel, an accumulating timer, the script entry point,
a file copy and an options printout."""

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

from . import checking as chk


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
