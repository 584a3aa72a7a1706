"""Early-termination trackers and gradient amplification (twin of
``aqc_research_tpu/optim/stoppers.py``).

The host-protocol optimizer (optim/optimizer.py) keeps the reference's
exception-driven control flow: an objective raises ``StopIteration``,
``TimeoutError`` or :class:`StagnantOptimizationWarning`, and the optimizer
turns it into the best-so-far result.  Everything here is numpy and host
clocks; the device loop of optim/lbfgs.py carries the same stop conditions
as flags instead.
"""

from __future__ import annotations

from collections import deque
from time import perf_counter
from typing import Callable, Optional, Union

import numpy as np

from .. import checking as chk
from ..utils import create_logger

_logger = create_logger(__file__)


class StagnantOptimizationWarning(UserWarning):
    """Raised when the optimization makes no progress."""


class TimeoutStopper:
    """Raises TimeoutError once a wall-clock limit is exceeded."""

    def __init__(self, *, time_limit: int):
        assert chk.is_int(time_limit)
        self._end_time = -1.0
        if time_limit > 0:
            self._end_time = perf_counter() + time_limit

    def check(self) -> None:
        if 0 < self._end_time < perf_counter():
            raise TimeoutError("optimization time budget exhausted")


class NotImproveStopper:
    """Flags/raises when fobj has not decreased for ``num_iters`` iterations;
    supports reset/disable for restart loops."""

    def __init__(self, *, num_iters: int, raise_ex: bool = True):
        assert chk.is_int(num_iters, num_iters > 1)
        self._num_iters = int(num_iters)
        self._min_fobj = np.inf
        self._min_iteration = 0
        self._enabled = True
        self._raise_ex = bool(raise_ex)

    def reset(self) -> None:
        self._min_fobj = np.inf
        self._min_iteration = 0
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def check(self, fobj: float, iter_no: int) -> bool:
        if not self._enabled:
            return False
        if fobj < self._min_fobj:
            self._min_fobj = fobj
            self._min_iteration = iter_no
        elif iter_no - self._min_iteration > self._num_iters:
            if self._raise_ex:
                raise StagnantOptimizationWarning(
                    f"objective stagnant for {self._num_iters} iterations — stopping"
                )
            return True
        return False


class SmallObjectiveStopper:
    """Raises StopIteration once fobj falls below a threshold."""

    def __init__(self, *, fobj_thr: float):
        assert chk.is_float(fobj_thr)
        self._fobj_thr = float(fobj_thr)

    def check(self, fobj: float) -> None:
        if fobj < self._fobj_thr:
            raise StopIteration(
                f"objective {fobj:0.5f} is under the stop threshold "
                f"{self._fobj_thr:0.5f} — done"
            )


class TimeoutChecker:
    """Timeout tracker that snapshots the best-so-far result before raising."""

    def __init__(self, *, time_limit: Union[int, dict], start_immediately: bool = True):
        if isinstance(time_limit, dict):
            time_limit = time_limit.get("timeout", -1)
        assert chk.is_int(time_limit)
        self._end_time = -1.0
        self._time_limit = int(time_limit)
        self._results: dict = {}
        if start_immediately:
            self.start()

    def start(self) -> None:
        self._end_time = -1.0 if self._time_limit <= 0 else perf_counter() + self._time_limit

    def check(
        self,
        fobj: float,
        thetas: np.ndarray,
        on_stop: Optional[Callable[[float, np.ndarray], dict]] = None,
    ) -> None:
        if 0 < self._end_time < perf_counter():
            if on_stop is not None:
                self._results = on_stop(fobj, thetas)
            raise TimeoutError("time limit reached mid-optimization")

    @property
    def optim_results(self) -> dict:
        return self._results


class EarlyStopper:
    """One-shot stop-condition monitor of the host-driven optimizer loop.

    Watches three triggers — objective below ``fobj_thr``, fidelity at or
    above ``fidelity_thr``, and a stall of more than ``num_iters`` iterations
    without a new objective minimum — and raises ``StopIteration`` on the
    first one that fires, after snapshotting the result through the
    caller's ``on_stop``.  On a stall the snapshot is taken at the running
    minimum, not at the current point."""

    def __init__(
        self,
        fobj_thr: Optional[float] = None,
        fidelity_thr: Optional[float] = None,
        num_iters: Optional[int] = None,
    ):
        if fidelity_thr is not None and not 0 < fidelity_thr <= 1:
            raise ValueError("fidelity_thr must lie in (0, 1]")
        self._fobj_thr = fobj_thr
        self._fidelity_thr = fidelity_thr
        self._stall_limit = int(num_iters) if num_iters else 0
        # Running minimum as (fobj, thetas copy, iter_no); None until the
        # first check that carries an objective value.
        self._best: Optional[tuple] = None
        self._results: dict = {}

    def _halt(self, on_stop, fobj, thetas, reason: str) -> None:
        self._results = on_stop(fobj, thetas)
        raise StopIteration(reason)

    def check(
        self,
        fobj: Union[float, None],
        fidelity: Union[float, None],
        thetas: np.ndarray,
        iter_no: int,
        on_stop: Callable[[float, np.ndarray], dict],
    ) -> None:
        if fobj is not None:
            if self._best is None or fobj < self._best[0]:
                self._best = (fobj, np.array(thetas, copy=True), iter_no)
            if self._fobj_thr is not None and fobj < self._fobj_thr:
                self._halt(
                    on_stop,
                    fobj,
                    thetas,
                    f"stop: objective {fobj:0.5f} reached its target {self._fobj_thr:0.5f}",
                )
            if self._stall_limit > 0 and iter_no - self._best[2] > self._stall_limit:
                best_fobj, best_thetas, _ = self._best
                self._halt(
                    on_stop,
                    best_fobj,
                    best_thetas,
                    f"stop: stalled for more than {self._stall_limit} iterations",
                )
        if fidelity is not None and self._fidelity_thr is not None and fidelity >= self._fidelity_thr:
            self._halt(
                on_stop,
                fobj,
                thetas,
                f"stop: fidelity {fidelity:0.3f} reached its target {self._fidelity_thr:0.3f}",
            )

    @property
    def optim_results(self) -> dict:
        return self._results


class GradientAmplifier:
    """Adaptive gradient rescaling for barren-plateau escapes.

    Keeps a ring buffer of the latest objective samples.  Once it is full,
    the window's spread (max - min) maps through ``-log10`` (``-ln`` when
    ``strong``), clamped below at 1, and the published scale follows that
    target through an exponential moving average: a flat window pushes the
    scale up smoothly, normal progress keeps it at 1."""

    # EMA weight and the spread floor that guards the log on flat windows.
    _EMA_WEIGHT = 0.3
    _SPREAD_FLOOR = 1e-8

    def __init__(self, history: int = 5, strong: bool = False, verbose: bool = False):
        if int(history) < 3:
            raise ValueError("history window must hold at least 3 samples")
        self._window: "deque[float]" = deque(maxlen=int(history))
        self._log = np.log if strong else np.log10
        self._scale = 1.0
        self._verbose = bool(verbose)
        if verbose:
            _logger.warning("gradient amplification active (experimental barren-plateau aid)")

    def estimate(self, fobj: float) -> float:
        self._window.append(float(fobj))
        if len(self._window) < self._window.maxlen:
            return 1.0
        spread = max(self._window) - min(self._window)
        target = max(1.0, -float(self._log(max(spread, self._SPREAD_FLOOR))))
        w = self._EMA_WEIGHT
        self._scale = (1.0 - w) * self._scale + w * target
        if self._verbose and self._scale > 1.5:
            _logger.info("amplifying gradients by %0.4f", self._scale)
        return self._scale
