"""The host-protocol optimization loop with early termination (twin of
``aqc_research_tpu/optim/optimizer.py``).

Backends:

* ``"lbfgs"``  — SciPy L-BFGS-B driven from the host, calling the objective
  and its gradient; only ``maxiter`` and ``maxfun = 5 * maxiter`` are passed.
* ``"adam"``   — Adam on the host, with optax's update rule written in numpy
  (the card's machine has no optax): :func:`_adam_minimize`.
* ``"cobyla"`` — SciPy COBYLA, tol=0.001 (derivative-free).
* ``"bobyqa"`` — SciPy COBYQA with bounds ±2π (derivative-free).

Early termination keeps the exception protocol: an objective raises
``StopIteration``, ``TimeoutError`` or ``StagnantOptimizationWarning``, which
:meth:`AqcOptimizer.optimize` turns into the best-so-far result.  The
objectives hand over float64 numpy gradients, whatever device they run on.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import scipy.optimize as sciopt

from .. import checking as chk
from ..circuit.ansatz import Ansatz
from ..utils import create_logger
from .stoppers import EarlyStopper, StagnantOptimizationWarning, TimeoutChecker

_logger = create_logger(__file__)

_OPTIMIZERS = ["adam", "lbfgs", "cobyla", "bobyqa"]


class AQCOptimResult:
    """The canonical optimization-result dictionary."""

    def __init__(self, circ: Ansatz, thetas_0: np.ndarray):
        self._result = {
            "cost": float(1e30),
            "num_iters": 0,
            "num_fun_ev": 0,
            "num_grad_ev": 0,
            "ini_thetas": np.asarray(thetas_0).copy(),
            "thetas": np.asarray(thetas_0).copy(),
            "blocks": circ.blocks.copy(),
            "entangler": circ.entangler,
            "stats": {},
        }

    def update_from_scipy(self, res: sciopt.OptimizeResult, blocks: np.ndarray):
        """Updates from a SciPy result; the counters accumulate, since an
        optimization may span several epochs."""
        self._result["cost"] = float(res.fun)
        self._result["num_iters"] += int(getattr(res, "nit", 0) or 0)
        self._result["num_fun_ev"] += int(getattr(res, "nfev", 0) or 0)
        self._result["num_grad_ev"] += int(getattr(res, "njev", 0) or 0)
        self._result["thetas"] = np.asarray(res.x).copy()
        self._result["blocks"] = np.asarray(blocks).copy()

    def update_from_dict(self, res: dict):
        assert isinstance(res, dict)
        self._result.update(res)

    @property
    def thetas(self) -> np.ndarray:
        return self._result["thetas"]

    @property
    def as_dict(self) -> dict:
        return self._result


# optax.adam's defaults: moment decays, and eps added after the square root.
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _adam_minimize(fun, jac, x0, maxiter: int, learn_rate: float):
    """Host-driven Adam with ``optax.adam``'s update rule: moments
    ``mu = b1 mu + (1 - b1) g`` and ``nu = b2 nu + (1 - b2) g²``, both
    bias-corrected by ``1 - b^t``, step ``-lr · mu_hat / (sqrt(nu_hat) +
    eps)``, in float64."""
    x = np.asarray(x0, dtype=np.float64).copy()
    mu = np.zeros_like(x)
    nu = np.zeros_like(x)
    for t in range(1, maxiter + 1):
        fun(x)
        grad = np.asarray(jac(x), dtype=np.float64)
        mu = (1.0 - _ADAM_B1) * grad + _ADAM_B1 * mu
        nu = (1.0 - _ADAM_B2) * grad * grad + _ADAM_B2 * nu
        mu_hat = mu / (1.0 - _ADAM_B1**t)
        nu_hat = nu / (1.0 - _ADAM_B2**t)
        x = x + (-learn_rate) * (mu_hat / (np.sqrt(nu_hat) + _ADAM_EPS))
    return sciopt.OptimizeResult(
        x=x, fun=float(fun(x)), nit=maxiter, nfev=maxiter + 1, njev=maxiter, success=True
    )


class AqcOptimizer:
    """Runs the AQC/ASP optimization with early-termination handling."""

    def __init__(
        self,
        *,
        optimizer_name: str = "lbfgs",
        maxiter: int = 1000,
        learn_rate: float = 0.1,
        lbfgs_maxcor: Optional[int] = None,
        verbose: bool = False,
    ):
        assert chk.is_str(optimizer_name, optimizer_name in _OPTIMIZERS)
        assert chk.is_int(maxiter, maxiter > 0)
        assert chk.is_float(learn_rate, 0 < learn_rate < 1)
        self._optimizer_name = optimizer_name
        self._maxiter = int(maxiter)
        self._learn_rate = float(learn_rate)
        self._lbfgs_maxcor = lbfgs_maxcor
        self._verbose = bool(verbose)

    def optimize(
        self,
        objv: Any,
        circ: Ansatz,
        thetas_0: np.ndarray,
        *,
        stopper: Optional[EarlyStopper] = None,
        timeout: Optional[TimeoutChecker] = None,
    ) -> dict:
        """Runs the optimization; returns the canonical result dict, with
        "is_timeout" and, where the objective has one, "fidelity"."""
        assert hasattr(objv, "objective") and hasattr(objv, "gradient")
        assert isinstance(circ, Ansatz)
        thetas_0 = np.asarray(thetas_0, dtype=np.float64)

        result = AQCOptimResult(circ, thetas_0)
        opname = self._optimizer_name
        is_timeout = False

        def _fun(th):
            return float(objv.objective(np.asarray(th)))

        def _jac(th):
            return np.asarray(objv.gradient(np.asarray(th)), dtype=np.float64)

        try:
            if hasattr(objv, "set_status_trackers"):
                objv.set_status_trackers(timeout=timeout, stopper=stopper)
            self._log(f"starting the {opname.upper()} loop ...")
            if opname == "adam":
                res = _adam_minimize(_fun, _jac, thetas_0, self._maxiter, self._learn_rate)
            elif opname == "lbfgs":
                options = {"maxiter": self._maxiter, "maxfun": 5 * self._maxiter}
                if self._lbfgs_maxcor:
                    options["maxcor"] = int(self._lbfgs_maxcor)
                res = sciopt.minimize(_fun, thetas_0, jac=_jac, method="L-BFGS-B", options=options)
            elif opname == "cobyla":
                res = sciopt.minimize(
                    _fun, thetas_0, method="COBYLA", tol=0.001, options={"maxiter": self._maxiter}
                )
            else:  # "bobyqa"
                bounds = [(-2 * np.pi, 2 * np.pi)] * thetas_0.size
                res = sciopt.minimize(
                    _fun, thetas_0, method="COBYQA", bounds=bounds, options={"maxiter": self._maxiter}
                )
            result.update_from_scipy(res, circ.blocks)

        except StopIteration as ex:
            self._log(str(ex))
            if hasattr(objv, "optim_results"):
                result.update_from_dict(objv.optim_results)
            elif stopper is not None:
                result.update_from_dict(stopper.optim_results)
        except StagnantOptimizationWarning as ex:
            self._log(str(ex))
            if hasattr(objv, "optim_results"):
                result.update_from_dict(objv.optim_results)
        except TimeoutError as ex:
            is_timeout = True
            self._log(str(ex))
            if hasattr(objv, "optim_results"):
                result.update_from_dict(objv.optim_results)
            elif timeout is not None:
                result.update_from_dict(timeout.optim_results)
        finally:
            result.update_from_dict({"is_timeout": is_timeout})
            if hasattr(objv, "fidelity"):
                result.update_from_dict({"fidelity": objv.fidelity})

        if hasattr(objv, "statistics"):
            stats = {"stats": objv.statistics}
            stats["stats"]["is_timeout"] = is_timeout
            result.update_from_dict(stats)

        return result.as_dict

    def _log(self, msg: str) -> None:
        if self._verbose:
            _logger.info(msg)
