"""State handlers and the objective base of the host-protocol ASP objectives
(twin of ``aqc_research_tpu/models/sp_lhs/objective_base.py``).

The flip-state subspace {|0>, X_i|0>, X_i X_j|0>, ...} gives the local
surrogate objective its O(n) cost: each Hilbert-Schmidt product
``<state|V†|target>`` is one element pick (dense path) or one O(n χ²)
contraction (MPS path) of the cached ``V† target``.

The objectives follow SciPy's protocol: ``objective(θ)`` and ``gradient(θ)``
take float64 numpy θ, cast once to ``config.real_dtype()`` on the device,
and return a float and a float64 numpy gradient.  States, the target and
``V† target`` stay on the device; only the flip-state projections and the
gradient come to the host.  Counters, statistics and the hysteresis state
live on the host.
"""

from __future__ import annotations

import functools
import itertools
from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ... import checking as chk
from ... import config
from ...circuit.ansatz import Ansatz, TrotterAnsatz
from ...circuit.program import GateProgram, program_to_state, state_preparation_program
from ...ops import mps as mpsop
from ...optim.stoppers import EarlyStopper, TimeoutChecker
from ...utils import create_logger

_logger = create_logger(__file__)


def _host_complex(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a complex128 numpy array."""
    return np.asarray(t.detach().cpu().numpy(), dtype=np.complex128)


# -----------------------------------------------------------------------------
# Flip-state handlers.
# -----------------------------------------------------------------------------


class ThinStateHandler:
    """Flip states stored as their single nonzero index: O(1) memory per
    state and O(1) dot products by element picks."""

    def __init__(self, num_qubits: int, max_flips: int, verbose: bool = False):
        assert chk.is_int(num_qubits, num_qubits >= 2)
        assert chk.is_int(max_flips, 0 <= max_flips <= num_qubits)
        if verbose:
            _logger.info("State handler: %s", self.__class__.__name__)

        dim = 2**num_qubits
        comb_labels, num_states = self._generate_combinations(num_qubits, max_flips)
        self._comb_labels = comb_labels
        self._num_qubits = num_qubits
        self._state_idx = np.zeros(num_states, dtype=np.int64)
        count = 1
        for flips in range(max_flips):
            for subset in comb_labels[flips]:
                index = 0
                for k in subset:
                    index ^= 1 << k  # little-endian bit flip
                assert 0 <= index < dim
                self._state_idx[count] = index
                count += 1
        assert count == num_states

    @property
    def state_indices(self) -> np.ndarray:
        """The nonzero element's index of every flip state."""
        return self._state_idx

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(2**self._num_qubits, dtype=config.complex_dtype(), device=config.device())

    def init_state(self, state_no: int) -> torch.Tensor:
        """One-hot vector of the requested flip state, on the device."""
        assert chk.is_int(state_no, 0 <= state_no < self.num_states)
        state = self._zeros()
        state[int(self._state_idx[state_no])] = 1
        return state

    @property
    def state0(self) -> torch.Tensor:
        return self.init_state(0)

    def state_dot_vector(self, state_no: int, vec: torch.Tensor) -> complex:
        """``<state|vec>``: one element pick."""
        assert chk.is_int(state_no, 0 <= state_no < self.num_states)
        return complex(vec[int(self._state_idx[state_no])].item())

    def _check_coefs(self, coefs: np.ndarray, size: int) -> None:
        assert coefs.size == size
        assert abs(np.linalg.norm(coefs) - 1) < np.sqrt(np.finfo(np.float64).eps)

    def init_composite_state_no_zero(self, coefs: np.ndarray) -> torch.Tensor:
        """Linear combination of the flip states, |0> excluded."""
        self._check_coefs(coefs, self.num_states - 1)
        state = self._zeros()
        state[torch.as_tensor(self._state_idx[1:], device=state.device)] = torch.as_tensor(
            coefs, dtype=state.dtype, device=state.device
        )
        return state

    def init_composite_state(self, coefs: np.ndarray) -> torch.Tensor:
        """Linear combination of all flip states."""
        self._check_coefs(coefs, self.num_states)
        state = self._zeros()
        state[torch.as_tensor(self._state_idx, device=state.device)] = torch.as_tensor(
            coefs, dtype=state.dtype, device=state.device
        )
        return state

    def _picks(self, vec: torch.Tensor, idx: np.ndarray) -> np.ndarray:
        return _host_complex(vec[torch.as_tensor(idx, device=vec.device)])

    def composite_state_dot_vector_no_zero(self, coefs, vec) -> complex:
        assert coefs.size == self.num_states - 1
        return complex(np.vdot(coefs, self._picks(vec, self._state_idx[1:])))

    def composite_state_dot_vector(self, coefs, vec) -> complex:
        assert coefs.size == self.num_states
        return complex(np.vdot(coefs, self._picks(vec, self._state_idx)))

    @property
    def num_states(self) -> int:
        return self._state_idx.size

    @property
    def flip_qubit_positions(self) -> List[List[Tuple]]:
        return self._comb_labels

    @staticmethod
    def _generate_combinations(num_qubits: int, max_flips: int) -> Tuple[list, int]:
        s = list(range(num_qubits))
        comb_labels = [[] for _ in range(max_flips)]
        for flip in range(1, max_flips + 1):
            for subset in itertools.combinations(s, flip):
                comb_labels[flip - 1].append(subset)
        num_states = functools.reduce(lambda n, a: n + len(a), comb_labels, 1)
        return comb_labels, num_states


class _NoCompositeStates:
    """The composite-state interface of the handlers that cache full states:
    not supported (max_flips <= 1 keeps them small)."""

    def init_composite_state_no_zero(self, _):
        raise NotImplementedError("composite states need the ThinStateHandler")

    def init_composite_state(self, _):
        raise NotImplementedError("composite states need the ThinStateHandler")

    def composite_state_dot_vector_no_zero(self, _, __):
        raise NotImplementedError("composite states need the ThinStateHandler")

    def composite_state_dot_vector(self, _, __):
        raise NotImplementedError("composite states need the ThinStateHandler")


class GenericStateHandler(_NoCompositeStates):
    """Caches the full vectors ``S X_i |0>`` of a state-prep program ``S``,
    as one (num_states, 2^n) device tensor.  max_flips <= 1."""

    def __init__(
        self,
        num_qubits: int,
        max_flips: int,
        state_prep_func: Optional[Callable[[int], GateProgram]] = None,
        verbose: bool = False,
    ):
        assert chk.is_int(num_qubits, num_qubits >= 2)
        if max_flips > 1:
            raise ValueError("expects 'max_flips <= 1' to save memory")
        if verbose:
            _logger.info("State handler: %s", self.__class__.__name__)
        self._states = torch.stack([
            program_to_state(
                state_preparation_program(num_qubits, flip_bit=i - 1, state_prep_func=state_prep_func),
                num_qubits,
            )
            for i in range(num_qubits + 1)
        ])

    @property
    def states_matrix(self) -> torch.Tensor:
        """(num_states, dim): all cached states."""
        return self._states

    def init_state(self, state_no: int) -> torch.Tensor:
        assert chk.is_int(state_no, 0 <= state_no < self.num_states)
        return self._states[state_no]

    def state_dot_vector(self, state_no: int, vec: torch.Tensor) -> complex:
        assert chk.is_int(state_no, 0 <= state_no < self.num_states)
        return complex(torch.vdot(self._states[state_no], vec).item())

    @property
    def state0(self) -> torch.Tensor:
        return self._states[0]

    @property
    def num_states(self) -> int:
        return self._states.shape[0]


class MpsStateHandler(_NoCompositeStates):
    """Flip states ``S X_i |0>`` in MPS form at bond dimension ``chi_max``.
    max_flips <= 1."""

    def __init__(
        self,
        num_qubits: int,
        max_flips: int,
        state_prep_func: Optional[Callable[[int], GateProgram]] = None,
        verbose: bool = False,
        chi_max: int = 8,
    ):
        assert chk.is_int(num_qubits, num_qubits >= 2)
        if max_flips > 1:
            raise ValueError("expects 'max_flips <= 1' to save memory & time")
        if verbose:
            _logger.info("State handler: %s", self.__class__.__name__)
        self._states = [
            mpsop.mps_from_program(
                state_preparation_program(num_qubits, flip_bit=i - 1, state_prep_func=state_prep_func),
                num_qubits,
                chi_max=chi_max,
            )
            for i in range(num_qubits + 1)
        ]

    def init_state(self, state_no: int) -> mpsop.MPS:
        assert chk.is_int(state_no, 0 <= state_no < self.num_states)
        return self._states[state_no]

    def state_dot_vector(self, state_no: int, vec: mpsop.MPS) -> complex:
        assert chk.is_int(state_no, 0 <= state_no < self.num_states)
        return complex(mpsop.mps_dot(self._states[state_no], vec).item())

    @property
    def state0(self) -> mpsop.MPS:
        return self._states[0]

    @property
    def num_states(self) -> int:
        return len(self._states)


# -----------------------------------------------------------------------------
# Optimization bookkeeping.
# -----------------------------------------------------------------------------


class SpService:
    """Iteration counters, early-stop dispatch, statistics and progress
    printing of one objective."""

    def __init__(self, user_parameters: dict, circuit: Ansatz, num_states: int, verbose: bool = False):
        assert isinstance(user_parameters, dict)
        assert isinstance(circuit, Ansatz)
        self._params = user_parameters
        self._circuit = circuit
        self._num_states = num_states
        self._verbose = bool(verbose)
        self._num_fun_ev = 0
        self._num_grad_ev = 0
        self._stats: dict = {}
        self._timeout_checker: Optional[TimeoutChecker] = None
        self._early_stopper: Optional[EarlyStopper] = None

        if user_parameters.get("enable_optim_stats", False):
            self._stats = {
                "hs2": np.empty((0, num_states), dtype=np.float16),
                "weight": np.empty(0, dtype=np.float16),
                "fobj": np.empty(0, dtype=np.float32),
                "grad": np.empty(0, dtype=np.float32),
                "num_fun_ev": 0,
                "num_grad_ev": 0,
            }

    def set_status_trackers(
        self, timeout: Optional[TimeoutChecker] = None, stopper: Optional[EarlyStopper] = None
    ):
        self._timeout_checker = timeout
        self._early_stopper = stopper

    @property
    def statistics(self) -> dict:
        return self._stats

    @property
    def num_fun_ev(self) -> int:
        return self._num_fun_ev

    @property
    def num_grad_ev(self) -> int:
        return self._num_grad_ev

    def _on_stop(self, fobj: float, thetas: np.ndarray) -> dict:
        if self._verbose:
            _logger.warning("optimizer halted early by a stop condition")
        return {
            "cost": fobj,
            "num_fun_ev": self._num_fun_ev,
            "num_grad_ev": self._num_grad_ev,
            "num_iters": self._num_grad_ev,
            "thetas": np.asarray(thetas).copy(),
            "blocks": self._circuit.blocks.copy(),
        }

    def on_begin_gradient(self, fobj: float, thetas: np.ndarray, fidelity: Optional[float] = None):
        if self._timeout_checker:
            self._timeout_checker.check(fobj, thetas, self._on_stop)
        if self._early_stopper:
            self._early_stopper.check(
                fobj=fobj, fidelity=fidelity, thetas=thetas, iter_no=self._num_grad_ev, on_stop=self._on_stop
            )

    def on_end_gradient(self, fobj: float, fidelity: float, grad: np.ndarray, hs2: np.ndarray, weight: float):
        self._num_grad_ev += 1
        if self._params.get("enable_optim_stats", False):
            sts = self._stats
            sts["hs2"] = np.vstack([sts["hs2"], np.asarray(hs2, np.float16)])
            sts["weight"] = np.append(sts["weight"], np.float16(weight))
            sts["fobj"] = np.append(sts["fobj"], np.float32(fobj))
            sts["grad"] = np.append(sts["grad"], np.float32(np.linalg.norm(grad)))
            sts["num_fun_ev"] = self._num_fun_ev
            sts["num_grad_ev"] = self._num_grad_ev
            sts["num_iters"] = self._num_grad_ev

        verbose = self._params.get("verbose", False)
        maxiter = self._params.get("maxiter", 100)
        if self._num_grad_ev % max(1, maxiter // 50) == 0:
            if verbose and self._params.get("num_simulations", 1) == 1:
                fid_str = f", fidelity: {fidelity:0.6f}" if fidelity >= 0 else ""
                _logger.info("fobj: %0.6f %s", fobj, fid_str)
            else:
                print(".", end="", flush=True)

    def on_end_objective(self):
        self._num_fun_ev += 1

    def on_epoch_end(self):
        if self._verbose:
            _logger.warning("epoch boundary reached (stats marked with NaN row)")
        if self._stats:
            sts = self._stats
            sts["hs2"] = np.vstack([sts["hs2"], np.full((1, self._num_states), np.nan, np.float16)])
            sts["weight"] = np.append(sts["weight"], np.float16(np.nan))
            sts["fobj"] = np.append(sts["fobj"], np.float32(np.nan))
            sts["grad"] = np.append(sts["grad"], np.float32(np.nan))


# -----------------------------------------------------------------------------
# The objective base.
# -----------------------------------------------------------------------------


class SpLHSObjectiveBase(ABC):
    """Base of the surrogate ASP objectives: caches ``V† target`` between
    the objective and the gradient call (the optimizer makes them
    separately) and re-evaluates the objective when θ changed in between."""

    def __init__(self, user_parameters: dict, circuit: Ansatz, use_mps: bool = False, verbose: bool = False):
        assert isinstance(user_parameters, dict)
        assert isinstance(circuit, Ansatz)
        if verbose:
            _logger.info("Objective: %s", self.__class__.__name__)
            if isinstance(circuit, TrotterAnsatz):
                _logger.info("objective runs on a Trotterized ansatz")

        self._params = user_parameters
        self._circuit = circuit
        self._target = None
        self._last_thetas = np.empty(0)
        self._use_mps = bool(use_mps)
        self._verbose = bool(verbose)
        self._print_grad_warning = True
        self._vh_target = None

        num_qubits = user_parameters["num_qubits"]
        max_flips = user_parameters["max_flips"]
        state_prep_func = user_parameters.get("state_prep_func", None)
        if use_mps:
            # The co-sweep gradient applies the ansatz to the flip states, so
            # their bond dimension is the working χ of the target path.
            chi_max = int(user_parameters.get("chi_max", 64))
            self._state_handler = MpsStateHandler(num_qubits, max_flips, state_prep_func, verbose, chi_max=chi_max)
            self._num_states = num_qubits + 1
            if max_flips != 1:
                raise ValueError("the MPS state handler supports max_flips=1 only")
        else:
            if state_prep_func is None:
                self._state_handler = ThinStateHandler(num_qubits, max_flips, verbose)
            else:
                self._state_handler = GenericStateHandler(num_qubits, max_flips, state_prep_func, verbose)
            self._num_states = self._state_handler.num_states

        self._service = SpService(user_parameters, circuit, self._num_states, verbose=verbose)
        self._hs2 = np.zeros(self._num_states)
        self._fobj = 1.0
        self._weight = 1.0

    @staticmethod
    def _device_thetas(thetas: np.ndarray) -> torch.Tensor:
        """θ (float64 numpy from the optimizer) in the precision in effect on
        the device."""
        return torch.as_tensor(np.asarray(thetas, dtype=np.float64), device=config.device()).to(
            config.real_dtype()
        )

    def _store_latest_thetas(self, thetas: np.ndarray):
        # A copy: SciPy may reuse the buffer it passed for the next point.
        self._last_thetas = np.array(thetas, dtype=np.float64, copy=True)

    def _calc_objective_before_gradient(self, thetas: np.ndarray):
        """Makes the cached ``V† target`` correspond to ``thetas``."""
        tol = float(np.sqrt(np.finfo(np.float64).eps))
        last = self._last_thetas
        if last.size == 0 or not np.allclose(thetas, last, atol=tol, rtol=tol):
            self.objective(thetas)
            if self._verbose and self._print_grad_warning:
                _logger.warning(
                    "thetas changed since the last objective call — re-evaluating it before the gradient"
                )
                self._print_grad_warning = False

    @abstractmethod
    def objective(self, thetas: np.ndarray) -> float:
        raise NotImplementedError()

    @abstractmethod
    def gradient(self, thetas: np.ndarray) -> np.ndarray:
        raise NotImplementedError()

    def set_status_trackers(self, timeout: Optional[TimeoutChecker] = None, stopper: Optional[EarlyStopper] = None):
        self._service.set_status_trackers(timeout, stopper)

    @property
    def num_thetas(self) -> int:
        return self._circuit.num_thetas

    @property
    def num_states(self) -> int:
        return self._num_states

    @property
    def target(self):
        return self._target

    def set_target(self, target) -> None:
        """A dense target (numpy or tensor; numpy goes to the device in the
        precision in effect) or, for an MPS objective, an MPS."""
        if isinstance(target, mpsop.MPS):
            assert self._use_mps
            self._target = target
            return
        assert not self._use_mps
        if not isinstance(target, torch.Tensor):
            target = torch.tensor(np.asarray(target), device=config.device()).to(config.complex_dtype())
        self._target = target

    @property
    def statistics(self) -> dict:
        return self._service.statistics

    def on_epoch_end(self):
        self._service.on_epoch_end()


class MaxProjectionSurrogate(SpLHSObjectiveBase):
    """The max-projection surrogate both host objectives compute:
    ``fobj = 1 - (1-w)·hs2[0] - w·hs2[max]`` with ``hs[i] = <state_i|V†|target>``,
    ``max`` the leading flip state chosen with 1.1x hysteresis, and the weight
    EMA ``w += 0.1·(sqrt|fobj| - w)`` after every gradient.  A subclass
    computes the projections and the complex dot gradients on its engine."""

    _gamma = 0.1  # EMA rate of the weighting factor

    def __init__(self, user_parameters: dict, circuit: Ansatz, use_mps: bool, verbose: bool, grad_scaler):
        super().__init__(user_parameters, circuit, use_mps=use_mps, verbose=verbose)
        self._fidelity = -1.0
        self._grad_scaler = grad_scaler
        self._hs = np.zeros(self._num_states, dtype=np.complex128)
        self._max_no = 0

    def _objective_from_projections(self, hs: np.ndarray) -> float:
        """Host bookkeeping of one objective call from the projections."""
        self._hs = np.asarray(hs, dtype=np.complex128)
        np.copyto(self._hs2, np.abs(self._hs) ** 2)
        # Hysteresis: switch the leading state only on a clearly better one.
        max_proj = self._hs2[self._max_no]
        for i in range(self.num_states):
            if 1.1 * max_proj < self._hs2[i]:
                max_proj = self._hs2[i]
                self._max_no = i
        wgh = self._weight
        self._fobj = float(1.0 - (1.0 - wgh) * self._hs2[0] - wgh * self._hs2[self._max_no])
        self._fidelity = float(self._hs2[0])
        self._service.on_end_objective()
        return self._fobj

    def _gradient_from_dots(self, thetas: np.ndarray, dot_gradient: Callable[[int], torch.Tensor]) -> np.ndarray:
        """The surrogate's float64 gradient from ``dot_gradient(i)``, the
        complex gradient of ``<state_i|V†|target>`` at the cached ``V†
        target``: one co-sweep, a second where the leading state is not
        |0>.  Runs the stop checks first and re-evaluates the objective if
        θ changed since it."""
        self._service.on_begin_gradient(self._fobj, thetas, self._fidelity)
        self._calc_objective_before_gradient(thetas)
        grad_0 = _host_complex(dot_gradient(0))
        if self._max_no == 0:
            full_grad = (grad_0 * (-2 * np.conj(self._hs[0]))).real.copy()
        else:
            full_grad = (grad_0 * (-2 * (1 - self._weight) * np.conj(self._hs[0]))).real.copy()
            grad_max = _host_complex(dot_gradient(self._max_no))
            full_grad += (grad_max * (-2 * self._weight * np.conj(self._hs[self._max_no]))).real
        if self._grad_scaler:
            full_grad *= self._grad_scaler.estimate(self._fobj)
        self._weight += self._gamma * (float(np.sqrt(abs(self._fobj))) - self._weight)
        self._service.on_end_gradient(self._fobj, self._fidelity, full_grad, self._hs2, self._weight)
        return full_grad

    @property
    def fidelity(self) -> float:
        return self._fidelity
