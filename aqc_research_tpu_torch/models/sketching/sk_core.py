"""Sketching objective and sketching-vector generators for full and
sketched AQC (twin of ``aqc_research_tpu/models/sketching/sk_core.py``).

Objective: ``fobj = 1 - Re <X, V† Y> / m`` with ``Y = U X`` over ``m``
sketching columns; ``X = I`` is full AQC.  One call computes the objective
and its gradient together: ``V† Y`` (fused 4x4 block applies on a
(2^n, m) matrix), then the matrix co-sweep gradient, on the default device.

Sketching vectors are drawn on the host with numpy from its global stream,
so the same seed gives the JAX package's X and Y.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from time import perf_counter
from typing import Optional, Tuple

import numpy as np
import torch

from ... import checking as chk
from ...circuit.ansatz import Ansatz
from ...config import complex_dtype, device, real_of
from ...ops.gradients import grad_of_matrix_dot_product
from ...ops.statevector import v_dagger_mul_mat
from ...optim.stoppers import (
    GradientAmplifier,
    NotImproveStopper,
    SmallObjectiveStopper,
    TimeoutStopper,
)


class SketchingVectorsBase(ABC):
    """Generator contract: produce (X, Y = U @ X) stacked in columns.
    ``num_skvecs`` must be a power of 2."""

    def __init__(self, num_skvecs: int, target_mat: np.ndarray):
        assert chk.is_int(num_skvecs)
        assert chk.complex_2d_square(target_mat)
        num_skvecs = min(max(num_skvecs, 1), target_mat.shape[0])
        if not (num_skvecs > 0 and ((num_skvecs - 1) & num_skvecs) == 0):
            raise ValueError("'num_skvecs' must be a power of 2 number")
        self._num_skvecs = num_skvecs
        self._target_mat = np.asarray(target_mat)

    @property
    def num_skvecs(self) -> int:
        return self._num_skvecs

    @property
    def target_matrix(self) -> np.ndarray:
        return self._target_mat

    @abstractmethod
    def generate(
        self,
        circ: Optional[Ansatz] = None,
        thetas: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError("abstract method")


def objective_and_gradient(circ: Ansatz, thetas: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """``fobj = 1 - Re<X, V† Y>/m`` and its real gradient ``-Re ∇/m``, in
    one pass of ``V† Y`` and one co-sweep; X and Y (2^n, m) on the device
    the result lives on."""
    m = x.shape[-1]
    vh_y = v_dagger_mul_mat(circ, thetas, y)
    fobj = 1.0 - torch.vdot(x.reshape(-1), vh_y.reshape(-1)).real / m
    grad = grad_of_matrix_dot_product(circ, thetas, x, vh_y)
    return fobj.to(thetas.dtype), (-grad.real / m).to(thetas.dtype)


def sketch_tensors(x: np.ndarray, y: np.ndarray):
    """X and Y as tensors of the precision in effect on the default device."""
    cdt = complex_dtype()
    dev = device()
    return torch.as_tensor(np.asarray(x), device=dev).to(cdt), torch.as_tensor(np.asarray(y), device=dev).to(cdt)


class SketchingObjectiveEx:
    """Sketching objective with best-so-far tracking, stop checks, and the
    split objective()/gradient() interface for host-driven optimizers."""

    def __init__(
        self,
        circ: Ansatz,
        skvecs: SketchingVectorsBase,
        *,
        enable_stats: bool = False,
        grad_scaler: Optional[GradientAmplifier] = None,
        stop_timeout: Optional[TimeoutStopper] = None,
        stop_stagnant: Optional[NotImproveStopper] = None,
        stop_small_fobj: Optional[SmallObjectiveStopper] = None,
        logger=None,
    ):
        assert isinstance(circ, Ansatz)
        assert isinstance(skvecs, SketchingVectorsBase)
        self._circ = circ
        self._target = skvecs.target_matrix
        self._skvecs = skvecs
        self._enable_stats = bool(enable_stats)
        self._grad_scaler = grad_scaler
        self._stop_timeout = stop_timeout
        self._stop_stagnant = stop_stagnant
        self._stop_small_fobj = stop_small_fobj
        self._logger = logger

        self._fobj_best = float(np.inf)
        self._thetas_best = np.zeros(circ.num_thetas)
        self._nit = 0
        self._fobj_profile: list = []

        self._fobj_latest = float(1e30)
        self._grad_latest = np.empty(0)
        self._thetas_latest = np.empty(0)

        self._elapsed_time = perf_counter()
        self._period = int(round(10 + 60.0 / (1 + 2.0 ** (6 - circ.num_qubits))))

    def objective_and_gradient(self, thetas: np.ndarray) -> Tuple[float, np.ndarray]:
        now = perf_counter()
        if self._elapsed_time + self._period < now:
            print(".", end="", flush=True)
            self._elapsed_time = now

        x, y = sketch_tensors(*self._skvecs.generate(self._circ, np.asarray(thetas)))
        th = torch.as_tensor(np.asarray(thetas, np.float64), device=x.device).to(real_of(x.dtype))
        with torch.no_grad():
            fobj, grad = objective_and_gradient(self._circ, th, x, y)
        fobj, grad = float(fobj), grad.cpu().numpy().astype(np.float64)

        if self._grad_scaler:
            grad *= self._grad_scaler.estimate(fobj)

        if fobj < self._fobj_best:
            self._fobj_best = fobj
            np.copyto(self._thetas_best, np.asarray(thetas))

        self._nit += 1
        if self._enable_stats:
            self._fobj_profile.append(fobj)
        if self._logger is not None:
            gnorm = np.linalg.norm(grad)
            print(f"\riter: {self._nit:4d}, fobj: {fobj:0.4f}, |grad|: {gnorm:0.5f}")

        if self._stop_timeout:
            self._stop_timeout.check()
        if self._stop_stagnant:
            self._stop_stagnant.check(fobj=fobj, iter_no=self._nit)
        if self._stop_small_fobj:
            self._stop_small_fobj.check(fobj=fobj)

        return fobj, grad

    def objective(self, thetas: np.ndarray) -> float:
        self._thetas_latest = np.asarray(thetas).copy()
        self._fobj_latest, self._grad_latest = self.objective_and_gradient(thetas)
        return self._fobj_latest

    def gradient(self, thetas: np.ndarray) -> np.ndarray:
        tol = float(10.0 * np.finfo(np.float64).eps)
        last = self._thetas_latest
        if last.size == 0 or not np.allclose(thetas, last, atol=tol, rtol=tol):
            self.objective(thetas)
        return self._grad_latest

    @property
    def statistics(self) -> dict:
        return {
            "convergence_profile": np.asarray(self._fobj_profile, dtype=np.float32),
            "nit": self._nit,
        }

    @property
    def num_iterations(self) -> int:
        return self._nit

    @property
    def optim_results(self) -> dict:
        return {
            "cost": float(self._fobj_best),
            "num_fun_ev": self._nit,
            "num_grad_ev": self._nit,
            "num_iters": self._nit,
            "thetas": self._thetas_best,
            "entangler": self._circ.entangler,
            "blocks": self._circ.blocks.copy(),
        }

    def set_status_trackers(self, timeout, stopper):
        """Compatibility hook for AqcOptimizer."""


# -----------------------------------------------------------------------------
# Sketching-vector generators.
# -----------------------------------------------------------------------------


class FullRangeSketchingVectors(SketchingVectorsBase):
    """X = I, Y = U — the full AQC problem."""

    def __init__(self, target_mat: np.ndarray):
        super().__init__(target_mat.shape[0], target_mat)

    def generate(self, _=None, __=None):
        dim = self.target_matrix.shape[0]
        return np.eye(dim, dtype=np.complex128), self.target_matrix


class RandomSketchingVectors(SketchingVectorsBase):
    """Fresh random orthonormal columns every request."""

    def generate(self, _=None, __=None):
        dim, m = self.target_matrix.shape[0], self.num_skvecs
        x, _r = np.linalg.qr(np.random.rand(dim, m) + 1j * np.random.rand(dim, m))
        return x, self.target_matrix @ x


class AlternatingSketchingVectors(SketchingVectorsBase):
    """Random column subsets of U, cycling through a permutation."""

    def __init__(self, num_skvecs: int, target_mat: np.ndarray):
        super().__init__(num_skvecs, target_mat)
        dim = target_mat.shape[0]
        assert dim % self.num_skvecs == 0
        self._offset = 0
        self._indices = np.random.permutation(dim)

    def generate(self, _=None, __=None):
        target = self.target_matrix
        dim, m = target.shape[0], self.num_skvecs
        if self._offset >= dim:
            self._offset = 0
            self._indices = np.random.permutation(dim)
        idx = self._indices[self._offset : self._offset + m]
        x = np.zeros((dim, m), dtype=np.complex128)
        y = np.zeros((dim, m), dtype=np.complex128)
        for i in range(idx.size):
            x[idx[i], i] = 1
            y[:, i] = target[:, idx[i]]
        self._offset += m
        return x, y


class EigenSketchingVectors(SketchingVectorsBase):
    """Randomized range finder of (V† - U†) — sketch the subspace of largest
    discrepancy (Halko et al. 2010)."""

    def generate(self, circ: Optional[Ansatz] = None, thetas=None):
        assert isinstance(circ, Ansatz)
        thetas = np.asarray(thetas)
        dim, m = self.target_matrix.shape[0], self.num_skvecs
        target = self.target_matrix

        omega = np.random.randn(dim, m) + 1j * np.random.randn(dim, m)
        uh_omega = target.conj().T @ omega
        om, _ = sketch_tensors(omega, omega[:, :0])
        th = torch.as_tensor(thetas, device=om.device).to(real_of(om.dtype))
        with torch.no_grad():
            vh_omega = v_dagger_mul_mat(circ, th, om).cpu().numpy()
        x, _r = np.linalg.qr(vh_omega - uh_omega)
        return x, target @ x


def skvecs_generator(
    skvecs_type: str, num_skvecs: int, target_mat: np.ndarray
) -> SketchingVectorsBase:
    """The generator of ``skvecs_type``; full range whenever ``num_skvecs``
    spans the whole space."""
    if skvecs_type == "full" or num_skvecs == target_mat.shape[0]:
        return FullRangeSketchingVectors(target_mat)
    if skvecs_type == "rand":
        return RandomSketchingVectors(num_skvecs, target_mat)
    if skvecs_type == "alt":
        return AlternatingSketchingVectors(num_skvecs, target_mat)
    if skvecs_type == "eigen":
        return EigenSketchingVectors(num_skvecs, target_mat)
    raise ValueError(
        f"no such sketching-vector generator; available: "
        f"['full', 'rand', 'alt', 'eigen'], got {skvecs_type}"
    )
