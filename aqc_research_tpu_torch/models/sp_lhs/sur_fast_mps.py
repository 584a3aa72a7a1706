"""Max-projection surrogate objective on MPS states (Trotterized ansatz),
in SciPy's protocol (twin of ``aqc_research_tpu/models/sp_lhs/sur_fast_mps.py``).

The surrogate math of sur_max.py, with the states in MPS form: ``V† target``
is one fused-block MPS sweep — with the per-layer boundary cache where the
ansatz has at least two layers (``v_dagger_mul_mps_layers``), plain
(``v_dagger_mul_mps``) otherwise — and the gradient is the MPS co-sweep
(ops/mps_gradient.py), which consumes that cache when there is one.  For an
X-layer (product) prep all n+1 projections come from one amplitude sweep
(``mps_flip_amplitudes``); a general prep takes one MPS dot per flip state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...circuit.ansatz import Ansatz, TrotterAnsatz, first_layer_included, layer_to_block_range
from ...ops import mps as mpsop
from ...ops.mps_gradient import fast_dot_gradient
from ...optim.stoppers import GradientAmplifier
from ...utils import create_logger
from . import objective_base as obj_base

_logger = create_logger(__file__)


class SpSurrogateObjectiveFastMpsTrotter(obj_base.MaxProjectionSurrogate):
    """MPS surrogate objective of a Trotterized (nearest-neighbour) ansatz
    over single-bit flip states."""

    def __init__(
        self,
        *,
        user_parameters: dict,
        circ: Ansatz,
        layer_range: Optional[Tuple[int, int]] = None,
        alt_layers: bool = False,
        verbose: bool = False,
        grad_scaler: Optional[GradientAmplifier] = None,
    ):
        super().__init__(user_parameters, circ, True, verbose, grad_scaler)
        assert isinstance(circ, TrotterAnsatz)
        if alt_layers:
            _logger.warning("alternating optimization is disabled; 'alt_layers' set to False")
        self._trunc_thr = float(user_parameters["trunc_thr"])
        self._layer_range = (0, circ.num_layers) if layer_range is None else tuple(layer_range)
        if self.num_states != circ.num_qubits + 1:
            raise ValueError("this objective handles single-bit flip states only")
        self._z_layers = None

        # An X-layer prep (or none) is a basis state: its bits feed the
        # one-sweep amplitudes.
        self._base_bits = None
        prep = user_parameters.get("state_prep_func", None)
        program = () if prep is None else prep(circ.num_qubits)
        if all(g.name == "x" for g in program):
            bits = [0] * circ.num_qubits
            for g in program:
                bits[g.qubits[0]] ^= 1
            self._base_bits = tuple(bits)

    def objective(self, thetas: np.ndarray) -> float:
        self._store_latest_thetas(thetas)
        assert isinstance(self.target, mpsop.MPS)
        th = self._device_thetas(thetas)
        if mpsop.v_dagger_layer_cache_eligible(self._circuit):
            # The per-layer z cache spares the gradient its z-side updates.
            self._vh_target, self._z_layers = mpsop.v_dagger_mul_mps_layers(
                self._circuit, th, self.target, trunc_thr=self._trunc_thr
            )
        else:
            self._vh_target = mpsop.v_dagger_mul_mps(self._circuit, th, self.target, trunc_thr=self._trunc_thr)
            self._z_layers = None
        if self._base_bits is not None:
            hs = obj_base._host_complex(mpsop.mps_flip_amplitudes(self._vh_target, self._base_bits))
        else:
            hs = np.array([self._state_handler.state_dot_vector(i, self._vh_target) for i in range(self.num_states)])
        return self._objective_from_projections(hs)

    def gradient(self, thetas: np.ndarray) -> np.ndarray:
        circ = self._circuit
        block_range = layer_to_block_range(circ, self._layer_range)
        front = first_layer_included(circ, self._layer_range)
        th = self._device_thetas(thetas)

        def dot_gradient(state_no: int) -> torch.Tensor:
            # The flip states are MPS at chi_max, not χ=1 product states:
            # no grow_w.
            return fast_dot_gradient(
                circ, th, self._state_handler.init_state(state_no), self._vh_target,
                trunc_thr=self._trunc_thr, block_range=block_range, front_layer=front, z_layers=self._z_layers,
            )

        return self._gradient_from_dots(thetas, dot_gradient)
