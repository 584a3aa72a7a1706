"""Max-projection surrogate objective on full state vectors, in SciPy's
protocol (twin of ``aqc_research_tpu/models/sp_lhs/sur_max.py``).

Per objective call: ``V† target`` on the device (ops/statevector.py) and all
flip-state projections ``hs[i] = <state_i|V†|target>`` from it (element
picks, or one product with the cached states of a general prep), read back
once.  Per gradient call: one co-sweep (ops/gradients.py), a second one
while the leading flip state is not |0>.  The hysteresis and the weight EMA
run on the host (objective_base.MaxProjectionSurrogate).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ... import checking as chk
from ...circuit.ansatz import Ansatz
from ...ops.gradients import grad_of_dot_product
from ...ops.statevector import v_dagger_mul_vec
from ...optim.stoppers import GradientAmplifier
from . import objective_base as obj_base


class SpSurrogateObjectiveMax(obj_base.MaxProjectionSurrogate):
    """Max-projection surrogate objective (full-vector engine)."""

    def __init__(
        self,
        *,
        user_parameters: dict,
        circ: Ansatz,
        block_range: Optional[Tuple[int, int]] = None,
        front_layer: bool = False,
        verbose: bool = False,
        grad_scaler: Optional[GradientAmplifier] = None,
    ):
        super().__init__(user_parameters, circ, False, verbose, grad_scaler)
        block_range = (0, circ.num_blocks) if block_range is None else block_range
        assert chk.is_tuple(block_range, len(block_range) == 2)
        assert 0 <= block_range[0] < block_range[1] <= circ.num_blocks
        self._block_range = tuple(block_range)
        self._front_layer = bool(front_layer)

    def objective(self, thetas: np.ndarray) -> float:
        self._store_latest_thetas(thetas)
        vh = v_dagger_mul_vec(self._circuit, self._device_thetas(thetas), self._target)
        handler = self._state_handler
        if isinstance(handler, obj_base.ThinStateHandler):
            hs = vh[torch.as_tensor(handler.state_indices, device=vh.device)]
        else:
            hs = torch.matmul(handler.states_matrix.conj(), vh)
        self._vh_target = vh
        return self._objective_from_projections(obj_base._host_complex(hs))

    def gradient(self, thetas: np.ndarray) -> np.ndarray:
        # Where the range covers the whole ansatz, the front layer is in it.
        front = self._front_layer or self._block_range == (0, self._circuit.num_blocks)
        th = self._device_thetas(thetas)

        def dot_gradient(state_no: int) -> torch.Tensor:
            return grad_of_dot_product(
                self._circuit, th, self._state_handler.init_state(state_no),
                self._vh_target, block_range=self._block_range, front_layer=front,
            )

        return self._gradient_from_dots(thetas, dot_gradient)
