"""ASP target states in MPS form (twin of ``TargetMpsState`` and the
first-horizon step of ``generate_all_mps_targets`` in
``aqc_research_tpu/models/sp_lhs/target_states.py``).

Every horizon has two Trotter targets: the ground truth ``t1_gt``
(``precise_multiplier()`` times more steps) and the reference ``t1``.  The
caching, the incremental later horizons and the dense targets belong to the
horizon-schedule slice (``run_simulation``) and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging

from ...ops import mps as mpsop
from ...targets import trotter as trotop

_logger = logging.getLogger(__name__)


def precise_multiplier() -> int:
    """Steps multiplier of the ground-truth Trotter circuit."""
    return 10


@dataclasses.dataclass
class TargetMpsState:
    """Target |t1> in MPS form plus the options that produced it."""

    num_qubits: int
    num_trot_steps: int
    evol_time: float
    my_id: int
    trunc_thr: float
    chi_max: int
    delta: float
    t1_gt: mpsop.MPS
    t1: mpsop.MPS
    second_order: bool
    precise_multiplier: int = dataclasses.field(default_factory=precise_multiplier)


def first_horizon_mps_target(
    *,
    num_qubits: int,
    evol_time: float,
    num_trot_steps: int,
    delta: float,
    chi_max: int,
    trunc_thr: float,
    second_order: bool,
    ini_state_func=trotop.neel_init_state,
    dtype=None,
    device=None,
) -> TargetMpsState:
    """The first horizon's targets: ``t1_gt`` with ``num_trot_steps *
    precise_multiplier()`` steps and ``t1`` with ``num_trot_steps`` steps,
    both evolved from ``ini_state_func(num_qubits)`` over ``evol_time``."""
    def evolve(steps: int) -> mpsop.MPS:
        trot = trotop.Trotter(
            num_qubits=num_qubits, evol_time=float(evol_time), num_steps=steps,
            delta=float(delta), second_order=second_order,
        )
        return trot.as_mps(
            ini_state_func(num_qubits), trunc_thr=trunc_thr, chi_max=chi_max,
            dtype=dtype, device=device,
        )

    target = TargetMpsState(
        num_qubits=int(num_qubits),
        num_trot_steps=int(num_trot_steps),
        evol_time=float(evol_time),
        my_id=0,
        trunc_thr=float(trunc_thr),
        chi_max=int(chi_max),
        delta=float(delta),
        t1_gt=evolve(int(num_trot_steps) * precise_multiplier()),
        t1=evolve(int(num_trot_steps)),
        second_order=bool(second_order),
    )
    _logger.info(
        "t=%0.3f: fid(|t1>, |t1_gt>) = %0.6f",
        target.evol_time, trotop.fidelity(target.t1_gt, target.t1),
    )
    return target
