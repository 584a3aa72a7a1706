"""Computation, caching and loading of the ASP target states, MPS form (twin
of the MPS part of ``aqc_research_tpu/models/sp_lhs/target_states.py``).

Every horizon has two Trotter targets: the ground truth ``t1_gt``
(``precise_multiplier()`` times more steps) and the reference ``t1``.  They
are generated incrementally: each horizon's circuit is applied to the
previous horizon's MPS.  The list is pickled per qubit count into
``opts.result_dir``, validated against the options on load and regenerated
when stale.  The dense targets belong to the dense slice and are not ported
yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, List, Optional

import numpy as np
import torch

from ... import checking as chk
from ... import config
from ...ops import mps as mpsop
from ...targets import trotter as trotop
from ...utils import MyTimer, create_logger
from .user_options import UserOptions

_logger = create_logger(__file__)


def precise_multiplier() -> int:
    """Steps multiplier of the ground-truth Trotter circuit."""
    return 10


class TargetMpsState:
    """Target |t1> in MPS form plus the options that produced it."""

    def __init__(
        self,
        *,
        opts: Any,
        num_qubits: int,
        num_trot_steps: int,
        evol_time: float,
        my_id: int,
        t1_gt: mpsop.MPS,
        t1: mpsop.MPS,
        second_order: bool,
    ):
        assert chk.is_int(num_qubits, num_qubits >= 2)
        assert num_trot_steps in list(opts.trotter_steps)
        assert evol_time in list(opts.evol_times)
        assert isinstance(t1_gt, mpsop.MPS) and isinstance(t1, mpsop.MPS)

        self.num_qubits = int(num_qubits)
        self.num_trot_steps = int(num_trot_steps)
        self.precise_multiplier = precise_multiplier()
        self.trunc_thr = float(opts.trunc_thr_target)
        self.chi_max = int(opts.chi_max)
        self.delta = float(opts.delta)
        self.evol_time = float(evol_time)
        self.my_id = int(my_id)
        self.t1_gt = t1_gt
        self.t1 = t1
        self.second_order = bool(second_order)

    def __getstate__(self):
        """The MPS pickle as numpy arrays, so a cache written on the card
        loads on the CPU and the reverse."""
        state = self.__dict__.copy()
        for key in ("t1_gt", "t1"):
            m = state[key]
            state[key] = (m.gammas.detach().cpu().numpy(), m.lambdas.detach().cpu().numpy())
        return state

    def __setstate__(self, state):
        """Restores the MPS onto ``config.device()`` in the precision in
        effect."""
        dtype = config.complex_dtype()
        for key in ("t1_gt", "t1"):
            g, lam = state[key]
            state[key] = mpsop.MPS(
                torch.from_numpy(np.asarray(g)).to(config.device(), dtype),
                torch.from_numpy(np.asarray(lam)).to(config.device(), config.real_of(dtype)),
            )
        self.__dict__.update(state)

    @staticmethod
    def check_cached_data(opts: Any, num_qubits: int, data: List[Any]) -> bool:
        """Structural validation of a cached list against the options."""
        if not chk.is_list(data):
            return False
        for i in range(min(len(data), len(opts.evol_times), len(opts.trotter_steps))):
            dat, t, s = data[i], opts.evol_times[i], opts.trotter_steps[i]
            if not (
                isinstance(dat, TargetMpsState)
                and dat.num_qubits == num_qubits
                and dat.num_trot_steps == s
                and dat.precise_multiplier == precise_multiplier()
                and np.isclose(dat.trunc_thr / opts.trunc_thr_target, 1)
                and getattr(dat, "chi_max", -1) == opts.chi_max
                and np.isclose(dat.delta / opts.delta, 1)
                and np.isclose(dat.evol_time / t, 1)
                and dat.my_id == i
                and mpsop.check_mps(dat.t1_gt)
                and mpsop.check_mps(dat.t1)
                and isinstance(dat.second_order, bool)
            ):
                return False
        return True


def generate_all_mps_targets(
    *, opts: Any, num_qubits: int, second_order: bool, dtype=None, device=None
) -> List[TargetMpsState]:
    """Incremental MPS target generation: each horizon's circuit is applied
    to the PREVIOUS horizon's MPS.  ``dtype``/``device``: of the MPS
    (default: the precision in effect, ``config.device()``)."""
    _logger.info("%s: generating targets ...", generate_all_mps_targets.__name__)
    trotter_steps = np.asarray(opts.trotter_steps)
    evol_times = np.asarray(opts.evol_times)
    assert evol_times.size == trotter_steps.size
    assert np.unique(np.diff(trotter_steps)).size <= 1, "trotter_steps must grow by a constant increment"
    assert np.allclose(np.diff(evol_times), evol_times[0]), "evol_times must form a uniform grid"

    thr = opts.trunc_thr_target
    chi = int(opts.chi_max)

    def initial():
        return mpsop.mps_from_program(
            opts.ini_state_func[0](num_qubits), num_qubits, chi_max=chi, trunc_thr=thr,
            dtype=dtype, device=device,
        )

    t1_gt, t1 = initial(), initial()
    interval = float(evol_times[0])
    nsteps = int(trotter_steps[0])
    targets: List[TargetMpsState] = []
    for i in range(evol_times.size):
        timer = MyTimer()
        if i > 0:
            interval = float(evol_times[i] - evol_times[i - 1])
            nsteps = int(trotter_steps[i] - trotter_steps[i - 1])

        def evolve(state, steps):
            trot = trotop.Trotter(
                num_qubits=num_qubits, evol_time=interval, num_steps=steps,
                delta=opts.delta, second_order=second_order,
            )
            return trot.as_mps(state, trunc_thr=thr)

        with timer("|t1_gt>"):
            t1_gt = evolve(t1_gt, nsteps * precise_multiplier())
        with timer("|t1>"):
            t1 = evolve(t1, nsteps)
        targets.append(
            TargetMpsState(
                opts=opts,
                num_qubits=num_qubits,
                num_trot_steps=int(trotter_steps[i]),
                evol_time=float(evol_times[i]),
                my_id=i,
                t1_gt=t1_gt,
                t1=t1,
                second_order=second_order,
            )
        )
        _logger.info(
            "t=%0.3f: fid(|t1>, |t1_gt>) = %0.6f  |  timings: %s",
            evol_times[i],
            trotop.fidelity(t1_gt, t1),
            timer.rounded_metrics(3),
        )
    return targets


def get_target_mps_states(
    opts: Any, num_qubits: int, second_order: bool, input_file: Optional[str] = None
) -> List[TargetMpsState]:
    """Load-or-compute MPS targets with cache validation."""
    filename = os.path.join(opts.result_dir, f"target_mps_states_n{num_qubits}.pkl")
    if not (isinstance(input_file, str) and os.path.isfile(input_file)):
        input_file = filename
    if os.path.isfile(input_file):
        _logger.info("loading precomputed target MPS states from %s", input_file)
        with open(input_file, "rb") as fld:
            data = pickle.load(fld)
        if TargetMpsState.check_cached_data(opts, num_qubits, data):
            return data
        _logger.info("target cache is stale for these options — regenerating")

    data = generate_all_mps_targets(opts=opts, num_qubits=num_qubits, second_order=second_order)
    assert TargetMpsState.check_cached_data(opts, num_qubits, data)
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    with open(filename, "wb") as fld:
        pickle.dump(data, fld)
    return data


def get_target_classic_states(
    opts: Any, num_qubits: int, second_order: bool, input_file: Optional[str] = None
):
    """Dense targets: not ported yet."""
    raise NotImplementedError(
        "dense (classic) targets belong to the dense slice of the port "
        "(ROADMAP.md section 1, items 6-10); use an MPS objective"
    )


def get_target_states(opts: Any) -> List[TargetMpsState]:
    """Dispatch on ``opts.use_mps``."""
    get = get_target_mps_states if opts.use_mps else get_target_classic_states
    return get(
        opts=opts,
        num_qubits=opts.num_qubits,
        second_order=opts.second_order_trotter,
        input_file=opts.targets_file,
    )


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
    """The first horizon's targets alone (:func:`generate_all_mps_targets`
    on a one-horizon schedule): ``t1_gt`` with ``num_trot_steps *
    precise_multiplier()`` steps and ``t1`` with ``num_trot_steps`` steps,
    both evolved from ``ini_state_func(num_qubits)`` over ``evol_time`` at
    truncation ``trunc_thr``."""
    opts = UserOptions()
    opts.num_qubits = int(num_qubits)
    opts.evol_times = [float(evol_time)]
    opts.trotter_steps = [int(num_trot_steps)]
    opts.delta = float(delta)
    opts.chi_max = int(chi_max)
    opts.trunc_thr_target = float(trunc_thr)
    opts.ini_state_func = (ini_state_func,)
    return generate_all_mps_targets(
        opts=opts, num_qubits=int(num_qubits), second_order=bool(second_order), dtype=dtype, device=device
    )[0]
