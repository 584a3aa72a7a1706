"""A run of the harness on the CPU at a small size (8 qubits, chi 8), past
its look for a card, with the timed path broken underneath: ``correct``
comes out false for each fault the cells can have, and true without one.
The one-card cells exchange nothing between chips, so that fault has no
case."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import cell, check, spec  # noqa: E402
from reference import mps as R  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _restore_config():
    """A run's set-up pins the precision and the pair-update route for the
    whole process; later tests get the defaults back."""
    from aqc_research_tpu_torch import config

    precision = config.precision()
    yield
    config.set_svd_impl(None)
    config.set_precision(precision)


def _spec():
    cfg = spec.load_json(spec.HERE / "tests" / "tiny_asp8.json")
    trf = spec.load_json(spec.HERE / "traffic" / "restarts_jacobi.json")
    limits = spec.load_json(spec.HERE / "limits" / "asp20-jacobi-restarts.json")
    return spec.CellSpec("tiny", 1, cfg, trf, limits, [], [])


def _numbers(seed=7, after_setup=None, prec=R.EXACT):
    s = _spec()
    prog = cell.setup(s, CPU)
    try:
        if after_setup is not None:
            after_setup()
        run = cell.Run(s, seed, CPU)
        cell.program_outputs(run, prog, cell.window(run, prog, 0.0, False, int(s.traffic["sample"])))
    finally:
        cell.release(prog)
    return check.readings(run, CPU, prec), s.limits, cell.failed(run)


def _correct(numbers, limits):
    return check.verdict(numbers, limits)[0]


def test_sound_run_is_correct():
    numbers, limits, failed = _numbers()
    assert _correct(numbers, limits), numbers
    assert failed == 0


def test_control_is_not_correct():
    numbers, limits, _ = _numbers(prec=R.TF32)
    assert not _correct(numbers, limits), numbers


@pytest.fixture
def jit_asp():
    from aqc_research_tpu_torch.models.sp_lhs import jit_asp as module

    return module


def test_horizon_returns_its_start(monkeypatch, jit_asp):
    def patch():
        def unchanged(circ, thetas0, target, *, base_bits, trunc_thr=1e-6, fidelity_thr=None, maxiter=100,
                      no_improve_iters=None):
            value = jit_asp._mps_value_program(circ, tuple(base_bits), float(trunc_thr), "jacobi")
            f = value(thetas0, target)
            return jit_asp.JitHorizonResult(thetas0.clone(), f, 1.0 - f, maxiter, False)

        monkeypatch.setattr(jit_asp, "optimize_horizon_mps_jit", unchanged)

    numbers, limits, failed = _numbers(after_setup=patch)
    assert not _correct(numbers, limits), numbers
    assert failed == 3


def test_objective_altered_where_produced(monkeypatch, jit_asp):
    real = jit_asp.optimize_horizon_mps_jit

    def patch():
        def altered(*args, **kwargs):
            res = real(*args, **kwargs)
            return res._replace(fobj=res.fobj * 0.5)

        monkeypatch.setattr(jit_asp, "optimize_horizon_mps_jit", altered)

    numbers, limits, _ = _numbers(after_setup=patch)
    assert not _correct(numbers, limits), numbers
    assert numbers["fobj_gap"] > limits["fobj_gap"]


def test_half_of_each_pair_batch_left_out(monkeypatch):
    from aqc_research_tpu_torch.ops import mps

    real = mps._pair_update

    def half(lam_l, lam_c, lam_r, g1, g2, *rest):
        new_g1, new_g2, new_lam = real(lam_l, lam_c, lam_r, g1, g2, *rest)
        b = g1.shape[-4]
        if b > 1:   # the second half of the batch keeps its old tensors
            keep = torch.arange(b) >= (b + 1) // 2
            new_g1 = torch.where(keep[:, None, None, None], g1, new_g1)
            new_g2 = torch.where(keep[:, None, None, None], g2, new_g2)
            new_lam = torch.where(keep[:, None], lam_c.to(new_lam.dtype), new_lam)
        return new_g1, new_g2, new_lam

    monkeypatch.setattr(mps, "_pair_update", half)
    numbers, limits, _ = _numbers()
    assert not _correct(numbers, limits), numbers


def test_gradient_half_left_out(monkeypatch, jit_asp):
    real = jit_asp._mps_value_fns

    def fns(*args):
        value, value_and_grad = real(*args)

        def halved(th, tgt):
            f, g = value_and_grad(th, tgt)
            return f, torch.where(torch.arange(g.shape[-1]) % 2 == 0, g, torch.zeros_like(g))

        return value, halved

    monkeypatch.setattr(jit_asp, "_mps_value_fns", fns)
    numbers, limits, _ = _numbers()
    assert not _correct(numbers, limits), numbers
    assert numbers["grad_gap"] > limits["grad_gap"]
