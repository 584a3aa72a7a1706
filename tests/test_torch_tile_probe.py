"""The tile-precision probe (ops/tile_probes.py, csrc/tile_probe.cu) against
the JAX package's two Pallas compiler probes, ``benchmarks/probe_mosaic_
precision.py`` (P1) and ``benchmarks/probe_mosaic_ops.py`` (P2).

Each probe's ``main()`` runs here on the CPU with ``pl.pallas_call`` asked
for ``interpret=True`` and the outputs of its jitted call captured (a
monkeypatch of this test; the probes stay as they are).  The port's plain
twin on the probes' own inputs must match those outputs within 1e-5
relative (max-abs error over max-abs value, the probes' measure), and both
must meet the probes' bar against f64.  The wrapper's dispatch and argument
checks run on the CPU; the kernel against its twin needs the card (marked
``cuda``).  JAX is imported only by the probe cases, so the card's case
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tile_probe.py -q"""

import importlib

import numpy as np
import pytest
import torch

from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.ops import tile_probes as tp

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _run_probe(monkeypatch, module_name: str):
    """Runs a probe's main() in Pallas interpret mode; returns the outputs
    of its jitted kernel call as numpy arrays."""
    import jax
    from jax.experimental import pallas as pl

    probe = importlib.import_module(f"benchmarks.{module_name}")
    real_call, real_jit = pl.pallas_call, jax.jit
    captured = []

    def interpreted(*args, **kwargs):
        return real_call(*args, **{**kwargs, "interpret": True})

    def capturing_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)

        def call(*xs):
            out = jitted(*xs)
            captured.append([np.asarray(o) for o in out])
            return out

        return call

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(jax, "jit", capturing_jit)
    probe.main()
    assert len(captured) == 1
    return captured[0]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(float(np.max(np.abs(ref))), 1e-30))


def test_p1_twin_matches_the_pallas_probe(monkeypatch, capsys):
    o1, o2 = _run_probe(monkeypatch, "probe_mosaic_precision")
    assert "FAIL" not in capsys.readouterr().out
    a, b = tp.p1_inputs()
    dot, dgt, tr = tp.tile_probe(torch.tensor(a)[None], torch.tensor(b)[None], torch.ones(1))
    assert _rel(dot[0], o1) <= TOL and _rel(dgt[0], o2) <= TOL
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    assert _rel(dot[0], a64 @ b64) <= TOL and _rel(dgt[0], a64 @ b64.T) <= TOL
    assert torch.equal(tr[0], torch.tensor(a).T)


def test_p2_twin_matches_the_pallas_probe(monkeypatch, capsys):
    o_dot, o_dgt, o_tr = _run_probe(monkeypatch, "probe_mosaic_ops")
    assert "FAIL" not in capsys.readouterr().out
    a, b, s = tp.p2_inputs()
    at, bt = torch.tensor(a), torch.tensor(b)
    dot, dgt, tr = tp.tile_probe(at[:, 0], bt[:, 1], torch.full((1,), s))
    assert dot.shape == dgt.shape == tr.shape == (tp.PROBE_CHUNK, tp.PROBE_N, tp.PROBE_N)
    assert _rel(dot, o_dot) <= TOL and _rel(dgt, o_dgt) <= TOL
    np.testing.assert_array_equal(tr.numpy(), o_tr)
    ref_dot, ref_dgt, _ = tp.f64_results(at[:, 0], bt[:, 1], torch.full((1,), s))
    assert _rel(dot, ref_dot) <= TOL and _rel(dgt, ref_dgt) <= TOL


def test_run_probes_and_main_on_the_cpu(capsys):
    rows = tp.run_probes(torch.device("cpu"))
    assert [(r["probe"], r["form"]) for r in rows] == [
        ("P1", "dot HIGHEST"), ("P1", "dotT HIGHEST"), ("P2", "dot"), ("P2", "dot_general_T"), ("P2", "transpose")]
    assert all(r["ok"] and r["twin_rel_err"] == 0.0 for r in rows)
    assert tp.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(" OK") == 5 and "allow_tf32 (cuBLAS) False" in out


def test_wrapper_dispatch_and_argument_checks():
    a = torch.zeros(2, 8, 8)
    before = tp.tile_probe.launches
    tp.tile_probe(a, a, torch.ones(1))
    assert tp.tile_probe.launches == before  # CPU tensors run the twin
    with pytest.raises(ValueError, match="unsupported device"):
        tp.tile_probe(a.to("meta"), a.to("meta"), torch.ones(1, device="meta"))
    with pytest.raises(ValueError, match="float32"):
        tp.check_probe_args(a.double(), a.double(), torch.ones(1))
    with pytest.raises(ValueError, match="two"):
        tp.check_probe_args(a, torch.zeros(2, 8, 4), torch.ones(1))
    with pytest.raises(ValueError, match="row-major"):
        tp.check_probe_args(a.transpose(-1, -2), a, torch.ones(1))
    with pytest.raises(ValueError, match="one-element"):
        tp.check_probe_args(a, a, torch.ones(2))
    tp.check_probe_args(torch.zeros(2, 2, 8, 8)[:, 0], a, torch.ones(1))  # a strided stack of planes


@pytest.mark.cuda
@pytest.mark.parametrize("batch, n", [(1, 128), (2, 128), (3, 100), (1, 33)])
def test_kernel_matches_twin_on_card(cuda_device, batch, n):
    """The kernel against its twin and f64, on the probes' shapes and on
    ragged edges (n not a multiple of the 32 tile or the 16 k-tile)."""
    rng = np.random.default_rng(n + batch)
    a = torch.tensor(rng.standard_normal((batch, 2, n, n)).astype(np.float32), device=cuda_device)
    b = torch.tensor(rng.standard_normal((batch, 2, n, n)).astype(np.float32), device=cuda_device)
    s = torch.full((1,), 2.5, device=cuda_device)
    before = tp.tile_probe.launches
    got = tp.tile_probe(a[:, 0], b[:, 1], s)
    torch.cuda.synchronize()
    assert tp.tile_probe.launches == before + 1
    twin = tp.tile_probe_reference(a[:, 0], b[:, 1], s)
    refs = tp.f64_results(a[:, 0], b[:, 1], s)
    for g, t, r in zip(got, twin, refs):
        assert tp.rel_err(g, r) <= TOL and tp.rel_err(g, t.double().cpu().numpy()) <= TOL
    assert torch.equal(got[2], twin[2])
