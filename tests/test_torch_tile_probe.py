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
``cuda``).  The tensor-core modes' twins ("highest": split 3xTF32,
"default": one TF32 pass) are held to the same Pallas outputs: "highest"
within the bar, "default" outside it and under 1e-2; their TF32 rounding
is held to a numpy reference on edge values.  JAX is imported only by the
probe cases, so the card's case runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tile_probe.py -q"""

import importlib

import numpy as np
import pytest
import torch

from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.ops import tile_probes as tp
from tests import _torch_threads  # noqa: F401

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
    forms = [("P1", "dot HIGHEST"), ("P1", "dotT HIGHEST"), ("P2", "dot"), ("P2", "dot_general_T"), ("P2", "transpose")]
    assert [(r["probe"], r["form"]) for r in rows if r["precision"] == "fma"] == forms
    assert [r["precision"] for r in rows] == [m for m in tp.PRECISIONS for _ in range(2)] + [
        m for m in tp.PRECISIONS for _ in range(3)]
    assert all(r["ok"] and r["twin_rel_err"] == 0.0 for r in rows)
    for r in rows:
        if r["precision"] == "default" and r["form"] != "transpose":
            assert TOL < r["rel_err"] < tp.TF32_CEILING  # the probe sees TF32
        else:
            assert r["rel_err"] <= TOL
    assert tp.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(" OK") == 15 and "FAIL" not in out and "allow_tf32 (cuBLAS) False" in out


def test_main_exits_1_when_a_mode_misses(monkeypatch, capsys):
    """A "default" result inside the bar is a probe that cannot see TF32:
    main exits 1, as it does for an "fma" or "highest" result outside it."""
    real = tp.tile_probe_reference

    def blind(a, b, scale, precision="fma"):
        return real(a, b, scale, "fma")

    monkeypatch.setattr(tp, "tile_probe_reference", blind)
    assert tp.main(["--cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("[default]: ") == 5 and out.count(" FAIL") == 4  # the four "default" products
    assert not tp.meets("fma", "dot", 2e-5) and not tp.meets("highest", "dot", 2e-5)
    assert not tp.meets("default", "dot", 2e-2) and tp.meets("default", "transpose", 0.0)


def _tf32_numpy(x32: np.ndarray) -> np.ndarray:
    """TF32 rounding in f64 arithmetic: the nearest multiple of the TF32
    spacing at x's binade (2^-136 below the normal range), ties away from
    zero, back to f32 (overflow to inf); zeros, infinities and NaN kept."""
    x = x32.astype(np.float64)
    out = x.copy()
    fin = np.isfinite(x) & (x != 0)
    _, e = np.frexp(x[fin])
    spacing = np.ldexp(1.0, np.maximum(e - 11, -136))
    q = x[fin] / spacing
    out[fin] = np.sign(q) * np.floor(np.abs(q) + 0.5) * spacing
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


F32_MAX = float(np.finfo(np.float32).max)
TF32_EDGES = {
    "ties": [1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, 3 * 2.0**-12 + 2.0**-1, 2.0**100 * (1 + 2.0**-11)],
    "subnormals": [2.0**-149, -(2.0**-149), 2.0**-137, 3 * 2.0**-137, 2.0**-127 + 2.0**-140, 2.0**-126 - 2.0**-149],
    "specials": [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, F32_MAX, -F32_MAX],
    "powers_of_two": [2 - 2.0**-23, 2 - 2.0**-11, 2 - 2.0**-10, 2 + 2.0**-22, 0.5 - 2.0**-25, 1024 * (1 - 2.0**-12),
                      2.0**-126, 2.0**127],
}


@pytest.mark.parametrize("group", sorted(TF32_EDGES))
def test_round_tf32_against_numpy(group):
    x = np.array(TF32_EDGES[group], dtype=np.float32)
    x = np.concatenate([x, np.random.default_rng(3).standard_normal(64).astype(np.float32) * 1e3])
    got = tp.round_tf32(torch.tensor(x)).numpy()
    want = _tf32_numpy(x)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))
    assert np.all(got[~nan].view(np.int32) & 0x1FFF == 0)  # 13 low bits clear


def test_split_is_exact_to_f32():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096),
                        [1 + 2.0**-11, 1 - 2.0**-24, 2.0**-120, 3.0]]).astype(np.float32)
    big, small = tp.split_tf32(torch.tensor(x))
    assert torch.equal(tp.round_tf32(big), big) and torch.equal(tp.round_tf32(small), small)
    x64 = x.astype(np.float64)
    gap = np.abs(big.double().numpy() + small.double().numpy() - x64)
    assert np.all(gap <= 2.0**-22 * np.abs(x64))
    assert np.any(small.numpy() != 0)


def test_wrapper_dispatch_and_argument_checks():
    a = torch.zeros(2, 8, 8)
    before, by_kernel = tp.tile_probe.launches, dict(tp.tile_probe.launches_by_kernel)
    for precision in tp.PRECISIONS:
        tp.tile_probe(torch.zeros(2, 64, 64), torch.zeros(2, 64, 64), torch.ones(1), precision)
    # CPU tensors run the twin
    assert tp.tile_probe.launches == before and tp.tile_probe.launches_by_kernel == by_kernel
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


@pytest.mark.parametrize("precision, n, match", [
    ("bf16", 64, "precision must be one of"),
    ("HIGHEST", 64, "precision must be one of"),
    ("highest", 96, "multiple of 64"),
    ("default", 33, "multiple of 64"),
    ("fma", 33, None),
    ("highest", 128, None),
])
def test_wrapper_precision_checks(precision, n, match):
    """Unknown modes raise; the tensor-core modes take n % 64 == 0 and raise
    otherwise on every device (no quiet fall back to "fma")."""
    a = torch.zeros(1, n, n)
    if match is None:
        tp.check_probe_args(a, a, torch.ones(1), precision)
        dot, _, _ = tp.tile_probe(a, a, torch.ones(1), precision)
        assert dot.shape == (1, n, n)
        return
    for call in (tp.tile_probe, tp.tile_probe_reference, tp.check_probe_args):
        with pytest.raises(ValueError, match=match):
            call(a, a, torch.ones(1), precision)


@pytest.fixture(scope="module")
def pallas_outputs():
    """Each Pallas probe's outputs in interpret mode, run once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        return {"P1": _run_probe(mp, "probe_mosaic_precision"), "P2": _run_probe(mp, "probe_mosaic_ops")}


@pytest.mark.parametrize("probe", ["P1", "P2"])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_emulated_modes_against_the_pallas_probes(pallas_outputs, probe, precision):
    """On the probes' own inputs the emulated 3xTF32 lies within the bar of
    the Pallas probes' outputs and of f64; one emulated TF32 pass misses the
    bar and stays under 1e-2 against both."""
    case = tp.probe_cases(torch.device("cpu"))[probe]
    got = tp.tile_probe_reference(*case, precision)
    refs = tp.f64_results(*case)
    products = zip(got[:2], pallas_outputs[probe][:2], refs[:2])
    for g, pallas, ref in products:
        for want in (pallas, ref):
            err = _rel(g, want)
            assert (err <= TOL) if precision == "highest" else (TOL < err < tp.TF32_CEILING), err
    assert torch.equal(got[2], case[0].transpose(-1, -2))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", tp.PRECISIONS)
@pytest.mark.parametrize("batch, n", [(1, 128), (2, 128), (3, 100), (1, 33), (2, 64), (3, 192), (14, 256)])
def test_kernel_matches_twin_on_card(cuda_device, batch, n, precision):
    """The kernel of each mode against its twin and f64, on the probes'
    shapes, the path's and ragged edges: n not a multiple of the 32 tile or
    the 16 k-tile ("fma"), a half-used 128 tile (64, 192).  The tensor-core
    modes refuse n % 64 != 0."""
    rng = np.random.default_rng(n + batch)
    a = torch.tensor(rng.standard_normal((batch, 2, n, n)).astype(np.float32), device=cuda_device)
    b = torch.tensor(rng.standard_normal((batch, 2, n, n)).astype(np.float32), device=cuda_device)
    s = torch.full((1,), 2.5, device=cuda_device)
    before, by_kernel = tp.tile_probe.launches, dict(tp.tile_probe.launches_by_kernel)
    if precision != "fma" and n % tp.TC_MULTIPLE:
        with pytest.raises(ValueError, match="multiple of 64"):
            tp.tile_probe(a[:, 0], b[:, 1], s, precision)
        assert tp.tile_probe.launches == before and tp.tile_probe.launches_by_kernel == by_kernel
        return
    got = tp.tile_probe(a[:, 0], b[:, 1], s, precision)
    torch.cuda.synchronize()
    by_kernel[tp.KERNEL_OF[precision]] += 1
    assert tp.tile_probe.launches == before + 1 and tp.tile_probe.launches_by_kernel == by_kernel
    twin = tp.tile_probe_reference(a[:, 0], b[:, 1], s, precision)
    refs = tp.f64_results(a[:, 0], b[:, 1], s)
    for g, t, r in zip(got[:2], twin, refs):
        assert tp.rel_err(g, t.double().cpu().numpy()) <= tp.TWIN_TOL
        err = tp.rel_err(g, r)
        assert (TOL < err < tp.TF32_CEILING) if precision == "default" else err <= TOL
    assert torch.equal(got[2], twin[2])


TC_MANGLED = "_ZN46_GLOBAL__N__45f1bb57_13_tile_probe_cu_4eb8299120tile_probe_tc_kernelILi3EEEvPKfS2_S2_PfS3_S3_ixx"
FMA_MANGLED = "_ZN46_GLOBAL__N__45f1bb57_13_tile_probe_cu_4eb8299117tile_probe_kernelEPKfS1_S1_PfS2_S2_ixx"


@pytest.mark.parametrize("mangled, label", [
    (TC_MANGLED, "tile_probe_tc_kernel<3>"),
    (TC_MANGLED.replace("ILi3EE", "ILi1ELb0EE"), "tile_probe_tc_kernel<1,0>"),
    (FMA_MANGLED, "tile_probe_kernel"),
    ("_ZN3aqc18theta_build_kernelILi32EEEvPKfS2_", "theta_build_kernel<32>"),
    ("_Z10some_helperPf", None),
])
def test_chip_smoke_kernel_labels(mangled, label):
    """The smoke's ptxas and SASS readers name each template instance of a
    kernel apart (every integer or bool template argument)."""
    import chip_smoke

    assert chip_smoke.kernel_label(mangled) == label


def test_chip_smoke_counts_hgmma_per_kernel():
    import chip_smoke

    sass = "\n".join([
        f"\t\tFunction : {TC_MANGLED}",
        "        /*4f20*/                   HGMMA.64x128x8.F32.TF32 R24, gdesc[UR16], R24, gsb0 ;",
        "        /*4fb0*/                   HGMMA.64x128x8.F32.TF32 R24, gdesc[UR16], R24, gsb0 ;",
        "        /*4fc0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;",
        f"\t\tFunction : {FMA_MANGLED}",
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;",
    ])
    assert chip_smoke.sass_op_counts(sass, "HGMMA") == {"tile_probe_tc_kernel<3>": 2, "tile_probe_kernel": 0}
    report = (f"ptxas info    : Compiling entry function '{TC_MANGLED}' for 'sm_90a'\n"
              f"ptxas info    : Function properties for {TC_MANGLED}\n"
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
              "ptxas info    : Used 141 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_usage(report) == {"tile_probe_tc_kernel<3>": "141 regs, spill 0/0 B"}
    remark = ("ptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async instructions are serialized due "
              f"to program dependence on compiler-inserted WG.DP in divergent path in the function '{TC_MANGLED}'\n")
    assert chip_smoke.ptxas_remarks(report + remark) == {"tile_probe_tc_kernel<3>": ["C7518"]}


def test_chip_smoke_counts_each_probe_kernel():
    """The smoke reads the probe wrapper's launches per kernel, so the
    record's ``tile_probe`` (CUDA cores) and ``tile_probe_tc`` (tensor
    cores) entries each carry their own kernel's count, and resets both."""
    import chip_smoke

    saved = tp.tile_probe.launches, dict(tp.tile_probe.launches_by_kernel)
    try:
        tp.tile_probe.launches, tp.tile_probe.launches_by_kernel = 6, {"tile_probe": 2, "tile_probe_tc": 4}
        counts = chip_smoke.read_counts()
        assert counts["tile_probe"] == 2 and counts["tile_probe_tc"] == 4
        assert {name for name, *_ in chip_smoke.KERNELS} <= set(counts)
        chip_smoke.reset_counts()
        assert tp.tile_probe.launches == 0
        assert tp.tile_probe.launches_by_kernel == {"tile_probe": 0, "tile_probe_tc": 0}
    finally:
        tp.tile_probe.launches, tp.tile_probe.launches_by_kernel = saved
