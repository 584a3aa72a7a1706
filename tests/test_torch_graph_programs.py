"""The MPS objective's device programs (models/sp_lhs/jit_asp.py,
ops/cuda_graphs.py), the counterpart of the JAX package's jitted
``_mps_value_program`` and ``_mps_chunk_cache``, held on the CPU, where a
program is its eager function, at 6 qubits, χ=8, on the layered Trotter
path with its layer cache, the one-layer Trotter path, the plain layered
path (cz) and the per-gate path (cp on a random non-adjacent layout):

* cache keys: the same key gives the same program; a flipped route, θ
  shape, χ or pair-update policy gives a new one; a program stays pinned to
  its route whatever route is in effect when it is called (the JAX
  docstring's stale-program case);
* capture-clean evaluation: after a warm-up, one value and one obj+grad on
  "native" and on "rand", at one lane's θ and at a fleet's rows, make no
  device read (``aten._local_scalar_dense``,
  ``.cpu()``, ``.numpy()``, ``.tolist()``, a boolean-mask index or
  ``nonzero``) and build no tensor from host data (``aten.lift_fresh``,
  ``torch.tensor``, ``torch.as_tensor``, ``torch.from_numpy``): what a CUDA
  stream capture refuses.  The kernels' plain twins run only on CPU tensors
  and may read their own convergence flags, so the spy exempts ops made
  inside ``jacobi_rows_reference`` (K1's twin, which K3's and K4's twins
  call);
* the programs against the eager functions: equal bit for bit to the eager
  ``_mps_value_fns`` on every route, and within 1e-10 of the JAX package's
  ``_mps_value_fns`` in complex128 on "native";
* the Jacobi loop's masked sweeps (the loop under a program) equal its
  early exit bit for bit, sweep counts included;
* ``optimize_horizon_mps_jit`` and the timed runner through the programs
  against the eager loop they replaced: the same iterations and fobj within
  1e-10 (c128, "native"; c64, "rand"); the collapse watchdog's reference
  evaluation and re-run go through the reference route's programs;
* the driver releases the programs between horizons.

The card holds the graphs against the eager programs in
``tests/test_torch_kernel.py`` (marked ``cuda``, no JAX) and in
``chip_smoke.py``'s ``[graphs]`` phase."""

import sys
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aqc_research_tpu.circuit.ansatz import Ansatz as JAnsatz
from aqc_research_tpu.circuit.ansatz import TrotterAnsatz as JTrotterAnsatz
from aqc_research_tpu.circuit.structures import create_ansatz_structure, make_trotter_like_circuit
from aqc_research_tpu.models.sp_lhs import jit_asp as jja
from aqc_research_tpu.ops import mps as jm
from aqc_research_tpu.utils import rand_circuit
from aqc_research_tpu_torch import config, interop
from aqc_research_tpu_torch.models.sp_lhs import jit_asp as tja
from aqc_research_tpu_torch.ops import cuda_graphs as cg
from aqc_research_tpu_torch.ops import jacobi_svd as tjs
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.ops import rand_svd as trs
from aqc_research_tpu_torch.optim.lbfgs import lbfgs_chunk_programs, run_lbfgs_chunked, stateless
from tests import _torch_threads  # noqa: F401

N, CHI, THR = 6, 8, 1e-6
BITS = tuple(1 if q % 2 == 0 else 0 for q in range(N))
KINDS = ["trotter", "trotter1", "cz-plain", "cp-pergate"]
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


@pytest.fixture(autouse=True)
def _fresh_programs():
    tja.release_mps_programs()
    yield
    tja.release_mps_programs()


@pytest.fixture
def rand_route(monkeypatch):
    """The rand route's fused update on CPU tensors at χ=8: RAND_MIN_N
    lowered, the fused twins forced on."""
    monkeypatch.setattr(trs, "RAND_MIN_N", 2 * CHI)
    config.set_fused_pair(True)
    yield
    config.set_fused_pair(None)


def _jansatz(kind: str):
    if kind.startswith("trotter"):
        return JTrotterAnsatz.make(N, make_trotter_like_circuit(N, 1 if kind == "trotter1" else 2), True)
    entangler, layout = kind.split("-")
    if layout == "plain":
        blocks = np.concatenate([create_ansatz_structure(N, "spin", "full", N - 1)] * 2, axis=1)
    else:
        np.random.seed(21)
        blocks = rand_circuit(N, 5)
    return JAnsatz.make(N, entangler, blocks)


def _state() -> np.ndarray:
    rng = np.random.default_rng(1)
    v = rng.standard_normal(2**N) + 1j * rng.standard_normal(2**N)
    return v / np.linalg.norm(v)


def _case(kind: str, cdtype=torch.complex128):
    """(JAX ansatz, port ansatz, θ (numpy), port θ, port target)."""
    jc = _jansatz(kind)
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    th = np.random.default_rng(3).uniform(-np.pi, np.pi, jc.num_thetas)
    rdtype = config.real_of(cdtype)
    target = tm.mps_from_dense(_state(), CHI, dtype=cdtype)
    return jc, tc, th, torch.tensor(th, dtype=rdtype), target


# -----------------------------------------------------------------------------
# Cache keys.
# -----------------------------------------------------------------------------


def test_same_key_same_program_and_new_keys_new_ones(monkeypatch):
    _, tc, _, th, tgt = _case("trotter")
    value = tja._mps_value_program(tc, BITS, THR, "native")
    assert value is tja._mps_value_program(tc, BITS, THR, "native")
    assert value is not tja._mps_value_program(tc, BITS, THR, "jacobi")
    assert value is not tja._mps_value_program(tc, BITS, 1e-8, "native")
    assert value is not tja._mps_value_and_grad_program(tc, BITS, THR, "native")
    entry = value.entry(th, tgt)
    assert entry is value.entry(th.clone(), tm.MPS(tgt.gammas.clone(), tgt.lambdas.clone()))
    assert entry is not value.entry(th[:-1], tgt)  # θ shape
    assert entry is not value.entry(th, tm.mps_resize(tgt, 2 * CHI))  # χ
    assert entry is not value.entry(th.float(), tm.MPS(tgt.gammas.to(torch.complex64), tgt.lambdas.float()))
    config.set_fused_pair(True)  # the pair updates' policy
    try:
        assert entry is not value.entry(th, tgt)
    finally:
        config.set_fused_pair(None)
    monkeypatch.setattr(trs, "RAND_MIN_N", 2 * CHI)  # the range-finder's knobs
    assert entry is not value.entry(th, tgt)
    monkeypatch.undo()
    assert entry is value.entry(th, tgt)
    chunks = tja._mps_chunk_cache(tc, BITS, THR, None, 5, None, "native")
    assert chunks is tja._mps_chunk_cache(tc, BITS, THR, None, 5, None, "native")
    assert chunks is not tja._mps_chunk_cache(tc, BITS, THR, None, 6, None, "native")
    assert chunks is not tja._mps_chunk_cache(tc, BITS, THR, None, 5, None, "jacobi")
    assert len(tja.mps_programs()) == 6
    assert tja.release_mps_programs() == 0  # no pool on the CPU
    assert tja.mps_programs() == [] and value.cache.programs == {}


def test_programs_stay_pinned_to_their_route(monkeypatch):
    """A program built for "jacobi" runs "jacobi" under any ambient route:
    flipping the route between calls never serves a stale program.  Which
    route ran is read from spies on the routes' SVD entries
    (``torch.linalg.svd`` for "native", the Jacobi twin and kernel wrapper
    for "jacobi"): the two routes' f32 values may tie in every bit."""
    ran = Counter()

    def spy(route, fn):
        def entry(*args, **kwargs):
            ran[route] += 1
            return fn(*args, **kwargs)

        return entry

    monkeypatch.setattr(torch.linalg, "svd", spy("native", torch.linalg.svd))
    monkeypatch.setattr(tm, "jacobi_svd_top_k", spy("jacobi", tm.jacobi_svd_top_k))
    monkeypatch.setattr(tm, "jacobi_svd_kernel_top_k", spy("jacobi", tm.jacobi_svd_kernel_top_k))
    _, tc, _, th, tgt = _case("trotter", torch.complex64)
    value, _ = tja._mps_value_fns(tc, BITS, THR)
    with config.svd_impl_override("jacobi"):
        f_jacobi = value(th, tgt)
    with config.svd_impl_override("native"):
        f_native = value(th, tgt)
    jacobi_program = tja._mps_value_program(tc, BITS, THR, "jacobi")
    native_program = tja._mps_value_program(tc, BITS, THR, "native")
    for ambient in ("native", "jacobi", "rand"):
        with config.svd_impl_override(ambient):
            ran.clear()
            assert torch.equal(jacobi_program(th, tgt), f_jacobi)
            assert ran["jacobi"] > 0 and ran["native"] == 0, (ambient, ran)
            ran.clear()
            assert torch.equal(native_program(th, tgt), f_native)
            assert ran["native"] > 0 and ran["jacobi"] == 0, (ambient, ran)


def test_the_contract_is_checked_once_per_program(monkeypatch):
    """The co-sweep's grow_w contract reads the device: the obj+grad program
    checks it once when it is built, and the traced function skips it."""
    _, tc, _, th, tgt = _case("trotter")
    calls = []
    real = tja._check_grow_w_contract
    monkeypatch.setattr(tja, "_check_grow_w_contract", lambda *a: calls.append(a) or real(*a))
    program = tja._mps_value_and_grad_program(tc, BITS, THR, "native")
    for _ in range(3):
        program(th, tgt)
    assert len(calls) == 1 and calls[0][0] is True
    bad = tm.MPS(tgt.gammas, torch.ones_like(tgt.lambdas))
    with pytest.raises(ValueError, match="grow_w"):
        real(True, bad)
    with cg._traced():
        real(True, bad)  # checked where the program is built


# -----------------------------------------------------------------------------
# Capture-clean evaluation.
# -----------------------------------------------------------------------------

_TWINS = {"jacobi_rows_reference"}
_READS = ("aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero", "aten.masked_select", "aten.unique",
          "aten._unique")


def _in_twin() -> bool:
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name in _TWINS:
            return True
        frame = frame.f_back
    return False


class _CaptureSpy(TorchDispatchMode):
    """Records the ops a CUDA stream capture refuses: device reads, host
    data turned into tensors, boolean-mask indexing."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bool_index = name.startswith(("aten.index.", "aten.index_put")) and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple)) else ()))
        if (name.startswith(_READS) or bool_index) and not _in_twin():
            self.hits.append(name)
        return func(*args, **(kwargs or {}))


def _programs(tc):
    impl = config.svd_impl(None)
    return (tja._mps_value_program(tc, BITS, THR, impl), tja._mps_value_and_grad_program(tc, BITS, THR, impl))


def _spy_evaluations(kind, cdtype, monkeypatch, lanes=None):
    _, tc, _, th, tgt = _case(kind, cdtype)
    if lanes is not None:  # a fleet's rows (L, P)
        th = th + 0.1 * torch.arange(lanes, dtype=th.dtype)[:, None]
    value, value_and_grad = _programs(tc)
    value(th, tgt)
    value_and_grad(th, tgt)  # warm-up: builds the tables, draws the sketch
    x = th + 0.01
    hits = []

    def wrap(owner, name):
        real = getattr(owner, name)

        def spy(*args, **kwargs):
            if not _in_twin():
                hits.append(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(owner, name, spy)

    for name in ("cpu", "numpy", "tolist", "item"):
        wrap(torch.Tensor, name)
    for name in ("tensor", "as_tensor", "from_numpy"):
        wrap(torch, name)
    with _CaptureSpy() as spy:
        f = value(x, tgt)
        fg, g = value_and_grad(x, tgt)
    monkeypatch.undo()
    return spy.hits + hits, (f, fg, g)


@pytest.mark.parametrize("kind", KINDS)
def test_native_evaluation_is_capture_clean(kind, monkeypatch):
    with config.svd_impl_override("native"):
        hits, values = _spy_evaluations(kind, torch.complex128, monkeypatch)
    assert hits == []
    assert all(bool(torch.isfinite(v).all()) for v in values)


@pytest.mark.parametrize("kind", KINDS)
def test_rand_evaluation_is_capture_clean(kind, rand_route, monkeypatch):
    with config.svd_impl_override("rand"):
        assert _spy_evaluations(kind, torch.complex64, monkeypatch)[0] == []


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", ["native", "rand"])
def test_fleet_evaluation_is_capture_clean(kind, route, rand_route, monkeypatch):
    """The programs at a fleet's rows (3, P), as the fleet replays them at
    each running-lane count: no device read, no host data."""
    cdtype = torch.complex128 if route == "native" else torch.complex64
    with config.svd_impl_override(route):
        hits, values = _spy_evaluations(kind, cdtype, monkeypatch, lanes=3)
    assert hits == [] and values[0].shape == (3,) and values[2].shape[0] == 3


def test_the_spy_sees_what_a_capture_refuses(monkeypatch):
    """The eager functions, outside a program, still read the device (the
    Jacobi loop's early exit, the grow_w contract): the spy sees them."""
    _, tc, _, th, tgt = _case("trotter", torch.complex64)
    _, value_and_grad = tja._mps_value_fns(tc, BITS, THR)
    with config.svd_impl_override("jacobi"):
        value_and_grad(th, tgt)
        with _CaptureSpy() as spy:
            value_and_grad(th, tgt)
    assert "aten._local_scalar_dense.default" in spy.hits
    with _CaptureSpy() as spy:
        torch.tensor([1, 2])
        torch.zeros(3)[torch.tensor([True, False, True])]
    assert any(h.startswith("aten.lift_fresh") for h in spy.hits)
    assert any(h.startswith("aten.index.") for h in spy.hits)


# -----------------------------------------------------------------------------
# The programs against the eager functions.
# -----------------------------------------------------------------------------


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN equal to a NaN at the same place (the CPU rand
    route's Householder QR returns NaN on the uncached co-sweeps' pair
    samples whose columns fall below the f32 range; ROADMAP §3)."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", ["native", "jacobi", "rand"])
def test_programs_equal_the_eager_functions_bit_for_bit(kind, route, rand_route):
    cdtype = torch.complex128 if route == "native" else torch.complex64
    _, tc, _, th, tgt = _case(kind, cdtype)
    value, value_and_grad = tja._mps_value_fns(tc, BITS, THR)
    with config.svd_impl_override(route):
        want_f = value(th, tgt)
        want_fg, want_g = value_and_grad(th, tgt)
        vp, vgp = _programs(tc)
        got_f = vp(th, tgt)
        got_fg, got_g = vgp(th, tgt)
    assert _same(got_f, want_f) and _same(got_fg, want_fg) and _same(got_g, want_g)


@pytest.mark.parametrize("kind", KINDS)
def test_programs_match_jax_in_c128(kind):
    jc, tc, th, tth, tgt = _case(kind)
    jphi = jm.mps_from_dense(_state(), CHI)
    jv, jvg = jja._mps_value_fns(jc, BITS, THR)
    j_f = float(jv(jnp.asarray(th), jphi))
    j_fg, j_g = jvg(jnp.asarray(th), jphi)
    with config.svd_impl_override("native"):
        vp, vgp = _programs(tc)
        f = vp(tth, tgt)
        fg, g = vgp(tth, tgt)
    assert abs(float(f) - j_f) <= TOL
    assert abs(float(fg) - float(j_fg)) <= TOL
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", [2, 4, 6])
def test_masked_jacobi_sweeps_equal_the_early_exit(dtype, n):
    """Under a program the Jacobi loop (the χ-growth heads' SVD) runs every
    sweep, masked after convergence: the same factors and counts."""
    rng = np.random.default_rng(n)
    m = torch.tensor(rng.standard_normal((5, n, n)) + 1j * rng.standard_normal((5, n, n))).to(dtype)
    m[0] = 0.0  # a zero matrix converges at once
    want = tjs.jacobi_svd(m)
    want_sweeps = tjs.jacobi_sweeps_per_matrix(m)
    with cg._traced():
        got = tjs.jacobi_svd(m)
        got_sweeps = tjs.jacobi_sweeps_per_matrix(m)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got_sweeps, want_sweeps) and int(want_sweeps.max()) < tjs.DEFAULT_SWEEPS


# -----------------------------------------------------------------------------
# Horizons through the programs.
# -----------------------------------------------------------------------------


def _eager_horizon(tc, x0, tgt, maxiter, chunk_iters=None):
    """The loop ``optimize_horizon_mps_jit`` ran before the programs: the
    eager functions, the target closed over."""
    value, value_and_grad = tja._mps_value_fns(tc, BITS, THR)
    programs = lbfgs_chunk_programs(*stateless(lambda th: value(th, tgt), lambda th: value_and_grad(th, tgt)),
                                    maxiter=maxiter)
    res, _, _ = run_lbfgs_chunked(programs, x0, maxiter=maxiter, chunk_iters=chunk_iters or maxiter)
    return res


@pytest.mark.parametrize("kind", KINDS)
def test_horizon_matches_the_eager_loop_c128(kind):
    _, tc, _, th, tgt = _case(kind)
    with config.svd_impl_override("native"):
        want = _eager_horizon(tc, th, tgt, 6)
    tja.watchdog_events.clear()
    got = tja.optimize_horizon_mps_jit(tc, th, tgt, base_bits=BITS, trunc_thr=THR, maxiter=6)
    assert got.num_iters == want.num_iters and got.converged == want.converged
    assert abs(float(got.fobj) - float(want.fobj)) <= TOL
    np.testing.assert_allclose(got.thetas.numpy(), want.thetas.numpy(), atol=TOL, rtol=0)
    assert tja.watchdog_events == []


def test_rand_horizon_and_timed_runner_match_the_eager_loop(rand_route, monkeypatch):
    """On "rand" (c64) through the programs, in one run and in chunks, from
    a perturbed Trotter start against a Trotter target at χ=16 (every pair
    update of the full χ on the fused update); the watchdog's reference
    evaluation goes through "native"'s value program."""
    from aqc_research_tpu_torch.targets import trotter as ttrot

    chi = 2 * CHI
    monkeypatch.setattr(trs, "RAND_MIN_N", 2 * chi)

    _, tc, _, _, _ = _case("trotter")
    th = ttrot.init_ansatz_to_trotter(tc, np.zeros(tc.num_thetas), evol_time=1.2, delta=1.0)
    th = torch.tensor(th + 0.05 * np.random.default_rng(5).standard_normal(tc.num_thetas), dtype=torch.float32)
    tgt = ttrot.Trotter(num_qubits=N, evol_time=1.2, num_steps=3, delta=1.0, second_order=True).as_mps(
        ttrot.neel_init_state(N), trunc_thr=THR, chi_max=chi)
    tgt = tm.MPS(tgt.gammas.to(torch.complex64), tgt.lambdas.float())
    with config.svd_impl_override("rand"):
        want = _eager_horizon(tc, th, tgt, 5)
        tja.watchdog_events.clear()
        got = tja.optimize_horizon_mps_jit(tc, th, tgt, base_bits=BITS, trunc_thr=THR, maxiter=5)
        timed, timed_out = tja.optimize_horizon_mps_timed(tc, th, tgt, base_bits=BITS, trunc_thr=THR, maxiter=5,
                                                          time_limit=None, chunk_iters=2)
    assert got.num_iters == want.num_iters == timed.num_iters and not timed_out
    assert abs(float(got.fobj) - float(want.fobj)) <= TOL and torch.equal(timed.fobj, got.fobj)
    assert tja.watchdog_events == []
    keys = {(k[0], k[-1]) for k in tja._PROGRAMS}
    assert {("value", "rand"), ("value_and_grad", "rand"), ("value", "native")} <= keys


def test_watchdog_reruns_through_the_reference_programs():
    _, tc, _, th, tgt = _case("trotter")
    fake = tja.JitHorizonResult(th, torch.tensor(1e-6, dtype=torch.float64), torch.tensor(1.0), 0, True)
    tja.watchdog_events.clear()
    with config.svd_impl_override("jacobi"):
        out = tja._mps_watchdog(tc, th, tgt, fake, base_bits=BITS, trunc_thr=THR, fobj_thr=None, maxiter=2,
                                no_improve_iters=None)
    assert len(tja.watchdog_events) == 1 and tja.watchdog_events.pop()["reference_impl"] == "native"
    assert out.num_iters == 2 and float(out.fobj) < float(tja._mps_value_program(tc, BITS, THR, "native")(th, tgt))
    keys = {(k[0], k[-1]) for k in tja._PROGRAMS}
    assert keys == {("value", "native"), ("value_and_grad", "native"), ("chunks", "native")}


def test_the_driver_releases_programs_between_horizons(monkeypatch):
    from aqc_research_tpu_torch.models.sp_lhs import time_evol as tte
    from aqc_research_tpu_torch.models.sp_lhs.user_options import UserOptions

    releases = []
    real = tja.release_mps_programs
    monkeypatch.setattr(tja, "release_mps_programs", lambda: releases.append(len(tja._PROGRAMS)) or real())
    jc = JTrotterAnsatz.make(4, make_trotter_like_circuit(4, 2), True)
    tc = interop.ansatz_from_args(interop.ansatz_args(jc))
    opts = UserOptions()
    opts.maxiter, opts.time_limit = 2, -1
    target = tm.mps_from_dense(np.eye(16)[5].astype(np.complex128), 4)
    for _ in range(2):
        tte._optimize_jit(opts=opts, circ=tc, thetas_0=np.zeros(tc.num_thetas), target=target, fid_thr=0.999)
    assert releases == [0, 3]  # the first horizon's value, obj+grad and chunk programs go before the second


def test_chip_smoke_counts_the_launches_that_ran():
    """A kernel wrapper counts at capture, when nothing runs; chip_smoke's
    counts take the captured launches off and add each replay's."""
    import chip_smoke
    from aqc_research_tpu_torch.ops.jacobi_kernel import jacobi_rows

    chip_smoke.reset_counts()
    try:
        jacobi_rows.launches, jacobi_rows.launches_at, jacobi_rows.launches_home = 5, {128: 5}, {"cluster": 5}
        step = Counter({("jacobi_rows",): 3, ("jacobi_rows", "at", 128): 3, ("jacobi_rows", "home", "cluster"): 3})
        cg.captured.update(step)
        for _ in range(4):
            cg.replayed.update(step)
        assert chip_smoke.read_counts()["jacobi_rows"] == 5 - 3 + 12
        assert chip_smoke.read_counts_at()["jacobi_rows"] == {128: 14}
        assert chip_smoke.read_counts_home()["jacobi_rows"] == {"cluster": 14}
        assert cg.kernel_launches(step) == {"jacobi_rows": 3}
    finally:
        chip_smoke.reset_counts()
    assert not cg.captured and not cg.replayed and jacobi_rows.launches == 0
