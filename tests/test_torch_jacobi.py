"""The one-sided Jacobi route of the port (ops/jacobi_kernel.py,
ops/jacobi_svd.py) held against the JAX package's Pallas kernel in
interpret mode (ops/pallas_jacobi.py) and its XLA spec (ops/jacobi_svd.py).

Tolerances: singular values 1e-5 * s_max and reconstruction 1e-5 relative —
the f32 convergence floor of the adaptive loop (tol 1e-6 per entry,
pallas_jacobi.py:85-93, plus f32 rounding of the two implementations);
kept-subspace projectors 1e-4 — the projector is sensitive to the spectral
gap as well.  Raw factors are not compared (phases are arbitrary).

The kernel itself runs only on a CUDA card: tests/test_torch_kernel.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqc_research_tpu import config as jcfg
from aqc_research_tpu.ops import jacobi_svd as jspec
from aqc_research_tpu.ops import pallas_jacobi as jpj
from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.kernel_checks import padded_pair_batch
from aqc_research_tpu_torch.ops import cuda_build
from aqc_research_tpu_torch.ops import jacobi_kernel as jk
from aqc_research_tpu_torch.ops import jacobi_svd as tspec
from tests import _torch_threads  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _pin_cpu():
    """The port runs on the CPU only when asked to: pin it, restore after."""
    previous = config._DEVICE
    config.set_device("cpu")
    yield
    config.set_device(previous)


S_TOL = 1e-5
REC_TOL = 1e-5
PROJ_TOL = 1e-4


def graded(seed: int, batch: int, n: int, decades: float = 2.0) -> np.ndarray:
    """Complex64 matrices with a log-spaced spectrum 1 .. 10^-decades."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    u, _, vh = np.linalg.svd(a)
    s = 10.0 ** (-decades * np.arange(n) / (n - 1))
    return ((u * s[None, None, :]) @ vh).astype(np.complex64)


@pytest.fixture
def jax_criterion():
    """Sets both packages' Jacobi criterion and the JAX kernel's chunk to 1
    (per-matrix adaptive loop, the port's semantics); restores both."""
    previous = config.jacobi_criterion()

    def use(criterion):
        jcfg.set_jacobi_criterion(criterion)
        config.set_jacobi_criterion(criterion)
        jcfg.set_svd_chunk(1)
        jax.clear_caches()

    yield use
    jcfg.set_jacobi_criterion(None)
    jcfg.set_svd_chunk(None)
    config.set_jacobi_criterion(previous)
    jax.clear_caches()


@pytest.mark.parametrize("criterion", ["entry", "hybrid"])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_twin_matches_pallas_interpret(jax_criterion, n, criterion):
    jax_criterion(criterion)
    m = graded(n, 3, n)
    k = n // 2
    ju, js, jvh = (np.asarray(x) for x in jpj.jacobi_svd_pallas_top_k(jnp.asarray(m), k))
    tu, ts, tvh = jk.jacobi_svd_kernel_top_k(torch.tensor(m), k)
    smax = js[:, :1]
    assert np.abs(ts.numpy() - js).max() <= S_TOL * smax.max()
    # Full factorization of the port reconstructs m.
    fu, fs, fvh = jk.jacobi_svd_kernel_top_k(torch.tensor(m), n)
    rec = torch.matmul(fu * fs[:, None, :].to(fu.dtype), fvh)
    rel = torch.linalg.matrix_norm(rec - torch.tensor(m)) / torch.linalg.matrix_norm(torch.tensor(m))
    assert float(rel.max()) <= REC_TOL
    # Kept subspaces agree (left and right projectors).
    tpu = tu.numpy() @ np.conj(np.swapaxes(tu.numpy(), -1, -2))
    jpu = ju @ np.conj(np.swapaxes(ju, -1, -2))
    assert np.abs(tpu - jpu).max() <= PROJ_TOL
    tpv = np.conj(np.swapaxes(tvh.numpy(), -1, -2)) @ tvh.numpy()
    jpv = np.conj(np.swapaxes(jvh, -1, -2)) @ jvh
    assert np.abs(tpv - jpv).max() <= PROJ_TOL


@pytest.mark.parametrize("criterion", ["entry", "hybrid"])
def test_twin_sweep_counts_match_jax(jax_criterion, criterion):
    """Per-matrix adaptive sweep counts equal the JAX spec's count of each
    matrix (jacobi_sweeps_used runs the identical schedule/tolerance)."""
    jax_criterion(criterion)
    m = graded(5, 3, 16)
    mt = torch.tensor(m).transpose(-1, -2)
    _, _, sweeps = jk.jacobi_rows_reference(mt.real.contiguous(), mt.imag.contiguous(), 12)
    want = [int(jspec.jacobi_sweeps_used(jnp.asarray(m[i]), 12, criterion)) for i in range(3)]
    assert sweeps.tolist() == want


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_spec_matches_jax_at_n4(dtype):
    """Matrices below 8 columns take the spec (the χ-growth heads)."""
    rng = np.random.default_rng(11)
    m = (rng.standard_normal((3, 4, 4)) + 1j * rng.standard_normal((3, 4, 4))).astype(dtype)
    ju, js, jvh = (np.asarray(x) for x in jspec.jacobi_svd_top_k(jnp.asarray(m), 2))
    tu, ts, tvh = tspec.jacobi_svd_top_k(torch.tensor(m), 2)
    tol = 1e-12 if dtype == np.complex128 else S_TOL
    np.testing.assert_allclose(ts.numpy(), js, atol=tol * js.max())
    fu, fs, fvh = tspec.jacobi_svd(torch.tensor(m))
    rec = (fu * fs[:, None, :].to(fu.dtype)) @ fvh
    np.testing.assert_allclose(rec.numpy(), m, atol=(1e-12 if dtype == np.complex128 else 1e-5))
    np.testing.assert_allclose(
        np.abs(tu.numpy() @ np.conj(np.swapaxes(tu.numpy(), -1, -2))),
        np.abs(ju @ np.conj(np.swapaxes(ju, -1, -2))),
        atol=(1e-10 if dtype == np.complex128 else PROJ_TOL),
    )


def test_sort_guard_matches_jax_on_rank_deficient_rows():
    """Rows below 32*eps*s_max come back as exact zeros, as in JAX."""
    rng = np.random.default_rng(2)
    norms = np.array([1.0, 0.7, 0.5, 0.3, 0.1, 5e-2, 1e-2, 1e-3, 1e-4, 1e-5, 5e-6, 3e-6, 1e-6, 1e-7, 1e-8, 0.0])
    rows = rng.standard_normal((2, 16, 16)) + 1j * rng.standard_normal((2, 16, 16))
    rows = rows / np.linalg.norm(rows, axis=-1, keepdims=True) * norms[None, :, None]
    w_re, w_im = rows.real.astype(np.float32), rows.imag.astype(np.float32)
    jw, js, jinv = jpj._sort_guard_top_k(jnp.asarray(w_re), jnp.asarray(w_im), 16, jnp.complex64)
    tw, ts, tinv = jk._sort_guard_top_k(torch.tensor(w_re), torch.tensor(w_im), 16, torch.complex64)
    assert (ts.numpy() == 0).any()
    np.testing.assert_array_equal(ts.numpy() == 0, np.asarray(js) == 0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    m = graded(3, 2, 16)
    mt = torch.tensor(m).transpose(-1, -2)
    re, im = mt.real.contiguous(), mt.imag.contiguous()
    before = jk.jacobi_rows.launches
    got = jk.jacobi_rows(re, im, 12)
    want = jk.jacobi_rows_reference(re, im, 12)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert jk.jacobi_rows.launches == before


def test_rows_reject_other_devices():
    meta = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        jk.jacobi_rows(meta, meta, 12)


@pytest.mark.parametrize(
    "shape,dtype,why",
    [
        ((2, 8, 8), torch.float64, "float32"),
        ((8, 8), torch.float32, r"\(B, c, r\)"),
        ((2, 7, 8), torch.float32, "even c"),
        ((2, 8, 6), torch.float32, "r >= c"),
    ],
)
def test_kernel_argument_checks_raise(shape, dtype, why):
    t = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=why):
        jk.check_rows_args(t, t)


def test_kernel_argument_checks_accept_the_slice_shapes():
    for n in (8, 16, 32, 64, 128, 256):
        t = torch.zeros((10, n, n))
        jk.check_rows_args(t, t)
    assert jk.rows_smem_bytes(128, 128) == 4 * (2 * 128 * 128 + 3 * 128)
    t = torch.zeros((2, 16, 8)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        jk.check_rows_args(t, t)


@pytest.mark.parametrize(
    "c,r,max_smem,home,threads",
    [
        (128, 128, 232448, "cluster", 288),  # the 20q path: 8 CTAs of 8 pairs, 33,152 B each
        (256, 256, 232448, "cluster", 544),  # the 28q pair matrices: 8 CTAs of 16 pairs, 131,840 B each
        (16, 16, 232448, "cluster", 64),  # a head: 8 CTAs of one pair
        (136, 256, 232448, "cluster", 320),
        (128, 128, 101376, "cluster", 288),  # a card with less shared memory per block
        (8, 8, 232448, "shared", 128),  # below CLUSTER_MIN_ROWS: one block, a warp per pair
        (32, 32, 232448, "cluster", 96),  # 8 CTAs of 2 pairs
        (64, 64, 232448, "cluster", 160),
        (18, 18, 232448, "cluster", 96),  # 9 pairs: 5 CTAs of 2, none idle
        (256, 256, 101376, "global", 1024),  # 16 pairs of 256 lanes fit no CTA there
        (64, 64, 8000, "global", 1024),  # neither a CTA of the cluster nor one block fits
        (512, 512, 232448, "global", 1024),  # past the cluster loop's 256 rows
    ],
)
def test_plane_home_rule(c, r, max_smem, home, threads):
    """The path shapes and the heads from CLUSTER_MIN_ROWS = 16 rows live in
    the shared memory of a thread-block cluster (a warp per pair, the pairs
    spread over up to 8 CTAs); smaller heads in one block's shared memory
    (8 warps at most); what neither holds in device memory, with a warp per
    row pair up to 32."""
    assert jk.plane_home(c, r, max_smem) == home
    assert jk.launch_shape(c, home, None)[1] == threads
    assert jk.block_threads(c) == 32 * min(8, c // 2)
    if home == "cluster":
        assert threads == jk.cluster_threads(c, jk.cluster_size(c))
    else:
        assert threads == jk.block_threads(c, home)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()


def test_truncation_supported_matches_jax():
    for thr in (1e-16, 1.4e-14, 1e-13, 1e-12, 1e-8, 1e-6, 1e-3):
        assert jk.truncation_supported(thr) == jpj.truncation_supported(thr)


# -----------------------------------------------------------------------------
# The block-cyclic schedule of K4's cluster home (csrc/block_sweeps.cuh) and
# its twin, at 2 and 4 "CTAs" of 8-row blocks and at the path's 16-row blocks.
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(32, 8), (64, 8), (256, 16), (200, 16), (192, 16)])
def test_block_schedule_visits_every_pair_once(n, block):
    """A sweep of the block-cyclic schedule, from any round, rotates each
    unordered pair of the rows (padded with zero rows to whole blocks, two a
    CTA) exactly once in 2P blocks x block - 1 phases of disjoint pairs; and
    between two rounds every CTA keeps its block b and sends a: CTA 0 keeps
    the circle's fixed block, every other CTA's kept block is its a in the
    next round (the block buffers of block_sweeps.cuh rest on both)."""
    ctas = jk.block_ctas(n, block)
    rows = 2 * ctas * block
    assert n <= rows < n + 2 * block
    circle = 2 * ctas - 1
    for first in range(2 * circle):
        phases = jk.block_sweep_phases(ctas, block, first)
        assert len(phases) == rows - 1
        met = set()
        for left, right in phases:
            assert len(set(left) | set(right)) == len(left) + len(right) == rows
            met.update(frozenset(pair) for pair in zip(left, right))
        assert len(met) == rows * (rows - 1) // 2
    for g in range(2 * circle):
        held = [jk.block_pair(c, g, ctas) for c in range(ctas)]
        after = [jk.block_pair(c, g + 1, ctas) for c in range(ctas)]
        assert sorted(x for pair in held for x in pair) == list(range(2 * ctas))
        assert held[0][1] == after[0][1] == circle
        assert all(after[c][0] == held[c][1] for c in range(1, ctas))


def _values(w_re, w_im):
    return torch.sqrt((w_re**2 + w_im**2).sum(-1)).sort(-1, descending=True).values


@pytest.mark.parametrize("criterion", ["entry", "hybrid"])
@pytest.mark.parametrize("n,rank", [(32, None), (64, None), (64, 20)])
def test_block_twin_matches_svd_and_the_ring(n, rank, criterion):
    """The blocked twin on 2 and 4 CTAs of 8-row blocks (and a zero-padded
    rank-20 pair matrix, bonds held at chi = n/2): singular values within
    S_TOL * s_max of LAPACK's in f64, the rotated rows orthogonal (each
    Gram entry within 1e-5 s_max of the larger row norm), sweep counts
    within 1 of the ring twin's on the same planes."""
    m = graded(n, 3, n) if rank is None else padded_pair_batch(np.random.default_rng(n), 3, n, rank).numpy()
    mt = torch.tensor(m).transpose(-1, -2)
    re, im = mt.real.contiguous(), mt.imag.contiguous()
    b_re, b_im, b_sw = jk.block_jacobi_rows_reference(re, im, 12, criterion, block=8)
    _, _, r_sw = jk.jacobi_rows_reference(re, im, 12, criterion)
    want = torch.linalg.svdvals(torch.tensor(m).to(torch.complex128))
    smax = float(want.max())
    assert float((_values(b_re, b_im).double() - want).abs().max()) <= S_TOL * smax
    w = torch.complex(b_re, b_im).to(torch.complex128)
    gram = w @ w.conj().transpose(-1, -2)
    norms = gram.diagonal(dim1=-2, dim2=-1).real.sqrt()
    off = gram - torch.diag_embed(gram.diagonal(dim1=-2, dim2=-1))
    assert float((off.abs() / torch.maximum(norms[..., :, None], norms[..., None, :]).clamp(min=1e-30)).max()) \
        <= 1e-5 * smax
    assert int((b_sw - r_sw).abs().max()) <= 1 and int(b_sw.min()) >= 1


@pytest.mark.parametrize("criterion", ["entry", "hybrid"])
@pytest.mark.parametrize("n", [32, 64])
def test_block_twin_matches_pallas_interpret(jax_criterion, monkeypatch, n, criterion):
    """The truncated SVD through the blocked twin (2 and 4 CTAs of 8-row
    blocks) against the Pallas kernel in interpret mode, held as
    test_twin_matches_pallas_interpret holds the ring twin."""
    jax_criterion(criterion)
    monkeypatch.setattr(jk, "jacobi_rows", lambda re, im, sweeps: jk.block_jacobi_rows_reference(re, im, sweeps,
                                                                                                  block=8))
    m = graded(n + 1, 3, n)
    k = n // 2
    ju, js, jvh = (np.asarray(x) for x in jpj.jacobi_svd_pallas_top_k(jnp.asarray(m), k))
    tu, ts, tvh = jk.jacobi_svd_kernel_top_k(torch.tensor(m), k)
    assert np.abs(ts.numpy() - js).max() <= S_TOL * js.max()
    fu, fs, fvh = jk.jacobi_svd_kernel_top_k(torch.tensor(m), n)
    rec = torch.matmul(fu * fs[:, None, :].to(fu.dtype), fvh)
    rel = torch.linalg.matrix_norm(rec - torch.tensor(m)) / torch.linalg.matrix_norm(torch.tensor(m))
    assert float(rel.max()) <= REC_TOL
    tpu = tu.numpy() @ np.conj(np.swapaxes(tu.numpy(), -1, -2))
    assert np.abs(tpu - ju @ np.conj(np.swapaxes(ju, -1, -2))).max() <= PROJ_TOL
    tpv = np.conj(np.swapaxes(tvh.numpy(), -1, -2)) @ tvh.numpy()
    assert np.abs(tpv - np.conj(np.swapaxes(jvh, -1, -2)) @ jvh).max() <= PROJ_TOL


def test_block_twin_rejects_blocks_that_do_not_hold_the_rows():
    t = torch.zeros((1, 40, 40))
    with pytest.raises(ValueError, match="do not fit"):
        jk.block_jacobi_rows_reference(t, t, 12, block=8, ctas=2)
    with pytest.raises(ValueError, match="do not fit"):
        jk.block_jacobi_rows_reference(t, t, 12, block=7)
