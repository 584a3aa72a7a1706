"""The hand-written Jacobi kernel (csrc/jacobi_rows.cu) against its plain
twin, on a CUDA card.  Marked ``cuda``: skips without a card.  This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py -q

Tolerances: singular values within 1e-5 * s_max (the f32 convergence floor
of the adaptive loop, tol 1e-6 per entry, plus two rounding orders); sweep
counts within 1 (a sweep's residual can land on either side of the tolerance
under different rounding)."""

import numpy as np
import pytest
import torch

from aqc_research_tpu_torch import config
from aqc_research_tpu_torch.ops import jacobi_kernel as jk
from aqc_research_tpu_torch.ops import mps as tm
from aqc_research_tpu_torch.targets.trotter import (
    Trotter,
    _block_4x4_lo_hi,
    neel_init_state,
    trotter_alphas,
)


def graded(seed: int, batch: int, n: int) -> np.ndarray:
    """Complex64 matrices with a log-spaced spectrum 1 .. 1e-2."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    u, _, vh = np.linalg.svd(a)
    s = 10.0 ** (-2.0 * np.arange(n) / (n - 1))
    return ((u * s[None, None, :]) @ vh).astype(np.complex64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Jacobi kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("criterion", ["entry", "hybrid"])
def test_kernel_matches_twin_on_card(cuda_device, criterion):
    for n in (8, 16, 32, 64, 128):
        m = torch.tensor(graded(n, 10, n), device=cuda_device)
        mt = m.transpose(-1, -2)
        re, im = mt.real.contiguous(), mt.imag.contiguous()
        before = jk.jacobi_rows.launches
        k_re, k_im, k_sw = jk.jacobi_rows(re, im, 12, criterion)
        assert jk.jacobi_rows.launches == before + 1
        p_re, p_im, p_sw = jk.jacobi_rows_reference(re, im, 12, criterion)
        torch.cuda.synchronize()
        ks = torch.sqrt((k_re**2 + k_im**2).sum(-1)).sort(-1).values
        ps = torch.sqrt((p_re**2 + p_im**2).sum(-1)).sort(-1).values
        assert float((ks - ps).abs().max()) <= 1e-5 * float(ps.max())
        assert int((k_sw - p_sw).abs().max()) <= 1


@pytest.mark.cuda
def test_kernel_rejects_the_256_shape_on_card(cuda_device):
    t = torch.zeros((1, 256, 256), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        jk.jacobi_rows(t, t, 12)


@pytest.mark.cuda
def test_pair_update_routes_agree_on_card(cuda_device):
    """A Trotter half-layer at χ=64 (128x128 pair matrices) on the jacobi
    route (one kernel launch) and on the native route give the same state
    to f32 accuracy (1e-4 per amplitude of a unit vector)."""
    n = 8
    trot = Trotter(num_qubits=n, evol_time=0.8, num_steps=2, delta=1.0, second_order=True)
    with config.svd_impl_override("native"):
        state = trot.as_mps(neel_init_state(n), trunc_thr=1e-6, chi_max=64,
                            dtype=torch.complex64, device=cuda_device)
    block = _block_4x4_lo_hi(trotter_alphas(0.3, 1.0), torch.complex64, cuda_device)
    out = {}
    for route in ("jacobi", "native"):
        with config.svd_impl_override(route):
            before = jk.jacobi_rows.launches
            out[route] = tm.mps_to_vector(
                tm.apply_pairs_mps(state, block.expand(3, 4, 4), (1, 3, 5), trunc_thr=1e-6)
            ).cpu().numpy()
            assert jk.jacobi_rows.launches == before + (route == "jacobi")
    np.testing.assert_allclose(out["jacobi"], out["native"], atol=1e-4)
    assert abs(np.vdot(out["jacobi"], out["native"])) >= 1 - 1e-5
