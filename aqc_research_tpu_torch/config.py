"""Global precision / device / decomposition policy of the PyTorch port.

Twin of ``aqc_research_tpu/config.py``.  Two precision modes:

* ``"high"`` — float64 / complex128.  Used by the parity tests, which hold
  the port against the JAX package at the reference's <= 1e-10 bar.
* ``"fast"`` — float32 / complex64.  The production mode on the GPU.

The mode is process-global (it decides the dtype of newly created tensors);
functions also accept explicit dtypes where that matters.  It is read from
``AQC_TORCH_PRECISION`` (default ``"high"``).

The truncated-SVD route of the MPS engine is chosen per tensor: ``"rand"``
(the fused randomized-projection pair update, ops/fused_rand.py, with the
hand-written kernels) for CUDA tensors, ``"native"`` (``torch.linalg.svd``)
for CPU tensors — the twin of the JAX package's "rand route on the
accelerator, LAPACK elsewhere" rule (its ``config.svd_impl``).

Tensors the port creates without an input to follow go to :func:`device`,
which never falls back to the CPU on its own: without a CUDA card the CPU
must be asked for (``set_device("cpu")`` or ``AQC_TORCH_DEVICE=cpu``).
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch

_PRECISIONS = ("high", "fast")
_PRECISION = os.environ.get("AQC_TORCH_PRECISION", "high")
if _PRECISION not in _PRECISIONS:
    raise ValueError(f"AQC_TORCH_PRECISION must be one of {_PRECISIONS}")


def require_full_f32_matmul() -> None:
    """Sets and asserts true-f32 matrix products on the GPU.

    TF32 keeps ~10 mantissa bits; per-gate truncation error compounds over
    deep circuits into O(0.1) infidelity errors (the JAX package's reason for
    ``jax_default_matmul_precision=highest``).  Quantum simulation needs
    true-f32 contractions, so both cuBLAS and cuDNN TF32 are switched off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


require_full_f32_matmul()


def set_precision(mode: str) -> None:
    """Sets the global precision mode: ``"high"`` (f64/c128) or ``"fast"`` (f32/c64)."""
    global _PRECISION
    if mode not in _PRECISIONS:
        raise ValueError(f"unknown precision mode: {mode!r}")
    _PRECISION = mode


def precision() -> str:
    return _PRECISION


def real_dtype() -> torch.dtype:
    return torch.float64 if _PRECISION == "high" else torch.float32


def complex_dtype() -> torch.dtype:
    return torch.complex128 if _PRECISION == "high" else torch.complex64


def real_of(dtype: torch.dtype) -> torch.dtype:
    """The real dtype matching a complex (or real) dtype."""
    return {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(
        dtype, dtype
    )


_DEVICE = os.environ.get("AQC_TORCH_DEVICE") or None


def set_device(device) -> None:
    """Default device for tensors the port creates without an input to
    follow (``None``: the CUDA card, which must then be present)."""
    global _DEVICE
    _DEVICE = None if device is None else str(device)


def device() -> torch.device:
    """The default device: the one set, else the CUDA card.  Raises when
    nothing was set and there is no card — the port runs on the CPU only
    when asked to."""
    if _DEVICE is not None:
        return torch.device(_DEVICE)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no default device was set; "
            'to run the port on the CPU call config.set_device("cpu") or set '
            "AQC_TORCH_DEVICE=cpu"
        )
    return torch.device("cuda")


_SVD_IMPLS = ("native", "gram", "jacobi", "rand")
_SVD_IMPL: str | None = os.environ.get("AQC_TORCH_SVD_IMPL") or None
if _SVD_IMPL is not None and _SVD_IMPL not in _SVD_IMPLS:
    raise ValueError(f"AQC_TORCH_SVD_IMPL must be one of {_SVD_IMPLS}")


def set_svd_impl(impl: str | None) -> None:
    """Selects the MPS truncated-SVD route.

    * ``"native"`` — ``torch.linalg.svd``.
    * ``"gram"`` — the Hermitian eigendecomposition of the Gram matrix and
      products (ops/svd_gram.py); the squared condition number touches only
      directions the update truncates.
    * ``"jacobi"`` — batched one-sided Jacobi (ops/jacobi_kernel.py): the
      hand-written CUDA kernel on CUDA tensors, its plain-torch twin on CPU
      tensors.  f32 arithmetic regardless of the precision mode.
    * ``"rand"`` — the fused randomized-projection pair update
      (ops/fused_rand.py): the θ-build kernel, a torch range-finder, the
      reduced-Jacobi tail kernel.  Taken for complex64 pair updates with
      χ % 8 == 0 and 2χ >= ``rand_svd.RAND_MIN_N`` where
      :func:`fused_rand_enabled` says so.  Every other pair update takes the
      "jacobi" route on CUDA tensors (unless :func:`allow_unfused_rand`
      opts in to the unfused one); on other tensors those from
      ``RAND_MIN_N`` on take the unfused ``rand_svd.rand_svd_top_k``, as the
      JAX package's do off its accelerator.
    * ``None`` — auto, per tensor: "rand" on CUDA, "native" on CPU.
    """
    global _SVD_IMPL
    if impl is not None and impl not in _SVD_IMPLS:
        raise ValueError(f"unknown svd impl: {impl!r} (use one of {_SVD_IMPLS})")
    _SVD_IMPL = impl


def svd_impl(dev=None) -> str:
    """The route in effect for tensors on ``dev`` (a device, a tensor or None
    for the default device)."""
    if _SVD_IMPL is not None:
        return _SVD_IMPL
    if isinstance(dev, torch.Tensor):
        dev = dev.device
    dev = device() if dev is None else torch.device(dev)
    return "rand" if dev.type == "cuda" else "native"


@contextmanager
def svd_impl_override(impl: str):
    """Scoped ``set_svd_impl``: forces ``impl`` inside the block."""
    global _SVD_IMPL
    if impl not in _SVD_IMPLS:
        raise ValueError(f"unknown svd impl: {impl!r} (use one of {_SVD_IMPLS})")
    previous = _SVD_IMPL
    _SVD_IMPL = impl
    try:
        yield
    finally:
        _SVD_IMPL = previous


_FUSED_PAIR: bool | None = {"1": True, "0": False}.get(os.environ.get("AQC_TORCH_FUSED_PAIR", ""))

# The JAX package's threshold (its config.py:249-254): its on-chip A/B found
# the fused kernel a wash at chi = 64 and ahead at chi = 128, so the auto
# rule routes by bond dimension.
_FUSED_PAIR_MIN_CHI = 96


def set_fused_pair(enabled: bool | None) -> None:
    """The fused pair-update kernel K4 (ops/fused_pair.fused_pair_update: θ
    build, adaptive Jacobi, truncation and both factors in one kernel) on
    the ``"jacobi"`` route:

    * ``True``  — whenever eligible (complex64 pair updates with chi >= 8);
      on CPU tensors that runs K4's plain twin,
    * ``False`` — never (the jacobi route then runs K1 on every pair update),
    * ``None``  — auto, per tensor: on for CUDA tensors at chi >= 96, off
      for CPU tensors (env override ``AQC_TORCH_FUSED_PAIR=1/0``).

    As in the JAX package, the same override also gates the rand route's
    fused update (:func:`fused_rand_enabled`, whose auto rule differs)."""
    global _FUSED_PAIR
    _FUSED_PAIR = enabled


def fused_pair_enabled(chi: int | None = None, dev=None) -> bool:
    """Whether the jacobi route's pair update at bond dimension ``chi`` on
    ``dev`` (a device, a tensor or None for the default device) takes K4."""
    if _FUSED_PAIR is not None:
        return _FUSED_PAIR
    if isinstance(dev, torch.Tensor):
        dev = dev.device
    dev = device() if dev is None else torch.device(dev)
    return dev.type == "cuda" and chi is not None and chi >= _FUSED_PAIR_MIN_CHI


def fused_rand_enabled(chi: int | None = None, dev=None) -> bool:
    """Whether the ``"rand"`` route's pair update at bond dimension ``chi``
    on ``dev`` (a device, a tensor or None for the default device) takes the
    fused update (ops/fused_rand.py: K2, the range-finder, K3).

    The JAX package's rule (its config.py:285-302): ``set_fused_pair``'s
    override wins; auto means on for CUDA tensors at chi >= 8.  Where it is
    off, ops/mps.py runs K1 on the square θ on CUDA tensors (the JAX
    package's fallback on its accelerator, where the unfused rand SVD has a
    known mid-optimization failure; :func:`allow_unfused_rand` opts in to
    the unfused ``rand_svd_top_k`` there) and the unfused
    ``rand_svd_top_k`` elsewhere."""
    if _FUSED_PAIR is not None:
        return _FUSED_PAIR
    if isinstance(dev, torch.Tensor):
        dev = dev.device
    dev = device() if dev is None else torch.device(dev)
    return dev.type == "cuda" and chi is not None and chi >= 8


def allow_unfused_rand() -> bool:
    """Whether a CUDA pair update that the rand route's fused update does
    not take (its shape guards, ``set_fused_pair(False)``) runs the unfused
    ``rand_svd.rand_svd_top_k`` from ``RAND_MIN_N`` on instead of K1: only
    with ``AQC_TORCH_ALLOW_UNFUSED_RAND=1`` (read at call time), for probes
    that study that route.  The JAX package's opt-in
    ``AQC_TPU_ALLOW_UNFUSED_RAND`` guards a known mid-optimization failure
    of the unfused rand SVD on its chip (a 16-qubit horizon collapsing to
    fobj = 1.0), so the default stays K1."""
    return os.environ.get("AQC_TORCH_ALLOW_UNFUSED_RAND", "") == "1"


def mps_watchdog_enabled() -> bool:
    """The MPS optimization watchdog (models/sp_lhs/jit_asp.py): after a
    horizon optimized under a route other than the reference one
    (``"jacobi"`` on CUDA, ``"native"`` on the CPU), the returned iterate's
    objective is re-evaluated under the reference and the horizon is flagged
    and re-optimized when the two disagree grossly.  Disable with
    ``AQC_TORCH_MPS_WATCHDOG=0``."""
    return os.environ.get("AQC_TORCH_MPS_WATCHDOG", "1") != "0"


_JACOBI_SWEEPS = int(os.environ.get("AQC_TORCH_JACOBI_SWEEPS", "0")) or None


def set_jacobi_sweeps(sweeps: int | None) -> None:
    """Maximum adaptive sweep count of the Jacobi route (None = 12)."""
    global _JACOBI_SWEEPS
    if sweeps is not None and sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    _JACOBI_SWEEPS = sweeps


def jacobi_sweeps() -> int | None:
    return _JACOBI_SWEEPS


# The port defaults to "hybrid" where the JAX package defaults to "entry":
# on the H100 at 20 qubits chi=64 (trunc 1e-6) the entry criterion's
# small-kept-column contamination put the objective 5.8e-4 (kernel) and
# 6.4e-4 (plain twin) away from the f64 LAPACK value, while hybrid stayed
# within 4.1e-5 / 2.9e-5 at 31% more sweeps (PERF.md, Findings).
_JACOBI_CRITERION = os.environ.get("AQC_TORCH_JACOBI_CRITERION", "hybrid")
if _JACOBI_CRITERION not in ("entry", "hybrid"):
    raise ValueError("AQC_TORCH_JACOBI_CRITERION must be 'entry' or 'hybrid'")


def set_jacobi_criterion(criterion: str | None) -> None:
    """f32 adaptive-sweep convergence criterion of the Jacobi route:

    * ``"entry"`` — converged once a pair's mixing contributes < 1e-6 *
      s_max to any reconstructed entry; a small KEPT column may then stay
      contaminated by large directions up to 1e-6 * s_max / s_j, which the
      ``vh = diag(1/s) u^H m`` recovery amplifies.
    * ``"hybrid"`` (default, None) — relative-grade orthogonality for
      columns above the 32*eps*s_max kill floor, entry-absolute below it.
    """
    global _JACOBI_CRITERION
    if criterion not in (None, "entry", "hybrid"):
        raise ValueError(f"unknown jacobi criterion: {criterion!r}")
    _JACOBI_CRITERION = criterion or "hybrid"


def jacobi_criterion() -> str:
    return _JACOBI_CRITERION


def trace_policy() -> tuple:
    """The global settings a pair update reads besides its route: the
    fused-update override, the Jacobi sweep cap and criterion, and the
    unfused-rand opt-in.  A device program bakes them in at its capture, so
    programs are keyed on them (models/sp_lhs/jit_asp.py)."""
    return (_FUSED_PAIR, _JACOBI_SWEEPS, _JACOBI_CRITERION, allow_unfused_rand())
