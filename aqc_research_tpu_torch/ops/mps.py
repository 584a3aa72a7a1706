"""Matrix-product-state engine on torch tensors (twin of
``aqc_research_tpu/ops/mps.py``).

* Vidal canonical form ``c_{s1..sn} = Γ_1^{s1} λ_1 Γ_2^{s2} λ_2 ... Γ_n^{sn}``.
* Static shapes: bond dimensions are padded to ``chi_max``; truncation masks
  singular values instead of reshaping.
* A two-qubit gate costs one pair contraction + one ``(2 chi, 2 chi)``
  truncated SVD + a rank-chi re-split; a chessboard half-layer of disjoint
  pairs is ONE batched decomposition (``_pair_update`` is natively batched).
* Truncation: discard the largest tail whose norm is ``<= trunc_thr * ||S||``,
  cap the rank at ``chi_max``, rescale the kept values to the full norm.

Sites are qubits in little-endian order (site j = bit j).  Functions are
pure: they return new tensors and never modify their inputs.  The tensors of
an :class:`MPS` may carry leading batch axes (``gammas (..., n, 2, chi,
chi)``), which the pair updates decompose as one batch.  Gates and Θ may
carry leading lane axes too (a fleet of L parameter vectors): an MPS
without them is broadcast to the lanes at the first gate, and every pair
group of all lanes is one batched decomposition.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..circuit.program import GateProgram, gate_matrix
from ..config import (
    complex_dtype,
    device as default_device,
    fused_pair_enabled,
    fused_rand_enabled,
    jacobi_sweeps,
    real_of,
    svd_impl,
)
from . import rand_svd
from .fused_pair import fused_pair_update
from .fused_rand import fused_rand_pair_update
from .jacobi_kernel import jacobi_svd_kernel_top_k, truncation_supported
from .jacobi_svd import DEFAULT_SWEEPS, jacobi_svd_top_k
from .statevector import block_gates, front_gates
from .svd_gram import svd_gram_top_k

_NO_TRUNCATION_THR = 1e-16


def no_truncation_threshold() -> float:
    """Threshold value that effectively disables truncation."""
    return _NO_TRUNCATION_THR


# -----------------------------------------------------------------------------
# Pair-sharding policy: when set, every batched half-layer pair update of the
# engine (the V† objective sweep, the co-sweep gradients, the χ-growth value
# sweeps, Trotter target evolution) goes through parallel/mps_sharded.py,
# each rank decomposing its run of the pairs.
# -----------------------------------------------------------------------------

_PAIR_SHARDING = None  # None or (DeviceMesh, axis name)


def set_pair_sharding(mesh, axis: str = "tp") -> None:
    """Enables (``mesh`` a DeviceMesh) or disables (None) sharded batched
    pair updates over ``mesh``'s ``axis``.  Every rank of the axis must set
    the same policy: the sharded update is a collective."""
    global _PAIR_SHARDING
    _PAIR_SHARDING = None if mesh is None else (mesh, str(axis))


def pair_sharding():
    return _PAIR_SHARDING


@dataclasses.dataclass
class MPS:
    """Vidal-form MPS with padded, static bond dimensions.

    Attributes:
        gammas: (..., n, 2, chi, chi) complex — Γ tensors; unused bond
            rows/cols are zero.  Γ_1 uses left bond 0 only; Γ_n right bond 0.
        lambdas: (..., n-1, chi) real — bond singular values, descending,
            zero-padded.
    """

    gammas: torch.Tensor
    lambdas: torch.Tensor

    @property
    def num_sites(self) -> int:
        return self.gammas.shape[-4]

    @property
    def chi(self) -> int:
        return self.gammas.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.gammas.device

    def __getitem__(self, idx) -> "MPS":
        """Indexes the leading (batch) axes of both tensors."""
        return MPS(self.gammas[idx], self.lambdas[idx])


def _boundary(chi: int, batch, dtype, device) -> torch.Tensor:
    """The trivial bond vector e_0, shape batch + (1, chi)."""
    b = torch.zeros(tuple(batch) + (1, chi), dtype=dtype, device=device)
    b[..., 0, 0] = 1.0
    return b


def mps_basis_state(bits: Tuple[int, ...], chi_max: int, dtype=None, device=None) -> MPS:
    """Computational basis state |b_{n-1} ... b_0> as an MPS (bit q = site q)."""
    dtype = complex_dtype() if dtype is None else dtype
    device = default_device() if device is None else device
    n = len(bits)
    gammas = torch.zeros((n, 2, chi_max, chi_max), dtype=dtype, device=device)
    for q, b in enumerate(bits):
        gammas[q, int(b), 0, 0] = 1.0
    lambdas = torch.zeros((max(n - 1, 0), chi_max), dtype=real_of(dtype), device=device)
    lambdas[:, 0] = 1.0
    return MPS(gammas, lambdas)


def mps_zero(num_qubits: int, chi_max: int, dtype=None, device=None) -> MPS:
    """|0...0> as an MPS with bond dimension padded to ``chi_max``."""
    return mps_basis_state((0,) * num_qubits, chi_max, dtype, device)


def broadcast_mps(mps: MPS, batch: Tuple[int, ...]) -> MPS:
    """``mps`` with its leading axes broadcast to ``batch`` (a copy when they
    grow, so the result may be written in place)."""
    batch = tuple(torch.broadcast_shapes(tuple(mps.gammas.shape[:-4]), tuple(batch)))
    if batch == tuple(mps.gammas.shape[:-4]):
        return mps
    return MPS(
        mps.gammas.expand(batch + tuple(mps.gammas.shape[-4:])).clone(),
        mps.lambdas.expand(batch + tuple(mps.lambdas.shape[-2:])).clone(),
    )


def mps_resize(mps: MPS, chi_new: int) -> MPS:
    """Pads (grows) or slices (shrinks) the static bond dimension.  Shrinking
    is exact only when the dropped bond rows/cols are zero."""
    chi = mps.chi
    if chi_new == chi:
        return mps
    k = min(chi, chi_new)
    g = mps.gammas.new_zeros(mps.gammas.shape[:-2] + (chi_new, chi_new))
    g[..., :k, :k] = mps.gammas[..., :k, :k]
    lam = mps.lambdas.new_zeros(mps.lambdas.shape[:-1] + (chi_new,))
    lam[..., :k] = mps.lambdas[..., :k]
    return MPS(g, lam)


def check_mps(mps: MPS) -> bool:
    """Structural validation of an unbatched MPS: consistent shapes, lambdas
    non-negative and descending (the JAX package's ops/mps.py:130)."""
    if not isinstance(mps, MPS):
        return False
    n, chi = mps.num_sites, mps.chi
    if tuple(mps.gammas.shape) != (n, 2, chi, chi):
        return False
    if tuple(mps.lambdas.shape) != (max(n - 1, 0), chi):
        return False
    lam = mps.lambdas.detach().cpu().double().numpy()
    if np.any(lam < -1e-12):
        return False
    return not np.any(lam[:, :-1] < lam[:, 1:] - 1e-9)  # descending order


# -----------------------------------------------------------------------------
# Gate application.
# -----------------------------------------------------------------------------


def apply_1q_mps(mps: MPS, gate2x2: torch.Tensor, site: int) -> MPS:
    """1-qubit gate ``(..., 2, 2)``: Γ_site <- G Γ_site."""
    g = gate2x2.to(mps.gammas.dtype)
    mps = broadcast_mps(mps, g.shape[:-2])
    gammas = mps.gammas.clone()
    gammas[..., site, :, :, :] = torch.einsum("...ij,...jab->...iab", g, mps.gammas[..., site, :, :, :])
    return MPS(gammas, mps.lambdas)


def apply_1q_many(mps: MPS, gates: torch.Tensor, sites: Tuple[int, ...]) -> MPS:
    """DISTINCT 1-qubit gates (..., P, 2, 2) at distinct sites in one batched einsum."""
    if len(set(sites)) != len(sites):
        raise ValueError("apply_1q_many needs distinct sites")
    idx = torch.as_tensor(sites, dtype=torch.long, device=mps.gammas.device)
    g = gates.to(mps.gammas.dtype)
    mps = broadcast_mps(mps, g.shape[:-3])
    gammas = mps.gammas.clone()
    gammas[..., idx, :, :, :] = torch.einsum("...pij,...pjab->...piab", g, mps.gammas[..., idx, :, :, :])
    return MPS(gammas, mps.lambdas)


def _safe_inv(lam: torch.Tensor, cutoff: float = 1e-12) -> torch.Tensor:
    scale = lam.amax(-1, keepdim=True)
    # dtype-aware floor: a literal like 1e-300 underflows to 0 in f32.
    thr = cutoff * torch.clamp(scale, min=torch.finfo(lam.dtype).tiny)
    big = lam > thr
    return torch.where(big, 1.0 / torch.where(big, lam, torch.ones_like(lam)), torch.zeros_like(lam))


def _truncation_mask(s: torch.Tensor, chi: int, trunc_thr: float):
    """Keep mask for the full singular spectrum: discard the largest tail
    whose norm is <= trunc_thr * ||S||, and cap the rank at chi."""
    s2 = s * s
    total = torch.sqrt(s2.sum(-1))
    tail = torch.sqrt(torch.flip(torch.cumsum(torch.flip(s2, [-1]), -1), [-1]))
    keep = tail > (trunc_thr * total[..., None])
    idx = torch.arange(s.shape[-1], device=s.device)
    return keep & (idx < chi), total


def _truncation_mask_topk(s: torch.Tensor, total: torch.Tensor, chi: int, trunc_thr: float):
    """Keep mask from the top-chi singular values and the matrix's full
    Frobenius norm ``total``: discard value i when the tail (from i on,
    including the unseen remainder) is <= trunc_thr * total.

    The tail splits into the SEEN part (small-end cumsum of the known s^2:
    no cancellation) and the UNSEEN remainder max(total^2 - sum s^2 - noise,
    0) with a 16*eps*total^2 noise floor — the naive ``total^2 - head`` is
    catastrophic cancellation for rank-deficient matrices, which made
    keep/drop a rounding coin flip (JAX package, ops/mps.py:236-269)."""
    s2 = s * s
    seen_tail = torch.flip(torch.cumsum(torch.flip(s2, [-1]), -1), [-1])
    head_all = s2.sum(-1)
    t2 = total * total
    noise = (16.0 * torch.finfo(s.dtype).eps) * t2
    unseen = torch.clamp(t2 - head_all - noise, min=0.0)
    tail = torch.sqrt(seen_tail + unseen[..., None])
    return tail > (trunc_thr * total[..., None])


def _truncated_svd(m: torch.Tensor, chi: int, trunc_thr: float, impl: str):
    """Top-chi SVD + discarded-weight keep mask of ``m`` (..., 2chi, 2chi)
    (leading axes are batch) by ``impl``: "native" (``torch.linalg.svd``),
    "gram" (``svd_gram.svd_gram_top_k``),
    "jacobi" (the Jacobi-rows kernel on CUDA, its plain twin on CPU;
    matrices below 8 columns, the χ-growth heads, take the spec) or
    "unfused" (``rand_svd.rand_svd_top_k``).

    Returns (u (..., 2chi, chi), s (..., chi), vh (..., chi, 2chi),
    mask (..., chi) bool, total (...,) Frobenius norm of m)."""
    if impl == "native":
        u, s, vh = torch.linalg.svd(m, full_matrices=False)
        mask, total = _truncation_mask(s, chi, trunc_thr)
        return u[..., :, :chi], s[..., :chi], vh[..., :chi, :], mask[..., :chi], total
    if impl == "gram":
        u, s, vh = svd_gram_top_k(m, chi)
        total = torch.linalg.matrix_norm(m).to(s.dtype)
        return u, s, vh, _truncation_mask_topk(s, total, chi, trunc_thr), total
    if m.dtype == torch.complex64 and not truncation_supported(trunc_thr):
        warnings.warn(
            f"trunc_thr={trunc_thr:g} is finer than the f32 Jacobi convergence "
            f"tolerance resolves (supported: >= 1e-12, or <= f32-eps^2 to disable "
            f"truncation); keep/drop decisions near the boundary are unreliable",
            stacklevel=3,
        )
    sweeps = jacobi_sweeps() or DEFAULT_SWEEPS
    if impl == "unfused":
        u, s, vh = rand_svd.rand_svd_top_k(m, chi, sweeps)
    elif m.shape[-1] < 8:
        u, s, vh = jacobi_svd_top_k(m, chi, sweeps)
    else:
        u, s, vh = jacobi_svd_kernel_top_k(m, chi, sweeps)
    total = torch.linalg.matrix_norm(m).to(s.dtype)
    mask = _truncation_mask_topk(s, total, chi, trunc_thr)
    return u, s, vh, mask, total


def _pair_theta(lam_l, lam_c, lam_r, g1, g2, gate4, chi, dtype):
    """The gated two-site tensor as a (..., 2chi, 2chi) matrix — the input of
    the pair update's truncated SVD."""
    t1 = g1 * lam_l[..., None, :, None].to(dtype)
    t1 = t1 * lam_c[..., None, None, :].to(dtype)
    theta = torch.einsum("...sab,...tbc->...stac", t1, g2)
    theta = theta * lam_r[..., None, None, None, :].to(dtype)
    g = gate4.to(dtype)
    g = g.reshape(g.shape[:-2] + (2, 2, 2, 2)).expand(theta.shape[:-4] + (2, 2, 2, 2))
    theta = torch.einsum("...stuv,...uvac->...stac", g, theta)
    batch_shape = theta.shape[:-4]
    return theta.transpose(-3, -2).reshape(batch_shape + (2 * chi, 2 * chi))


def _fused_rand_eligible(chi: int, dtype) -> bool:
    """The shape guards of the fused rand pair update (the JAX package's
    ops/mps.py:446-465): complex64, chi % 8 == 0, and a matrix large enough
    for the projection to pay with a sketch width that is a multiple of 8
    (module attributes read at call time)."""
    return (
        chi >= 8
        and chi % 8 == 0
        and dtype == torch.complex64
        and 2 * chi >= rand_svd.RAND_MIN_N
        and rand_svd.rand_ell(2 * chi, chi) % 8 == 0
    )


def _rand_route_update(chi: int, dtype, dev) -> str:
    """What the "rand" route runs for a pair update at bond dimension
    ``chi`` on ``dev`` (the JAX package's ops/mps.py:327-347, 446-471):
    "fused" (ops/fused_rand.py) where :func:`config.fused_rand_enabled` says
    so and the shape guards hold; otherwise "jacobi" on CUDA (K1 on the
    square θ: on its accelerator the JAX package falls back to its Jacobi
    kernel, never to the unfused rand SVD with its known on-chip failure);
    otherwise "unfused" (``rand_svd.rand_svd_top_k``) from
    ``rand_svd.RAND_MIN_N`` on and "jacobi" below, as the JAX package
    decides off its accelerator."""
    dev = torch.device(dev)
    if fused_rand_enabled(chi, dev) and _fused_rand_eligible(chi, dtype):
        return "fused"
    if dev.type != "cuda" and 2 * chi >= rand_svd.RAND_MIN_N:
        return "unfused"
    return "jacobi"


def pair_thetas(mps: MPS, gates4: torch.Tensor, lo_sites: Tuple[int, ...]) -> torch.Tensor:
    """The (P, 2chi, 2chi) matrices :func:`apply_pairs_mps` decomposes for
    the disjoint pairs ``lo_sites`` (a probe utility; same gather)."""
    lo = torch.as_tensor(np.asarray(lo_sites, dtype=int), dtype=torch.long, device=mps.gammas.device)
    lam_ext = _lam_ext(mps)
    return _pair_theta(
        lam_ext[..., lo, :], lam_ext[..., lo + 1, :], lam_ext[..., lo + 2, :],
        mps.gammas[..., lo, :, :, :], mps.gammas[..., lo + 1, :, :, :],
        torch.as_tensor(gates4, device=mps.gammas.device), mps.chi, mps.gammas.dtype,
    )


def _pair_update(lam_l, lam_c, lam_r, g1, g2, gate4, chi, trunc_thr, dtype, rdtype):
    """Core Vidal pair update on raw tensors; returns (g1', g2', lam').
    Natively batched over identical leading axes: one call is one batched
    decomposition.  On the "jacobi" route complex64 updates with chi >= 8
    take the fused kernel K4 (ops/fused_pair.py) where
    ``config.fused_pair_enabled`` says so (the JAX package's
    ops/mps.py:428-444); on the "rand" route :func:`_rand_route_update`
    picks the fused randomized-projection update (ops/fused_rand.py), the
    unfused rand SVD or the "jacobi" decomposition."""
    impl = svd_impl(g1.device)
    if impl == "jacobi" and chi >= 8 and dtype == torch.complex64 and fused_pair_enabled(chi, g1.device):
        return fused_pair_update(
            lam_l, lam_c, lam_r, g1, g2, gate4, chi, trunc_thr, dtype, rdtype,
            jacobi_sweeps() or DEFAULT_SWEEPS,
        )
    if impl == "rand":
        impl = _rand_route_update(chi, dtype, g1.device)
        if impl == "fused":
            return fused_rand_pair_update(
                lam_l, lam_c, lam_r, g1, g2, gate4, chi, trunc_thr, dtype, rdtype,
                jacobi_sweeps() or DEFAULT_SWEEPS,
            )
    m = _pair_theta(lam_l, lam_c, lam_r, g1, g2, gate4, chi, dtype)
    batch_shape = m.shape[:-2]

    u, s, vh, mask, total = _truncated_svd(m, chi, trunc_thr, impl)

    s_kept = torch.where(mask, s, torch.zeros_like(s))
    kept_norm = torch.sqrt((s_kept * s_kept).sum(-1))
    # finfo.tiny: a literal like 1e-300 underflows to 0 in f32 (0/0 lambdas).
    floor = torch.finfo(s_kept.dtype).tiny
    s_kept = s_kept * (total / torch.clamp(kept_norm, min=floor))[..., None]
    new_lam = s_kept.to(rdtype)

    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    u = torch.where(mask[..., None, :], u, zero)
    vh = torch.where(mask[..., :, None], vh, zero)

    inv_l = _safe_inv(lam_l).to(dtype)
    inv_r = _safe_inv(lam_r).to(dtype)
    new_g1 = u.reshape(batch_shape + (2, chi, chi)) * inv_l[..., None, :, None]
    new_g2 = vh.reshape(batch_shape + (chi, 2, chi)).transpose(-3, -2)
    new_g2 = new_g2 * inv_r[..., None, None, :]
    return new_g1, new_g2, new_lam


def _lam_ext(mps: MPS) -> torch.Tensor:
    """λ with the trivial boundary bond on both ends: lam_ext[i + 1] = λ_i."""
    lam = mps.lambdas
    b = _boundary(mps.chi, lam.shape[:-2], lam.dtype, lam.device)
    return torch.cat([b, lam, b], dim=-2)


def apply_2q_mps(mps: MPS, gate4: torch.Tensor, site: int, *, trunc_thr: float = _NO_TRUNCATION_THR) -> MPS:
    """2-qubit gate on adjacent (site, site+1); ``gate4`` in (site, site+1)
    index order."""
    if not 0 <= site < mps.num_sites - 1:
        raise ValueError(f"site {site} has no right neighbour")
    return apply_pairs_mps(mps, gate4.unsqueeze(-3), (site,), trunc_thr=trunc_thr)


def apply_pairs_mps(
    mps: MPS,
    gates4: torch.Tensor,
    lo_sites: Tuple[int, ...],
    *,
    trunc_thr: float = _NO_TRUNCATION_THR,
) -> MPS:
    """Applies DISJOINT adjacent-pair gates simultaneously — one batched pair
    update (one batched SVD) for a whole chessboard half-layer.  ``gates4``:
    (..., P, 4, 4) in (site, site+1) order (leading lane axes broadcast
    with the MPS's); ``lo_sites``: the P pair positions.  Under
    :func:`set_pair_sharding` a group of more than one pair goes through
    ``parallel/mps_sharded.apply_pairs_mps_sharded``."""
    n, chi = mps.num_sites, mps.chi
    lo_np = np.asarray(lo_sites, dtype=int)
    if not (lo_np.size > 0 and np.all(np.diff(lo_np) >= 2)):
        raise ValueError(f"pairs must be disjoint and ascending: {lo_sites}")
    if lo_np.min() < 0 or lo_np.max() + 1 >= n:
        raise ValueError(f"pair positions out of range: {lo_sites}")
    if _PAIR_SHARDING is not None and lo_np.size > 1:
        from ..parallel.mps_sharded import apply_pairs_mps_sharded

        mesh, axis = _PAIR_SHARDING
        return apply_pairs_mps_sharded(mps, gates4, lo_sites, mesh, axis=axis, trunc_thr=trunc_thr)
    dev = mps.gammas.device
    lo = torch.as_tensor(lo_np, dtype=torch.long, device=dev)
    mps = broadcast_mps(mps, gates4.shape[:-3])
    lam_ext = _lam_ext(mps)
    new_g1, new_g2, new_lam = _pair_update(
        lam_ext[..., lo, :],
        lam_ext[..., lo + 1, :],
        lam_ext[..., lo + 2, :],
        mps.gammas[..., lo, :, :, :],
        mps.gammas[..., lo + 1, :, :, :],
        gates4,
        chi,
        trunc_thr,
        mps.gammas.dtype,
        mps.lambdas.dtype,
    )
    gammas = mps.gammas.clone()
    gammas[..., lo, :, :, :] = new_g1
    gammas[..., lo + 1, :, :, :] = new_g2
    lambdas = mps.lambdas.clone()
    lambdas[..., lo, :] = new_lam
    return MPS(gammas, lambdas)


def _swap_gate(dtype, device) -> torch.Tensor:
    sw = torch.zeros((4, 4), dtype=dtype, device=device)
    sw[0, 0] = sw[3, 3] = sw[1, 2] = sw[2, 1] = 1
    return sw


def apply_2q_any_mps(
    mps: MPS, gate4: torch.Tensor, lo: int, hi: int, *, trunc_thr: float = _NO_TRUNCATION_THR
) -> MPS:
    """2-qubit gate on an arbitrary site pair lo < hi (``gate4`` in (lo, hi)
    order): non-adjacent pairs route through a swap network."""
    if not 0 <= lo < hi < mps.num_sites:
        raise ValueError(f"bad site pair ({lo}, {hi})")
    if hi == lo + 1:
        return apply_2q_mps(mps, gate4, lo, trunc_thr=trunc_thr)
    sw = _swap_gate(mps.gammas.dtype, mps.gammas.device)
    for k in range(hi - 1, lo, -1):
        mps = apply_2q_mps(mps, sw, k, trunc_thr=trunc_thr)
    mps = apply_2q_mps(mps, gate4, lo, trunc_thr=trunc_thr)
    for k in range(lo + 1, hi):
        mps = apply_2q_mps(mps, sw, k, trunc_thr=trunc_thr)
    return mps


def apply_gate_mps(mps: MPS, gate, *, trunc_thr: float = _NO_TRUNCATION_THR) -> MPS:
    """Applies one :class:`Gate` record."""
    mat = gate_matrix(gate, mps.gammas.dtype, mps.gammas.device)
    if len(gate.qubits) == 1:
        return apply_1q_mps(mps, mat, gate.qubits[0])
    ctrl, targ = gate.qubits
    lo, hi = min(ctrl, targ), max(ctrl, targ)
    g = mat.reshape(2, 2, 2, 2)
    if ctrl > targ:  # (ctrl, targ) = (hi, lo) -> (lo, hi) order
        g = g.permute(1, 0, 3, 2)
    return apply_2q_any_mps(mps, g.reshape(4, 4), lo, hi, trunc_thr=trunc_thr)


def apply_program_mps(mps: MPS, program: GateProgram, *, trunc_thr: Optional[float] = None) -> MPS:
    """Applies a whole gate program, gate by gate (non-adjacent 2-qubit
    gates through the swap network)."""
    thr = _NO_TRUNCATION_THR if trunc_thr is None else float(trunc_thr)
    for gate in program:
        mps = apply_gate_mps(mps, gate, trunc_thr=thr)
    return mps


def mps_from_program(
    program: GateProgram,
    num_qubits: int,
    *,
    chi_max: int = 64,
    trunc_thr: Optional[float] = None,
    dtype=None,
    device=None,
) -> MPS:
    """``program @ |0...0>`` in MPS form."""
    return apply_program_mps(mps_zero(num_qubits, chi_max, dtype, device), program, trunc_thr=trunc_thr)


# -----------------------------------------------------------------------------
# Inner products / conversion.
# -----------------------------------------------------------------------------


def _folded_tensors(mps: MPS) -> torch.Tensor:
    """A_i = Γ_i diag(λ_i) for i < n-1, A_{n-1} = Γ_{n-1}; (..., n, 2, chi, chi)."""
    lam = mps.lambdas
    lam_ext = torch.cat([lam, _boundary(mps.chi, lam.shape[:-2], lam.dtype, lam.device)], dim=-2)
    return mps.gammas * lam_ext[..., :, None, None, :].to(mps.gammas.dtype)


def mps_dot(mps1: MPS, mps2: MPS) -> torch.Tensor:
    """``<mps1 | mps2>`` by transfer-matrix contraction, O(n chi^3); the two
    states may have different (padded) bond dimensions and leading axes
    that broadcast."""
    a1 = _folded_tensors(mps1)
    a2 = _folded_tensors(mps2)
    env = torch.zeros((mps1.chi, mps2.chi), dtype=a1.dtype, device=a1.device)
    env[0, 0] = 1.0
    a1c = a1.conj()
    for q in range(mps1.num_sites):
        env = torch.einsum("...sab,...aA,...sAB->...bB", a1c[..., q, :, :, :], env, a2[..., q, :, :, :])
    return env[..., 0, 0]


def mps_norm(mps: MPS) -> torch.Tensor:
    return torch.sqrt(mps_dot(mps, mps).real)


def mps_flip_amplitudes(mps: MPS, base_bits: Tuple[int, ...]) -> torch.Tensor:
    """Amplitudes of the base basis state and all its single-bit flips:
    ``amps[..., 0] = <base|mps>``, ``amps[..., 1 + q] = <base ^ (1 <<
    q)|mps>`` — one prefix/suffix sweep of bond vectors, O(n chi^2)."""
    n, chi = mps.num_sites, mps.chi
    if len(base_bits) != n:
        raise ValueError("base_bits needs one bit per site")
    a = _folded_tensors(mps)
    e0 = torch.zeros(chi, dtype=a.dtype, device=a.device)
    e0[0] = 1.0

    def site(q, bit):
        return a[..., q, bit, :, :]

    def vec_mat(v, mat):
        return torch.matmul(v.unsqueeze(-2), mat).squeeze(-2)

    def mat_vec(mat, v):
        return torch.matmul(mat, v.unsqueeze(-1)).squeeze(-1)

    pre = [e0]
    for q in range(n):
        pre.append(vec_mat(pre[-1], site(q, base_bits[q])))
    suffix_from = [None] * (n + 1)
    suffix_from[n] = e0
    for q in range(n - 1, -1, -1):
        suffix_from[q] = mat_vec(site(q, base_bits[q]), suffix_from[q + 1])
    amps = [pre[n][..., 0]]
    for q in range(n):
        amps.append((vec_mat(pre[q], site(q, 1 - base_bits[q])) * suffix_from[q + 1]).sum(-1))
    return torch.stack(amps, dim=-1)


def mps_to_vector(mps: MPS) -> torch.Tensor:
    """Dense state vector (exponential — tests only)."""
    a = _folded_tensors(mps)
    v = a[0][:, 0, :]  # (2, chi) — left boundary bond is 0
    for i in range(1, mps.num_sites):
        v = torch.einsum("...b,sbc->s...c", v, a[i])
    # Axes are (s_n, ..., s_1): C-order ravel is the little-endian index.
    return v[..., 0].reshape(-1)


def mps_from_dense(state, chi_max: int, dtype=None, device=None) -> MPS:
    """Exact MPS of a dense state (numpy or tensor) by successive SVDs on the
    host, singular values below 1e-14 dropped (a test utility)."""
    dtype = complex_dtype() if dtype is None else dtype
    device = default_device() if device is None else device
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu().numpy()
    state = np.asarray(state)
    n = int(round(np.log2(state.size)))
    if 2**n != state.size:
        raise ValueError(f"a state of {state.size} amplitudes is not one of qubits")
    gammas = np.zeros((n, 2, chi_max, chi_max), dtype=np.complex128)
    lambdas = np.zeros((max(n - 1, 0), chi_max))
    # Axes (s_1, ..., s_n): site 1 (the least significant bit) splits first.
    psi = state.reshape([2] * n).transpose(list(range(n - 1, -1, -1)))
    left_dim, prev_lam = 1, np.ones(1)
    mats = psi.reshape(2, -1)
    for i in range(n - 1):
        u, s, vh = np.linalg.svd(mats, full_matrices=False)
        k = min(chi_max, int(np.sum(s > 1e-14)))
        u, s, vh = u[:, :k], s[:k], vh[:k, :]
        inv = np.where(prev_lam > 1e-14, 1.0 / prev_lam, 0.0)
        gammas[i, :, :left_dim, :k] = u.reshape(2, left_dim, k) * inv[None, :, None]
        lambdas[i, :k] = s
        prev_lam, left_dim = s, k
        # (diag(s) vh) is (k, 2^(n-i-1)) with s_{i+1} slowest: bring the
        # next site's index in front of the bond.
        mats = (np.diag(s) @ vh).reshape(k, 2, -1).transpose(1, 0, 2).reshape(2 * k, -1)
    inv = np.where(prev_lam > 1e-14, 1.0 / prev_lam, 0.0)
    gammas[n - 1, :, :left_dim, 0] = mats.reshape(2, left_dim) * inv[None, :]
    return MPS(
        torch.as_tensor(gammas, device=device).to(dtype),
        torch.as_tensor(lambdas, device=device).to(real_of(dtype)),
    )


def rand_mps_vec(
    num_qubits: int,
    num_layers: int = 3,
    chi_max: int = 32,
    *,
    generator: Optional[torch.Generator] = None,
    entangler: Optional[str] = None,
    thetas=None,
    dtype=None,
    device=None,
) -> MPS:
    """Random low-entanglement MPS: a random-angle spin-layout ansatz of
    ``num_layers * (n - 1)`` blocks applied to |0...0>.  The entangler
    (cx, cz or cp) and the angles, uniform in (-π, π), come from
    ``generator`` (torch's default one when None) unless given; ``thetas`` (numpy or tensor) pins the angles,
    which is how a caller reproduces another program's draw."""
    from ..circuit.ansatz import Ansatz
    from ..circuit.export import ansatz_to_program
    from ..circuit.structures import create_ansatz_structure

    if entangler is None:
        entangler = ("cx", "cz", "cp")[int(torch.randint(3, (1,), generator=generator))]
    blocks = create_ansatz_structure(num_qubits, "spin", "full", num_layers * (num_qubits - 1))
    circ = Ansatz.make(num_qubits, entangler, blocks)
    if thetas is None:
        thetas = torch.pi * (2 * torch.rand(circ.num_thetas, generator=generator, dtype=torch.float64) - 1)
    if isinstance(thetas, torch.Tensor):
        thetas = thetas.detach().cpu().numpy()
    return mps_from_program(
        ansatz_to_program(circ, thetas), num_qubits, chi_max=chi_max, dtype=dtype, device=device
    )


# -----------------------------------------------------------------------------
# Ansatz application (fused blocks — one SVD per unit block or pair run).
# -----------------------------------------------------------------------------


def _gate_lo_hi(circ, g4: torch.Tensor, k: int):
    """Block k's gate ``(..., 4, 4)`` reordered into (lo, hi) site order;
    returns (gate, lo, hi)."""
    ctrl, targ = int(circ.blocks[0, k]), int(circ.blocks[1, k])
    lead = tuple(g4.shape[:-2])
    g = g4.reshape(lead + (2, 2, 2, 2))
    if ctrl > targ:
        g = g.transpose(-4, -3).transpose(-2, -1)
    return g.reshape(lead + (4, 4)), min(ctrl, targ), max(ctrl, targ)


def _plan_runs(circ, ks):
    """Splits a block-index sequence into maximal runs whose pairs are
    pairwise disjoint-or-identical (such runs commute freely)."""
    runs, current, pairs = [], [], set()
    for k in ks:
        lo = min(int(circ.blocks[0, k]), int(circ.blocks[1, k]))
        if current and any(abs(lo - p) == 1 for p in pairs):
            runs.append(current)
            current, pairs = [], set()
        current.append(k)
        pairs.add(lo)
    if current:
        runs.append(current)
    return runs


def _apply_run(circ, mps: MPS, ks, gate_of, thr: float) -> MPS:
    """Applies a run of adjacent-pair blocks: same-pair gates multiply into
    one 4x4, disjoint pairs batch into one pair update."""
    per_pair: dict = {}
    for k in ks:
        g, lo, _ = _gate_lo_hi(circ, gate_of(k), k)
        per_pair[lo] = g if lo not in per_pair else torch.matmul(g, per_pair[lo])
    los = tuple(sorted(per_pair))
    return apply_pairs_mps(mps, torch.stack([per_pair[lo] for lo in los], dim=-3), los, trunc_thr=thr)


def _front_layer(circ, mps: MPS, f1q: torch.Tensor) -> MPS:
    for q in range(circ.num_qubits):
        mps = apply_1q_mps(mps, f1q[..., q, :, :], q)
    return mps


def _layer_gates(circ, gates: torch.Tensor, layers: int) -> torch.Tensor:
    """The first ``layers * bpl`` block gates as (..., layers, bpl, 4, 4)."""
    lead = tuple(gates.shape[:-3])
    return gates[..., : layers * circ.bpl, :, :].reshape(lead + (layers, circ.bpl, 4, 4))


def v_dagger_layer_cache_eligible(circ) -> bool:
    """True when :func:`v_dagger_mul_mps_layers` supports ``circ`` (layered
    adjacent-pair Trotter structure)."""
    nb = circ.num_blocks
    bpl = circ.bpl if circ.is_trotterized else 0
    return (
        circ.is_trotterized
        and circ.circuit_power == 1
        and nb > 0
        and bpl > 0
        and nb % bpl == 0
        and nb // bpl >= 2
        and all(
            abs(int(circ.blocks[0, k]) - int(circ.blocks[1, k])) == 1
            and circ.blocks[0, k] == circ.blocks[0, k % bpl]
            and circ.blocks[1, k] == circ.blocks[1, k % bpl]
            for k in range(nb)
        )
    )


def v_mul_mps_growing(
    circ,
    thetas: torch.Tensor,
    bits: Tuple[int, ...],
    chi_max: int,
    *,
    trunc_thr: Optional[float] = None,
    dtype=None,
) -> MPS:
    """``V(Θ) @ |bits>`` with χ-growth scheduling: the head phases run at a
    growing static bond dimension χ_p = min(chi_max, 2^p) — exact, because
    χ_p covers the attainable rank, the discarded-weight rule is
    scale-relative and the rank cap binds only at chi_max — then the layers
    continue at full χ.  ``thetas`` may carry lane axes ``(..., P)``.
    Requires :func:`v_dagger_layer_cache_eligible`."""
    if not v_dagger_layer_cache_eligible(circ):
        raise ValueError("v_mul_mps_growing needs a layered adjacent-pair Trotter ansatz")
    dtype = complex_dtype() if dtype is None else dtype
    thr = _NO_TRUNCATION_THR if trunc_thr is None else float(trunc_thr)
    f1q = front_gates(circ, circ.subset1q(thetas), dtype, dagger=False)
    gates = block_gates(circ, circ.subset2q(thetas), dtype, dagger=False)
    nb, bpl = circ.num_blocks, circ.bpl
    layers = nb // bpl
    runs = _plan_runs(circ, range(bpl))
    half = circ.half_layer_num_blocks
    half_runs = _plan_runs(circ, range(half)) if half else []
    g_layers = _layer_gates(circ, gates, layers)

    mps = _front_layer(circ, mps_basis_state(tuple(int(b) for b in bits), 1, dtype, thetas.device), f1q)
    # Head: grow χ by x2 before each phase until chi_max, stopping at a
    # layer boundary.
    chi_cur, layer_start = 1, 0
    for j in range(layers):
        if chi_cur >= chi_max:
            break
        for run in runs:
            if chi_cur < chi_max:
                chi_cur = min(chi_max, 2 * chi_cur)
                mps = mps_resize(mps, chi_cur)
            mps = _apply_run(circ, mps, run, lambda k: g_layers[..., j, k, :, :], thr)
        layer_start = j + 1
    mps = mps_resize(mps, chi_max)
    for j in range(layer_start, layers):
        for run in runs:
            mps = _apply_run(circ, mps, run, lambda k: g_layers[..., j, k, :, :], thr)
    for run in half_runs:
        mps = _apply_run(circ, mps, run, lambda k: gates[..., k, :, :], thr)
    return mps


def v_dagger_mul_mps_layers(
    circ, thetas: torch.Tensor, mps: MPS, *, trunc_thr: Optional[float] = None
) -> Tuple[MPS, MPS]:
    """``V† @ mps`` plus the per-layer intermediate cache of the co-sweep
    gradient: ``cache[j]`` (leading axis) is the state entering gradient
    layer j (``V_{layers>j}† @ mps``), ``cache[L]`` the state entering the
    trailing 2nd-order half-layer.  With lane axes on ``thetas`` the cache
    is ``(layers + 1, ..., n, 2, chi, chi)``.  Requires
    :func:`v_dagger_layer_cache_eligible`."""
    if not v_dagger_layer_cache_eligible(circ):
        raise ValueError("v_dagger_mul_mps_layers needs a layered adjacent-pair Trotter ansatz")
    thr = _NO_TRUNCATION_THR if trunc_thr is None else float(trunc_thr)
    dtype = mps.gammas.dtype
    f1q = front_gates(circ, circ.subset1q(thetas), dtype, dagger=True)
    gates = block_gates(circ, circ.subset2q(thetas), dtype, dagger=True)
    nb, bpl = circ.num_blocks, circ.bpl
    half = circ.half_layer_num_blocks
    layers = nb // bpl

    out = mps
    if half:  # trailing half-layer first (V† order), saved as cache[L]
        for run in _plan_runs(circ, range(half - 1, -1, -1)):
            out = _apply_run(circ, out, run, lambda k: gates[..., k, :, :], thr)
    c_last = out

    g_layers = _layer_gates(circ, gates, layers)
    runs = _plan_runs(circ, range(bpl - 1, -1, -1))
    states = []  # states[i] = after i+1 daggered layers (from the last layer)
    for j in range(layers - 1, -1, -1):
        for run in runs:
            out = _apply_run(circ, out, run, lambda k: g_layers[..., j, k, :, :], thr)
        states.append(out)
    out = _front_layer(circ, out, f1q)

    ordered = [broadcast_mps(s, out.gammas.shape[:-4]) for s in states[::-1] + [c_last]]
    cache = MPS(
        torch.stack([s.gammas for s in ordered]), torch.stack([s.lambdas for s in ordered])
    )
    return out, cache


def _v_mul_mps_impl(circ, thetas, mps: MPS, dagger: bool, trunc_thr: Optional[float]) -> MPS:
    """``V(Θ) @ mps`` or ``V(Θ)† @ mps`` (the JAX package's
    ``_v_mul_mps_impl``, its ops/mps.py:1065): the front layer, the blocks
    (runs of disjoint pairs batched; non-adjacent blocks through the swap
    network), then the trailing 2nd-order half-layer — in reverse order for
    V† — ``circuit_power`` times."""
    thr = _NO_TRUNCATION_THR if trunc_thr is None else float(trunc_thr)
    dtype = mps.gammas.dtype
    f1q = front_gates(circ, circ.subset1q(thetas), dtype, dagger=dagger)
    gates = block_gates(circ, circ.subset2q(thetas), dtype, dagger=dagger)
    nb = circ.num_blocks
    half = circ.half_layer_num_blocks if circ.is_trotterized else 0
    all_adjacent = all(
        abs(int(circ.blocks[0, k]) - int(circ.blocks[1, k])) == 1 for k in range(nb)
    )

    def apply_seq(mps_, count):
        order = range(count - 1, -1, -1) if dagger else range(count)
        if not all_adjacent:
            for k in order:
                g, lo, hi = _gate_lo_hi(circ, gates[..., k, :, :], k)
                mps_ = apply_2q_any_mps(mps_, g, lo, hi, trunc_thr=thr)
            return mps_
        for run in _plan_runs(circ, order):
            mps_ = _apply_run(circ, mps_, run, lambda k: gates[..., k, :, :], thr)
        return mps_

    for _ in range(circ.circuit_power):
        if dagger:
            mps = apply_seq(mps, half)
            mps = apply_seq(mps, nb)
            mps = _front_layer(circ, mps, f1q)
        else:
            mps = _front_layer(circ, mps, f1q)
            mps = apply_seq(mps, nb)
            mps = apply_seq(mps, half)
    return mps


def v_mul_mps(circ, thetas, mps: MPS, *, trunc_thr: Optional[float] = None) -> MPS:
    """``V(Θ) @ mps``, each unit block one fused 4x4 pair update."""
    return _v_mul_mps_impl(circ, thetas, mps, False, trunc_thr)


def v_dagger_mul_mps(circ, thetas, mps: MPS, *, trunc_thr: Optional[float] = None) -> MPS:
    """``V(Θ)† @ mps``."""
    return _v_mul_mps_impl(circ, thetas, mps, True, trunc_thr)
