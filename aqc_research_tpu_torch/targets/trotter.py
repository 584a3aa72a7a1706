"""Trotterized time evolution of the XXZ spin chain (twin of
``aqc_research_tpu/targets/trotter.py``), dense and MPS form.

Hamiltonian (half-spin): ``H = -1/4 (Σ XX + Σ YY + delta Σ ZZ)`` over
adjacent pairs.  The elementary 8-gate Trotter block is folded into one 4x4
unitary, so a Trotter step is two chessboard half-layers: ``n - 1`` fused
4x4 applications on a dense state, batched pair updates on an MPS.  The
gate-program form is kept for interop.  The global phase is ignored, as in
the reference; ``trotter_global_phase`` returns it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import checking as chk
from ..circuit import gates as G
from ..circuit.ansatz import Ansatz, TrotterAnsatz, first_layer_included
from ..circuit.program import GateProgram, ProgramBuilder, program_to_state
from ..config import complex_dtype, device as default_device
from ..ops import mps as mpsop
from ..ops.statevector import apply_2q


# -----------------------------------------------------------------------------
# Hamiltonian and exact evolution (test oracles, on the host in numpy).
# -----------------------------------------------------------------------------


def make_hamiltonian(num_qubits: int, delta: float) -> np.ndarray:
    """Dense XXZ-chain Hamiltonian with half-spin matrices (numpy c128)."""
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
    sz = np.array([[1, 0], [0, -1]], dtype=np.complex128)

    def full(op, j):
        return np.kron(np.kron(np.eye(2**j), op), np.eye(2 ** (num_qubits - j - 1)))

    h = np.zeros((2**num_qubits, 2**num_qubits), dtype=np.complex128)
    for i in range(num_qubits - 1):
        h += full(sx, i) @ full(sx, i + 1)
        h += full(sy, i) @ full(sy, i + 1)
        h += delta * (full(sz, i) @ full(sz, i + 1))
    return -0.25 * h


def exact_evolution(
    hamiltonian: np.ndarray,
    ini_state: Union[GateProgram, np.ndarray],
    evol_time: float,
) -> np.ndarray:
    """``exp(-i t H) |ini>`` via scipy's dense matrix exponential on the
    host (testing only); a program ``ini_state`` is applied to |0...0> in
    c128 on the CPU."""
    from scipy.linalg import expm

    if not isinstance(ini_state, np.ndarray):
        n = int(round(np.log2(hamiltonian.shape[0])))
        ini_state = program_to_state(ini_state, n, torch.complex128, "cpu").numpy()
    e_h = expm((-1.0j * evol_time) * np.asarray(hamiltonian))
    return e_h @ np.asarray(ini_state)


def trotter_alphas(dt: float, delta: float) -> np.ndarray:
    """The 3 angular parameters of the elementary Trotter block."""
    assert chk.is_float(dt, dt > 0) and chk.is_float(delta, delta > 0)
    return np.asarray(
        [np.pi / 2 - 0.5 * delta * dt, 0.5 * dt - np.pi / 2, np.pi / 2 - 0.5 * dt]
    )


def trotter_global_phase(num_qubits: int, num_steps: int, second_order: bool) -> float:
    """Global phase dropped by the (phase-free) Trotter construction."""
    quarter_pi = 0.25 * np.pi
    phs = quarter_pi * (num_qubits - 1) * num_steps
    if second_order:
        if num_qubits % 2 == 0:
            return phs + quarter_pi * num_qubits
        return phs + quarter_pi * (num_qubits - 1)
    return phs


def _controlled_rev(gate2x2: torch.Tensor, dtype, device) -> torch.Tensor:
    """Controlled gate with control on the LOW qubit, in (hi, lo) order:
    ``I (x) |0><0| + G (x) |1><1|``."""
    return G.kron2(G.eye2(dtype, device), G.proj0(dtype, device)) + G.kron2(
        gate2x2.to(dtype), G.proj1(dtype, device)
    )


def trotter_block_4x4(params, dtype=None, device=None) -> torch.Tensor:
    """The elementary Trotter block folded into one 4x4 unitary in (hi=k+1,
    lo=k) index order: Rz(-pi/2)@hi · CX(hi->lo) · Rz(p0)@lo · Ry(p1)@hi ·
    CX(lo->hi) · Ry(p2)@hi · CX(hi->lo) · Rz(pi/2)@lo, composed right to left."""
    dtype = complex_dtype() if dtype is None else dtype
    p = np.asarray(params, np.float64)
    eye = G.eye2(dtype, device)
    cx_hi = G.controlled(G.x(dtype, device))  # control = hi, target = lo
    cx_lo = _controlled_rev(G.x(dtype, device), dtype, device)  # control = lo

    m = G.kron2(G.rz(-np.pi / 2, dtype, device), eye)
    m = torch.matmul(cx_hi, m)
    m = torch.matmul(G.kron2(eye, G.rz(p[0], dtype, device)), m)
    m = torch.matmul(G.kron2(G.ry(p[1], dtype, device), eye), m)
    m = torch.matmul(cx_lo, m)
    m = torch.matmul(G.kron2(G.ry(p[2], dtype, device), eye), m)
    m = torch.matmul(cx_hi, m)
    m = torch.matmul(G.kron2(eye, G.rz(np.pi / 2, dtype, device)), m)
    return m


def _apply_half_layer(state, block4, num_qubits, start: int, tail: int = 1):
    """Applies ``block4`` to pairs (k, k+1) for k = start, start+2, ..."""
    for k in range(start, num_qubits - 1, 2):
        state = apply_2q(state, block4, k + 1, k, tail)  # (ctrl=hi, targ=lo)
    return state


def trotter_evolve_state(
    state: torch.Tensor,
    num_qubits: int,
    num_steps: int,
    alphas,
    betas,
    second_order: bool,
) -> torch.Tensor:
    """Evolves a dense state by ``num_steps`` fused Trotter layers.

    1st order: each step = even half-layer (alphas) + odd half-layer (alphas).
    2nd order: the very first even half-layer and an appended trailing even
    half-layer use the dt/2 parameters ``betas``."""
    blk_a = trotter_block_4x4(alphas, state.dtype, state.device)
    blk_b = trotter_block_4x4(betas, state.dtype, state.device)
    if second_order:
        state = _apply_half_layer(state, blk_b, num_qubits, 0)
        state = _apply_half_layer(state, blk_a, num_qubits, 1)
        for _ in range(num_steps - 1):
            state = _apply_half_layer(state, blk_a, num_qubits, 0)
            state = _apply_half_layer(state, blk_a, num_qubits, 1)
        return _apply_half_layer(state, blk_b, num_qubits, 0)
    for _ in range(num_steps):
        state = _apply_half_layer(state, blk_a, num_qubits, 0)
        state = _apply_half_layer(state, blk_a, num_qubits, 1)
    return state


def _block_4x4_lo_hi(params, dtype, device) -> torch.Tensor:
    """The elementary block in (lo, hi) order (the MPS pair convention)."""
    g = trotter_block_4x4(params, dtype, device).reshape(2, 2, 2, 2)
    return g.permute(1, 0, 3, 2).reshape(4, 4)


def trotter_evolve_mps(
    mps: mpsop.MPS,
    num_qubits: int,
    num_steps: int,
    alphas,
    betas,
    second_order: bool,
    trunc_thr: float,
) -> mpsop.MPS:
    """MPS Trotter evolution with fused elementary blocks: one truncated pair
    update per block, one batched decomposition per half-layer.  2nd order:
    the first even half-layer and an appended trailing even half-layer use
    the dt/2 parameters ``betas``."""
    dtype, device = mps.gammas.dtype, mps.gammas.device
    blk_a = _block_4x4_lo_hi(alphas, dtype, device)
    blk_b = _block_4x4_lo_hi(betas, dtype, device)

    def half_layer(m, blk, start):
        los = tuple(range(start, num_qubits - 1, 2))
        return mpsop.apply_pairs_mps(m, blk.expand(len(los), 4, 4), los, trunc_thr=trunc_thr)

    if second_order:
        mps = half_layer(mps, blk_b, 0)
        mps = half_layer(mps, blk_a, 1)
        for _ in range(num_steps - 1):
            mps = half_layer(mps, blk_a, 0)
            mps = half_layer(mps, blk_a, 1)
        return half_layer(mps, blk_b, 0)
    for _ in range(num_steps):
        mps = half_layer(mps, blk_a, 0)
        mps = half_layer(mps, blk_a, 1)
    return mps


def trotter_program(
    qb: ProgramBuilder,
    *,
    dt: float,
    delta: float,
    num_trotter_steps: int,
    second_order: bool,
) -> GateProgram:
    """Appends a 1st/2nd-order Trotter circuit to a program builder."""
    assert chk.is_int(num_trotter_steps, num_trotter_steps > 0)
    alphas = trotter_alphas(dt, delta)
    betas = trotter_alphas(dt * 0.5, delta)

    def block(k: int, params):
        qb.rz(-np.pi / 2, k + 1)
        qb.cx(k + 1, k)
        qb.rz(params[0], k)
        qb.ry(params[1], k + 1)
        qb.cx(k, k + 1)
        qb.ry(params[2], k + 1)
        qb.cx(k + 1, k)
        qb.rz(np.pi / 2, k)

    n = qb.num_qubits
    for j in range(num_trotter_steps):
        for q in range(0, n - 1, 2):
            block(q, betas if second_order and j == 0 else alphas)
        for q in range(1, n - 1, 2):
            block(q, alphas)
    if second_order:
        for q in range(0, n - 1, 2):
            block(q, betas)
    return qb.build()


def identity_circuit(num_qubits: int) -> GateProgram:
    """The empty program (|0...0> preparation)."""
    assert chk.is_int(num_qubits, num_qubits >= 2)
    return ProgramBuilder(num_qubits).build()


def neel_init_state(num_qubits: int) -> GateProgram:
    """Neel state |...101010> — X on every even qubit."""
    assert chk.is_int(num_qubits, num_qubits >= 2)
    qb = ProgramBuilder(num_qubits)
    for k in range(0, num_qubits, 2):
        qb.x(k)
    return qb.build()


def half_zero_circuit(num_qubits: int) -> GateProgram:
    """|1...1 0...0> — X on the upper half of the qubits."""
    assert chk.is_int(num_qubits, num_qubits >= 2)
    qb = ProgramBuilder(num_qubits)
    for k in range(num_qubits // 2, num_qubits):
        qb.x(k)
    return qb.build()


class Trotter:
    """Trotter evolution of quantum states; one "Trotter step" is a full
    layer of elementary blocks over all adjacent pairs (plus the trailing
    half-layer for 2nd order)."""

    def __init__(
        self,
        *,
        num_qubits: int,
        evol_time: float,
        num_steps: int,
        delta: float = 1.0,
        second_order: bool,
    ):
        assert chk.is_int(num_qubits, num_qubits >= 2)
        assert chk.is_float(evol_time, evol_time > 0)
        assert chk.is_int(num_steps, num_steps >= 1)
        assert chk.is_float(delta, delta > 0)
        self._num_qubits = num_qubits
        self._evol_time = float(evol_time)
        self._num_steps = int(num_steps)
        self._delta = float(delta)
        self._dt = evol_time / float(num_steps)
        self._second_order = bool(second_order)

    @property
    def evol_time(self) -> float:
        return self._evol_time

    @property
    def time_step(self) -> float:
        return self._dt

    @property
    def num_trotter_steps(self) -> int:
        return self._num_steps

    def as_vector(self, ini_state, *, dtype=None, device=None) -> torch.Tensor:
        """Dense-vector Trotter evolution via fused 4x4 blocks.  A program
        ``ini_state`` is applied to |0...0> in ``dtype`` on ``device``
        (default: the precision in effect, the default device); a tensor or
        numpy vector is evolved in its own dtype (numpy: on ``device``)."""
        if isinstance(ini_state, torch.Tensor):
            state = ini_state
        elif isinstance(ini_state, np.ndarray):
            state = torch.as_tensor(ini_state, device=default_device() if device is None else device)
        else:
            state = program_to_state(ini_state, self._num_qubits, dtype, device)
        return trotter_evolve_state(
            state,
            self._num_qubits,
            self._num_steps,
            trotter_alphas(self._dt, self._delta),
            trotter_alphas(self._dt * 0.5, self._delta),
            self._second_order,
        )

    def as_program(self, ini_state: Optional[GateProgram] = None) -> GateProgram:
        """Gate-program form of the evolution, after ``ini_state``."""
        qb = ProgramBuilder(self._num_qubits)
        if ini_state:
            qb.extend(ini_state)
        return trotter_program(
            qb,
            dt=self._dt,
            delta=self._delta,
            num_trotter_steps=self._num_steps,
            second_order=self._second_order,
        )

    def as_mps(
        self,
        ini_state,
        trunc_thr: Optional[float] = None,
        chi_max: int = 64,
        *,
        dtype=None,
        device=None,
    ) -> mpsop.MPS:
        """MPS-form Trotter evolution of ``ini_state`` (an MPS, or a gate
        program applied to |0...0>)."""
        thr = mpsop.no_truncation_threshold() if trunc_thr is None else float(trunc_thr)
        if isinstance(ini_state, mpsop.MPS):
            mps = ini_state
        else:
            mps = mpsop.mps_from_program(
                ini_state, self._num_qubits, chi_max=chi_max, trunc_thr=thr,
                dtype=dtype, device=device,
            )
        return trotter_evolve_mps(
            mps,
            self._num_qubits,
            self._num_steps,
            trotter_alphas(self._dt, self._delta),
            trotter_alphas(self._dt * 0.5, self._delta),
            self._second_order,
            thr,
        )


def _host_vector(state) -> np.ndarray:
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    return np.asarray(state)


def fidelity(state1, state2) -> float:
    """``|<s1|s2>|^2`` of two MPS states, or of two dense vectors (tensors
    or numpy, taken to the host in their own precision)."""
    if isinstance(state1, mpsop.MPS) or isinstance(state2, mpsop.MPS):
        return float(mpsop.mps_dot(state1, state2).abs() ** 2)
    return float(np.abs(np.vdot(_host_vector(state1), _host_vector(state2))) ** 2)


def state_difference(state1, state2) -> float:
    """``||s1 - s2||`` of two dense vectors — phase-sensitive distance."""
    return float(np.linalg.norm(_host_vector(state1) - _host_vector(state2)))


def slice2q(
    circ: Ansatz, vec: np.ndarray, *, layer_range: Optional[Tuple[int, int]] = None
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """View of Θ entries as (layers, n-1 triplets, 12 angles) for the
    selected layer range."""
    if not isinstance(circ, TrotterAnsatz):
        raise ValueError("the perfect init applies to a Trotterized ansatz only")
    assert isinstance(vec, np.ndarray) and vec.shape == (circ.num_thetas,)
    num_layers = circ.num_layers
    layer_range = (0, num_layers) if layer_range is None else layer_range
    assert 0 <= layer_range[0] < layer_range[1] <= num_layers
    vec2q = circ.subset2q(vec).reshape((num_layers, circ.num_qubits - 1, 12))
    return vec2q[layer_range[0] : layer_range[1]], layer_range


def init_ansatz_to_trotter(
    circ: Ansatz,
    thetas: np.ndarray,
    *,
    evol_time: float,
    delta: float,
    layer_range: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Sets Θ (within ``layer_range``) so the ansatz reproduces the Trotter
    circuit — the 'perfect' initial guess.  Only 3 angles per triplet are
    nonzero (indices 5, 0, 6 take the block alphas; the 2nd-order leading
    half-layer takes dt/2 alphas).  Modifies and returns the numpy
    ``thetas`` in place."""
    th2q, layer_range = slice2q(circ, thetas, layer_range=layer_range)
    delta_t = evol_time / float(layer_range[1] - layer_range[0])
    alphas = trotter_alphas(dt=delta_t, delta=delta)
    layer_0 = first_layer_included(circ, layer_range)
    if layer_0:
        circ.subset1q(thetas).fill(0)
    th2q.fill(0)
    th2q[:, :, 5] = alphas[0]
    th2q[:, :, 0] = alphas[1]
    th2q[:, :, 6] = alphas[2]
    if circ.is_second_order and layer_0:
        alphas = trotter_alphas(dt=delta_t * 0.5, delta=delta)
        half = circ.half_layer_num_blocks // 3
        assert 3 * half == circ.half_layer_num_blocks
        th2q[0, 0:half, 5] = alphas[0]
        th2q[0, 0:half, 0] = alphas[1]
        th2q[0, 0:half, 6] = alphas[2]
    return thetas


def trotter_circuit(
    num_qubits: int,
    *,
    dt: float,
    delta: float,
    num_trotter_steps: int,
    second_order: bool,
    ini_state: Optional[GateProgram] = None,
) -> GateProgram:
    """Trotter evolution as a gate program (``ini_state`` prepended)."""
    return Trotter(
        num_qubits=num_qubits,
        evol_time=float(dt) * int(num_trotter_steps),
        num_steps=int(num_trotter_steps),
        delta=float(delta),
        second_order=bool(second_order),
    ).as_program(ini_state)
