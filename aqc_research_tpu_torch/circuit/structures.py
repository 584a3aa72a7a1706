"""Generators of unit-block placement structures (twin of
``aqc_research_tpu/circuit/structures.py``; NumPy-only, carried over as is).
The produced ``(2, depth)`` arrays are static data for the engines.
"""

from __future__ import annotations

import logging
from logging import Logger
from typing import List, Optional

import numpy as np

from .. import checking as chk

_logger = logging.getLogger(__name__)


def lower_limit(num_qubits: int) -> int:
    """Lower bound on the number of unit blocks that guarantees exact
    compiling of an arbitrary unitary: ``ceil((4^n - 3n - 1) / 4)``.

    Cf. reference circuit_structures.py:31-43 and arXiv:2106.05649.
    """
    return int(round(np.ceil((4**num_qubits - 3 * num_qubits - 1) / 4.0)))


def circuit_layout_list() -> List[str]:
    return ["spin", "line", "cyclic_spin", "cyclic_line"]


def circuit_connectivity_list() -> List[str]:
    return ["full", "line"]


def create_ansatz_structure(
    num_qubits: int,
    layout: str = "spin",
    connectivity: str = "full",
    depth: int = 0,
    block_repeat: int = 1,
    logger: Optional[Logger] = None,
) -> np.ndarray:
    """Generates a ``(2, depth)`` unit-block placement array.

    Cf. reference circuit_structures.py:46-130.  Row 0 holds control-qubit
    indices, row 1 target indices.  ``depth <= 0`` selects the exact-compiling
    lower bound (exponential!).  ``block_repeat`` in 1..3 repeats each block
    on the same qubit pair.
    """
    if num_qubits < 2:
        raise ValueError("need at least 2 qubits to place unit blocks")

    if depth <= 0:
        depth = lower_limit(num_qubits)
        if logger:
            logger.warning(f"choosing the maximum number of 2-qubit unit blocks: {depth}")

    if not 1 <= block_repeat <= 3:
        raise ValueError(f"block_repeat is limited to 1..3, got {block_repeat}")

    if connectivity not in circuit_connectivity_list():
        raise ValueError(
            f"unknown connectivity {connectivity!r}; supported: "
            f"{circuit_connectivity_list()}"
        )

    if layout == "spin":
        blocks = _spin(num_qubits, depth)
    elif layout == "line":
        blocks = _line(num_qubits, depth)
    elif layout == "cyclic_spin":
        blocks = _cyclic_spin(num_qubits, depth)
    elif layout == "cyclic_line":
        blocks = _cyclic_line(num_qubits, depth)
    else:
        raise ValueError(
            f"circuit layout {layout!r} is not supported "
            f"(choose from {circuit_layout_list()})"
        )

    if block_repeat > 1:
        blocks = np.repeat(blocks, block_repeat, axis=1)

    if logger:
        logger.info(
            f"structure: layout={layout!r} x{block_repeat} repeats, "
            f"connectivity={connectivity!r}, {depth} unit blocks"
        )
    return blocks


def make_trotter_like_circuit(
    num_qubits: int,
    num_layers: int,
    *,
    connectivity: str = "full",
    verbose: bool = False,
) -> np.ndarray:
    """Trotter-like structure: spin layout with every block tripled and the
    middle block of each triplet flipped (control <-> target).

    Cf. reference circuit_structures.py:133-178.
    """
    if num_qubits < 2:
        raise ValueError("a Trotter-like structure needs at least 2 qubits")
    if connectivity not in circuit_connectivity_list():
        raise ValueError("expects 'full' or 'line' connectivity")
    if num_layers < 0:
        raise ValueError("the layer count cannot be negative")
    if num_layers == 0:
        return np.zeros((2, 0), dtype=int)
    if verbose:
        _logger.info("building a %d-layer Trotter-like block structure", num_layers)

    blocks = _spin(num_qubits, num_layers * (num_qubits - 1))
    blocks = np.repeat(blocks, 3, axis=1)
    # Swap control/target on the 1st and 3rd block of every triplet.
    bls = blocks.reshape((2, -1, 3))
    tmp = bls.copy()
    bls[0, :, [0, 2]] = tmp[1, :, [0, 2]]
    bls[1, :, [0, 2]] = tmp[0, :, [0, 2]]
    return bls.reshape((2, -1)).copy()


def num_blocks_per_layer(num_qubits: int, circuit_layout: str) -> int:
    """Blocks per layer for a layout (cf. reference circuit_structures.py:203-207)."""
    assert chk.is_int(num_qubits, num_qubits >= 2)
    assert circuit_layout in circuit_layout_list()
    return num_qubits if circuit_layout.startswith("cyclic_") else (num_qubits - 1)


def fraction_of_lower_bound(
    depth_fraction: float, num_qubits: int, circuit_layout: str
) -> int:
    """Number of layers at a fraction of the exact-compiling lower bound
    (cf. reference circuit_structures.py:210-251)."""
    assert chk.is_float(depth_fraction)
    if circuit_layout not in circuit_layout_list():
        raise ValueError(
            f"unknown circuit_layout {circuit_layout!r}; "
            f"choose from {circuit_layout_list()}"
        )
    if not 0 < depth_fraction <= 1:
        raise ValueError("depth_fraction must lie in (0, 1]")
    bpl = num_blocks_per_layer(num_qubits, circuit_layout)
    circuit_depth = int(round(depth_fraction * lower_limit(num_qubits)))
    return int(max(1, (circuit_depth + bpl - 1) // bpl))


# -----------------------------------------------------------------------------
# Layout kernels.  Each returns a (2, depth) int array of (top, bottom) qubit
# pairs; the arrays are a parity contract with reference
# circuit_structures.py:263-349 (bit-identical, pinned by tests), but the
# construction here is closed-form/vectorized rather than loop-emitted.
# -----------------------------------------------------------------------------


def _spin(num_qubits: int, depth: int) -> np.ndarray:
    """Chessboard bricks: one period is all even-anchored pairs followed by
    all odd-anchored pairs; ``np.resize`` tiles the period to ``depth``."""
    period = np.concatenate(
        [np.arange(0, num_qubits - 1, 2), np.arange(1, num_qubits - 1, 2)]
    )
    tops = np.resize(period, depth)
    return np.stack([tops, tops + 1]).astype(int)


def _line(num_qubits: int, depth: int) -> np.ndarray:
    """Open-chain staircase: pair anchors walk 0..n-2 and wrap without ever
    emitting the (last, first) link, i.e. anchor = i mod (n-1)."""
    tops = np.arange(depth) % (num_qubits - 1)
    return np.stack([tops, tops + 1]).astype(int)


def _cyclic_spin(num_qubits: int, depth: int) -> np.ndarray:
    """Chessboard bricks on a ring: for even n the anchor parity flips every
    n/2 blocks; odd n needs no flip (the stride-2 walk covers the ring)."""
    i = np.arange(depth)
    if num_qubits % 2 == 0:
        parity = (i // (num_qubits // 2)) % 2
    else:
        parity = np.zeros(depth, dtype=int)
    tops = (2 * i + parity) % num_qubits
    return np.stack([tops, (tops + 1) % num_qubits]).astype(int)


def _cyclic_line(num_qubits: int, depth: int) -> np.ndarray:
    """Closed-chain staircase: anchors walk the full ring, wrap-around
    (last, first) link included."""
    tops = np.arange(depth) % num_qubits
    return np.stack([tops, (tops + 1) % num_qubits]).astype(int)
