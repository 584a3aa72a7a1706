"""Parametric-circuit (ansatz) intermediate representation (twin of
``aqc_research_tpu/circuit/ansatz.py``; NumPy-only, carried over as is).

Immutable, hashable dataclasses: the circuit structure is static data for
the engines while the angle vector Θ is a tensor.

Parameter layout (identical to the reference, parametric_circuit.py:108-112):
``num_thetas = 3 * num_qubits + tpb * num_blocks`` with ``tpb = 5`` for the
"cp" entangler, else 4.  The first ``3n`` angles parameterize the front layer
of Rz·Ry·Rz rotations (3 per qubit), the rest parameterize 2-qubit unit
blocks.

Unit block (cf. parametric_circuit.py:30-35)::

    control ---*---|Ry(t0)|-|Rz(t1)|---
               |
    target  --|G|--|Ry(t2)|-|Rs(t3)|---      Rs = Rx if G=CX else Rz
                                             (t4 = CP angle when G=CP)
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Tuple, Union

import numpy as np

from .. import checking as chk

ENTANGLERS = ("cx", "cz", "cp")


def _blocks_to_tuple(blocks: np.ndarray) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    arr = np.asarray(blocks, dtype=int)
    return tuple(int(v) for v in arr[0]), tuple(int(v) for v in arr[1])


@dataclasses.dataclass(frozen=True)
class Ansatz:
    """Generic parametrized ansatz of 2-qubit unit blocks.

    Attributes:
        num_qubits: number of qubits, n >= 2.
        entangler: entangling gate of every unit block: "cx", "cz" or "cp".
        block_tuple: static block placement; two equal-length tuples
            (controls, targets) — the hashable twin of the reference's
            ``blocks`` array of shape (2, depth).
        name: optional circuit name.
        power: circuit repetition count V^power (experimental; must be 1).
    """

    num_qubits: int
    entangler: str
    block_tuple: Tuple[Tuple[int, ...], Tuple[int, ...]]
    name: str = ""
    power: int = 1

    def __post_init__(self):
        if self.entangler not in ENTANGLERS:
            raise ValueError(f"entangler must be one of {ENTANGLERS}")
        if not chk.is_int(self.power, self.power >= 1):
            raise ValueError("the circuit power p of V^p must be an integer >= 1")
        self.check_block_layout(self.num_qubits, self.blocks)

    # --- constructors ------------------------------------------------------

    @classmethod
    def make(
        cls,
        num_qubits: int,
        entangler: str,
        blocks: np.ndarray,
        name: str = "",
        power: int = 1,
    ) -> "Ansatz":
        """Builds an ansatz from a ``(2, depth)`` numpy block array (the
        reference constructor signature, parametric_circuit.py:37)."""
        return cls(int(num_qubits), entangler, _blocks_to_tuple(blocks), name, int(power))

    def with_blocks(self, blocks: np.ndarray) -> "Ansatz":
        """Functional twin of the reference's ``update_structure``."""
        return dataclasses.replace(self, block_tuple=_blocks_to_tuple(blocks))

    # --- structural properties --------------------------------------------

    @cached_property
    def blocks(self) -> np.ndarray:
        """Block placements as an int array of shape ``(2, depth)``."""
        return np.asarray(self.block_tuple, dtype=int).reshape(2, -1)

    @property
    def dimension(self) -> int:
        return int(2**self.num_qubits)

    @property
    def num_blocks(self) -> int:
        return len(self.block_tuple[0])

    @property
    def tpb(self) -> int:
        """Thetas per unit block: 5 for "cp", else 4."""
        return 5 if self.entangler == "cp" else 4

    @property
    def num_thetas(self) -> int:
        return 3 * self.num_qubits + self.tpb * self.num_blocks

    @property
    def circuit_power(self) -> int:
        return int(self.power)

    @property
    def is_trotterized(self) -> bool:
        return False

    @property
    def num_layers(self) -> int:
        raise NotImplementedError("a generic (non-Trotterized) ansatz has no layer grid")

    @property
    def bpl(self) -> int:
        raise NotImplementedError("a generic (non-Trotterized) ansatz has no layer grid")

    # --- theta views -------------------------------------------------------

    def subset1q(self, vec):
        """Front-layer angles reshaped ``(..., num_qubits, 3)`` (a view for
        numpy); leading axes of ``vec`` (lanes) are kept.

        Cf. reference parametric_circuit.py:143-164.
        """
        assert vec.shape[-1:] == (self.num_thetas,)
        return vec[..., 0 : 3 * self.num_qubits].reshape(tuple(vec.shape[:-1]) + (-1, 3))

    def subset2q(self, vec):
        """Block angles reshaped ``(..., num_blocks, tpb)`` (a view for
        numpy); leading axes of ``vec`` (lanes) are kept.

        Cf. reference parametric_circuit.py:166-187.
        """
        assert vec.shape[-1:] == (self.num_thetas,)
        return vec[..., 3 * self.num_qubits :].reshape(tuple(vec.shape[:-1]) + (-1, self.tpb))

    # --- structural mutation (functional) ----------------------------------

    def insert_unit_blocks(
        self,
        pos: int,
        extra_blocks: np.ndarray,
        thetas: Optional[np.ndarray] = None,
    ) -> Tuple["Ansatz", Optional[np.ndarray], Optional[np.ndarray]]:
        """Inserts unit blocks at block position ``pos``.

        Functional counterpart of reference parametric_circuit.py:189-232:
        returns ``(new_ansatz, new_thetas, new_idx)`` instead of mutating.
        ``new_thetas`` is ``thetas`` with zeros spliced in at the inserted
        block positions; ``new_idx`` are the indices of those zeros.
        """
        self.check_block_layout(self.num_qubits, np.asarray(extra_blocks, int))
        assert chk.is_int(pos, 0 <= pos <= self.num_blocks)

        new_blocks = np.insert(self.blocks, [pos], np.asarray(extra_blocks, int), axis=1)
        new_ansatz = self.with_blocks(new_blocks)

        new_thetas, new_idx = None, None
        if thetas is not None:
            thetas = np.asarray(thetas)
            assert thetas.size == self.num_thetas
            tpos = 3 * self.num_qubits + pos * self.tpb
            size = self.tpb * np.asarray(extra_blocks).shape[1]
            new_thetas = np.insert(thetas, [tpos], np.zeros(size, thetas.dtype))
            new_idx = np.arange(tpos, tpos + size, dtype=int)
            assert new_thetas.size == new_ansatz.num_thetas
        return new_ansatz, new_thetas, new_idx

    # --- validation ---------------------------------------------------------

    def check_block_layout(self, num_qubits: int, blocks: np.ndarray) -> None:
        """Raises ValueError unless a valid generic block layout was given
        (reference parametric_circuit.py:234-253)."""
        if not (chk.is_int(num_qubits) and num_qubits >= 2 and chk.block_structure(num_qubits, np.asarray(blocks, int))):
            raise ValueError("malformed unit-block structure (want a (2, depth) int array of qubit pairs)")


@dataclasses.dataclass(frozen=True)
class TrotterAnsatz(Ansatz):
    """Trotter-like ansatz of triple-block layers.

    Cf. reference parametric_circuit.py:267-423.  Every full layer contains
    ``n - 1`` triplets of CX unit blocks; the 2nd-order variant implies an
    *implicit* trailing half-layer that shares the leading half-layer's
    parameters (gradients of the two half-layers accumulate).
    """

    second_order: bool = False

    def __post_init__(self):
        if self.entangler != "cx":
            raise ValueError("TrotterAnsatz implies 'cx' entangler")
        super().__post_init__()

    @classmethod
    def make(
        cls,
        num_qubits: int,
        blocks: np.ndarray,
        second_order: bool,
        name: str = "",
    ) -> "TrotterAnsatz":
        return cls(
            int(num_qubits), "cx", _blocks_to_tuple(blocks), name, 1, bool(second_order)
        )

    @property
    def is_trotterized(self) -> bool:
        return True

    @property
    def is_second_order(self) -> bool:
        return bool(self.second_order)

    @property
    def half_layer_num_blocks(self) -> int:
        """Blocks in the implicit trailing half-layer (2nd order only)."""
        return int(3 * (self.num_qubits // 2)) if self.second_order else 0

    @property
    def num_layers(self) -> int:
        return self.num_blocks // self.bpl

    @property
    def bpl(self) -> int:
        """Blocks per full layer: 3 triplet-blocks per adjacent pair."""
        return 3 * (self.num_qubits - 1)

    def insert_unit_blocks(
        self,
        pos: int,
        extra_blocks: np.ndarray,
        thetas: Optional[np.ndarray] = None,
    ):
        """Layer-aligned insertion (reference parametric_circuit.py:349-389)."""
        assert chk.is_int(pos, 0 <= pos <= self.num_blocks)
        if pos % (3 * (self.num_qubits - 1)) != 0:
            raise ValueError("blocks can only be inserted at a layer boundary")
        return super().insert_unit_blocks(pos, extra_blocks, thetas)

    def check_block_layout(self, num_qubits: int, blocks: np.ndarray) -> None:
        """Triplet-layout validation (reference parametric_circuit.py:391-423):
        layers of triplets; 1st == 3rd block of a triplet; 2nd block flipped;
        blocks on adjacent qubits; 2nd-order leading half-layer connects pairs
        (0,1), (2,3), ..."""
        super().check_block_layout(num_qubits, blocks)
        blocks = np.asarray(blocks, int)
        num_blocks = blocks.shape[1]
        if num_blocks == 0:
            return
        bls = blocks.reshape((2, -1, 3))
        ok = (
            num_blocks % (3 * (num_qubits - 1)) == 0
            and np.all(bls[:, :, 0] == bls[:, :, 2])
            and np.all(bls[0, :, 0] == bls[1, :, 1])
            and np.all(bls[1, :, 0] == bls[0, :, 1])
            and np.all(bls[0, :, 0] == bls[1, :, 0] + 1)
        )
        if not ok:
            raise ValueError("the block sequence does not form Trotter triplets")
        if self.second_order:
            for i in range(num_qubits // 2):
                if not (bls[0, i, 1] == 2 * i and bls[1, i, 1] == 2 * i + 1):
                    raise ValueError("the leading half-layer does not match the even-pair chessboard")


# -----------------------------------------------------------------------------
# Layer-range helpers (reference parametric_circuit.py:426-466).
# -----------------------------------------------------------------------------


def layer_to_block_range(
    circ: Ansatz, layer_range: Union[Tuple[int, int], None]
) -> Tuple[int, int]:
    """Converts a layer range into the corresponding unit-block range."""
    assert isinstance(circ, Ansatz)
    if layer_range is None:
        return 0, circ.num_blocks
    assert chk.is_tuple(layer_range, len(layer_range) == 2)
    assert 0 <= layer_range[0] < layer_range[1] <= circ.num_layers
    block_range = (layer_range[0] * circ.bpl, layer_range[1] * circ.bpl)
    assert 0 <= block_range[0] < block_range[1] <= circ.num_blocks
    return block_range


def first_layer_included(
    circ: Ansatz, layer_range: Union[Tuple[int, int], None]
) -> bool:
    """True if layer 0 is inside ``layer_range`` (or range is None)."""
    assert isinstance(circ, Ansatz)
    if layer_range is None:
        return True
    assert chk.is_tuple(layer_range, len(layer_range) == 2)
    assert 0 <= layer_range[0] < layer_range[1] <= circ.num_layers
    return layer_range[0] == 0


# Reference class name (parametric_circuit.py:24): drop-in alias.
ParametricCircuit = Ansatz
