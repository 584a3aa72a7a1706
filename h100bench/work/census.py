"""The work of one evaluation of the ASP objective, counted from the
circuit's shape alone, and the H100's published peaks.

:func:`decomposition_census` is a frozen copy of the program's
``ops/roofline.decomposition_census`` for the layered Trotter ansatz: the
batched pair updates of one value sweep (the forward sweep from the product
state, whose bond dimension doubles per half-layer from 1 up to chi) and of
one objective+gradient sweep (the ``V^dagger`` sweep at full chi, then the
forward sweep of the gradient, growing as the value's).  Each entry is
``(batch, n)``: ``batch`` pair updates of ``n x n`` matrices, ``n = 2 chi'``.

Each pair update is charged the same work whatever computes it
(:func:`pair_flops`, :func:`pair_bytes`): the two-site tensor and its gate,
a dense SVD of the ``n x n`` complex matrix with both factors, and the
recovery of the right factor; the bytes read the two site tensors, three
bond vectors and the gate once and write the two new site tensors and bond
once, in complex64 / float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# float32 outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67.0e12
PEAK_HBM_BYTES = 3.35e12

COMPLEX_BYTES = 8  # complex64
REAL_BYTES = 4     # float32


def chessboard_groups(num_qubits: int) -> List[List[int]]:
    """The lower qubits of one layer's two half-layers of disjoint pairs."""
    return [list(range(0, num_qubits - 1, 2)), list(range(1, num_qubits - 1, 2))]


def decomposition_census(num_qubits: int, num_layers: int, chi: int, second_order: bool,
                         grow: bool = True) -> Dict[str, List[Tuple[int, int]]]:
    """``{"vdag": ..., "grad": ..., "value": ...}``: lists of (batch, n)."""
    sizes = [len(g) for g in chessboard_groups(num_qubits)]
    half = [sizes[0]] if second_order else []
    vdag = [(b, 2 * chi) for b in half + list(reversed(sizes)) * num_layers]

    def growing(batches):
        out, chi_w = [], 1
        for b in batches:
            chi_w = min(chi, 2 * chi_w) if grow else chi
            out.append((b, 2 * chi_w))
        return out

    fwd = sizes * num_layers + half
    return {"vdag": vdag, "grad": growing(fwd), "value": growing(fwd)}


def pair_flops(n: int) -> float:
    """Real floating-point operations of one pair update of an n x n matrix
    (chi' = n / 2; one complex multiply-add is 8 operations):
    two-site tensor 4 chi'^3 and gate 16 chi'^2 multiply-adds, a dense SVD
    with both factors (Golub-Reinsch, 21 n^3 real operations, times 4 for
    complex arithmetic), the right factor's recovery 4 chi'^3 multiply-adds."""
    c = n // 2
    return 8.0 * (4 * c**3 + 16 * c**2) + 84.0 * n**3 + 8.0 * 4 * c**3


def pair_bytes(n: int) -> float:
    """Bytes one pair update must move: two site tensors (2 x chi' x chi'
    each) and three bond vectors read, the 4 x 4 gate read, two site
    tensors and one bond vector written."""
    c = n // 2
    site = 2 * c * c * COMPLEX_BYTES
    return 2 * site + 3 * c * REAL_BYTES + 16 * COMPLEX_BYTES + 2 * site + c * REAL_BYTES


def evaluation_work(census: Dict[str, List[Tuple[int, int]]]) -> Dict[str, Tuple[float, float]]:
    """(flops, bytes) of one value and of one objective+gradient evaluation."""
    def total(stages):
        phases = [p for s in stages for p in census[s]]
        return (sum(b * pair_flops(n) for b, n in phases), sum(b * pair_bytes(n) for b, n in phases))

    return {"value": total(["value"]), "obj_grad": total(["vdag", "grad"])}
