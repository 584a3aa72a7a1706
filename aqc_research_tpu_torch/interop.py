"""Carries the JAX package's state over to the port, as numpy arrays.

The JAX package cannot be imported here (its config turns on jax x64
globally), so the state crosses as plain data: a theta vector, an MPS's
``gammas (n, 2, chi, chi)`` and ``lambdas (n-1, chi)``, and the ansatz's
constructor arguments.  The parity tests feed both packages identical
inputs and targets through these functions.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .circuit.ansatz import Ansatz, TrotterAnsatz
from .config import complex_dtype, device as default_device, real_of, real_dtype
from .ops.mps import MPS


def thetas_to_torch(thetas, dtype=None, device=None) -> torch.Tensor:
    """A theta vector (numpy, or anything ``np.asarray`` takes) as a real
    tensor of the port's precision."""
    dtype = real_dtype() if dtype is None else dtype
    device = default_device() if device is None else device
    return torch.tensor(np.array(thetas), dtype=dtype, device=device)


def mps_to_torch(gammas, lambdas, dtype=None, device=None) -> MPS:
    """An MPS from numpy ``gammas (..., n, 2, chi, chi)`` and ``lambdas
    (..., n-1, chi)``."""
    dtype = complex_dtype() if dtype is None else dtype
    device = default_device() if device is None else device
    g = torch.tensor(np.array(gammas), device=device).to(dtype)
    lam = torch.tensor(np.array(lambdas), device=device).to(real_of(dtype))
    return MPS(g, lam)


def ansatz_args(circ: Any) -> Dict[str, Any]:
    """Constructor arguments of an ansatz of either package, read from its
    fields: ``num_qubits``, ``entangler``, ``block_tuple``, ``name``,
    ``power`` and, for a Trotter ansatz, ``second_order``."""
    args = {
        "num_qubits": int(circ.num_qubits),
        "entangler": str(circ.entangler),
        "block_tuple": tuple(tuple(int(v) for v in row) for row in circ.block_tuple),
        "name": str(circ.name),
        "power": int(circ.power),
    }
    if getattr(circ, "is_trotterized", False):
        args["second_order"] = bool(circ.second_order)
    return args


def ansatz_from_args(args: Dict[str, Any]) -> Ansatz:
    """The port's ansatz from :func:`ansatz_args`' dictionary."""
    if "second_order" in args:
        return TrotterAnsatz(
            args["num_qubits"], args["entangler"], args["block_tuple"], args["name"],
            args["power"], args["second_order"],
        )
    return Ansatz(
        args["num_qubits"], args["entangler"], args["block_tuple"], args["name"], args["power"]
    )
