"""aqc_research_tpu_torch — the PyTorch/CUDA port of ``aqc_research_tpu``.

The JAX package stays the reference; this package mirrors its module names
so each module's twin is easy to find, and imports ``torch`` only (never
``jax``):

* ``circuit``  — parametric-ansatz IR, gate builders, gate programs
* ``ops``      — the MPS engine, its analytic co-sweep gradient, the one-sided
                 Jacobi SVD (hand-written CUDA kernel + plain-torch twin)
* ``optim``    — compact L-BFGS (two-loop recursion + Armijo backtracking)
* ``targets``  — Trotter evolution of the XXZ chain in MPS form
* ``models``   — the ASP horizon runner over the MPS objective
* ``interop``  — carries the JAX package's state (as numpy arrays) over
"""

__version__ = "0.1.0"

from . import config  # noqa: F401  (sets the f32 matmul policy)
