"""aqc_research_tpu_torch — the PyTorch/CUDA port of ``aqc_research_tpu``.

The JAX package stays the reference; this package mirrors its module names
so each module's twin is easy to find, and imports ``torch`` only (never
``jax``):

* ``circuit``  — parametric-ansatz IR, gate builders, gate programs
* ``ops``      — the statevector and MPS engines, their analytic co-sweep
                 gradients, the hand-written CUDA kernels and their
                 plain-torch twins, coordinate descent
* ``optim``    — L-BFGS (compact, and optax's with the zoom linesearch) and
                 Adam, one lane or a fleet of lanes; the host protocol
* ``targets``  — Trotter evolution of the XXZ chain, target generators
* ``models``   — the ASP horizons and driver, the AQC sketching drivers
* ``parallel`` — multi-start fleets and the job executor
* ``interop``  — carries the JAX package's state (as numpy arrays) over
"""

__version__ = "0.1.0"

from . import config  # noqa: F401  (sets the f32 matmul policy)
