"""Each pytest-xdist worker's share of the CPU.  At import, under xdist,
torch's intra-op pool and the BLAS/OpenMP pools of the libraries already
loaded (numpy's and SciPy's BLAS among them) are held to
``max(1, os.cpu_count() // workers)`` threads, ``workers`` being xdist's
PYTEST_XDIST_WORKER_COUNT: six workers that keep every pool at its default
spin several threads a core and finish far later than six with one thread
each on eight cores.  Outside xdist (a single run, the card tests under
``--noconftest``) nothing changes.  Every ``tests/test_torch_*.py`` imports
this module, so a run of any subset of them takes the rule."""

from __future__ import annotations

import os


def share(cpus: int | None, workers: str | None) -> int | None:
    """Threads of one worker among ``workers`` (xdist's worker count as its
    environment gives it; None outside xdist, which leaves the pools as they
    are) on ``cpus`` cores."""
    if workers is None:
        return None
    return max(1, (cpus or 1) // int(workers))


THREADS = share(os.cpu_count(), os.environ.get("PYTEST_XDIST_WORKER_COUNT"))

if THREADS is not None:
    import scipy.linalg  # noqa: F401  (loads SciPy's BLAS, so that the limit reaches it)
    import torch
    from threadpoolctl import threadpool_limits

    torch.set_num_threads(THREADS)
    threadpool_limits(THREADS)
