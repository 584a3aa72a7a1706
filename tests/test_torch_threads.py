"""The test workers' share of the CPU (tests/_torch_threads.py): the rule
max(1, cores // workers) under pytest-xdist, nothing outside it, and this
process's pools as the rule leaves them."""

import os

import pytest
import torch
from threadpoolctl import threadpool_info

from tests import _torch_threads


@pytest.mark.parametrize("cpus,workers,want", [(8, "6", 1), (64, "6", 10), (8, "1", 8), (1, "6", 1), (8, None, None)])
def test_share_is_the_cores_over_the_workers(cpus, workers, want):
    assert _torch_threads.share(cpus, workers) == want


def test_this_process_runs_its_share():
    """Under xdist torch and the BLAS pools (numpy's and SciPy's) run the
    worker's share; outside it the module has touched nothing."""
    threads = _torch_threads.share(os.cpu_count(), os.environ.get("PYTEST_XDIST_WORKER_COUNT"))
    assert _torch_threads.THREADS == threads
    if threads is not None:
        assert torch.get_num_threads() == threads
        assert all(pool["num_threads"] <= threads for pool in threadpool_info() if pool["user_api"] == "blas")
