"""A pool of Gloo worker processes for the port's multi-rank tests on the
CPU: ``world`` processes (``spawn``) join one process group through a
``FileStore`` in a directory the caller owns (no port, so parallel test
workers never race), then run the functions they are sent, each rank the
same call, and send back what they return (numpy or plain Python).

Workers import torch and the port only, pin the port to the CPU and run one
thread each.  A rank that raises sends its traceback; :meth:`GlooPool.run`
raises it.  A collective that waits longer than ``timeout_s`` fails on its
own, so a rank that dies cannot hang the others for longer than that."""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import queue
import traceback
from typing import Any, List


def _worker(rank: int, world: int, store_path: str, timeout_s: float, tasks, results) -> None:
    os.environ["AQC_TORCH_DEVICE"] = "cpu"
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            name, args = item
            try:
                module, fn = name.split(":")
                results.put((rank, True, getattr(importlib.import_module(module), fn)(*args)))
            except Exception:  # the test reads the traceback
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class GlooPool:
    def __init__(self, world: int, directory: str, timeout_s: float = 90.0):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        store = os.path.join(str(directory), f"gloo_store_{world}")
        self.procs = [
            ctx.Process(target=_worker, args=(r, world, store, timeout_s, self.tasks[r], self.results), daemon=True)
            for r in range(world)
        ]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args: Any) -> List[Any]:
        """Runs ``module:function(*args)`` on every rank; returns the
        results in rank order."""
        for q in self.tasks:
            q.put((name, args))
        out: List[Any] = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, val = self.results.get(timeout=2 * self.timeout_s)
            except queue.Empty:
                raise RuntimeError(f"{name}: a rank sent nothing within {2 * self.timeout_s} s") from None
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors:
            raise RuntimeError(f"{name} failed on {len(errors)} rank(s):\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)


def _env_rank(env: dict, name: str, results) -> None:
    os.environ.update(env)
    try:
        module, fn = name.split(":")
        results.put((int(env["RANK"]), True, getattr(importlib.import_module(module), fn)()))
    except Exception:  # the test reads the traceback
        results.put((int(env.get("RANK", -1)), False, traceback.format_exc()))


def run_from_env(name: str, envs: List[dict], timeout_s: float = 90.0) -> List[Any]:
    """Starts one process per environment in ``envs`` (a rank each: the
    process's environment is updated with it before anything is imported),
    runs ``module:function()`` there and returns the results in rank order."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_env_rank, args=(env, name, results), daemon=True) for env in envs]
    for p in procs:
        p.start()
    out: List[Any] = [None] * len(envs)
    errors = []
    try:
        for _ in envs:
            rank, ok, val = results.get(timeout=timeout_s)
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    if errors:
        raise RuntimeError(f"{name} failed on {len(errors)} rank(s):\n" + "\n".join(errors))
    return out


def assert_bitwise_same(results: List[dict], key: str) -> None:
    """The replication invariant: every rank returned the same bits."""
    import numpy as np

    first = np.asarray(results[0][key])
    for r in results[1:]:
        assert np.array_equal(np.asarray(r[key]), first, equal_nan=True), f"{key} differs across ranks"
