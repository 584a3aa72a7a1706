"""Multi-start job executor (twin of ``aqc_research_tpu/parallel/executor.py``).

Restarts that a fleet cannot take (each drives its own host loop) run in
this process: serially by default (the card serializes the device work
anyway), or in a thread pool for host-bound jobs.  The device-parallel
multi-start path is the lane fleet (parallel/multistart.py).

Per-job seeding keeps the reference's reproducibility contract:
``np.random.seed(seed + 7 * (job_index + 1))``.  With a cache directory,
completed jobs persist and a re-run with the same seed and config reuses
them.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import checking as chk


def _job_cache_path(cache_dir: str, job_index: int) -> str:
    return os.path.join(cache_dir, f"job_{job_index:04d}.pkl")


def config_fingerprint(config: Dict) -> str:
    """Digest of a job config: every key plus a content digest of each value
    (ndarrays by bytes+shape+dtype, scalars/strings by repr, callables by
    qualified name).  Cached job results are keyed by this, so re-running
    with the same seed and cache dir but CHANGED parameters — a different
    target matrix, maxiter, layer count — recomputes instead of reusing
    results computed for another problem."""
    import hashlib

    h = hashlib.sha256()
    for key in sorted(config):
        h.update(str(key).encode())
        val = config[key]
        if isinstance(val, np.ndarray):
            h.update(str(val.shape).encode())
            h.update(str(val.dtype).encode())
            h.update(np.ascontiguousarray(val).tobytes())
        elif callable(val):
            h.update(getattr(val, "__qualname__", repr(val)).encode())
        else:
            h.update(repr(val).encode())
    return h.hexdigest()[:20]


def _load_cached_job(
    cache_dir: str, job_index: int, job_seed: int, fingerprint: str
) -> Optional[Dict]:
    """A cached result is reused only when it completed successfully under
    the SAME derived seed AND the same config fingerprint — a resume with a
    different base seed or changed parameters recomputes."""
    path = _job_cache_path(cache_dir, job_index)
    if not os.path.isfile(path):
        return None
    try:
        with open(path, "rb") as fld:
            result = pickle.load(fld)
    except Exception:  # noqa: BLE001 — a torn write means recompute
        return None
    if (
        isinstance(result, dict)
        and str(result.get("status", "")).startswith("ok")
        and result.get("seed") == job_seed
        and result.get("config_fingerprint") == fingerprint
    ):
        result["cached"] = True
        return result
    return None


def _save_cached_job(cache_dir: str, job_index: int, result: Dict) -> None:
    """Atomic write (tmp + rename): a crash mid-dump never leaves a torn
    cache entry for the next resume to trip over."""
    path = _job_cache_path(cache_dir, job_index)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fld:
        pickle.dump(result, fld)
    os.replace(tmp, path)


def _job_wrapper(
    job_index: int,
    config: Dict,
    seed: int,
    job_function: Callable[[int, Dict], Dict],
    cache_dir: Optional[str] = None,
) -> Dict:
    """Runs one job with per-job seeding and exception capture into 'status'.
    With ``cache_dir``, completed jobs are persisted and reused on re-run."""
    job_seed = seed + 7 * (job_index + 1)
    fingerprint = config_fingerprint(config) if cache_dir is not None else ""
    if cache_dir is not None:
        cached = _load_cached_job(cache_dir, job_index, job_seed, fingerprint)
        if cached is not None:
            return cached
    try:
        np.random.seed(job_seed)
        tic = perf_counter()
        result = job_function(job_index, config)
        result.update(
            {
                "time": perf_counter() - tic,
                "status": "ok",
                "job_index": job_index,
                "seed": job_seed,
            }
        )
        if cache_dir is not None:
            result["config_fingerprint"] = fingerprint
            _save_cached_job(cache_dir, job_index, result)
    except Exception:  # noqa: BLE001 — captured into the result status
        print(f"exception in job={job_index}\n", flush=True)
        result = {
            "time": -1.0,
            "status": traceback.format_exc(),
            "job_index": job_index,
            "seed": job_seed,
        }
    return result


def run_jobs(
    configs: List[Dict],
    seed: int,
    job_function: Callable[[int, Dict], Dict],
    *,
    tolerate_failure: bool = False,
    num_jobs: int = 1,
    cache_dir: Optional[str] = None,
) -> List[Dict]:
    """Runs one simulation per config; returns the list of valid results.

    Args:
        configs: per-job parameter dictionaries.
        seed: base seed; each job derives a unique one.
        job_function: (job_index, config) -> result dict.
        tolerate_failure: drop failed jobs instead of failing the run
            (at least one job must succeed).
        num_jobs: concurrent jobs; 1 = serial (default — device work is
            serialized on the accelerator anyway), >1 or -1 = thread pool.
        cache_dir: when given, each successfully completed job's result is
            persisted to ``cache_dir/job_XXXX.pkl`` (atomic write) and a
            re-run with the same base seed reuses it instead of recomputing
            — crash-resume for long multi-start fleets (failed jobs are
            never cached, so a resume retries them).
    """
    assert chk.is_list(configs, len(configs) > 0) and chk.is_dict(configs[0])
    assert callable(job_function)
    assert chk.is_int(num_jobs, num_jobs == -1 or num_jobs >= 1)
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)

    if num_jobs == 1:
        results = [
            _job_wrapper(i, c, seed, job_function, cache_dir)
            for i, c in enumerate(configs)
        ]
    else:
        workers = None if num_jobs == -1 else num_jobs
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [
                pool.submit(_job_wrapper, i, c, seed, job_function, cache_dir)
                for i, c in enumerate(configs)
            ]
            results = [f.result() for f in futures]

    sys.stderr.flush()
    sys.stdout.flush()

    for r in results:
        if not r["status"].startswith("ok"):
            print(f"Simulation {r['job_index']} failed:\n\n{r['status']}\n{'-' * 80}\n")

    if sum(r["status"].startswith("ok") for r in results) == 0:
        raise RuntimeError("every job of the fleet failed — nothing to return")

    if tolerate_failure:
        results = [r for r in results if r["status"].startswith("ok")]
    return results


def is_debugging() -> bool:
    """True when running under a debugger (the reference's executor
    switches to serial execution then)."""
    import inspect

    return any(frame[1].endswith("pdb.py") for frame in inspect.stack())
