"""Traffic generators: a traffic file names one (`"generator"`), and the
pool of pairs a run cycles through is rendered from the run's seed.

`make_pool` renders the pairs in a pool of spawned worker processes (each
imports numpy only), joins them before it returns, and stacks
the pairs' arrays: pair idx of a pool is the same whichever worker drew
it.
"""
from __future__ import annotations

import importlib
import multiprocessing
import os

import numpy as np

GENERATORS = ("homography", "se3")
MAX_WORKERS = 8
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _module(name: str):
    if name not in GENERATORS:
        raise ValueError(f"unknown generator {name!r}; one of {GENERATORS}")
    return importlib.import_module(f"port_bench.generators.{name}")


def _render(args):
    name, entropy, idx, traffic = args
    return _module(name).make_pair(entropy, idx, traffic)


def make_pool(traffic: dict, entropy: int, workers: int | None = None
              ) -> dict:
    """The traffic's `pool_pairs` pairs, stacked: {key: [P, ...]}."""
    name = traffic["generator"]
    _module(name)
    n = int(traffic["pool_pairs"])
    jobs = [(name, entropy, i, traffic) for i in range(n)]
    workers = min(workers or os.cpu_count() or 1, n, MAX_WORKERS)
    if workers <= 1:
        pairs = [_render(j) for j in jobs]
    else:
        # one thread a worker: the workers share the host's cores
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update({k: "1" for k in _THREAD_VARS})
        try:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(workers) as pool:
                pairs = pool.map(_render, jobs, chunksize=1)
                pool.close()
                pool.join()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return {k: np.stack([p[k] for p in pairs]) for k in pairs[0]}
