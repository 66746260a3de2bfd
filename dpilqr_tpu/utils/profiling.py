"""Profiling utilities.

The reference scatters ``time.perf_counter`` deltas through its solvers
(control.py:169,213; distributed.py:65-89).  Here profiling is structured:

- ``trace(logdir)``: context manager around ``jax.profiler`` producing a
  TensorBoard-loadable device trace of everything inside.
- ``timed_solve``: steady-state wall time per call -- the median of timed
  calls, each ending in ``block_until_ready`` (JAX dispatch is
  asynchronous; without it a timing measures only the enqueue).
- ``solve_stats``: per-solve counters in the BASELINE.md units
  (solve Hz, Riccati block-nnz/s).
"""

from __future__ import annotations

import contextlib
from time import perf_counter

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_solve(fn, *args, reps: int = 20) -> float:
    """Median steady-state seconds per call, after one warm-up call."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(perf_counter() - t0)
    return float(np.median(times))


def solve_stats(wall_s: float, n_agents: int, horizon: int, iters: int,
                nx: int) -> dict:
    """BASELINE.md north-star counters for one solve."""
    blocks = horizon * (n_agents * n_agents + 2 * n_agents) * max(iters, 1)
    return {
        "wall_s": wall_s,
        "hz": 1.0 / wall_s if wall_s else float("inf"),
        "block_nnz_per_s": blocks / wall_s if wall_s else float("inf"),
        "n_agents": n_agents,
        "horizon": horizon,
        "iters": iters,
    }
