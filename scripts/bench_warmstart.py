#!/usr/bin/env python
"""Measure the selfish-warmstart lever on the 500-agent COLD solve.

The reference ships a per-agent solo warm start
(problem.py:66-91 ``selfish_warmstart``); this framework batches it as one
singleton-graph distributed solve (parallel/rhc.py).  Question: does
(warmstart + coupled solve) beat the pure cold solve end to end at the
scales where the 10 Hz cold bar is unmet, WITHOUT degrading the solution
(converged fraction, joint cost)?

Prints one JSON line per scale with both paths timed the way bench.py
times them: the median of calls that each end in ``block_until_ready``.
"""

import dataclasses
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from bench import _grid_scenario  # noqa: E402


def main(scales=(100, 250, 500)):
    import jax
    import jax.numpy as jnp

    import dpilqr_tpu as dtl
    from dpilqr_tpu.ops.ilqr import array_platform, resolve_sweep_backend
    from dpilqr_tpu.parallel.distributed import _solve_distributed
    from dpilqr_tpu.parallel.rhc import selfish_warmstart

    N, dt, radius, K = 50, 0.1, 0.5, 8
    dtype = jnp.float32
    cfg = dtl.SolverConfig(n_lqr_iter=15, tol=1e-3)

    def time_fn(fn, reps=10):
        out = jax.block_until_ready(fn())  # warm-up / compile
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), out

    for n in scales:
        x0, xf = _grid_scenario(n)
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt)
        cost = dtl.make_game_cost(
            jnp.asarray(xf, dtype),
            jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(np.eye(2), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(1e3 * np.eye(4), (n, 1, 1)), dtype),
            radius=radius,
        )
        x0j = jnp.asarray(x0, dtype)
        X0 = jnp.broadcast_to(x0j[None], (N + 1, n, 4))
        U0 = jnp.zeros((N, n, 2), dtype)
        rad = jnp.asarray(radius, dtype)
        ign = jnp.zeros((n,), bool)
        backend = resolve_sweep_backend(
            cfg, K * fleet.nx_p, dtype, array_platform(X0)
        )
        cfg_n = dataclasses.replace(cfg, sweep_backend=backend)

        def cold():
            return _solve_distributed(
                fleet, cfg_n, K, None, cost, X0, U0, rad, ign
            )

        def warmstarted():
            Uw = selfish_warmstart(fleet, cost, x0j, N, config=cfg_n)
            return _solve_distributed(
                fleet, cfg_n, K, None, cost, X0, Uw, rad, ign
            )

        ms_c, res_c = time_fn(cold)
        ms_w, res_w = time_fn(warmstarted)
        rec = {
            "n": n,
            "backend": backend,
            "cold_ms": round(ms_c, 2),
            "cold_hz": round(1e3 / ms_c, 2),
            "cold_iters": int(np.asarray(res_c.iters).sum()),
            "cold_J": float(np.asarray(res_c.J)),
            "cold_conv_frac": float(np.asarray(res_c.converged).mean()),
            "ws_total_ms": round(ms_w, 2),
            "ws_total_hz": round(1e3 / ms_w, 2),
            "ws_coupled_iters": int(np.asarray(res_w.iters).sum()),
            "ws_J": float(np.asarray(res_w.J)),
            "ws_conv_frac": float(np.asarray(res_w.converged).mean()),
        }
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    scales = tuple(int(a) for a in sys.argv[1:]) or (100, 250, 500)
    main(scales)
