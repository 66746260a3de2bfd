#!/usr/bin/env python
"""Crossover benchmark: sequential vs parallel-scan Riccati backward pass.

The sequential sweep (lax.scan) has O(N) dependency depth; the
associative-scan formulation (ops/pscan.py) has O(log N) depth but does
four (nxf, nxf) solves per combine.  This script measures both on the
current backend across horizons and reports the crossover -- the horizon
beyond which the parallel scan wins (VERDICT r1 item 9; PAPERS.md
"Parallelization of Riccati Recursion").

Usage: python scripts/bench_pscan.py [--agents 4] [--f64]
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--horizons", type=int, nargs="+",
                    default=[50, 100, 200, 400, 800, 1600])
    ap.add_argument("--f64", action="store_true",
                    help="float64 on CPU (default: float32 on the default backend)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import dpilqr_tpu as dtl
    from dpilqr_tpu.ops.costs import make_game_cost
    from dpilqr_tpu.ops.ilqr import _backward_pass, _rollout_fn
    from dpilqr_tpu.ops.pscan import backward_pass_pscan

    if args.f64:
        jax.config.update("jax_default_device", jax.devices("cpu")[0])
        dtype = jnp.float64
    else:
        dtype = jnp.float32

    n = args.agents
    rng = np.random.default_rng(0)
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=5.0, n_d=2)
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    cost = make_game_cost(
        jnp.asarray(xf, dtype),
        jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(np.eye(2), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(1e3 * np.eye(4), (n, 1, 1)), dtype),
        radius=0.5,
    )

    def timed(fn, *a):
        out = fn(*a)
        jax.block_until_ready(out)
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps * 1e3

    crossover = None
    rows = []
    for N in args.horizons:
        U = jnp.asarray(rng.uniform(size=(N, n, 2)) * 0.1, dtype)
        X, _ = _rollout_fn(fleet.step, cost, jnp.asarray(x0, dtype), U)
        mu = jnp.asarray(1.0, dtype)
        seq = jax.jit(
            lambda X, U, mu: _backward_pass(fleet.linearize, cost, X, U, mu)
        )
        par = jax.jit(
            lambda X, U, mu: backward_pass_pscan(
                fleet.linearize, cost, X, U, mu
            )
        )
        t_seq = timed(seq, X, U, mu)
        t_par = timed(par, X, U, mu)
        rows.append(
            {"N": N, "seq_ms": round(t_seq, 3), "pscan_ms": round(t_par, 3),
             "speedup": round(t_seq / t_par, 2)}
        )
        print(json.dumps(rows[-1]))
        if crossover is None and t_par < t_seq:
            crossover = N

    print(json.dumps({"summary": "pscan crossover", "n_agents": n,
                      "crossover_N": crossover}))


if __name__ == "__main__":
    main()
