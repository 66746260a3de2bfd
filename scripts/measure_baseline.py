#!/usr/bin/env python
"""Measure the reference baseline END TO END (VERDICT r2 item 7).

bench.py's ``vs_baseline`` PROJECTS the reference cost: per-iteration numpy
oracle time on ONE K-slot subproblem x the total subproblem iterations the
device solve executed.  This tool instead runs the reference's actual
sequential distributed path (dpilqr/distributed.py:56-77) on the exact
bench workload -- build the interaction graph of the 100-agent grid
scenario, then solve every agent's neighborhood subproblem one after
another with the float64 numpy oracle -- and reports the measured total,
the projection, and their ratio.  Results are recorded in BASELINE.md.
"""

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(
    0, str(pathlib.Path(__file__).resolve().parent.parent / "tests")
)


def main(n=100, N=50, dt=0.1, radius=0.5):
    from bench import _grid_scenario
    from oracle import OracleGameCost, OracleMultiModel, oracle_ilqr

    x0, xf = _grid_scenario(n)

    # Interaction graph exactly like the reference (distributed.py:224-247):
    # threshold pairwise distances at 2*radius over the (static warm-start)
    # trajectory -- with a constant X the 10-knot sampling reduces to the
    # initial positions.
    pos = x0[:, :2]
    D = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    M = D < 2.0 * radius
    np.fill_diagonal(M, True)

    total_iters = 0
    t0 = time.perf_counter()
    for i in range(n):
        members = np.flatnonzero(M[i])
        k = len(members)
        model = OracleMultiModel("Unicycle4D", k, dt)
        cost = OracleGameCost(
            xf[members].flatten(), [np.eye(4)] * k, [np.eye(2)] * k,
            [1e3 * np.eye(4)] * k, radius, 4, 2, k,
        )
        _, _, _, iters, _ = oracle_ilqr(
            model, cost, x0[members].flatten(), N=N,
            n_lqr_iter=15, tol=1e-3,
        )
        total_iters += iters
    measured_s = time.perf_counter() - t0

    # The projection bench.py uses: one K=8 subproblem's per-iteration time.
    K = 8
    x0o, xfo = _grid_scenario(K, seed=1)
    model_o = OracleMultiModel("Unicycle4D", K, dt)
    cost_o = OracleGameCost(
        xfo.flatten(), [np.eye(4)] * K, [np.eye(2)] * K,
        [1e3 * np.eye(4)] * K, radius, 4, 2, K,
    )
    t0 = time.perf_counter()
    _, _, _, base_iters, _ = oracle_ilqr(
        model_o, cost_o, x0o.flatten(), N=N, n_lqr_iter=10, tol=1e-9
    )
    per_iter_ms = (time.perf_counter() - t0) * 1e3 / max(base_iters, 1)
    projected_s = per_iter_ms * total_iters / 1e3

    out = {
        "n_agents": n,
        "n_subproblems": n,
        "total_oracle_iters": total_iters,
        "measured_sequential_s": round(measured_s, 3),
        "projected_s": round(projected_s, 3),
        "measured_over_projected": round(measured_s / projected_s, 3),
        "neighborhood_sizes": {
            "min": int(M.sum(1).min()), "max": int(M.sum(1).max()),
            "mean": float(M.sum(1).mean()),
        },
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
