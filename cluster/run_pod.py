#!/usr/bin/env python
"""Multi-host pod-slice launcher for Monte-Carlo / scaling runs.

The reference's multi-node story is a SLURM batch script running analysis.py
on one 16-core node (reference cluster/sim.sbatch).  Here ONE process per
host drives all of that host's GPUs (cluster/pod.sbatch launches it); with
several hosts, pass ``--coordinator/--num-hosts/--host-id`` and
``jax.distributed.initialize`` joins them into one global mesh.  The
subproblem batch and Monte-Carlo trial axes shard over the global device
mesh; each host feeds its local shard.

On a single host the mesh is the local devices, so the same entry point
serves a laptop (``--cpu``), one 4-GPU host and several hosts.

Usage (each host):
  python cluster/run_pod.py --agents 64 --trials 4
"""

import argparse
import json
from time import perf_counter

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--radius", type=float, default=0.5)
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address for jax.distributed (multi-host)")
    ap.add_argument("--num-hosts", type=int, default=None)
    ap.add_argument("--host-id", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument(
        "--vmap-trials", action="store_true",
        help="run all Monte-Carlo trials as ONE sharded batch axis over the "
        "mesh (SURVEY 2.3 cluster parallelism) instead of a host loop",
    )
    ap.add_argument(
        "--scaling", action="store_true",
        help="measure parallel efficiency: time the same problem on a "
        "1-device mesh vs the full mesh (BASELINE.md >= 80%% target)",
    )
    args = ap.parse_args()

    import jax

    if args.coordinator:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_hosts,
            process_id=args.host_id,
        )
    if args.cpu:
        jax.config.update("jax_default_device", jax.devices("cpu")[0])

    import jax.numpy as jnp

    import dpilqr_tpu as dtl

    devices = jax.devices("cpu") if args.cpu else jax.devices()
    if jax.process_index() == 0:
        print(f"hosts={jax.process_count()} devices={len(devices)}")

    mesh = dtl.make_mesh(devices)
    n, N, dt = args.agents, args.horizon, 0.1
    dtype = jnp.float32
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt)

    if args.scaling:
        _scaling_run(args, fleet, devices, n, N)
        return

    if args.vmap_trials:
        costs, X0s, U0s = [], [], []
        for trial in range(args.trials):
            rng = np.random.default_rng(trial)
            x0, xf = dtl.random_setup(n, 4, rng=rng, energy=16.0 * n)
            costs.append(dtl.make_game_cost(
                jnp.asarray(xf, dtype),
                jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
                jnp.asarray(np.tile(np.eye(2), (n, 1, 1)), dtype),
                jnp.asarray(np.tile(1e3 * np.eye(4), (n, 1, 1)), dtype),
                radius=args.radius,
            ))
            X0s.append(np.broadcast_to(x0[None].astype(np.float32), (2, n, 4)))
            U0s.append(np.zeros((N, n, 2), np.float32))
        cost_T = jax.tree.map(lambda *ls: jnp.stack(ls), *costs)
        res = dtl.solve_trials_sharded(
            fleet, cost_T, jnp.asarray(np.stack(X0s)),
            jnp.asarray(np.stack(U0s)), args.radius, mesh=mesh, K=8,
            config=dtl.SolverConfig(n_lqr_iter=8, tol=1e-6),
        )
        jax.block_until_ready(res)  # compile + warm
        t0 = perf_counter()
        res = dtl.solve_trials_sharded(
            fleet, cost_T, jnp.asarray(np.stack(X0s)),
            jnp.asarray(np.stack(U0s)), args.radius, mesh=mesh, K=8,
            config=dtl.SolverConfig(n_lqr_iter=8, tol=1e-6),
        )
        jax.block_until_ready(res)
        wall = perf_counter() - t0
        if jax.process_index() == 0:
            print(json.dumps({
                "summary": "vmapped MC trials (sharded batch axis)",
                "trials": args.trials, "n_agents": n, "devices": len(devices),
                "wall_s": round(wall, 4),
                "trials_per_s": round(args.trials / wall, 2),
                "J": np.asarray(res.J).round(1).tolist(),
            }))
        return

    results = []
    for trial in range(args.trials):
        rng = np.random.default_rng(trial)
        x0, xf = dtl.random_setup(n, 4, rng=rng, energy=10.0 + 2 * n ** 0.5)
        cost = dtl.make_game_cost(
            jnp.asarray(xf, dtype),
            jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(np.eye(2), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(1e3 * np.eye(4), (n, 1, 1)), dtype),
            radius=args.radius,
        )
        U0 = jnp.zeros((N, n, 2), dtype)
        res = dtl.solve_distributed_sharded(
            fleet, cost, jnp.asarray(x0, dtype)[None], U0, args.radius,
            mesh=mesh,
        )
        jax.block_until_ready(res)  # compile + warm
        reps = 5
        t0 = perf_counter()
        for _ in range(reps):
            res = dtl.solve_distributed_sharded(
                fleet, cost, jnp.asarray(x0, dtype)[None], U0, args.radius,
                mesh=mesh,
            )
        jax.block_until_ready(res)
        wall = (perf_counter() - t0) / reps
        results.append(
            {
                "trial": trial,
                "n_agents": n,
                "wall_s": wall,
                "hz": 1.0 / wall,
                "J": float(res.J),
                "mean_subproblem": float(np.mean(np.asarray(res.sizes))),
            }
        )
        if jax.process_index() == 0:
            print(json.dumps(results[-1]))

    if jax.process_index() == 0:
        walls = [r["wall_s"] for r in results]
        print(
            json.dumps(
                {
                    "summary": "distributed solve",
                    "n_agents": n,
                    "devices": len(devices),
                    "median_wall_s": float(np.median(walls)),
                    "median_hz": float(1.0 / np.median(walls)),
                }
            )
        )


def _scaling_run(args, fleet, devices, n, N):
    """Strong-scaling measurement: same problem, 1-device vs D-device mesh.

    Emits ``parallel_efficiency = t_1 / (ideal * t_D)`` plus a correctness
    cross-check (both meshes must produce the same stitched-plan cost).
    On a virtual CPU mesh (``--xla_force_host_platform_device_count``) the
    devices share the host's physical cores, so the 1-device baseline is
    pinned to ONE core and ``ideal = min(n_devices, n_cores)`` -- the mesh
    validates the sharded program and per-core efficiency; chip-level
    efficiency (BASELINE.md >= 80% target) needs real cards.
    """
    import jax
    import jax.numpy as jnp

    import dpilqr_tpu as dtl

    dtype = jnp.float32
    rng = np.random.default_rng(0)
    # Spread scenario + fixed K=8 neighborhoods: measures the sharded
    # batch's scaling, not the (density-dependent) subproblem sizes.
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=16.0 * n)
    cost = dtl.make_game_cost(
        jnp.asarray(xf, dtype),
        jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(np.eye(2), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(1e3 * np.eye(4), (n, 1, 1)), dtype),
        radius=args.radius,
    )
    U0 = jnp.zeros((N, n, 2), dtype)
    x0j = jnp.asarray(x0, dtype)[None]

    cfg = dtl.SolverConfig(n_lqr_iter=8, tol=1e-6)

    def timed(mesh, reps=7):
        res = dtl.solve_distributed_sharded(
            fleet, cost, x0j, U0, args.radius, mesh=mesh, K=8, config=cfg
        )
        float(res.J)  # compile + hard sync
        # Best-of-reps: virtual CPU meshes share oversubscribed host cores
        # with whatever else runs on the box, and per-rep times swing by
        # tens of percent; the minimum estimates the uncontended time.
        best = float("inf")
        for _ in range(reps):
            t0 = perf_counter()
            res = dtl.solve_distributed_sharded(
                fleet, cost, x0j, U0, args.radius, mesh=mesh, K=8, config=cfg
            )
            float(res.J)
            best = min(best, perf_counter() - t0)
        return best, float(res.J)

    import os

    cpu_mesh = devices[0].platform == "cpu"
    all_cores = None
    if cpu_mesh and hasattr(os, "sched_getaffinity"):
        all_cores = os.sched_getaffinity(0)
        os.sched_setaffinity(0, {min(all_cores)})
    t1, J1 = timed(dtl.make_mesh(devices[:1]))
    if all_cores is not None:
        os.sched_setaffinity(0, all_cores)
    tD, JD = timed(dtl.make_mesh(devices))
    D = len(devices)
    n_cores = len(all_cores) if all_cores is not None else D
    ideal = min(D, n_cores) if cpu_mesh else D
    eff = t1 / (ideal * tD)
    assert abs(J1 - JD) <= 1e-3 * abs(J1), (J1, JD)
    if jax.process_index() == 0:
        print(
            json.dumps(
                {
                    "summary": "strong scaling",
                    "n_agents": n,
                    "horizon": N,
                    "devices": D,
                    "cores": n_cores,
                    "ideal_speedup": ideal,
                    "t_1dev_s": round(t1, 4),
                    "t_fullmesh_s": round(tD, 4),
                    "speedup": round(t1 / tD, 3),
                    "parallel_efficiency": round(eff, 3),
                    "J_match": True,
                }
            )
        )


if __name__ == "__main__":
    main()
