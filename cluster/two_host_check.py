#!/usr/bin/env python
"""Prove the multi-process `jax.distributed` path actually executes.

The reference's multi-node story runs a multiprocessing pool under SLURM
(reference dpilqr/distributed.py:79-97, cluster/sim.sbatch).  Our
replacement is multi-controller JAX: every host runs the same program,
`jax.distributed.initialize` forms the global runtime, and the sharded
solve's collectives cross process boundaries.  Real multi-host ICI/DCN is
environmentally unreachable here, but the one thing this box CAN prove is
the full multi-process software path: distributed initialization, global
mesh construction spanning two OS processes, cross-process collectives,
and numerical equality with the single-process solve.

Parent mode (no --host-id): computes the single-process reference result
on an 8-virtual-device CPU mesh, then spawns TWO child processes (4
virtual CPU devices each) that initialize `jax.distributed` against a
localhost coordinator, build the global 8-device mesh, run the identical
sharded solve, and write their results to disk.  The parent asserts J and
trajectory equality and prints one JSON summary line.

Child mode (--host-id given): one "host" of the 2-process run.

Usage:  python cluster/two_host_check.py [--agents 64] [--horizon 50]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def build_problem(args, dtl, jnp):
    dtype = jnp.float32
    n = args.agents
    rng = np.random.default_rng(0)
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=16.0 * n)
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    cost = dtl.make_game_cost(
        jnp.asarray(xf, dtype),
        jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(np.eye(2), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(1e3 * np.eye(4), (n, 1, 1)), dtype),
        radius=args.radius,
    )
    U0 = jnp.zeros((args.horizon, n, 2), dtype)
    x0j = jnp.asarray(x0, dtype)[None]
    cfg = dtl.SolverConfig(n_lqr_iter=8, tol=1e-6)
    return fleet, cost, x0j, U0, cfg


def run_solve(args, mesh, dtl, jnp):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    fleet, cost, x0j, U0, cfg = build_problem(args, dtl, jnp)
    # Multi-process jit needs global arrays: replicate the (identical)
    # host data onto the global mesh up front; the sharding constraints
    # inside the solve lay the subproblem axis across processes.
    rep = NamedSharding(mesh, P())
    put = lambda t: jax.tree.map(lambda a: jax.device_put(a, rep), t)
    cost, x0j, U0 = put(cost), put(x0j), put(U0)
    radius = jax.device_put(jnp.asarray(args.radius, x0j.dtype), rep)
    return dtl.solve_distributed_sharded(
        fleet, cost, x0j, U0, radius, mesh=mesh, K=args.K, config=cfg
    )


def child(args):
    import jax

    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_hosts,
        process_id=args.host_id,
    )
    import jax.numpy as jnp

    import dpilqr_tpu as dtl

    assert jax.process_count() == args.num_hosts, jax.process_count()
    mesh = dtl.make_mesh(jax.devices())
    res = run_solve(args, mesh, dtl, jnp)
    # The solve's outputs are global arrays whose shards span both
    # processes (the subproblem axis is laid out across them); force-
    # replicate through a jitted identity so every process can fetch the
    # full value -- this is itself a cross-process all-gather.
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    gather = jax.jit(lambda x: x, out_shardings=rep)
    X = np.asarray(jax.device_get(gather(res.X)))
    J = float(np.asarray(jax.device_get(gather(res.J))))
    out = {
        "host_id": args.host_id,
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "J": J,
    }
    np.save(Path(args.out) / f"X_host{args.host_id}.npy", X)
    (Path(args.out) / f"host{args.host_id}.json").write_text(json.dumps(out))
    if args.host_id == 0:
        print(json.dumps(out))


def parent(args):
    # Single-process reference on the same 8-virtual-device topology.
    env_base = dict(os.environ)
    env_base["JAX_PLATFORMS"] = "cpu"
    outdir = Path(tempfile.mkdtemp(prefix="two_host_"))

    ref_code = f"""
import json
import numpy as np
import jax
import jax.numpy as jnp
import sys
sys.path.insert(0, {str(REPO)!r})
sys.path.insert(0, {str(REPO / 'cluster')!r})
import dpilqr_tpu as dtl
from two_host_check import build_problem, run_solve
import argparse
a = argparse.Namespace(agents={args.agents}, horizon={args.horizon},
                       radius={args.radius}, K={args.K})
mesh = dtl.make_mesh(jax.devices())
res = run_solve(a, mesh, dtl, jnp)
np.save({str(outdir / 'X_ref.npy')!r}, np.asarray(res.X))
print(json.dumps({{"J": float(res.J), "devices": len(jax.devices())}}))
"""
    env1 = dict(env_base)
    env1["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    r = subprocess.run(
        [sys.executable, "-c", ref_code], env=env1, capture_output=True,
        text=True, timeout=600,
    )
    if r.returncode != 0:
        sys.stderr.write(r.stderr)
        raise SystemExit("single-process reference run failed")
    ref = json.loads(r.stdout.strip().splitlines()[-1])

    # Two child processes, 4 virtual devices each, one localhost coordinator.
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env2 = dict(env_base)
    env2["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = []
    for host_id in range(2):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, __file__,
                    "--agents", str(args.agents),
                    "--horizon", str(args.horizon),
                    "--radius", str(args.radius),
                    "--K", str(args.K),
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-hosts", "2",
                    "--host-id", str(host_id),
                    "--out", str(outdir),
                ],
                env=env2, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
        )
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            sys.stderr.write(err)
            raise SystemExit(f"child failed rc={p.returncode}")

    h0 = json.loads((outdir / "host0.json").read_text())
    h1 = json.loads((outdir / "host1.json").read_text())
    X_ref = np.load(outdir / "X_ref.npy")
    X0 = np.load(outdir / "X_host0.npy")
    X1 = np.load(outdir / "X_host1.npy")

    assert h0["process_count"] == 2 and h1["process_count"] == 2
    assert h0["global_devices"] == 8 and h0["local_devices"] == 4
    # Both processes of the distributed run agree with each other and with
    # the single-process mesh bit-for-bit (same GSPMD partitioning).
    np.testing.assert_array_equal(X0, X1)
    np.testing.assert_allclose(X0, X_ref, atol=1e-6)
    np.testing.assert_allclose(h0["J"], ref["J"], rtol=1e-6)

    print(json.dumps({
        "summary": "two-process jax.distributed check",
        "agents": args.agents,
        "horizon": args.horizon,
        "processes": 2,
        "devices_per_process": 4,
        "global_devices": h0["global_devices"],
        "J_two_process": h0["J"],
        "J_single_process": ref["J"],
        "trajectory_equal_across_processes": True,
        "trajectory_matches_single_process": True,
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--radius", type=float, default=0.5)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-hosts", type=int, default=None)
    ap.add_argument("--host-id", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.host_id is None:
        parent(args)
    else:
        child(args)


if __name__ == "__main__":
    main()
