"""Multi-device tests on the virtual 8-device CPU mesh: the sharded
decomposed solve must produce the same result as the unsharded one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dpilqr_tpu as dtl

cpu_devices = jax.devices("cpu")

pytestmark = pytest.mark.skipif(
    len(cpu_devices) < 8, reason="needs XLA_FLAGS=--xla_force_host_platform_device_count=8"
)


def _scenario(n, dt=0.1, seed=0):
    rng = np.random.default_rng(seed)
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=10.0, n_d=2)
    cost = dtl.make_game_cost(
        xf,
        np.tile(np.eye(4), (n, 1, 1)),
        np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)),
        radius=0.5,
    )
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt)
    return fleet, cost, x0, xf


def test_sharded_matches_unsharded():
    n, N = 8, 20
    fleet, cost, x0, xf = _scenario(n)
    U0 = jnp.zeros((N, n, 2))
    mesh = dtl.make_mesh(cpu_devices[:8])

    res = dtl.solve_distributed(fleet, cost, jnp.asarray(x0)[None], U0, 0.5)
    res_s = dtl.solve_distributed_sharded(
        fleet, cost, jnp.asarray(x0)[None], U0, 0.5, mesh=mesh
    )
    assert np.asarray(res.membership).tolist() == np.asarray(res_s.membership).tolist()
    assert np.asarray(res.iters).tolist() == np.asarray(res_s.iters).tolist()
    assert np.allclose(np.asarray(res.X), np.asarray(res_s.X), atol=1e-8)
    assert np.isclose(float(res.J), float(res_s.J), rtol=1e-8)


def test_sharded_output_layout():
    n, N = 8, 10
    fleet, cost, x0, xf = _scenario(n, seed=1)
    U0 = jnp.zeros((N, n, 2))
    mesh = dtl.make_mesh(cpu_devices[:8])
    res = dtl.solve_distributed_sharded(
        fleet, cost, jnp.asarray(x0)[None], U0, 0.5, mesh=mesh
    )
    # Per-subproblem outputs are sharded over the mesh.
    assert len(res.iters.sharding.device_set) == 8


def test_trials_sharded_matches_per_trial():
    """Monte-Carlo trials as a sharded batch axis (SURVEY 2.3 cluster
    parallelism): each trial's result must equal its own unsharded solve."""
    n, N, T = 6, 12, 8
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    mesh = dtl.make_mesh(cpu_devices[:8])
    cfg = dtl.SolverConfig(n_lqr_iter=5, sweep_backend="xla")

    costs, X0s, U0s = [], [], []
    for t in range(T):
        _, cost, x0, _ = _scenario(n, seed=t)
        costs.append(cost)
        X0s.append(np.broadcast_to(x0[None], (2, n, 4)))
        U0s.append(np.zeros((N, n, 2)))
    cost_T = jax.tree.map(lambda *ls: jnp.stack(ls), *costs)
    X_T = jnp.asarray(np.stack(X0s))
    U_T = jnp.asarray(np.stack(U0s))

    res = dtl.solve_trials_sharded(
        fleet, cost_T, X_T, U_T, 0.5, mesh=mesh, K=4, config=cfg
    )
    assert res.J.shape == (T,)
    for t in (0, 3, 7):
        ref = dtl.solve_distributed(
            fleet, costs[t], X_T[t], U_T[t], 0.5, K=4, config=cfg
        )
        assert np.isclose(float(res.J[t]), float(ref.J), rtol=1e-8)
        assert np.allclose(
            np.asarray(res.X[t]), np.asarray(ref.X), atol=1e-8
        )


def test_sharded_kernel_path_matches_unsharded(triton_interpret):
    """The sharded solve with the Triton sweep kernel (shard_map, one
    batched solve per device; interpret mode on CPU) must reproduce the
    single-device kernel solve AND the XLA sharded path -- identical
    per-subproblem iteration counts, values to the usual float64
    tolerance."""
    n, N = 16, 8
    fleet, cost, x0, xf = _scenario(n, seed=3)
    U0 = jnp.zeros((N, n, 2))
    mesh8 = dtl.make_mesh(cpu_devices[:8])
    mesh1 = dtl.make_mesh(cpu_devices[:1])
    cfg_k = dtl.SolverConfig(n_lqr_iter=6, sweep_backend="triton")
    cfg_x = dtl.SolverConfig(n_lqr_iter=6, sweep_backend="xla")

    res_k8 = dtl.solve_distributed_sharded(
        fleet, cost, jnp.asarray(x0)[None], U0, 0.5, mesh=mesh8, K=4,
        config=cfg_k,
    )
    res_k1 = dtl.solve_distributed_sharded(
        fleet, cost, jnp.asarray(x0)[None], U0, 0.5, mesh=mesh1, K=4,
        config=cfg_k,
    )
    res_x8 = dtl.solve_distributed_sharded(
        fleet, cost, jnp.asarray(x0)[None], U0, 0.5, mesh=mesh8, K=4,
        config=cfg_x,
    )
    res_u = dtl.solve_distributed(
        fleet, cost, jnp.asarray(x0)[None], U0, 0.5, K=4, config=cfg_k
    )
    # The shard outputs live on all 8 devices.
    assert len(res_k8.iters.sharding.device_set) == 8
    for other in (res_k1, res_x8, res_u):
        np.testing.assert_array_equal(
            np.asarray(res_k8.iters), np.asarray(other.iters)
        )
        np.testing.assert_array_equal(
            np.asarray(res_k8.converged), np.asarray(other.converged)
        )
        np.testing.assert_allclose(
            float(res_k8.J), float(other.J), rtol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(res_k8.X), np.asarray(other.X), atol=1e-8
        )
    # Work happened and neighborhoods were genuinely multi-agent.
    assert int(np.asarray(res_k8.iters).sum()) > 0
    assert int(np.asarray(res_k8.sizes).max()) > 1


def test_trials_sharded_kernel_path(triton_interpret):
    """Monte-Carlo trials on the Triton kernel path: the flattened (trial,
    subproblem) batch must reproduce each trial's own unsharded kernel
    solve."""
    n, N, T = 6, 8, 4
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    mesh = dtl.make_mesh(cpu_devices[:8])
    cfg = dtl.SolverConfig(n_lqr_iter=4, sweep_backend="triton")

    costs, X0s, U0s = [], [], []
    for t in range(T):
        _, cost, x0, _ = _scenario(n, seed=10 + t)
        costs.append(cost)
        X0s.append(np.broadcast_to(x0[None], (2, n, 4)))
        U0s.append(np.zeros((N, n, 2)))
    cost_T = jax.tree.map(lambda *ls: jnp.stack(ls), *costs)
    X_T = jnp.asarray(np.stack(X0s))
    U_T = jnp.asarray(np.stack(U0s))

    res = dtl.solve_trials_sharded(
        fleet, cost_T, X_T, U_T, 0.5, mesh=mesh, K=4, config=cfg
    )
    assert res.J.shape == (T,)
    for t in range(T):
        ref = dtl.solve_distributed(
            fleet, costs[t], X_T[t], U_T[t], 0.5, K=4, config=cfg
        )
        np.testing.assert_array_equal(
            np.asarray(res.iters[t]), np.asarray(ref.iters)
        )
        np.testing.assert_allclose(
            float(res.J[t]), float(ref.J), rtol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(res.X[t]), np.asarray(ref.X), atol=1e-8
        )


def test_two_process_distributed():
    """The multi-process jax.distributed path actually executes: two OS
    processes (4 virtual CPU devices each) form a global 8-device mesh via
    a localhost coordinator and produce the single-process result exactly
    (cluster/two_host_check.py; SCALING.md round-4 section)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parent.parent / "cluster" / "two_host_check.py"
    r = subprocess.run(
        [sys.executable, str(script), "--agents", "24", "--horizon", "20"],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["processes"] == 2
    assert out["global_devices"] == 8
    assert out["trajectory_equal_across_processes"] is True
    assert out["trajectory_matches_single_process"] is True
