#!/usr/bin/env python
"""Benchmark: DP-iLQR solves at 10 / 50 / 100 / 250 / 500 agents.

Prints the device (JAX platform, device kind, count) and the card
(``nvidia-smi`` name and power limit, where present) on one line, then ONE
JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.

- value: wall-clock milliseconds of the HEADLINE workload -- a full
  100-agent distributed (proximity-decomposed, K=8 slot neighborhoods)
  N=50 unicycle DP-iLQR solve on the default backend, float32,
  at constant agent density (jittered grid, ~5 agents per neighborhood;
  the BASELINE.md north-star scale with a >= 10 Hz replanning target).
- vs_baseline: speedup over the reference algorithm (labicon/dp-ilqr
  publishes no numbers -- see BASELINE.md), estimated as an in-process
  dense numpy transcription of the reference solving the same subproblems
  SEQUENTIALLY (its distributed.py:56-77 path): per-iteration oracle time
  on one K-slot subproblem x the total subproblem iterations executed.
  BASELINE.md records a full end-to-end measured run of the same oracle
  validating this projection.
- extra: per-scale wall-clock + replanning Hz, each with the RESOLVED
  sweep backend and executed iteration count (self-proving artifacts:
  a changed number traces to a changed path or changed work); the
  sustained closed-loop ms per MPC step at 100 agents (solve + graph +
  gather + advance + warm-start shift, the reference's real-time
  contract, distributed.py:164-199); and the Riccati block-nnz/s
  north-star counter.  Every distributed point asserts that no
  neighborhood was truncated by the static slot count K.
"""

import json
import sys
import time

import numpy as np


def _grid_scenario(n, spacing=0.75, seed=0):
    """Constant-density start/goal sets: jittered grid, goals mirrored so
    trajectories cross (realistic interaction graphs: ~5-7 agents within
    the 2 * 0.5 planning radius at any density-preserving n)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    pts = np.stack(
        np.meshgrid(np.arange(side), np.arange(side)), -1
    ).reshape(-1, 2)[:n] * spacing
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    x0 = np.zeros((n, 4))
    x0[:, :2] = pts
    xf = np.zeros((n, 4))
    xf[:, :2] = pts[::-1] + rng.uniform(-0.05, 0.05, pts.shape)
    return x0, xf


def _swap_scenario(n, spacing=0.75, seed=0):
    """Constant-density scenario with LOCAL crossings: adjacent grid columns
    swap positions, so every agent crosses its lateral neighbor head-on but
    nobody transits the whole field.  Planned trajectories then keep
    neighborhood sizes bounded (~4-10) at any fleet size -- the regime the
    proximity decomposition is designed for.  (The mirrored-grid scenario
    of ``_grid_scenario`` routes ALL agents through the field center, so
    over a 5 s planning horizon nearly every pair comes within the
    2r threshold and any non-truncating decomposition -- ours or the
    reference's -- degenerates toward n copies of the centralized problem;
    that scenario stays the SINGLE-SOLVE headline where the initial-state
    graph is local.)"""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pts = np.stack([ii, jj], -1).reshape(-1, 2)[:n] * spacing
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    # Swap each even column with the next odd column (goal = partner's pos).
    col = (np.arange(n) % side)
    partner = np.where(
        (col % 2 == 0) & (col + 1 < side),
        np.arange(n) + 1,
        np.where(col % 2 == 1, np.arange(n) - 1, np.arange(n)),
    )
    # Truncated grids (side^2 > n): a last agent's partner may fall off
    # the end -- keep it in place instead.
    partner = np.where(partner < n, partner, np.arange(n))
    goals = pts[partner] + rng.uniform(-0.05, 0.05, pts.shape)
    x0 = np.zeros((n, 4))
    x0[:, :2] = pts
    xf = np.zeros((n, 4))
    xf[:, :2] = goals
    return x0, xf


def _cl_problem(n, dt, radius, model="unicycle"):
    """Fleet + cost + x0 for a closed-loop workload.  ``model``:
    "unicycle" (2D swap scenario, spacing 1.25) or "quad6d" (3D
    local-crossing grid, spacing 0.85 -- the quadrotor swarm of
    BASELINE.json config 5)."""
    import dpilqr_tpu as dtl
    import jax.numpy as jnp

    dtype = jnp.float32
    if model == "quad6d":
        x0, xf = _grid3d_scenario(n, spacing=0.85, nx=6)
        fleet = dtl.homogeneous_fleet(dtl.QUAD_6D, n, dt)
        cost = dtl.make_game_cost(
            jnp.asarray(xf, dtype),
            jnp.asarray(np.tile(np.eye(6), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(np.eye(3), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(1e3 * np.eye(6), (n, 1, 1)), dtype),
            radius=radius,
            n_pos=np.full((n,), 3, np.int32),
        )
    else:
        # spacing 1.25 keeps trajectory-union neighborhoods <= ~8, so
        # auto-K stays at K <= 8.
        x0, xf = _swap_scenario(n, spacing=1.25)
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt)
        cost = dtl.make_game_cost(
            jnp.asarray(xf, dtype),
            jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(np.eye(2), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(1e3 * np.eye(4), (n, 1, 1)), dtype),
            radius=radius,
        )
    return fleet, cost, x0


def closed_loop_run(n=100, n_steps=20, N=50, dt=0.1, radius=0.5, K=None,
                    cfg=None, model="unicycle", t_kill=None):
    """Sustained closed-loop benchmark: ``n_steps`` receding-horizon MPC
    steps of the decomposed solve (the reference's per-step real-time
    contract, distributed.py:164-199).  Returns ``(ms_per_step, RhcResult)``
    of a timed run after one warm-up run.  Shared by bench.py and
    scripts/bench_rhc.py so the two artifacts measure the same workload."""
    import time

    import numpy as np

    import dpilqr_tpu as dtl

    cfg = dtl.SolverConfig(n_lqr_iter=15, tol=1e-3) if cfg is None else cfg
    fleet, cost, x0 = _cl_problem(n, dt, radius, model)

    def once(kill=t_kill):
        return dtl.solve_rhc(
            fleet, cost, x0.astype(np.float32), N, radius=radius,
            centralized=False, step_size=1, J_converge=1e-3,
            t_diverge=(n_steps - 1) * dt, K=K, config=cfg,
            rng=np.random.default_rng(0), t_kill=kill,
        )

    if t_kill is not None:
        # Compile the deadline path's step programs WITHOUT the deadline
        # first: a cold compile inside a deadline-capped warm-up run would
        # leave every step returning the unoptimized warm start.
        import jax.numpy as jnp

        from dpilqr_tpu.parallel.deadline import solve_distributed_steppable

        x32 = x0.astype(np.float32)
        X0 = jnp.broadcast_to(
            jnp.asarray(x32)[None], (N + 1, n, fleet.nx_p)
        )
        U0 = jnp.zeros((N, n, fleet.nu_p), jnp.float32)
        solve_distributed_steppable(
            fleet, cost, X0, U0, radius, K=K, config=cfg, t_kill=None
        )
    once()  # warm-up / compile
    per_step = []
    for _ in range(3):  # solve_rhc returns host arrays: already synced
        t0 = time.perf_counter()
        res = once()
        per_step.append((time.perf_counter() - t0) / len(res.steps) * 1e3)
    return float(np.median(per_step)), res


def _grid3d_scenario(n, spacing=0.75, nx=6, seed=0):
    """3D constant-density scenario with local crossings for the quad
    models: agents sit on a jittered 3D grid and swap with their lateral
    neighbor (same regime as _swap_scenario, one layer axis added)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1.0 / 3.0)))
    ii, jj, kk = np.meshgrid(
        np.arange(side), np.arange(side), np.arange(side), indexing="ij"
    )
    pts = np.stack([ii, jj, kk], -1).reshape(-1, 3)[:n] * spacing
    pts = pts + rng.uniform(-0.05, 0.05, pts.shape)
    col = np.arange(n) % side
    partner = np.where(
        (col % 2 == 0) & (col + 1 < side),
        np.arange(n) + 1,
        np.where(col % 2 == 1, np.arange(n) - 1, np.arange(n)),
    )
    # Truncated grids (side^3 > n): a last agent's partner may fall off
    # the end -- keep it in place instead.
    partner = np.where(partner < n, partner, np.arange(n))
    goals = pts[partner] + rng.uniform(-0.05, 0.05, pts.shape)
    x0 = np.zeros((n, nx))
    x0[:, :3] = pts
    xf = np.zeros((n, nx))
    xf[:, :3] = goals
    return x0, xf


def _distributed_point(dtl, fleet, cost, x0, N, radius, K, cfg, time_solve,
                       reps=10):
    """Measure one distributed solve config; returns (ms, backend, iters,
    truncated)."""
    import dataclasses

    import jax.numpy as jnp

    from dpilqr_tpu.ops.ilqr import array_platform, resolve_sweep_backend
    from dpilqr_tpu.parallel.distributed import _solve_distributed

    n, nx = x0.shape
    dtype = jnp.float32
    x0j = jnp.asarray(x0, dtype)
    X0 = jnp.broadcast_to(x0j[None], (N + 1, n, nx))
    U0 = jnp.zeros((N, n, fleet.nu_p), dtype)
    rad = jnp.asarray(radius, dtype)
    ign = jnp.zeros((n,), bool)
    backend = resolve_sweep_backend(
        cfg, K * fleet.nx_p, dtype, array_platform(X0)
    )
    cfg_n = dataclasses.replace(cfg, sweep_backend=backend)
    ms, res = time_solve(
        lambda: _solve_distributed(
            fleet, cfg_n, K, None, cost, X0, U0, rad, ign
        ),
        reps=reps,
    )
    return ms, backend, int(np.asarray(res.iters).sum()), bool(res.truncated)


def _model_family_points(dtl, cfg, N, dt, radius, time_solve):
    """BASELINE.json configs 3 + 5: the heterogeneous
    DoubleInt4D+Car3D+Bike5D fleet and the quadcopter swarm
    (Quad6D at 64 agents = config 5's nearest runnable single-chip form,
    plus Quad12D points).  Each reports its RESOLVED sweep backend."""
    import jax.numpy as jnp

    dtype = jnp.float32
    out = {}

    # Config 5: Quad6D swarm, 3D local-crossing scenario.  Spacing 0.85
    # couples the axis neighbors (<= 7-agent neighborhoods) while keeping
    # jittered face diagonals outside the 2*radius threshold, so K=8
    # never truncates.
    n = 64
    x0q, xfq = _grid3d_scenario(n, spacing=0.85, nx=6)
    fleetq = dtl.homogeneous_fleet(dtl.QUAD_6D, n, dt)
    costq = dtl.make_game_cost(
        jnp.asarray(xfq, dtype),
        jnp.asarray(np.tile(np.eye(6), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(np.eye(3), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(1e3 * np.eye(6), (n, 1, 1)), dtype),
        radius=radius,
        n_pos=np.full((n,), 3, np.int32),
    )
    ms, backend, iters, trunc = _distributed_point(
        dtl, fleetq, costq, x0q, N, radius, 8, cfg, time_solve
    )
    assert not trunc, "quad6d_64 truncated"
    out.update({
        "ms_quad6d_64_distributed": round(ms, 3),
        "hz_quad6d_64_distributed": round(1000.0 / ms, 2),
        "backend_quad6d_64": backend,
        "iters_quad6d_64": iters,
    })

    # Quad12D point (config 5's full-state model).  K=8 covers the 3D
    # grid neighborhoods (nxf = 96).
    n = 16
    x0q, xfq = _grid3d_scenario(n, spacing=0.85, nx=12)
    fleetq = dtl.homogeneous_fleet(dtl.QUAD_12D, n, dt)
    costq = dtl.make_game_cost(
        jnp.asarray(xfq, dtype),
        jnp.asarray(np.tile(np.eye(12), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(1e3 * np.eye(12), (n, 1, 1)), dtype),
        radius=radius,
        n_pos=np.full((n,), 3, np.int32),
    )
    ms, backend, iters, trunc = _distributed_point(
        dtl, fleetq, costq, x0q, N, radius, 8, cfg, time_solve
    )
    assert not trunc, "quad12d_16 truncated"
    out.update({
        "ms_quad12d_16_distributed": round(ms, 3),
        "hz_quad12d_16_distributed": round(1000.0 / ms, 2),
        "backend_quad12d_16": backend,
        "iters_quad12d_16": iters,
    })

    # Quad12D AT SWARM SCALE (BASELINE config 5's 50-100 agents): 64
    # agents on a 3D pairwise-swap grid at spacing 1.25, where only swap
    # partners (and occasional chains) couple -- neighborhoods <= 4, so
    # K=4 gives nxf = 48.
    n = 64
    x0q, xfq = _grid3d_scenario(n, spacing=1.25, nx=12)
    fleetq = dtl.homogeneous_fleet(dtl.QUAD_12D, n, dt)
    costq = dtl.make_game_cost(
        jnp.asarray(xfq, dtype),
        jnp.asarray(np.tile(np.eye(12), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(1e3 * np.eye(12), (n, 1, 1)), dtype),
        radius=radius,
        n_pos=np.full((n,), 3, np.int32),
    )
    ms, backend, iters, trunc = _distributed_point(
        dtl, fleetq, costq, x0q, N, radius, 4, cfg, time_solve
    )
    assert not trunc, "quad12d_64 truncated"
    out.update({
        "ms_quad12d_64_distributed": round(ms, 3),
        "hz_quad12d_64_distributed": round(1000.0 / ms, 2),
        "backend_quad12d_64": backend,
        "iters_quad12d_64": iters,
    })

    # Full-state Quad12D at K=8 (nxf=96): the DENSE quadrotor swarm --
    # the spacing-0.85 local-crossing grid quad6d_64 uses, neighborhoods
    # up to 8.  Own guard: a failure must not sink the rest of the
    # section.
    try:
        x0q8, xfq8 = _grid3d_scenario(n, spacing=0.85, nx=12)
        costq8 = dtl.make_game_cost(
            jnp.asarray(xfq8, dtype),
            jnp.asarray(np.tile(np.eye(12), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(np.eye(4), (n, 1, 1)), dtype),
            jnp.asarray(np.tile(1e3 * np.eye(12), (n, 1, 1)), dtype),
            radius=radius,
            n_pos=np.full((n,), 3, np.int32),
        )
        ms, backend, iters, trunc = _distributed_point(
            dtl, fleetq, costq8, x0q8, N, radius, 8, cfg, time_solve
        )
        assert not trunc, "quad12d_64_k8 truncated"
        out.update({
            "ms_quad12d_64_k8_distributed": round(ms, 3),
            "hz_quad12d_64_k8_distributed": round(1000.0 / ms, 2),
            "backend_quad12d_64_k8": backend,
            "iters_quad12d_64_k8": iters,
        })
    except Exception as e:  # noqa: BLE001 -- diagnostic, not control
        print(f"quad12d_64_k8 point failed: {e!r:.300}", file=sys.stderr)
        out["quad12d_64_k8_error"] = f"{e!s:.200}"

    # Config 3: heterogeneous DoubleInt4D + Car3D + Bike5D fleet (zero-
    # padded states; Bike5D's rk4_substeps=1 vs 5 elsewhere; nxf=40).
    n = 99
    x0h, xfh = _swap_scenario(n, spacing=0.75)
    models = [dtl.DOUBLE_INT_4D, dtl.CAR_3D, dtl.BIKE_5D] * (n // 3)
    fleeth = dtl.Fleet(tuple(models), dt)
    nx_p = fleeth.nx_p
    x0p = np.zeros((n, nx_p))
    x0p[:, :2] = x0h[:, :2]
    xfp = np.zeros((n, nx_p))
    xfp[:, :2] = xfh[:, :2]
    costh = dtl.make_game_cost(
        jnp.asarray(xfp, dtype),
        jnp.asarray(np.tile(np.eye(nx_p), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(np.eye(fleeth.nu_p), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(1e3 * np.eye(nx_p), (n, 1, 1)), dtype),
        radius=radius,
    )
    ms, backend, iters, trunc = _distributed_point(
        dtl, fleeth, costh, x0p, N, radius, 8, cfg, time_solve
    )
    assert not trunc, "hetero_99 truncated"
    out.update({
        "ms_hetero_99_distributed": round(ms, 3),
        "hz_hetero_99_distributed": round(1000.0 / ms, 2),
        "backend_hetero_99": backend,
        "iters_hetero_99": iters,
    })
    return out


def device_line() -> str:
    """The device as JAX reports it, and the card as ``nvidia-smi`` does."""
    import subprocess

    import jax

    d = jax.devices()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        card = "no nvidia-smi"
    return (
        f"device: platform={d[0].platform} kind={d[0].device_kind} "
        f"count={len(d)} card={card!r}"
    )


def main():
    import jax
    import jax.numpy as jnp

    import dpilqr_tpu as dtl
    from dpilqr_tpu.parallel.distributed import _solve_distributed

    N, dt, radius, K = 50, 0.1, 0.5, 8
    dtype = jnp.float32
    cfg = dtl.SolverConfig(n_lqr_iter=15, tol=1e-3)

    def build(n):
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
        return fleet, cost, x0, X0, U0

    def time_solve(fn, reps=20):
        """Median wall milliseconds per solve over ``reps`` timed calls,
        each ending in ``block_until_ready``, after one warm-up call."""
        out = jax.block_until_ready(fn())  # warm-up / compile
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), out

    import dataclasses

    from dpilqr_tpu.ops.ilqr import array_platform, resolve_sweep_backend

    print(device_line(), flush=True)

    points = {}  # n -> {"ms", "backend", "iters"}
    builds = {}
    for n in (50, 100, 250, 500):
        fleet, cost, x0, X0, U0 = build(n)
        builds[n] = (fleet, cost, x0)
        rad = jnp.asarray(radius, dtype)
        ign = jnp.zeros((n,), bool)
        backend = resolve_sweep_backend(
            cfg, K * fleet.nx_p, dtype, array_platform(X0)
        )
        cfg_n = dataclasses.replace(cfg, sweep_backend=backend)

        def solve(fleet=fleet, cost=cost, X0=X0, U0=U0, rad=rad, ign=ign,
                  cfg_n=cfg_n):
            return _solve_distributed(
                fleet, cfg_n, K, None, cost, X0, U0, rad, ign
            )

        ms, res = time_solve(solve, reps=20 if n <= 100 else 10)
        assert not bool(res.truncated), (
            f"neighborhood truncated at n={n}, K={K}: benchmark invalid"
        )
        points[n] = {
            "ms": ms,
            "backend": backend,
            "iters": int(np.asarray(res.iters).sum()),
            "J": float(np.asarray(res.J)),
        }

    # Sustained closed-loop MPC rate: receding-horizon steps of solve_rhc
    # (graph build, gather, batched solve, owner extraction, advance,
    # warm-start shift, per-step host sync).  100 agents uses honest
    # auto-K; 250/500 pin K=8 (auto-K's width-growth sequence would
    # compile several widths, blowing the bench budget) and assert
    # the pin was wide enough -- truncation would make the numbers
    # meaningless.  Each point is guarded: a failure records an error
    # instead of costing the round the headline artifact.
    cl_extra = {}

    def _cl_point(name, n, n_steps, K_pin, model="unicycle", t_kill=None):
        try:
            ms, res = closed_loop_run(
                n=n, n_steps=n_steps, N=N, dt=dt, radius=radius, K=K_pin,
                cfg=cfg, model=model, t_kill=t_kill,
            )
            if K_pin is not None:
                mx = max(
                    max(len(v) for v in s.graph.values()) for s in res.steps
                )
                assert mx <= K_pin, f"{name} truncated: max nbhd {mx}"
            cl_extra[f"ms_per_mpc_step_{name}"] = round(ms, 3)
            cl_extra[f"hz_mpc_{name}"] = round(1000.0 / ms, 2)
            if t_kill is not None:
                # Reference realtime contract (analysis.py:145-148):
                # every solve capped at t_kill = dt.  Report how often the
                # deadline actually binds.
                capped = np.mean(
                    [s.solve_time > t_kill for s in res.steps]
                )
                cl_extra[f"deadline_capped_frac_{name}"] = round(
                    float(capped), 3
                )
        except Exception as e:  # noqa: BLE001 -- diagnostic, not control
            print(f"closed-loop {name} failed: {e!r:.300}", file=sys.stderr)
            cl_extra[f"mpc_{name}_error"] = f"{e!s:.200}"

    # Selfish-warmstart cold solves (reference problem.py:66-91): the
    # reference's own per-agent solo warm start, batched here as ONE
    # singleton-graph solve, followed by the coupled distributed solve.
    # Timed END TO END (warmstart included); scripts/bench_warmstart.py
    # measures both side by side, and the zero-warmstart series above
    # stays canonical.
    def _ws_points():
        from dpilqr_tpu.parallel.rhc import selfish_warmstart

        out = {}
        for n in (100, 250, 500):
            fleet, cost, x0 = builds[n]
            x0j = jnp.asarray(x0, dtype)
            X0 = jnp.broadcast_to(x0j[None], (N + 1, n, 4))
            rad = jnp.asarray(radius, dtype)
            ign = jnp.zeros((n,), bool)
            backend = resolve_sweep_backend(
                cfg, K * fleet.nx_p, dtype, array_platform(X0)
            )
            cfg_n = dataclasses.replace(cfg, sweep_backend=backend)

            def solve_ws(fleet=fleet, cost=cost, x0j=x0j, X0=X0, rad=rad,
                         ign=ign, cfg_n=cfg_n, n=n):
                Uw = selfish_warmstart(fleet, cost, x0j, N, config=cfg_n)
                return _solve_distributed(
                    fleet, cfg_n, K, None, cost, X0, Uw, rad, ign
                )

            ms, res = time_solve(solve_ws, reps=10)
            assert not bool(res.truncated)
            out[f"ms_{n}_distributed_ws"] = round(ms, 3)
            out[f"hz_{n}_distributed_ws"] = round(1000.0 / ms, 2)
            out[f"iters_{n}_distributed_ws"] = int(
                np.asarray(res.iters).sum()
            )
            # Solution-quality ratio vs the zero-warmstart solve: < 1
            # means the warmstarted solve found a BETTER joint optimum.
            out[f"J_ws_over_cold_{n}"] = round(
                float(np.asarray(res.J)) / points[n]["J"], 3
            )
        return out

    _cl_point("100", 100, 20, None)
    _cl_point("250", 250, 20, 8)
    _cl_point("500", 500, 15, 8)
    # The quadrotor swarm closed loop (honest auto-K) and the reference's
    # realtime analysis mode t_kill=dt (the deadline path).
    _cl_point("quad6d_64", 64, 20, None, model="quad6d")
    _cl_point("100_tkill", 100, 20, 8, t_kill=dt)

    # 10-agent centralized (round-1 headline metric, kept for continuity).
    rng = np.random.default_rng(12345)
    x0c, xfc = dtl.random_setup(10, 4, rng=rng, energy=10.0, n_d=2)
    fleet10 = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, 10, dt)
    cost10 = dtl.make_game_cost(
        jnp.asarray(xfc, dtype),
        jnp.asarray(np.tile(np.eye(4), (10, 1, 1)), dtype),
        jnp.asarray(np.tile(np.eye(2), (10, 1, 1)), dtype),
        jnp.asarray(np.tile(1e3 * np.eye(4), (10, 1, 1)), dtype),
        radius=radius,
    )
    cfg10 = dtl.SolverConfig(n_lqr_iter=15, tol=1e-9)
    backend10 = resolve_sweep_backend(
        cfg10, 10 * fleet10.nx_p, dtype, jax.default_backend()
    )
    solve10 = dtl.make_solver(fleet10, N, cfg10)
    U0c = jnp.zeros((N, 10, 2), dtype)
    x0cj = jnp.asarray(x0c, dtype)
    ms10, res10 = time_solve(lambda: solve10(cost10, x0cj, U0c))

    # Baseline: the reference algorithm (numpy oracle) solving ONE K-slot
    # subproblem; the reference runs the n subproblems sequentially
    # (distributed.py:56-77), so its projected cost is per-iteration time
    # x total subproblem iterations of the 100-agent solve.
    sys.path.insert(0, "tests")
    from oracle import OracleGameCost, OracleMultiModel, oracle_ilqr

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
    base_per_iter_ms = (time.perf_counter() - t0) * 1e3 / max(base_iters, 1)
    # Calibration from the one-time END-TO-END baseline measurement
    # (scripts/measure_baseline.py, recorded in BASELINE.md): the real
    # sequential run over all 100 neighborhood subproblems took 0.455x the
    # K=8-projection (neighborhoods average ~4.9 agents, not 8).  Scaling
    # keeps the per-round projection cheap while anchoring it to a measured
    # run -- and makes the claimed speedup conservative.
    MEASURED_OVER_PROJECTED = 0.455
    base_100_ms = (
        base_per_iter_ms * points[100]["iters"] * MEASURED_OVER_PROJECTED
    )

    # North-star counter: Riccati block-nnz/s of the 100-agent solve
    # (utils/metrics.py): nonzero block entries touched per second by the
    # backward sweeps actually executed.
    from dpilqr_tpu.utils.metrics import riccati_block_nnz

    nnz = riccati_block_nnz(n_agents=K, nx=4, nu=2, N=N) * points[100]["iters"]
    block_nnz_per_s = nnz / (points[100]["ms"] / 1e3)

    extra = {
        **cl_extra,
        "ms_10_centralized": round(ms10, 3),
        "backend_10_centralized": backend10,
        "iters_10_centralized": int(np.asarray(res10.iters)),
        "subproblem_iters_100": points[100]["iters"],
        "riccati_block_nnz_per_s": float(f"{block_nnz_per_s:.3e}"),
        "truncated_any": False,  # asserted per distributed point above
    }
    for n, p in points.items():
        extra[f"ms_{n}_distributed"] = round(p["ms"], 3)
        extra[f"hz_{n}_distributed"] = round(1000.0 / p["ms"], 2)
        extra[f"backend_{n}_distributed"] = p["backend"]
        extra[f"iters_{n}_distributed"] = p["iters"]

    # BASELINE.json configs 3 + 5.  These sections are SUPPLEMENTARY: a
    # failure must not cost the run its headline artifact -- log to stderr
    # and emit partial extras instead.
    for section in (
        _ws_points,
        lambda: _model_family_points(dtl, cfg, N, dt, radius, time_solve),
    ):
        try:
            extra.update(section())
        except Exception as e:  # noqa: BLE001 -- diagnostic, not control
            print(f"bench section failed: {e!r:.300}", file=sys.stderr)
            extra["section_error"] = f"{e!s:.200}"

    # Self-verifying completeness: the guarded
    # sections can demote a point to an error string; compare against the
    # canonical key set so a thinner-than-intended artifact says so
    # ITSELF.  The headline (100-agent cold solve) is computed unguarded
    # above -- its failure already exits nonzero.
    canonical = [
        "ms_per_mpc_step_100", "ms_per_mpc_step_250", "ms_per_mpc_step_500",
        "ms_per_mpc_step_quad6d_64", "ms_per_mpc_step_100_tkill",
        "deadline_capped_frac_100_tkill",
        "ms_10_centralized", "riccati_block_nnz_per_s",
        "ms_50_distributed", "ms_100_distributed", "ms_250_distributed",
        "ms_500_distributed", "ms_500_distributed_ws",
        "ms_quad6d_64_distributed", "ms_quad12d_16_distributed",
        "ms_quad12d_64_distributed", "ms_quad12d_64_k8_distributed",
        "ms_hetero_99_distributed",
    ]
    missing = [k for k in canonical if extra.get(k) is None]
    if missing:
        extra["incomplete"] = missing

    print(
        json.dumps(
            {
                "metric": (
                    "dp-ilqr distributed solve, 100 unicycles "
                    "(K=8 neighborhoods), N=50"
                ),
                "value": round(points[100]["ms"], 3),
                "unit": "ms",
                "vs_baseline": round(base_100_ms / points[100]["ms"], 3),
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
