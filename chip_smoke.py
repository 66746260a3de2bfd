#!/usr/bin/env python
"""Bring-up check: the DP-iLQR main path on an NVIDIA GPU.

    python chip_smoke.py           # one card: phases 1-4
    python chip_smoke.py --four    # four cards: the sharded phase only

One process drives the card(s).  Phases, in order:

1. device: JAX must find a GPU (anything else exits nonzero); prints the
   device kind and count, the card's name and power limit from
   ``nvidia-smi``, and the compilation-cache directory.
2. main path, float32, through the public entry points at the sizes
   bench.py defines: the 500-agent Unicycle4D distributed solve (K=8,
   N=50), a 500-agent ``solve_rhc`` closed loop, the 64-agent Quad6D swarm,
   the 99-agent DoubleInt4D+Car3D+Bike5D fleet, the 10-agent centralized
   solve, a 100-agent ``t_kill = dt`` deadline solve, and (reported only)
   Quad12D.  Each prints its compile seconds, the median wall ms of 5 warm
   repeats, the summed subproblem iterations, the converged fraction and J.
3. correctness on the card: the 10-agent centralized solve in float64
   against the NumPy oracle (tests/oracle.py, on the host); the 500-agent
   float32 solve against the same solve in float64; the Triton sweep
   kernel against the plain XLA sweep at the 500-agent shapes.
4. kernel decision: ``solve_distributed`` end to end with the plain XLA
   sweep and with the Triton sweep, in turns (plain, kernel, kernel,
   plain), at 100 and 500 Unicycle4D agents and the 64-agent Quad6D swarm.

``--four`` runs ``solve_distributed_sharded`` and ``solve_trials_sharded``
on a 4-card mesh against the same calls on one card, and nothing else.

The last stdout line is ``{"ok": true, "device": {...}}``.  A failing phase
raises, so the script then exits nonzero and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

N, DT, RADIUS, K = 50, 0.1, 0.5, 8
REPS = 5
# Fleet sizes of the bench.py workloads.
SIZES = {"headline": 500, "closed_loop": 500, "quad6d": 64, "hetero": 99,
         "deadline": 100, "quad12d": 16, "decision_small": 100,
         "trials": 64}


# ---------------------------------------------------------------------------
# Host helpers (no JAX).
# ---------------------------------------------------------------------------


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``(name, power limit)`` per card from the output of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    rows = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        rows.append((name.strip(), limit.strip()))
    if not rows:
        raise ValueError("nvidia-smi listed no GPU")
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return "card: " + "; ".join(
        f"{name}, {limit}" for name, limit in parse_nvidia_smi(out)
    )


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True,
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def require_gpu(devices) -> None:
    """Exit nonzero unless JAX's first device is a GPU: nothing here may
    carry on on the CPU."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found {platform!r}"
        )


def import_repo():
    """The solver package of THIS checkout (a copy of this script alone,
    or one that would pick up an installed package, must fail)."""
    sys.path.insert(0, str(HERE))
    import dpilqr_tpu

    if Path(dpilqr_tpu.__file__).resolve().parent.parent != HERE:
        raise SystemExit(
            f"chip_smoke: dpilqr_tpu imported from {dpilqr_tpu.__file__}, "
            f"not from {HERE}"
        )
    return dpilqr_tpu


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


# ---------------------------------------------------------------------------
# Problems (the bench.py scenarios).
# ---------------------------------------------------------------------------


def _cost(dtl, jnp, xf, nx, nu, dtype, n_pos=None):
    n = xf.shape[0]
    import numpy as np

    return dtl.make_game_cost(
        jnp.asarray(xf, dtype),
        jnp.asarray(np.tile(np.eye(nx), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(np.eye(nu), (n, 1, 1)), dtype),
        jnp.asarray(np.tile(1e3 * np.eye(nx), (n, 1, 1)), dtype),
        radius=RADIUS,
        n_pos=n_pos,
    )


def distributed_problem(dtl, jnp, kind: str, n: int, dtype):
    """``(fleet, cost, X0, U0)`` of one bench.py distributed workload."""
    import numpy as np

    from bench import _grid3d_scenario, _grid_scenario, _swap_scenario

    if kind == "unicycle":
        x0, xf = _grid_scenario(n)
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, DT)
        cost = _cost(dtl, jnp, xf, 4, 2, dtype)
    elif kind in ("quad6d", "quad12d"):
        nx = 6 if kind == "quad6d" else 12
        x0, xf = _grid3d_scenario(n, spacing=0.85, nx=nx)
        model = dtl.QUAD_6D if kind == "quad6d" else dtl.QUAD_12D
        fleet = dtl.homogeneous_fleet(model, n, DT)
        cost = _cost(dtl, jnp, xf, nx, fleet.nu_p, dtype,
                     n_pos=np.full((n,), 3, np.int32))
    elif kind == "hetero":
        xs, xfs = _swap_scenario(n, spacing=0.75)
        models = [dtl.DOUBLE_INT_4D, dtl.CAR_3D, dtl.BIKE_5D] * (n // 3)
        fleet = dtl.Fleet(tuple(models), DT)
        x0 = np.zeros((n, fleet.nx_p))
        x0[:, :2] = xs[:, :2]
        xf = np.zeros((n, fleet.nx_p))
        xf[:, :2] = xfs[:, :2]
        cost = _cost(dtl, jnp, xf, fleet.nx_p, fleet.nu_p, dtype)
    else:
        raise ValueError(kind)
    X0 = jnp.broadcast_to(
        jnp.asarray(x0, dtype)[None], (N + 1, n, fleet.nx_p)
    )
    U0 = jnp.zeros((N, n, fleet.nu_p), dtype)
    return fleet, cost, X0, U0


def centralized_problem(dtl, jnp, dtype):
    import numpy as np

    rng = np.random.default_rng(12345)
    x0, xf = dtl.random_setup(10, 4, rng=rng, energy=10.0, n_d=2)
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, 10, DT)
    return fleet, _cost(dtl, jnp, xf, 4, 2, dtype), x0, xf


# ---------------------------------------------------------------------------
# Measurement.
# ---------------------------------------------------------------------------


def measure(jax, fn, reps=REPS):
    """``(out, compile_s, median_ms)``: compile_s is the first call's wall
    time minus the warm median (compilation plus first-call set-up)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return out, first - med, med * 1e3


def peak_bytes(device) -> int:
    return device.memory_stats()["peak_bytes_in_use"]


def report(name, backend, compile_s, ms, iters, conv_frac, J):
    print(
        f"  {name}: backend={backend} compile_s={compile_s:.2f} "
        f"median_ms={ms:.3f} (of {REPS} warm) iters_sum={iters} "
        f"converged_frac={conv_frac:.4f} J={J:.6g}",
        flush=True,
    )


def backend_for(ilqr, cfg, nxf, dtype):
    """The sweep backend ``auto`` resolves to on the card."""
    return ilqr.resolve_sweep_backend(cfg, nxf, dtype, "gpu")


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_main_path(jax, jnp, np, dtl):
    from dpilqr_tpu.ops import ilqr

    print("phase 2: main path (float32)", flush=True)
    cfg = dtl.SolverConfig(n_lqr_iter=15, tol=1e-3)
    f32 = jnp.float32
    out = {}

    def distributed(name, kind, n, gate=True):
        fleet, cost, X0, U0 = distributed_problem(dtl, jnp, kind, n, f32)
        res, c_s, ms = measure(jax, lambda: dtl.solve_distributed(
            fleet, cost, X0, U0, RADIUS, K=K, config=cfg))
        J = float(res.J)
        report(name, backend_for(ilqr, cfg, K * fleet.nx_p, f32), c_s, ms,
               int(np.sum(res.iters)), float(np.mean(res.converged)), J)
        if gate:
            check(np.isfinite(J) and res.X.shape == (N + 1, n, fleet.nx_p)
                  and not bool(res.truncated) and int(np.sum(res.iters)) > 0,
                  f"{name}: finite J, X shape {(N + 1, n, fleet.nx_p)}, "
                  "no truncated neighborhood, iterations ran")
        return fleet, cost, X0, U0, res

    n_head = SIZES["headline"]
    fleet, cost, X0, U0, res500 = distributed(
        f"unicycle_{n_head}_distributed", "unicycle", n_head
    )
    out["headline"] = (fleet, cost, X0, U0, res500)

    # Device memory of the headline solve program.
    import dataclasses

    from dpilqr_tpu.parallel.distributed import _solve_distributed

    cfg_r = dataclasses.replace(
        cfg, sweep_backend=backend_for(ilqr, cfg, K * 4, f32)
    )
    compiled = _solve_distributed.lower(
        fleet, cfg_r, K, None, cost, X0, U0, jnp.asarray(RADIUS, f32),
        jnp.zeros((n_head,), bool),
    ).compile()
    print(f"  unicycle_{n_head} memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)

    # Closed loop: a few MPC steps of solve_rhc.
    from bench import _cl_problem

    fleet_cl, cost_cl, x0_cl = _cl_problem(SIZES["closed_loop"], DT, RADIUS)
    n_steps = 3

    def closed_loop():
        return dtl.solve_rhc(
            fleet_cl, cost_cl, x0_cl.astype(np.float32), N, radius=RADIUS,
            centralized=False, step_size=1, J_converge=1e-3,
            t_diverge=(n_steps - 1) * DT, K=K, config=cfg,
            rng=np.random.default_rng(0),
        )

    rhc, c_s, ms = measure(jax, closed_loop)
    iters = int(sum(int(np.sum(s.iters)) for s in rhc.steps))
    print(
        f"  unicycle_{SIZES['closed_loop']}_rhc: "
        f"backend={backend_for(ilqr, cfg, K * 4, f32)} "
        f"compile_s={c_s:.2f} median_ms={ms:.3f} per run of "
        f"{len(rhc.steps)} MPC steps (of {REPS} warm) iters_sum={iters} "
        f"run_converged={rhc.converged} J={rhc.J:.6g}",
        flush=True,
    )
    check(np.isfinite(rhc.J) and len(rhc.steps) >= 2 and iters > 0,
          "closed loop: finite J, several MPC steps, iterations ran")

    distributed(f"quad6d_{SIZES['quad6d']}_distributed", "quad6d",
                SIZES["quad6d"])
    distributed(f"hetero_{SIZES['hetero']}_distributed", "hetero",
                SIZES["hetero"])

    fleet10, cost10, x0c, _ = centralized_problem(dtl, jnp, f32)
    cfg10 = dtl.SolverConfig(n_lqr_iter=15, tol=1e-9)
    x0cj = jnp.asarray(x0c, f32)
    res10, c_s, ms = measure(jax, lambda: dtl.ilqr_solve(
        fleet10, cost10, x0cj, N=N, config=cfg10))
    report("centralized_10", backend_for(ilqr, cfg10, 40, f32), c_s, ms,
           int(res10.iters), float(res10.converged), float(res10.J))
    check(np.isfinite(float(res10.J)) and int(res10.iters) > 0,
          "centralized_10: finite J, iterations ran")

    # Deadline path: t_kill = dt (compiled without the
    # deadline first, so the capped runs measure solving, not compiling).
    fleet_d, cost_d, X0_d, U0_d = distributed_problem(
        dtl, jnp, "unicycle", SIZES["deadline"], f32
    )
    t0 = time.perf_counter()
    jax.block_until_ready(dtl.solve_distributed(
        fleet_d, cost_d, X0_d, U0_d, RADIUS, K=K, config=cfg, t_kill=1e9))
    first = time.perf_counter() - t0
    res_d, _, ms = measure(jax, lambda: dtl.solve_distributed(
        fleet_d, cost_d, X0_d, U0_d, RADIUS, K=K, config=cfg, t_kill=DT))
    report(f"unicycle_{SIZES['deadline']}_tkill_dt",
           backend_for(ilqr, cfg, K * 4, f32),
           first - ms / 1e3, ms, int(np.sum(res_d.iters)),
           float(np.mean(res_d.converged)), float(res_d.J))
    check(np.isfinite(float(res_d.J)) and int(np.max(res_d.iters)) > 0,
          "deadline solve: finite J, iterations ran within t_kill")

    # Quad12D (nxf = 96): reported, gates nothing -- its float32 XLA path
    # is known to stop after one iteration (ROADMAP).
    distributed(f"quad12d_{SIZES['quad12d']}_distributed (reported only)",
                "quad12d", SIZES["quad12d"], gate=False)
    return out


def phase_correctness(jax, jnp, np, dtl, headline):
    sys.path.insert(0, str(HERE / "tests"))
    from oracle import OracleGameCost, OracleMultiModel, oracle_ilqr

    print("phase 3: correctness on the card", flush=True)
    f64 = jnp.float64

    # (a) 10-agent centralized, float64 on the GPU vs the NumPy oracle.
    fleet10, cost10, x0c, xfc = centralized_problem(dtl, jnp, f64)
    cfg10 = dtl.SolverConfig(n_lqr_iter=15, tol=1e-9)
    res = dtl.ilqr_solve(fleet10, cost10, jnp.asarray(x0c, f64), N=N,
                         config=cfg10)
    eye = np.eye
    _, _, J_o, it_o, _ = oracle_ilqr(
        OracleMultiModel("Unicycle4D", 10, DT),
        OracleGameCost(xfc.flatten(), [eye(4)] * 10, [eye(2)] * 10,
                       [1e3 * eye(4)] * 10, RADIUS, 4, 2, 10),
        x0c.flatten(), N=N, n_lqr_iter=15, tol=1e-9,
    )
    rel = abs(float(res.J) - J_o) / abs(J_o)
    print(f"  centralized_10 float64: J={float(res.J):.12g} "
          f"oracle J={J_o:.12g} rel={rel:.3g} iters={int(res.iters)} "
          f"oracle iters={it_o}", flush=True)
    check(int(res.iters) == it_o and rel <= 1e-6,
          "centralized_10 float64 == oracle: same iteration count, J within "
          "rtol 1e-6, the oracle rtol of tests/test_robustness.py (the "
          "widest CPU parity test): this solve bails after 6 iterations "
          "with mu decayed toward zero, so float64 summation-order noise "
          "grows to ~1e-7 (CHANGES.md)")

    # (b) The headline float32 solve vs the same solve in float64.
    fleet, cost, X0, U0, res32 = headline
    cost64 = jax.tree.map(
        lambda a: a.astype(f64) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, cost)
    cfg = dtl.SolverConfig(n_lqr_iter=15, tol=1e-3)
    res64 = dtl.solve_distributed(fleet, cost64, X0.astype(f64),
                                  U0.astype(f64), RADIUS, K=K, config=cfg)
    J32, J64 = float(res32.J), float(res64.J)
    c32 = float(np.mean(res32.converged))
    c64 = float(np.mean(res64.converged))
    relJ = abs(J32 - J64) / abs(J64)
    n = X0.shape[1]
    print(f"  unicycle_{n} float32 J={J32:.9g} conv={c32:.4f}; float64 "
          f"J={J64:.9g} conv={c64:.4f}; rel J={relJ:.3g} "
          f"|d conv|={abs(c32 - c64):.3g}", flush=True)
    check(relJ <= 0.33 and abs(c32 - c64) <= 0.105,
          f"unicycle_{n} float32 ~ float64: joint J within rtol 0.33 and "
          "converged fraction within 0.105 -- 1.5x the largest gaps (0.22, "
          "0.07) of the same float32-vs-float64 comparison at 100 agents "
          "on the CPU, 3 seeds, where TF32 cannot occur: a 15-iteration "
          "solve that mostly does not converge amplifies rounding "
          "(CHANGES.md)")

    # (c) Triton sweep vs the plain sweep at the headline shapes.
    from dpilqr_tpu.ops.ilqr import _backward_pass
    from dpilqr_tpu.ops.riccati_triton import backward_pass_triton
    from dpilqr_tpu.parallel.deadline import _init_xla, _iterate_xla, _prep

    f32 = jnp.float32
    cfg_x = dtl.SolverConfig(n_lqr_iter=15, tol=1e-3, sweep_backend="xla")
    _, _, _, sub_cost, x0_s, U_s, mids_s, enabled = _prep(
        fleet, cfg_x, K, None, cost, X0, U0, jnp.asarray(RADIUS, f32),
        jnp.zeros((n,), bool),
    )
    carry = _init_xla(fleet, cfg_x, sub_cost, x0_s, U_s, mids_s, enabled)
    carry = _iterate_xla(fleet, cfg_x, sub_cost, mids_s, carry)

    def sweep(fn):
        def one(cost_b, mids_b, X, U, mu):
            def lin(x, u):
                return fleet.linearize_dyn(mids_b, x, u)

            return fn(lin, cost_b, X, U, mu)

        return jax.jit(jax.vmap(one))

    args = (sub_cost, mids_s, carry.X, carry.U, carry.mu)
    K_k, d_k = sweep(backward_pass_triton)(*args)
    K_x, d_x = sweep(_backward_pass)(*args)
    # float64 reference on the same (float32-rounded) inputs.
    args64 = jax.tree.map(
        lambda a: a.astype(f64) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, args)
    K_r, d_r = sweep(_backward_pass)(*args64)

    def rel(a, b):
        """Max error over the largest reference entry: globally, and the
        median over subproblems of the same ratio per subproblem."""
        a, b = a.astype(f64), b.astype(f64)
        axes = tuple(range(1, a.ndim))
        per = jnp.max(jnp.abs(a - b), axis=axes) / jnp.max(
            jnp.abs(b), axis=axes)
        return (float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b))),
                float(jnp.median(per)))

    err = {
        "kernel vs plain": (rel(K_k, K_x), rel(d_k, d_x)),
        "kernel vs float64": (rel(K_k, K_r), rel(d_k, d_r)),
        "plain vs float64": (rel(K_x, K_r), rel(d_x, d_r)),
    }
    print(f"  riccati_sweep at {K_k.shape[0]} subproblems x N={N}, error "
          "relative to the largest entry, as (max, median over "
          "subproblems) for K; d: " + "; ".join(
              f"{k} ({v[0][0]:.3g}, {v[0][1]:.3g}); ({v[1][0]:.3g}, "
              f"{v[1][1]:.3g})" for k, v in err.items()),
          flush=True)
    worst = max(err["kernel vs plain"][0][0], err["kernel vs plain"][1][0])
    bound = 2.0 * max(err["plain vs float64"][0][0],
                      err["plain vs float64"][1][0])
    check(worst <= bound,
          f"Triton sweep == plain sweep, float32 at HIGHEST: max relative "
          f"error {worst:.3g} <= {bound:.3g}, twice the plain float32 "
          "sweep's own worst error against the float64 sweep on the same "
          "inputs (the worst subproblems are ill-conditioned, so any two "
          "float32 orderings differ there by float32's own error)")


def phase_kernel_decision(jax, jnp, np, dtl):
    import dataclasses

    from dpilqr_tpu.parallel.distributed import _solve_distributed

    print("phase 4: kernel decision (solve_distributed, plain vs Triton)",
          flush=True)
    f32 = jnp.float32
    base = dtl.SolverConfig(n_lqr_iter=15, tol=1e-3)
    for kind, n in (("unicycle", SIZES["decision_small"]),
                    ("unicycle", SIZES["headline"]),
                    ("quad6d", SIZES["quad6d"])):
        name = f"{kind}_{n}"
        fleet, cost, X0, U0 = distributed_problem(dtl, jnp, kind, n, f32)
        rad = jnp.asarray(RADIUS, f32)
        ign = jnp.zeros((n,), bool)
        fns = {}
        for backend in ("xla", "triton"):
            cfg = dataclasses.replace(base, sweep_backend=backend)
            fns[backend] = (
                lambda cfg=cfg: _solve_distributed(
                    fleet, cfg, K, None, cost, X0, U0, rad, ign
                )
            )
            jax.block_until_ready(fns[backend]())  # compile
        times = {"xla": [], "triton": []}
        for backend in ("xla", "triton", "triton", "xla"):
            for _ in range(REPS):
                t0 = time.perf_counter()
                jax.block_until_ready(fns[backend]())
                times[backend].append((time.perf_counter() - t0) * 1e3)
        plain = statistics.median(times["xla"])
        kern = statistics.median(times["triton"])
        print(f"  {name}: plain_xla_median_ms={plain:.3f} "
              f"triton_median_ms={kern:.3f} speedup={plain / kern:.2f}x "
              f"({2 * REPS} calls each, turns plain,kernel,kernel,plain)",
              flush=True)


def phase_four(jax, jnp, np, dtl):
    """Both sharded entry points on 4 cards vs 1 card.  float64 (the XLA
    sweep) must agree to float64 tolerances: the sharding itself changes
    no arithmetic.  float32 (the Triton sweep) is held to the float32
    bound of phase 3: smaller per-card batches let library kernels sum in
    another order, and a solve that mostly does not converge amplifies
    that (on 4 virtual CPU devices too)."""
    from bench import _grid_scenario

    print("phase 5: sharded solves on a 4-card mesh vs one card", flush=True)
    devs = jax.devices()
    check(len(devs) >= 4, f"4 GPUs visible (found {len(devs)})")
    mesh4 = dtl.make_mesh(devs[:4])
    mesh1 = dtl.make_mesh(devs[:1])
    cfg = dtl.SolverConfig(n_lqr_iter=15, tol=1e-3)

    def sharded_call(dtype):
        fleet, cost, X0, U0 = distributed_problem(
            dtl, jnp, "unicycle", SIZES["headline"], dtype
        )
        return f"solve_distributed_sharded {X0.shape[1]} agents", (
            lambda mesh: dtl.solve_distributed_sharded(
                fleet, cost, X0, U0, RADIUS, mesh=mesh, K=K, config=cfg)
        )

    def trials_call(dtype):
        n_t, T = SIZES["trials"], 8
        costs, X_T, U_T = [], [], []
        for t in range(T):
            x0, xf = _grid_scenario(n_t, seed=t)
            costs.append(_cost(dtl, jnp, xf, 4, 2, dtype))
            X_T.append(np.broadcast_to(x0[None], (2, n_t, 4)))
            U_T.append(np.zeros((N, n_t, 2)))
        cost_T = jax.tree.map(lambda *ls: jnp.stack(ls), *costs)
        X_T = jnp.asarray(np.stack(X_T), dtype)
        U_T = jnp.asarray(np.stack(U_T), dtype)
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n_t, DT)
        return f"solve_trials_sharded {T}x{n_t} agents", (
            lambda mesh: dtl.solve_trials_sharded(
                fleet, cost_T, X_T, U_T, RADIUS, mesh=mesh, K=K, config=cfg)
        )

    runs = [
        (jnp.float64, sharded_call), (jnp.float64, trials_call),
        (jnp.float32, sharded_call),
    ]
    results = []
    for dtype, make in runs:
        name, call = make(dtype)
        name = f"{name} {jnp.dtype(dtype).name}"
        r4, c_s, ms4 = measure(jax, lambda: call(mesh4), reps=2)
        print(f"  {name}, 4 cards: compile_s={c_s:.2f} median_ms={ms4:.3f}; "
              f"J sharding {r4.J.sharding}; iters sharding "
              f"{r4.iters.sharding}", flush=True)
        results.append((name, dtype, call, r4))
    # Read before the one-card runs, which use card 0 again.
    peaks = [peak_bytes(d) for d in devs[:4]]
    print(f"  peak_bytes_in_use per card: {peaks}", flush=True)
    check(all(p > 0 for p in peaks), "memory used on all four cards")

    for name, dtype, call, r4 in results:
        r1, _, ms1 = measure(jax, lambda: call(mesh1), reps=2)
        J4, J1 = np.asarray(r4.J), np.asarray(r1.J)
        relJ = float(np.max(np.abs(J4 - J1) / np.abs(J1)))
        dX = float(np.max(np.abs(np.asarray(r4.X) - np.asarray(r1.X))))
        same = float(np.mean(np.asarray(r4.iters) == np.asarray(r1.iters)))
        dconv = abs(float(np.mean(r4.converged)) - float(np.mean(r1.converged)))
        print(f"  {name}, 1 card: median_ms={ms1:.3f}; 4 vs 1: max rel J "
              f"diff={relJ:.3g} max |dX|={dX:.3g} identical iteration "
              f"counts={same:.4f} |d conv|={dconv:.3g}", flush=True)
        if dtype == jnp.float64:
            check(relJ <= 1e-9 and dX <= 1e-8 and same == 1.0,
                  f"{name}: 4 cards == 1 card (J rtol 1e-9, X atol 1e-8, "
                  "identical iteration counts: the tolerances of "
                  "tests/test_sharding.py)")
        else:
            check(relJ <= 0.33 and dconv <= 0.105,
                  f"{name}: 4 cards ~ 1 card within phase 3's float32 "
                  "bound (J rtol 0.33, converged fraction within 0.105)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices)
    dtl = import_repo()
    import jax.numpy as jnp
    import numpy as np

    from dpilqr_tpu.config import compilation_cache_dir

    print("phase 1: device", flush=True)
    d0 = devices[0]
    print(f"  platform={d0.platform} device_kind={d0.device_kind} "
          f"count={len(devices)}", flush=True)
    print(card_line(), flush=True)
    print(f"  compilation cache: {compilation_cache_dir()}", flush=True)

    t_start = time.perf_counter()
    if args.four:
        phase_four(jax, jnp, np, dtl)
    else:
        out = phase_main_path(jax, jnp, np, dtl)
        phase_correctness(jax, jnp, np, dtl, out["headline"])
        phase_kernel_decision(jax, jnp, np, dtl)
    print(f"phases done in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(result_line(d0.platform, d0.device_kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
