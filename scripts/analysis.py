#!/usr/bin/env python
"""Monte-Carlo benchmark: centralized vs distributed receding-horizon solves
on random setups.

Reproduces the reference's benchmark procedure (scripts/analysis.py:126-174):
trials x agent counts x models, paired centralized/distributed runs from the
same initial conditions, CSV rows in the reference schema plus JSON-lines
solver metrics.

Usage:
  python scripts/analysis.py                 # full sweep (reference params)
  python scripts/analysis.py --quick         # tiny smoke sweep
  python scripts/analysis.py --realtime      # mode 2: t_kill = dt cap
  python scripts/analysis.py --cpu           # force CPU backend
"""

import argparse
from pathlib import Path
from time import strftime

import numpy as np

import dpilqr_tpu as dtl
from dpilqr_tpu.utils.metrics import JsonlWriter, csv_row, setup_csv_logger

# Reference sweep parameters (analysis.py:128-151).
DT = 0.1
N = 50
ENERGY = 10.0
RADIUS = 0.5
STEP_SIZE = 3

MODELS = {
    "DoubleIntDynamics4D": (dtl.DOUBLE_INT_4D, 4, 2),
    "UnicycleDynamics4D": (dtl.UNICYCLE_4D, 4, 2),
    "QuadcopterDynamics6D": (dtl.QUAD_6D, 6, 3),
}


def build_problem(model_spec, n_states, n_agents, rng):
    x0, xf = dtl.random_setup(
        n_agents, n_states, rng=rng, energy=ENERGY, n_d=2,
        rel_dist=2.0, var=n_agents / 2,
    )
    fleet = dtl.homogeneous_fleet(model_spec, n_agents, DT)
    n_controls = fleet.nu_p
    Q = np.eye(n_states)
    R = np.eye(n_controls)
    Qf = 1e3 * np.eye(n_states)
    cost = dtl.make_game_cost(
        xf,
        np.tile(Q, (n_agents, 1, 1)),
        np.tile(R, (n_agents, 1, 1)),
        np.tile(Qf, (n_agents, 1, 1)),
        radius=RADIUS,
        n_pos=np.full(n_agents, 2),
    )
    return fleet, cost, x0, xf


def multi_agent_run(
    model_name, n_agents, i_trial, logger, jsonl, rng, t_kill=None,
    t_diverge=None,
):
    """Paired centralized/distributed RHC comparison
    (reference analysis.py:35-107)."""
    spec, n_states, _ = MODELS[model_name]
    fleet, cost, x0, xf = build_problem(spec, n_states, n_agents, rng)
    ids = list(range(n_agents))

    results = {}
    for centralized in (True, False):

        def log_step(info, centralized=centralized):
            logger.info(
                csv_row(
                    model_name, n_agents, i_trial, centralized, False,
                    info.t, info.J, N, DT, True, ids,
                    [round(info.solve_time, 4)],
                    [info.graph[k] for k in info.graph] if info.graph else [ids],
                    [round(d, 4) for d in info.distance_left],
                )
            )

        res = dtl.solve_rhc(
            fleet, cost, x0, N,
            radius=RADIUS, centralized=centralized, step_size=STEP_SIZE,
            dist_converge=0.1, t_diverge=t_diverge or N * DT,
            t_kill=t_kill, rng=np.random.default_rng(i_trial),
            log_fn=log_step,
        )
        tf = res.U.shape[0] * DT
        final_dist = np.linalg.norm(
            res.X[-1][:, :2] - np.asarray(cost.xf)[:, :2], axis=1
        )
        logger.info(
            csv_row(
                model_name, n_agents, i_trial, centralized, True,
                tf, res.J, N, DT, res.converged, ids,
                [round(s.solve_time, 4) for s in res.steps[-1:]],
                [], [round(float(d), 4) for d in final_dist],
            )
        )
        jsonl.write(
            {
                "model": model_name,
                "n_agents": n_agents,
                "trial": i_trial,
                "centralized": centralized,
                "J": res.J,
                "converged": res.converged,
                "tf": tf,
                "mean_solve_time": float(
                    np.mean([s.solve_time for s in res.steps])
                )
                if res.steps
                else None,
                "n_mpc_steps": len(res.steps),
            }
        )
        results[centralized] = res
    return results


def monte_carlo_analysis(args):
    logdir = Path("logs")
    logdir.mkdir(exist_ok=True)
    mode = 2 if args.realtime else 1
    stamp = strftime("%Y%m%d%H%M%S")
    logger = setup_csv_logger(logdir / f"dec-mc-{mode}_{stamp}.csv")
    jsonl = JsonlWriter(logdir / f"dec-mc-{mode}_{stamp}.jsonl")

    n_trials = 1 if args.quick else 2
    agent_range = [3] if args.quick else [3, 4, 5, 6, 7]
    models = (
        ["DoubleIntDynamics4D"] if args.quick else list(MODELS)
    )
    t_kill = DT if args.realtime else None
    t_diverge = N * DT if args.realtime else 3 * N * DT

    rng = np.random.default_rng(args.seed)
    for model_name in models:
        for n_agents in agent_range:
            for trial in range(n_trials):
                print(f"=== {model_name} n={n_agents} trial={trial}")
                multi_agent_run(
                    model_name, n_agents, trial, logger, jsonl, rng,
                    t_kill=t_kill, t_diverge=t_diverge,
                )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny smoke sweep")
    ap.add_argument(
        "--realtime", action="store_true",
        help="mode 2: cap each solve at t_kill = dt (reference analysis.py:145-150)",
    )
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_default_device", jax.devices("cpu")[0])
    monte_carlo_analysis(args)


if __name__ == "__main__":
    main()
