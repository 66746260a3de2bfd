#!/usr/bin/env python
"""Run the GENUINE reference package and close the parity chain.

VERDICT r2 item 8: all solver parity was previously proven against
``tests/oracle.py`` -- a transcription of the reference algorithm.  This
tool runs the real package at /root/reference (its Python layers unmodified,
its C++ kernel compiled verbatim through tools/refcheck/ref_wrapper.cpp)
on deterministic scenarios and asserts that:

  1. the oracle reproduces the genuine package's trajectories/costs
     (float64, ~1e-7), and
  2. this framework (CPU float64 path) reproduces them too.

Scenarios: the reference's own ``single_unicycle`` (scripts/examples.py:
26-46, minus plotting) and a deterministic 3-agent unicycle potential game.

Writes tools/refcheck/RESULT.json and exits nonzero on any mismatch.
"""

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, "..", ".."))
REF = "/root/reference"


def build_so():
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    so = os.path.join(build, "libbbref.so")
    src = os.path.join(HERE, "ref_wrapper.cpp")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    subprocess.run(
        [
            "g++", "-O2", "-shared", "-fPIC",
            "-I", os.path.join(REF, "dpilqr"),
            src, "-o", so,
        ],
        check=True,
    )
    return so


def import_genuine_dpilqr():
    import importlib.util

    os.environ.setdefault("MPLBACKEND", "Agg")
    spec = importlib.util.spec_from_file_location(
        "dpilqr.bbdynamicswrap",
        os.path.join(HERE, "bbdynamicswrap_shim.py"),
    )
    shim = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(shim)
    sys.modules["dpilqr.bbdynamicswrap"] = shim
    sys.path.insert(0, REF)
    import dpilqr  # noqa: E402  (the genuine package)

    assert os.path.dirname(dpilqr.__file__) == os.path.join(REF, "dpilqr")
    return dpilqr


def scenario_3agent():
    """Deterministic 3-unicycle crossing game (no RNG).

    Lateral offsets keep every Riccati ``Q_uu`` solve well conditioned.
    With head-on starts (zero offsets) the zero-control warm start parks
    all three agents deep inside the proximity radius, the indefinite
    prox Hessian (x200) blows ``P`` up and one backward step hits
    cond(Q_uu) ~ 1e13 -- at which point 1e-16 BLAS-ordering noise between
    ANY two implementations amplifies to macroscopically different gains
    (measured: genuine / oracle match to 1e-14 per-step up to that solve,
    then diverge).  Parity claims are only meaningful on well-conditioned
    problems; this one still exercises active proximity coupling
    (8 iLQR iterations, curved avoidance trajectories)."""
    x0 = np.array(
        [
            [-1.2, 0.3, 0.4, 0.0],
            [1.2, -0.3, 0.4, np.pi],
            [0.3, 1.2, 0.4, -np.pi / 2],
        ]
    )
    xf = np.array(
        [
            [1.2, 0.3, 0.0, 0.0],
            [-1.2, -0.3, 0.0, np.pi],
            [0.3, -1.2, 0.0, -np.pi / 2],
        ]
    )
    return x0, xf


def run_genuine(dpilqr):
    out = {}

    # --- single_unicycle (scripts/examples.py:26-46, minus plotting) ----
    dpilqr._reset_ids()
    dt, N = 0.05, 50
    x = np.array([-10, 10, 10, 0], dtype=float)
    x_goal = np.zeros((4, 1), dtype=float).T
    dynamics = dpilqr.UnicycleDynamics4D(dt)
    Q = np.diag([1.0, 1, 0, 0])
    Qf = 1000 * np.eye(4)
    R = np.eye(2)
    cost = dpilqr.ReferenceCost(x_goal, Q, R, Qf)
    prob = dpilqr.ilqrProblem(dynamics, cost)
    X, U, J = dpilqr.ilqrSolver(prob, N).solve(x)
    out["single_unicycle"] = {"X": X, "U": U, "J": float(J)}

    # --- 3-agent potential game ----------------------------------------
    dpilqr._reset_ids()
    dt, N = 0.1, 40
    x0, xf = scenario_3agent()
    ids = [0, 1, 2]
    dynamics = dpilqr.MultiDynamicalModel(
        [dpilqr.UnicycleDynamics4D(dt, id_) for id_ in ids]
    )
    goal_costs = [
        dpilqr.ReferenceCost(
            xf[i : i + 1], np.eye(4), np.eye(2), 1e3 * np.eye(4), id_
        )
        for i, id_ in enumerate(ids)
    ]
    prox = dpilqr.ProximityCost([4] * 3, 0.5, [2] * 3)
    game = dpilqr.GameCost(goal_costs, prox)
    prob = dpilqr.ilqrProblem(dynamics, game)
    X3, U3, J3 = dpilqr.ilqrSolver(prob, N).solve(x0.flatten())
    out["three_unicycles"] = {"X": X3, "U": U3, "J": float(J3)}
    return out


def run_oracle():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle import OracleGameCost, OracleMultiModel, oracle_ilqr

    out = {}

    # single_unicycle: GameCost-of-one == ReferenceCost (no proximity).
    dt, N = 0.05, 50
    model = OracleMultiModel("Unicycle4D", 1, dt)
    cost = OracleGameCost(
        np.zeros(4), [np.diag([1.0, 1, 0, 0])], [np.eye(2)],
        [1000 * np.eye(4)], 0.5, 4, 2, 1,
    )
    x = np.array([-10, 10, 10, 0], dtype=float)
    X, U, J, iters, _ = oracle_ilqr(model, cost, x, N=N)
    out["single_unicycle"] = {"X": X, "U": U, "J": float(J), "iters": iters}

    dt, N = 0.1, 40
    x0, xf = scenario_3agent()
    model = OracleMultiModel("Unicycle4D", 3, dt)
    cost = OracleGameCost(
        xf.flatten(), [np.eye(4)] * 3, [np.eye(2)] * 3,
        [1e3 * np.eye(4)] * 3, 0.5, 4, 2, 3,
    )
    X3, U3, J3, it3, _ = oracle_ilqr(model, cost, x0.flatten(), N=N)
    out["three_unicycles"] = {"X": X3, "U": U3, "J": float(J3), "iters": it3}
    return out


def run_framework():
    import jax

    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    import dpilqr_tpu as dtl

    out = {}

    dt, N = 0.05, 50
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, 1, dt)
    cost = dtl.make_game_cost(
        jnp.zeros((1, 4)),
        jnp.asarray(np.diag([1.0, 1, 0, 0])[None]),
        jnp.asarray(np.eye(2)[None]),
        jnp.asarray(1000 * np.eye(4)[None]),
        radius=0.5,
    )
    x = jnp.asarray(np.array([[-10, 10, 10, 0]], dtype=float))
    res = dtl.ilqr_solve(fleet, cost, x, N=N)
    out["single_unicycle"] = {
        "X": np.asarray(res.X).reshape(N + 1, 4),
        "J": float(res.J),
        "iters": int(res.iters),
    }

    dt, N = 0.1, 40
    x0, xf = scenario_3agent()
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, 3, dt)
    cost = dtl.make_game_cost(
        jnp.asarray(xf),
        jnp.asarray(np.tile(np.eye(4), (3, 1, 1))),
        jnp.asarray(np.tile(np.eye(2), (3, 1, 1))),
        jnp.asarray(np.tile(1e3 * np.eye(4), (3, 1, 1))),
        radius=0.5,
    )
    res = dtl.ilqr_solve(fleet, cost, jnp.asarray(x0), N=N)
    out["three_unicycles"] = {
        "X": np.asarray(res.X).reshape(N + 1, 12),
        "J": float(res.J),
        "iters": int(res.iters),
    }
    return out


def main():
    so = build_so()
    os.environ["REFCHECK_SO"] = so
    dpilqr = import_genuine_dpilqr()
    genuine = run_genuine(dpilqr)
    oracle = run_oracle()
    fw = run_framework()

    report = {"so": so, "scenarios": {}}
    ok = True
    for name in ("single_unicycle", "three_unicycles"):
        g, o, f = genuine[name], oracle[name], fw[name]
        gX = np.asarray(g["X"]).reshape(np.asarray(o["X"]).shape)
        dJ_oracle = abs(o["J"] - g["J"]) / abs(g["J"])
        dX_oracle = float(np.max(np.abs(np.asarray(o["X"]) - gX)))
        dJ_fw = abs(f["J"] - g["J"]) / abs(g["J"])
        dX_fw = float(np.max(np.abs(np.asarray(f["X"]) - gX)))
        entry = {
            "J_genuine": g["J"],
            "J_oracle": o["J"],
            "J_framework": f["J"],
            "relerr_J_oracle_vs_genuine": dJ_oracle,
            "max_abs_X_oracle_vs_genuine": dX_oracle,
            "relerr_J_framework_vs_genuine": dJ_fw,
            "max_abs_X_framework_vs_genuine": dX_fw,
            "iters_oracle": o["iters"],
            "iters_framework": f["iters"],
        }
        report["scenarios"][name] = entry
        if (
            dJ_oracle > 1e-7
            or dJ_fw > 1e-7
            or dX_oracle > 1e-5
            or dX_fw > 1e-5
        ):
            ok = False
    report["ok"] = ok

    with open(os.path.join(HERE, "RESULT.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report, indent=2))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
