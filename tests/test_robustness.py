"""Tests for round-2 solver robustness features:

- the mu-increase failed-line-search policy (the reference's dead code at
  control.py:198-208, implemented behind ``SolverConfig.on_failed_ls``),
- the reference-parity proximity evaluation mode (``prox_eval_n_d``,
  reproducing dpilqr/cost.py:122-133 vs :135-171 exactly),
- the wall-clock deadline on distributed solves (``t_kill``; reference
  threads it through every subproblem solve, distributed.py:170-176).
"""

from time import perf_counter

import numpy as np
import pytest
import jax.numpy as jnp

import dpilqr_tpu as dtl
from dpilqr_tpu.config import SolverConfig
from dpilqr_tpu.ops import costs as _costs


def _hard_two_agent():
    """Head-on near-collision: steep proximity gradients make the plain
    line search bail (see also the reference's jittered starts)."""
    n, dt = 2, 0.1
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt)
    x0 = np.array(
        [[0.0, 0.0, 1.0, 0.0], [1.0, 0.01, 1.0, np.pi]], dtype=float
    )
    xf = np.array(
        [[3.0, 0.0, 0.0, 0.0], [-2.0, 0.0, 0.0, np.pi]], dtype=float
    )
    # Starts INSIDE each other's proximity radius: the steep penalty
    # gradient reliably trips the plain line search's bail-out.
    cost = _costs.make_game_cost(
        jnp.asarray(xf),
        np.tile(np.eye(4), (n, 1, 1)),
        np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)),
        radius=1.2,
    )
    return fleet, cost, jnp.asarray(x0)


class TestMuIncrease:
    def test_recovers_from_failed_line_search(self):
        fleet, cost, x0 = _hard_two_agent()
        bail = dtl.ilqr_solve(
            fleet, cost, x0, N=30,
            config=SolverConfig(n_lqr_iter=30, tol=1e-9, on_failed_ls="bail"),
        )
        inc = dtl.ilqr_solve(
            fleet, cost, x0, N=30,
            config=SolverConfig(
                n_lqr_iter=30, tol=1e-9, on_failed_ls="increase"
            ),
        )
        # The scenario must actually trip the bail-out for the test to be
        # meaningful (matches the reference's observed behavior).
        assert bool(bail.failed_line_search)
        # The increase policy keeps iterating and ends at least as good.
        assert int(inc.iters) > int(bail.iters)
        assert float(inc.J) <= float(bail.J) * (1 + 1e-9)

    def test_mu_max_aborts(self):
        fleet, cost, x0 = _hard_two_agent()
        cfg = SolverConfig(
            n_lqr_iter=200, tol=1e-12, on_failed_ls="increase", mu_max=10.0
        )
        res = dtl.ilqr_solve(fleet, cost, x0, N=30, config=cfg)
        # With a tiny mu_max the increase path must hit the abort before
        # exhausting the iteration budget.
        assert int(res.iters) < 200


class TestProxParityMode:
    """The reference evaluates proximity with 2-D distances but
    quadraticizes with min(n_dims) (cost.py:122-133 vs :135-171)."""

    def _cost3d(self, prox_eval_n_d):
        n = 2
        xf = np.zeros((n, 6))
        return _costs.make_game_cost(
            xf,
            np.tile(np.eye(6), (n, 1, 1)),
            np.tile(np.eye(3), (n, 1, 1)),
            np.tile(np.eye(6), (n, 1, 1)),
            radius=1.0,
            n_pos=np.array([3, 3]),
            prox_eval_n_d=prox_eval_n_d,
        )

    def test_quirk_semantics(self):
        # Two agents separated by 0.4 in xy and 0.5 in z: 2-D distance 0.4,
        # 3-D distance 0.64.
        x = jnp.asarray(
            np.array([[0.0, 0.0, 0.0, 0, 0, 0], [0.4, 0.0, 0.5, 0, 0, 0]])
        )
        parity = self._cost3d(prox_eval_n_d=2)
        exact = self._cost3d(prox_eval_n_d=None)

        # Evaluation: parity uses the 2-D distance (reference cost.py:122).
        pen_parity = float(_costs.proximity_cost(parity, x))
        pen_exact = float(_costs.proximity_cost(exact, x))
        d2, d3 = 0.4, float(np.sqrt(0.4**2 + 0.5**2))
        assert np.isclose(pen_parity, (d2 - 1.0) ** 2, atol=1e-9)
        assert np.isclose(pen_exact, (d3 - 1.0) ** 2, atol=1e-9)

        # Quadraticization: BOTH use min(n_dims) = 3 components (the quirk:
        # derivatives disagree with the parity-mode penalty, reference
        # cost.py:135-171).
        for c in (parity, exact):
            L_x, _ = _costs.proximity_quadraticize(c, x)
            g = np.asarray(L_x)
            # 3-D gradient has a z component; built from the 3-D distance.
            assert abs(g[0, 2]) > 1e-9
            expect_dx = 2.0 * (d3 - 1.0) / d3 * (-0.4)
            assert np.isclose(g[0, 0], expect_dx, atol=1e-9)

    def test_facade_passthrough(self):
        from dpilqr_tpu import api

        prox = api.ProximityCost([6, 6], 1.0, n_dims=[3, 3], eval_n_d=2)
        x = np.array([[0.0, 0, 0, 0, 0, 0], [0.4, 0, 0.5, 0, 0, 0]]).flatten()
        assert np.isclose(prox(x), (0.4 - 1.0) ** 2, atol=1e-9)
        sub = list(api.GameCost(
            [api.ReferenceCost(np.zeros(6), np.eye(6), np.eye(3), id=i)
             for i in range(2)],
            prox,
        ).split({0: [0, 1]}))[0]
        assert sub.prox_cost.eval_n_d == 2


class TestDistributedDeadline:
    def test_t_kill_stops_early(self):
        from dpilqr_tpu.parallel.deadline import solve_distributed_steppable

        n, N = 4, 20
        rng = np.random.default_rng(1)
        x0, xf = dtl.random_setup(n, 4, rng=rng, energy=5.0, n_d=2)
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
        cost = _costs.make_game_cost(
            jnp.asarray(xf),
            np.tile(np.eye(4), (n, 1, 1)),
            np.tile(np.eye(2), (n, 1, 1)),
            np.tile(1e3 * np.eye(4), (n, 1, 1)),
            radius=0.5,
        )
        X0 = jnp.broadcast_to(jnp.asarray(x0)[None], (N + 1, n, 4))
        U0 = jnp.zeros((N, n, 2))
        cfg = SolverConfig(n_lqr_iter=40, tol=1e-12)

        # Unlimited: runs many iterations.
        full = solve_distributed_steppable(
            fleet, cost, X0, U0, 0.5, K=4, config=cfg, t_kill=None
        )
        # Deadline already expired when iterations start: the solve must
        # stop after at most the initial rollout + one host check, i.e.
        # strictly fewer iterations than the unlimited run.
        t0 = perf_counter()
        capped = solve_distributed_steppable(
            fleet, cost, X0, U0, 0.5, K=4, config=cfg, t_kill=1e-9
        )
        assert int(np.asarray(capped.iters).max()) == 0
        assert int(np.asarray(full.iters).max()) > 2
        # Result is still a valid (rolled-out) plan with finite cost.
        assert np.isfinite(float(capped.J))

    def test_t_kill_midflight(self):
        """Non-degenerate deadline: sized to stop an unlimited-length solve
        roughly halfway (reference control.py:213-218 stops accepting
        iterations once the wall clock passes)."""
        from dpilqr_tpu.parallel.deadline import solve_distributed_steppable

        n, N = 6, 30
        rng = np.random.default_rng(7)
        x0, xf = dtl.random_setup(n, 4, rng=rng, energy=5.0, n_d=2)
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
        cost = _costs.make_game_cost(
            jnp.asarray(xf),
            np.tile(np.eye(4), (n, 1, 1)),
            np.tile(np.eye(2), (n, 1, 1)),
            np.tile(1e3 * np.eye(4), (n, 1, 1)),
            radius=0.5,
        )
        X0 = jnp.broadcast_to(jnp.asarray(x0)[None], (N + 1, n, 4))
        U0 = jnp.zeros((N, n, 2))
        # Tiny tol: the unlimited solve runs many iterations.
        cfg = SolverConfig(n_lqr_iter=40, tol=1e-12)

        args = (fleet, cost, X0, U0, 0.5)
        kw = dict(K=4, config=cfg)
        full = solve_distributed_steppable(*args, **kw, t_kill=None)  # warm-up
        t0 = perf_counter()
        full = solve_distributed_steppable(*args, **kw, t_kill=None)
        t_full = perf_counter() - t0
        iters_full = int(np.asarray(full.iters).max())
        assert iters_full >= 6  # precondition: enough room to stop midway

        capped = solve_distributed_steppable(
            *args, **kw, t_kill=0.5 * t_full
        )
        iters_capped = int(np.asarray(capped.iters).max())
        assert 0 < iters_capped < iters_full
        assert np.isfinite(float(capped.J))


class TestTruncationGuard:
    def _dense_cluster(self, n, N=10):
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
        # All agents within one planning radius of each other.
        x0 = np.zeros((n, 4))
        x0[:, 0] = np.linspace(0, 0.3, n)
        xf = x0 + np.array([2.0, 0, 0, 0])
        cost = _costs.make_game_cost(
            jnp.asarray(xf),
            np.tile(np.eye(4), (n, 1, 1)),
            np.tile(np.eye(2), (n, 1, 1)),
            np.tile(1e3 * np.eye(4), (n, 1, 1)),
            radius=0.5,
        )
        X0 = jnp.broadcast_to(jnp.asarray(x0)[None], (N + 1, n, 4))
        U0 = jnp.zeros((N, n, 2))
        return fleet, cost, X0, U0

    def test_truncated_flag(self):
        """K smaller than a neighborhood drops coupling partners; the result
        must SAY so (the reference never truncates, problem.py:36-47)."""
        fleet, cost, X0, U0 = self._dense_cluster(5)
        cfg = SolverConfig(n_lqr_iter=3)
        res_small = dtl.solve_distributed(
            fleet, cost, X0, U0, 0.5, K=2, config=cfg
        )
        assert bool(np.asarray(res_small.truncated))
        # Auto-K / adequate K: no truncation.
        res_auto = dtl.solve_distributed(fleet, cost, X0, U0, 0.5, config=cfg)
        assert not bool(np.asarray(res_auto.truncated))
        # The deadline path carries the flag too.
        from dpilqr_tpu.parallel.deadline import solve_distributed_steppable

        res_dl = solve_distributed_steppable(
            fleet, cost, X0, U0, 0.5, K=2, config=cfg, t_kill=None
        )
        assert bool(np.asarray(res_dl.truncated))


class TestFacadeProxDefault:
    def test_3d_fleet_reference_semantics_by_default(self):
        """A drop-in user's all-3-D fleet gets the reference's exact
        trajectories with NO flag: the proximity penalty EVALUATES with 2-D
        distances (reference cost.py:121-123 via util.py:48) while the
        derivatives use min(n_dims)=3 (cost.py:135-171)."""
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).parent))
        from oracle import OracleGameCost, OracleMultiModel, oracle_ilqr

        from dpilqr_tpu import api

        n, nx, nu, dt, N = 3, 6, 3, 0.1, 15
        radius = 1.5
        rng = np.random.default_rng(3)
        x0 = np.zeros((n, nx))
        x0[:, :3] = rng.uniform(-1, 1, (n, 3))
        xf = np.zeros((n, nx))
        xf[:, :3] = -x0[:, :3]

        models = [api.QuadcopterDynamics6D(dt, i) for i in range(n)]
        rcs = [
            api.ReferenceCost(
                xf[i], np.eye(nx), np.eye(nu), 100 * np.eye(nx), i
            )
            for i in range(n)
        ]
        # DEFAULT proximity cost: n_dims=[3,3,3], no eval flag supplied.
        game = api.GameCost(
            rcs, api.ProximityCost([nx] * n, radius, [3] * n)
        )
        prob = api.ilqrProblem(api.MultiDynamicalModel(models), game)
        X, U, J = api.ilqrSolver(prob, N).solve(
            x0.flatten(), n_lqr_iter=12, tol=1e-9, verbose=False
        )

        model_o = OracleMultiModel("Quad6D", n, dt)
        # Hover thrust is zero-control in neither system; both start at U=0.
        cost_o = OracleGameCost(
            xf.flatten(), [np.eye(nx)] * n, [np.eye(nu)] * n,
            [100 * np.eye(nx)] * n, radius, nx, nu, n,
            n_pos=3, n_pos_eval=2,  # the reference quirk
        )
        X_o, U_o, J_o, _, _ = oracle_ilqr(
            model_o, cost_o, x0.flatten(), N=N, n_lqr_iter=12, tol=1e-9
        )
        assert np.isclose(J, J_o, rtol=1e-6)
        assert np.allclose(X, X_o, atol=1e-6)

        # Sanity: the quirk is load-bearing -- consistent-mode (eval 3-D)
        # oracle produces a DIFFERENT trajectory for this scenario.
        cost_c = OracleGameCost(
            xf.flatten(), [np.eye(nx)] * n, [np.eye(nu)] * n,
            [100 * np.eye(nx)] * n, radius, nx, nu, n, n_pos=3,
        )
        X_c, _, J_c, _, _ = oracle_ilqr(
            model_o, cost_c, x0.flatten(), N=N, n_lqr_iter=12, tol=1e-9
        )
        assert not np.allclose(X, X_c, atol=1e-6)


class TestMuFloor:
    """SolverConfig.mu_floor (conditioning guard): mu bottoms out at mu_min
    instead of the reference's snap-to-zero (control.py:236), bounding
    kappa(Q_uu) on adversarial deep-penetration scenarios (BASELINE.md
    caveat) without changing well-conditioned solves materially."""

    def _deep_penetration(self):
        # All three agents parked deep inside one another's proximity
        # radius: the zero-control warm start makes the 200x-weighted
        # indefinite pair Hessian drive the unregularized Q_uu solve to
        # cond ~1e13 (BASELINE.md).
        n, dt = 3, 0.1
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt)
        x0 = np.array(
            [[0.0, 0.0, 0.0, 0.0],
             [0.05, 0.02, 0.0, 2.0],
             [-0.03, 0.06, 0.0, 4.0]]
        )
        xf = np.array(
            [[2.0, 0.0, 0.0, 0.0],
             [-2.0, 1.0, 0.0, 2.0],
             [0.0, -2.0, 0.0, 4.0]]
        )
        cost = _costs.make_game_cost(
            jnp.asarray(xf),
            np.tile(np.eye(4), (n, 1, 1)),
            np.tile(np.eye(2), (n, 1, 1)),
            np.tile(1e3 * np.eye(4), (n, 1, 1)),
            radius=2.0,
        )
        return fleet, cost, jnp.asarray(x0)

    def test_deep_penetration_converges_deterministically(self):
        fleet, cost, x0 = self._deep_penetration()
        cfg = SolverConfig(n_lqr_iter=50, tol=1e-3, mu_floor=True)
        res1 = dtl.ilqr_solve(fleet, cost, x0, N=30, config=cfg)
        res2 = dtl.ilqr_solve(fleet, cost, x0, N=30, config=cfg)
        assert np.isfinite(float(res1.J))
        assert bool(res1.converged), (int(res1.iters), float(res1.J))
        np.testing.assert_array_equal(np.asarray(res1.X), np.asarray(res2.X))
        np.testing.assert_array_equal(np.asarray(res1.U), np.asarray(res2.U))

    def test_well_conditioned_solves_unchanged(self):
        # Away from the conditioning cliff the floor changes mu only after
        # it would have snapped to zero; trajectories stay equivalent.
        rng = np.random.default_rng(2)
        x0, xf = dtl.random_setup(4, 4, rng=rng, energy=5.0, n_d=2)
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, 4, 0.1)
        cost = _costs.make_game_cost(
            jnp.asarray(xf),
            np.tile(np.eye(4), (4, 1, 1)),
            np.tile(np.eye(2), (4, 1, 1)),
            np.tile(1e3 * np.eye(4), (4, 1, 1)),
            radius=0.5,
        )
        base = dtl.ilqr_solve(
            fleet, cost, jnp.asarray(x0), N=25,
            config=SolverConfig(n_lqr_iter=25, tol=1e-6),
        )
        guarded = dtl.ilqr_solve(
            fleet, cost, jnp.asarray(x0), N=25,
            config=SolverConfig(n_lqr_iter=25, tol=1e-6, mu_floor=True),
        )
        np.testing.assert_allclose(
            float(guarded.J), float(base.J), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(guarded.X), np.asarray(base.X), atol=1e-5
        )


class TestEnvBackendValidation:
    """DPILQR_SWEEP_BACKEND is validated against the known backend set; a
    typo raises immediately instead of surfacing downstream."""

    def test_typo_raises(self, monkeypatch):
        from dpilqr_tpu.ops.ilqr import env_sweep_backend

        monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "palas")
        with pytest.raises(ValueError, match="DPILQR_SWEEP_BACKEND"):
            env_sweep_backend()

    def test_valid_values(self, monkeypatch):
        from dpilqr_tpu.ops.ilqr import env_sweep_backend

        monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "xla")
        assert env_sweep_backend() == "xla"
        monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "auto")
        assert env_sweep_backend() is None
        monkeypatch.delenv("DPILQR_SWEEP_BACKEND")
        assert env_sweep_backend() is None

    def test_resolvers_reject_typo(self, monkeypatch):
        from dpilqr_tpu.ops.ilqr import resolve_sweep_backend

        monkeypatch.setenv("DPILQR_SWEEP_BACKEND", "cuda")
        cfg = SolverConfig()
        with pytest.raises(ValueError, match="DPILQR_SWEEP_BACKEND"):
            resolve_sweep_backend(cfg, 16, np.float32, "gpu")
        with pytest.raises(ValueError, match="DPILQR_SWEEP_BACKEND"):
            resolve_sweep_backend(cfg, 16, np.float64, "cpu")
