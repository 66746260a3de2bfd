"""Distributed-layer tests: graph semantics, batching invariants, and
equivalence properties (padded/batched subproblem solves == standalone
solves -- the key correctness property behind the batched design).
"""

import numpy as np
import jax.numpy as jnp

import dpilqr_tpu as dtl
from dpilqr_tpu.parallel import gather_subproblems


def _uni_cost(n, xf, radius):
    return dtl.make_game_cost(
        xf,
        np.tile(np.eye(4), (n, 1, 1)),
        np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)),
        radius=radius,
    )


class TestInteractionGraph:
    def test_threshold_semantics(self):
        # Agents 0,1 within 2*radius; agent 2 far away.
        radius = 0.5
        X = np.zeros((1, 3, 4))
        X[0, 0, :2] = [0.0, 0.0]
        X[0, 1, :2] = [0.9, 0.0]  # d = 0.9 < 1.0 = 2r
        X[0, 2, :2] = [5.0, 5.0]
        M = np.asarray(dtl.interaction_graph(jnp.asarray(X), radius))
        expect = np.array(
            [[1, 1, 0], [1, 1, 0], [0, 0, 1]], dtype=bool
        )
        assert (M == expect).all()

    def test_samples_over_trajectory(self):
        # Agents apart at t=0 but crossing mid-trajectory -> coupled.
        radius = 0.5
        T = 21
        X = np.zeros((T, 2, 4))
        X[:, 0, 0] = np.linspace(-2, 2, T)
        X[:, 1, 0] = np.linspace(2, -2, T)
        M = np.asarray(dtl.interaction_graph(jnp.asarray(X), radius))
        assert M.all()

    def test_graph_to_dict(self):
        M = jnp.asarray(np.array([[1, 1, 0], [1, 1, 0], [0, 0, 1]], dtype=bool))
        d = dtl.graph_to_dict(M, ids=[100, 101, 102])
        assert d == {100: [100, 101], 101: [100, 101], 102: [102]}


class TestGatherPlan:
    def test_members_owner_first_then_sorted(self):
        M = jnp.asarray(
            np.array([[1, 0, 1, 0], [0, 1, 0, 0], [1, 0, 1, 1], [0, 0, 1, 1]], bool)
        )
        b = gather_subproblems(M)
        mi = np.asarray(b.member_idx)
        mm = np.asarray(b.member_mask)
        assert mi[0, :2].tolist() == [0, 2] and mm[0].tolist() == [1, 1, 0, 0]
        assert mi[1, 0] == 1 and mm[1].tolist() == [1, 0, 0, 0]
        assert mi[2, :3].tolist() == [2, 0, 3]  # owner 2 first, rest ascending
        assert mi[3, :2].tolist() == [3, 2]
        assert np.asarray(b.sizes).tolist() == [2, 1, 3, 2]
        # Owner always occupies slot 0 of its own subproblem.
        assert np.asarray(b.owner_slot).tolist() == [0, 0, 0, 0]
        assert (mi[:, 0] == np.arange(4)).all()

    def test_truncation_keeps_owner(self):
        M = jnp.ones((4, 4), bool)
        b = gather_subproblems(M, K=2)
        mi = np.asarray(b.member_idx)
        assert mi.shape == (4, 2)
        # Truncation drops high-index non-owners, NEVER the owner itself
        # (a dropped owner would silently extract another agent's rows).
        assert (mi[:, 0] == np.arange(4)).all()
        assert np.asarray(b.member_mask)[:, 0].tolist() == [1.0] * 4
        # sizes still report the true neighborhood.
        assert np.asarray(b.sizes).tolist() == [4, 4, 4, 4]


class TestDistributedEquivalence:
    def test_fully_connected_equals_centralized(self):
        """When every agent is in every subproblem, each subproblem IS the
        centralized problem; owner extraction must reproduce it exactly."""
        n, dt, N, radius = 3, 0.1, 15, 10.0  # huge radius -> complete graph
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array([[-1.0, 0.0, 0, 0], [1.0, 0.3, 0, 0], [0.0, -1.0, 0, 0]])
        xf = np.array([[1.0, 0.0, 0, 0], [-1.0, 0.3, 0, 0], [0.0, 1.0, 0, 0]])
        cost = _uni_cost(n, xf, radius)
        U0 = jnp.zeros((N, n, 2))

        res_c = dtl.ilqr_solve(fleet, cost, jnp.asarray(x0), U0=U0)
        res_d = dtl.solve_distributed(
            fleet, cost, jnp.asarray(x0)[None], U0, radius
        )
        assert np.asarray(res_d.membership).all()
        assert int(res_c.iters) == int(np.asarray(res_d.iters)[0])
        # Equivalence is exact in exact arithmetic; under vmap the einsum
        # reduction order differs, so allow tiny fp drift per iteration.
        assert np.allclose(np.asarray(res_d.X), np.asarray(res_c.X), atol=1e-7)
        assert np.allclose(np.asarray(res_d.U), np.asarray(res_c.U), atol=1e-7)
        assert np.isclose(float(res_d.J), float(res_c.J), rtol=1e-8)

    def test_disconnected_equals_solo_solves(self):
        """Far-apart agents decompose into singleton problems identical to
        solving each agent alone."""
        dt, N = 0.1, 15
        n = 3
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt)
        x0 = np.zeros((n, 4))
        xf = np.zeros((n, 4))
        for i in range(n):
            x0[i, :2] = [100.0 * i, 0.0]
            xf[i, :2] = [100.0 * i + 2.0, 1.0]
        cost = _uni_cost(n, xf, radius=0.5)
        U0 = jnp.zeros((N, n, 2))
        res_d = dtl.solve_distributed(
            fleet, cost, jnp.asarray(x0)[None], U0, 0.5
        )
        assert np.asarray(res_d.sizes).tolist() == [1, 1, 1]

        fleet1 = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, 1, dt)
        for i in range(n):
            cost1 = _uni_cost(1, xf[i : i + 1], radius=0.5)
            res1 = dtl.ilqr_solve(
                fleet1, cost1, jnp.asarray(x0[i : i + 1]), N=N
            )
            assert np.allclose(
                np.asarray(res_d.X)[:, i], np.asarray(res1.X)[:, 0], atol=1e-9
            )

    def test_ignored_agents_stay_zero(self):
        n, dt, N = 2, 0.1, 10
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array([[0.0, 0, 0, 0], [10.0, 0, 0, 0]])
        xf = np.array([[1.0, 0, 0, 0], [11.0, 0, 0, 0]])
        cost = _uni_cost(n, xf, radius=0.5)
        res = dtl.solve_distributed(
            fleet, cost, jnp.asarray(x0)[None], jnp.zeros((N, n, 2)), 0.5,
            ignore_mask=np.array([False, True]),
        )
        assert np.allclose(np.asarray(res.X)[:, 1], 0.0)
        assert np.allclose(np.asarray(res.U)[:, 1], 0.0)
        assert not np.allclose(np.asarray(res.X)[:, 0], 0.0)

    def test_heterogeneous_fleet_dynamic_dispatch(self):
        """Mixed-model fleet through the distributed path: each slot must
        integrate its gathered agent's model."""
        dt, N = 0.05, 10
        fleet = dtl.Fleet((dtl.QUAD_6D, dtl.HUMAN_LIN_6D), dt)
        x0 = np.array([[0.0, 0, 1, 0, 0, 0], [100.0, 0, 1, 0, 0, 0]])
        xf = np.array([[1.0, 0, 1, 0, 0, 0], [101.0, 1, 1, 0, 0, 0]])
        cost = dtl.make_game_cost(
            xf,
            np.tile(np.eye(6), (2, 1, 1)),
            np.tile(0.1 * np.eye(3), (2, 1, 1)),
            np.tile(1e3 * np.eye(6), (2, 1, 1)),
            radius=0.3,
            n_pos=np.array([3, 2]),
        )
        U0 = np.zeros((N, 2, 3))
        U0[:, 0, 0] = dtl.GRAVITY
        res = dtl.solve_distributed(
            fleet, cost, jnp.asarray(x0)[None], jnp.asarray(U0), 0.3
        )
        X = np.asarray(res.X)
        # Quad reaches its goal in 3D; human's z stays fixed (HumanLin6D).
        assert np.linalg.norm(X[-1, 0, :3] - xf[0, :3]) < 0.1
        assert np.allclose(X[:, 1, 2], 1.0)
        # Short horizon: the human closes most of the 1.4 m gap.
        start_err = np.linalg.norm(x0[1, :2] - xf[1, :2])
        assert np.linalg.norm(X[-1, 1, :2] - xf[1, :2]) < 0.3 * start_err


class TestSelfishWarmstart:
    def test_matches_solo_solves(self):
        dt, N = 0.1, 12
        n = 2
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt)
        x0 = np.array([[0.0, 0, 0, 0], [0.5, 0, 0, 0]])  # close together
        xf = np.array([[1.0, 1, 0, 0], [-1.0, 1, 0, 0]])
        cost = _uni_cost(n, xf, radius=5.0)
        U_warm = dtl.selfish_warmstart(fleet, cost, jnp.asarray(x0), N)

        fleet1 = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, 1, dt)
        for i in range(n):
            cost1 = _uni_cost(1, xf[i : i + 1], radius=5.0)
            res1 = dtl.ilqr_solve(fleet1, cost1, jnp.asarray(x0[i : i + 1]), N=N)
            assert np.allclose(
                np.asarray(U_warm)[:, i], np.asarray(res1.U)[:, 0], atol=1e-9
            )


class TestRhc:
    def test_centralized_rhc_converges(self):
        n, dt, N = 2, 0.1, 20
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array([[-1.0, 0.2, 0, 0], [1.0, -0.2, 0, 0]])
        xf = np.array([[1.0, 0.2, 0, 0], [-1.0, -0.2, 0, 0]])
        cost = _uni_cost(n, xf, radius=0.3)
        res = dtl.solve_rhc(
            fleet, cost, x0, N, centralized=True, step_size=2,
            dist_converge=0.1, t_diverge=10.0, rng=np.random.default_rng(0),
        )
        assert res.converged
        final = res.X[-1]
        assert np.all(
            np.linalg.norm(final[:, :2] - xf[:, :2], axis=1) < 0.5
        )

    def test_distributed_rhc_converges(self):
        n, dt, N = 2, 0.1, 20
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array([[-1.0, 0.2, 0, 0], [1.0, -0.2, 0, 0]])
        xf = np.array([[1.0, 0.2, 0, 0], [-1.0, -0.2, 0, 0]])
        cost = _uni_cost(n, xf, radius=0.3)
        res = dtl.solve_rhc(
            fleet, cost, x0, N, radius=0.3, centralized=False, step_size=2,
            dist_converge=0.1, t_diverge=10.0, rng=np.random.default_rng(0),
        )
        assert res.converged
        assert res.steps[0].graph is not None

    def test_rhc_u0_seeds_first_warm_start(self):
        # U0 replaces the rng warm start: the same U0 under DIFFERENT rngs
        # gives bit-identical runs, while the default rng warm start does
        # not -- proving the parameter is honored.  U0 here is the
        # reference's own selfish warmstart (problem.py:66-91), the
        # composition its examples use before a receding-horizon run.
        n, dt, N = 2, 0.1, 20
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array([[-1.0, 0.2, 0, 0], [1.0, -0.2, 0, 0]])
        xf = np.array([[1.0, 0.2, 0, 0], [-1.0, -0.2, 0, 0]])
        cost = _uni_cost(n, xf, radius=0.3)
        Uw = dtl.selfish_warmstart(fleet, cost, jnp.asarray(x0), N)

        def run(seed, U0=None):
            return dtl.solve_rhc(
                fleet, cost, x0, N, radius=0.3, centralized=False,
                step_size=2, dist_converge=0.1, t_diverge=10.0,
                rng=np.random.default_rng(seed), U0=U0,
            )

        a, b = run(0, U0=Uw), run(1, U0=Uw)
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.U, b.U)
        assert a.converged and b.converged
        c, d = run(0), run(1)
        assert not np.array_equal(c.U, d.U)

    def test_pipeline_commits_exactly_the_executed_steps(self):
        # The depth-1 pipeline dispatches one step past the stopping point;
        # the discarded step must never be committed: with t_diverge sized
        # for exactly k MPC steps, the run records exactly k steps and the
        # executed trajectory is exactly k * step_size states long.
        n, dt, N, step_size = 2, 0.1, 10, 2
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array([[-1.0, 0.2, 0, 0], [1.0, -0.2, 0, 0]])
        xf = np.array([[1.0, 0.2, 0, 0], [-1.0, -0.2, 0, 0]])
        cost = _uni_cost(n, xf, radius=0.3)
        for k in (1, 3):
            t_diverge = (k - 1) * step_size * dt  # breaks at the k-th step
            res = dtl.solve_rhc(
                fleet, cost, x0, N, radius=0.3, centralized=False,
                step_size=step_size, J_converge=1e-9, t_diverge=t_diverge,
                rng=np.random.default_rng(0),
            )
            assert len(res.steps) == k, (k, len(res.steps))
            assert res.X.shape[0] == k * step_size
            assert not res.converged

    def test_step_info_serializes(self):
        # RhcStepInfo materializes its lazy fields for to_dict / pickling
        # (metrics JsonlWriter and external consumers).
        import json
        import pickle

        n, dt, N = 2, 0.1, 10
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array([[-1.0, 0.2, 0, 0], [1.0, -0.2, 0, 0]])
        xf = np.array([[1.0, 0.2, 0, 0], [-1.0, -0.2, 0, 0]])
        cost = _uni_cost(n, xf, radius=0.3)
        res = dtl.solve_rhc(
            fleet, cost, x0, N, radius=0.3, centralized=False, step_size=2,
            J_converge=1e-9, t_diverge=0.4, rng=np.random.default_rng(0),
        )
        d = res.steps[0].to_dict()
        json.dumps(d)  # JSON-serializable
        assert set(d) == {"t", "J", "solve_time", "graph", "iters",
                          "distance_left"}
        back = pickle.loads(pickle.dumps(res.steps))
        assert back[0].graph == res.steps[0].graph
        assert back[0].iters == res.steps[0].iters

    def test_pipelined_run_is_deterministic(self):
        # Same seed => bit-identical executed trajectory, J trace, and
        # graphs, pipelining notwithstanding.
        n, dt, N = 2, 0.1, 20
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array([[-1.0, 0.2, 0, 0], [1.0, -0.2, 0, 0]])
        xf = np.array([[1.0, 0.2, 0, 0], [-1.0, -0.2, 0, 0]])
        cost = _uni_cost(n, xf, radius=0.3)
        runs = [
            dtl.solve_rhc(
                fleet, cost, x0, N, radius=0.3, centralized=False,
                step_size=2, dist_converge=0.1, t_diverge=10.0,
                rng=np.random.default_rng(7),
            )
            for _ in range(2)
        ]
        np.testing.assert_array_equal(runs[0].X, runs[1].X)
        assert [s.J for s in runs[0].steps] == [s.J for s in runs[1].steps]
        assert [s.graph for s in runs[0].steps] == [
            s.graph for s in runs[1].steps
        ]

    def test_auto_k_redo_on_densifying_graph(self):
        # Agents start in singleton neighborhoods (auto-K resolves to 1)
        # and converge toward a common region, so the neighborhood size
        # jumps to 3 mid-run.  Under pipelining the cached width lags; the
        # truncation-redo path must re-solve those steps with a wider K,
        # so the auto-K run matches a K=n pinned run (padded-slot
        # decoupling makes the two solves otherwise identical).
        n, dt, N = 3, 0.1, 20
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array(
            [[-3.0, 0.0, 0, 0], [3.0, 0.0, 0, 0], [0.0, 3.0, 0, 0]]
        )
        xf = np.array(
            [[0.3, 0.0, 0, 0], [-0.3, 0.0, 0, 0], [0.0, -0.3, 0, 0]]
        )
        cost = _uni_cost(n, xf, radius=0.4)
        kwargs = dict(
            radius=0.4, centralized=False, step_size=2, dist_converge=0.15,
            t_diverge=12.0,
        )
        res_auto = dtl.solve_rhc(
            fleet, cost, x0, N, K=None, rng=np.random.default_rng(3),
            **kwargs,
        )
        res_full = dtl.solve_rhc(
            fleet, cost, x0, N, K=n, rng=np.random.default_rng(3), **kwargs
        )
        # The run actually exercises width growth (graphs densify).
        max_nbhd = max(
            max(len(v) for v in s.graph.values()) for s in res_auto.steps
        )
        assert max_nbhd == 3, max_nbhd
        np.testing.assert_allclose(res_auto.X, res_full.X, atol=1e-10)

    def test_t_kill_caps_solve_time(self):
        n, dt, N = 2, 0.1, 20
        fleet = dtl.homogeneous_fleet(dtl.DOUBLE_INT_4D, n, dt)
        x0 = np.array([[-1.0, 0.2, 0, 0], [1.0, -0.2, 0, 0]])
        xf = np.array([[1.0, 0.2, 0, 0], [-1.0, -0.2, 0, 0]])
        cost = _uni_cost(n, xf, radius=0.3)
        res = dtl.solve_rhc(
            fleet, cost, x0, N, centralized=True, step_size=2,
            dist_converge=0.1, t_diverge=6.0, t_kill=0.5,
            rng=np.random.default_rng(0),
        )
        # Deadline mode still makes progress (may or may not fully converge).
        assert res.X.shape[0] >= 1


class TestSteppableRepack:
    def test_steppable_repack_equals_fused(self):
        """The host-stepped deadline loop (parallel/deadline.py) freezes
        finished subproblems between iterations; with no deadline pressure
        its result must equal the fused solve_distributed exactly, across a
        spread of per-subproblem convergence times."""
        n, dt, N = 160, 0.1, 8
        rng = np.random.default_rng(4)
        x0, xf = dtl.random_setup(n, 4, rng=rng, energy=4.0 * n, n_d=2)
        fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, dt)
        cost = _uni_cost(n, jnp.asarray(xf), radius=0.5)
        X0 = jnp.broadcast_to(jnp.asarray(x0)[None], (N + 1, n, 4))
        U0 = jnp.zeros((N, n, 2))
        cfg = dtl.SolverConfig(n_lqr_iter=8, tol=1e-3)
        fused = dtl.solve_distributed(
            fleet, cost, X0, U0, radius=0.5, K=4, config=cfg
        )
        stepped = dtl.solve_distributed(
            fleet, cost, X0, U0, radius=0.5, K=4, config=cfg, t_kill=600.0
        )
        iters = np.asarray(fused.iters)
        assert iters.max() > iters.min()  # spread: freezing engages
        np.testing.assert_array_equal(iters, np.asarray(stepped.iters))
        np.testing.assert_allclose(
            float(stepped.J), float(fused.J), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(stepped.X), np.asarray(fused.X), atol=1e-10
        )
