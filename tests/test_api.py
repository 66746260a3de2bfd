"""Reference-facade tests: the object API must behave like dpilqr's
(signatures, flat-array shapes, split/extract semantics)."""

import numpy as np
import pytest

from dpilqr_tpu import api


@pytest.fixture(autouse=True)
def reset_ids():
    api._reset_ids()
    yield
    api._reset_ids()


def test_single_unicycle_example():
    # scripts/examples.py:26-46 scenario through the facade.
    dt, N = 0.05, 50
    x = np.array([-10.0, 10, 10, 0])
    x_goal = np.zeros((4, 1)).T
    dynamics = api.UnicycleDynamics4D(dt)
    Q = np.diag([1.0, 1, 0, 0])
    Qf = 1000 * np.eye(4)
    cost = api.ReferenceCost(x_goal, Q, np.eye(2), Qf)
    prob = api.ilqrProblem(dynamics, cost)
    solver = api.ilqrSolver(prob, N)
    X, U, J = solver.solve(x, verbose=False)
    assert X.shape == (N + 1, 4)
    assert U.shape == (N, 2)
    assert np.linalg.norm(X[-1][:2]) < 0.1
    assert J < 3500


def test_multi_model_ids_and_split():
    dt = 0.1
    ids = [100, 101, 102]
    models = [api.UnicycleDynamics4D(dt, id_) for id_ in ids]
    dynamics = api.MultiDynamicalModel(models)
    assert dynamics.ids == ids
    graph = {100: [100, 101], 101: [100, 101], 102: [102]}
    subs = dynamics.split(graph)
    assert [m.n_players for m in subs] == [2, 2, 1]
    assert subs[0].ids == [100, 101]


def test_multi_linearize_dense_block_diag():
    dt = 0.1
    dynamics = api.MultiDynamicalModel(
        [api.DoubleIntDynamics4D(dt), api.DoubleIntDynamics4D(dt)]
    )
    A, B = dynamics.linearize(np.zeros(8), np.zeros(4))
    assert A.shape == (8, 8) and B.shape == (8, 4)
    assert np.allclose(A[:4, 4:], 0) and np.allclose(A[4:, :4], 0)
    assert np.isclose(A[0, 2], dt)


def test_game_cost_quadraticize_matches_core():
    n, nx, nu = 2, 4, 2
    rng = np.random.default_rng(0)
    xf = rng.normal(size=(n * nx))
    rcs = [
        api.ReferenceCost(xf[i * nx : (i + 1) * nx], np.eye(nx), np.eye(nu))
        for i in range(n)
    ]
    prox = api.ProximityCost([nx] * n, 5.0, [2, 2])
    game = api.GameCost(rcs, prox)
    x = rng.normal(size=(n * nx))
    u = rng.normal(size=(n * nu))
    L_x, L_u, L_xx, L_uu, L_ux = game.quadraticize(x, u)
    assert L_x.shape == (n * nx,)
    # Cross-check against the array core's quadraticization.
    import jax.numpy as jnp
    from dpilqr_tpu.ops import costs as C
    from dpilqr_tpu.models.fleet import homogeneous_fleet
    from dpilqr_tpu.models.specs import DOUBLE_INT_4D

    fleet = homogeneous_fleet(DOUBLE_INT_4D, n, 0.1)
    spec = game.to_array_spec(fleet)
    cx, cu, cxx, cuu = C.quadraticize_stage(
        spec, jnp.asarray(x.reshape(n, nx)), jnp.asarray(u.reshape(n, nu))
    )
    assert np.allclose(L_x, np.asarray(cx).reshape(-1))
    assert np.allclose(L_u, np.asarray(cu).reshape(-1))
    assert np.allclose(L_xx, np.asarray(cxx).reshape(n * nx, n * nx))
    # prox coupling appears off-diagonal when within radius
    d = np.linalg.norm(x[:2] - x[nx : nx + 2])
    assert d < 5.0 and not np.allclose(L_xx[:2, nx : nx + 2], 0)


def test_prox_cost_values():
    prox = api.ProximityCost([3, 3], 10.0, [2, 2])
    x = np.array([0.0, 0, 0, 1, 2, 0])
    assert np.isclose(prox(x), (np.hypot(1, 2) - 10.0) ** 2)
    assert api.ProximityCost([2], 10.0)([1, 2]) == 0.0


def test_solve_distributed_facade():
    dt, N, radius = 0.1, 15, 0.5
    ids = [100, 101]
    dynamics = api.MultiDynamicalModel(
        [api.DoubleIntDynamics4D(dt, id_) for id_ in ids]
    )
    x0 = np.array([-1.0, 0.1, 0, 0, 1.0, -0.1, 0, 0])
    xf = np.array([1.0, 0.1, 0, 0, -1.0, -0.1, 0, 0])
    rcs = [
        api.ReferenceCost(xf[4 * i : 4 * (i + 1)], np.eye(4), np.eye(2),
                          100 * np.eye(4), id_)
        for i, id_ in enumerate(ids)
    ]
    game = api.GameCost(rcs, api.ProximityCost([4, 4], radius, [2, 2]))
    prob = api.ilqrProblem(dynamics, game)
    U = np.zeros((N, 4))
    X_dec, U_dec, J, info = api.solve_distributed(
        prob, x0[None], U, radius
    )
    assert X_dec.shape == (N + 1, 8)
    assert U_dec.shape == (N, 4)
    assert set(info) == {100, 101}
    assert np.isfinite(J)


def test_extract_and_ids_validation():
    dt = 0.1
    ids = [7, 9]
    dynamics = api.MultiDynamicalModel(
        [api.UnicycleDynamics4D(dt, id_) for id_ in ids]
    )
    rcs = [
        api.ReferenceCost(np.zeros(4), np.eye(4), np.eye(2), id=id_)
        for id_ in ids
    ]
    game = api.GameCost(rcs, api.ProximityCost([4, 4], 1.0, [2, 2]))
    prob = api.ilqrProblem(dynamics, game)
    X = np.arange(2 * 8).reshape(2, 8).astype(float)
    U = np.arange(2 * 4).reshape(2, 4).astype(float)
    Xi, Ui = prob.extract(X, U, 9)
    assert np.allclose(Xi, X[:, 4:8])
    with pytest.raises(IndexError):
        prob.extract(X, U, 123)


def test_define_inter_graph_threshold():
    ids = [100, 101, 102]
    X = np.zeros((1, 12))
    X[0, 0:2] = [0, 0]
    X[0, 4:6] = [0.9, 0]
    X[0, 8:10] = [50, 50]
    graph = api.define_inter_graph_threshold(X, 0.5, [4, 4, 4], ids)
    assert graph == {100: [100, 101], 101: [100, 101], 102: [102]}


def test_receding_horizon_controller():
    dt, N = 0.1, 20
    dynamics = api.DoubleIntDynamics4D(dt)
    cost = api.ReferenceCost(np.zeros(4), np.eye(4), np.eye(2), 100 * np.eye(4))
    prob = api.ilqrProblem(dynamics, cost)
    solver = api.ilqrSolver(prob, N)
    rhc = api.RecedingHorizonController(np.array([2.0, 2, 0, 0]), solver, 2)
    steps = 0
    for X, U, J in rhc.solve(np.zeros((N, 2)), J_converge=5.0, verbose=False):
        steps += 1
        if steps > 30:
            break
    assert steps < 30
    assert np.linalg.norm(rhc.x[:2]) < 0.5


def test_selfish_warmstart_facade():
    dt, N = 0.1, 10
    ids = [0, 1]
    dynamics = api.MultiDynamicalModel(
        [api.UnicycleDynamics4D(dt, id_) for id_ in ids]
    )
    xf = np.array([1.0, 1, 0, 0, -1.0, 1, 0, 0])
    rcs = [
        api.ReferenceCost(xf[4 * i : 4 * (i + 1)], np.eye(4), np.eye(2),
                          100 * np.eye(4), id_)
        for i, id_ in enumerate(ids)
    ]
    game = api.GameCost(rcs, api.ProximityCost([4, 4], 0.5, [2, 2]))
    prob = api.ilqrProblem(dynamics, game)
    U = prob.selfish_warmstart(np.zeros(8), N)
    assert U.shape == (N, 4)
    assert np.abs(U).max() > 0


def test_symbolic_model_extensibility():
    """SymbolicModel (reference dynamics.py:95-114): a user-defined sympy
    model matches the equivalent built-in and runs through the array core."""
    import sympy as sym

    class UserBike(api.SymbolicModel):
        def __init__(self, dt, id=None):
            super().__init__(5, 2, dt, id)
            x = sym.Matrix(sym.symbols("p_x p_y v theta phi"))
            u = sym.Matrix(sym.symbols("a rho"))
            x_dot = sym.Matrix(
                [
                    x[2] * sym.cos(x[3]),
                    x[2] * sym.sin(x[3]),
                    u[0],
                    x[2] * sym.tan(x[4]),
                    u[1],
                ]
            )
            self._build(x, u, x_dot)

    dt = 0.1
    m = UserBike(dt)
    ref = api.BikeDynamics5D(dt)
    x = np.array([1.0, 2.0, 0.5, 0.3, 0.1])
    u = np.array([0.2, -0.1])
    assert np.allclose(m.f(x, u), ref.f(x, u))
    A, B = m.linearize(x, u)
    Ar, Br = ref.linearize(x, u)
    assert np.allclose(A, Ar) and np.allclose(B, Br)
    assert np.allclose(m(x, u), ref(x, u))

    # End-to-end through the array core (Fleet built from the custom spec).
    rc = api.ReferenceCost(np.zeros(5), np.eye(5), 0.1 * np.eye(2), id=m.id)
    prob = api.ilqrProblem(api.MultiDynamicalModel([m]), api.GameCost([rc]))
    X, U, J = api.ilqrSolver(prob, 20).solve(x, verbose=False)
    assert X.shape == (21, 5) and np.isfinite(J)
    assert np.linalg.norm(X[-1][:2]) < np.linalg.norm(x[:2])


def test_quadraticize_distance_matches_core():
    """quadraticize_distance (reference cost.py:269-315) agrees with the
    array core's pair Hessian and with finite differences."""
    r = 2.0
    for nd in (2, 3):
        # The reference evaluates the FULL 3-D distance and truncates the
        # outputs; 2-D callers pass z=0 points (reference cost.py:275-277).
        z_a, z_b = (0.3, -0.1) if nd == 3 else (0.0, 0.0)
        pa, pb = api.Point(0.1, -0.2, z_a), api.Point(0.4, 0.3, z_b)
        L_x, L_xx = api.quadraticize_distance(pa, pb, r, nd)
        assert L_x.shape == (nd,) and L_xx.shape == (nd, nd)
        # FD check of the gradient of min(0, d - r)^2 wrt point_a.
        a = np.array([pa.x, pa.y, pa.z])[:nd]
        b = np.array([pb.x, pb.y, pb.z])[:nd]

        def pen(p):
            d = np.linalg.norm(p - b)
            return min(0.0, d - r) ** 2

        eps = 1e-6
        g_fd = np.array(
            [
                (pen(a + eps * np.eye(nd)[i]) - pen(a - eps * np.eye(nd)[i]))
                / (2 * eps)
                for i in range(nd)
            ]
        )
        assert np.allclose(L_x, g_fd, atol=1e-5)
    # Outside the radius: identically zero.
    L_x, L_xx = api.quadraticize_distance(api.Point(0, 0), api.Point(5, 5), 1.0, 2)
    assert not L_x.any() and not L_xx.any()


def test_finite_difference_helpers():
    """quadraticize_finite_difference (reference cost.py:318-349) and
    linearize_finite_difference (dynamics.py:281-290) vs analytic paths."""
    rc = api.ReferenceCost(np.arange(4.0), np.diag([1.0, 2, 3, 4]), np.eye(2))
    x, u = np.array([0.5, -1.0, 2.0, 0.1]), np.array([0.3, -0.2])
    L_x, L_u, L_xx, L_uu, L_ux = rc.quadraticize(x, u)
    F_x, F_u, F_xx, F_uu, F_ux = api.quadraticize_finite_difference(rc, x, u)
    assert np.allclose(L_x, F_x, atol=1e-4)
    assert np.allclose(L_u, F_u, atol=1e-4)
    assert np.allclose(L_xx, F_xx, atol=1e-2)
    assert np.allclose(L_uu, F_uu, atol=1e-2)

    m = api.UnicycleDynamics4D(0.1)
    x, u = np.array([1.0, 2.0, 0.5, 0.3]), np.array([0.2, -0.1])
    A_fd, B_fd = api.linearize_finite_difference(m.f, x, u)
    A, B = m.linearize(x, u)  # Euler-discretized
    assert np.allclose(np.eye(4) + 0.1 * A_fd, A, atol=1e-5)
    assert np.allclose(0.1 * B_fd, B, atol=1e-5)


def test_flat_kernel_surface():
    """Model / f / integrate / linearize (reference bbdynamicswrap.pyx:8-164)."""
    x, u, dt = np.array([1.0, 2.0, 0.5, 0.3]), np.array([0.1, 0.2]), 0.1
    assert int(api.Model.Unicycle4D) == 3
    xdot = api.f(x, u, api.Model.Unicycle4D)
    assert np.allclose(
        xdot, [0.5 * np.cos(0.3), 0.5 * np.sin(0.3), 0.1, 0.2]
    )
    xn = api.integrate(x, u, dt, api.Model.Unicycle4D)
    m = api.UnicycleDynamics4D(dt)
    assert np.allclose(xn, m(x, u), atol=1e-12)
    A, B = api.linearize(x, u, dt, api.Model.Unicycle4D)
    Am, Bm = m.linearize(x, u)
    assert np.allclose(A, Am) and np.allclose(B, Bm)


def test_graphics_exports():
    """The reference's graphics surface exists on the facade
    (reference __init__.py:33-39)."""
    import matplotlib

    matplotlib.use("Agg")
    for name in (
        "set_bounds",
        "plot_solve",
        "plot_interaction_graph",
        "plot_pairwise_distances",
        "make_trajectory_gif",
        "eyeball_scenario",
    ):
        assert callable(getattr(api, name))
    # Flat-layout smoke: 2 unicycles.
    X = np.zeros((5, 8))
    X[:, 0] = np.linspace(0, 1, 5)
    X[:, 4] = np.linspace(1, 0, 5)
    ax = api.plot_solve(X, 12.3, np.zeros(8), [4, 4], n_d=2)
    assert ax is not None
    import matplotlib.pyplot as plt

    plt.close("all")


def test_solve_distributed_facade_t_kill():
    """t_kill flows through the reference-compatible facade
    (reference distributed.py:25,66-68 -> control.py:213-218)."""
    dt, N, n = 0.1, 10, 3
    models = [api.UnicycleDynamics4D(dt, i) for i in range(n)]
    dynamics = api.MultiDynamicalModel(models)
    x0 = np.array([0.0, 0, 0, 0, 1.5, 0, 0, 0, 0, 1.5, 0, 0])
    xf = np.array([1.5, 1.5, 0, 0, 0, 1.5, 0, 0, 1.5, 0, 0, 0])
    costs = [
        api.ReferenceCost(
            xf[4 * i : 4 * (i + 1)], np.eye(4), np.eye(2), 100 * np.eye(4), i
        )
        for i in range(n)
    ]
    game = api.GameCost(costs, api.ProximityCost([4] * n, 0.5, [2] * n))
    prob = api.ilqrProblem(dynamics, game)
    X0 = np.tile(x0, (N + 1, 1))
    U0 = np.zeros((N, 2 * n))

    # Deadline already expired: returns immediately with a valid plan.
    X, U, J, info = api.solve_distributed(prob, X0, U0, 0.5, t_kill=1e-9)
    assert X.shape == (N + 1, 4 * n) and U.shape == (N, 2 * n)
    assert np.isfinite(J)
    # Generous deadline: matches the no-deadline solve.
    X2, U2, J2, _ = api.solve_distributed(prob, X0, U0, 0.5, t_kill=60.0)
    Xn, Un, Jn, _ = api.solve_distributed(prob, X0, U0, 0.5)
    assert np.isclose(J2, Jn)
    assert np.allclose(X2, Xn)


def test_solve_subproblem_facade():
    """solve_subproblem / solve_subproblem_starmap (reference
    problem.py:97-110): solve one neighborhood subproblem and extract the
    owner's slice."""
    dt, N, radius = 0.1, 10, 0.5
    ids = [100, 101, 102]
    dynamics = api.MultiDynamicalModel(
        [api.DoubleIntDynamics4D(dt, id_) for id_ in ids]
    )
    x0 = np.array([-1.0, 0.1, 0, 0, 1.0, -0.1, 0, 0, 0.0, 3.0, 0, 0])
    xf = np.array([1.0, 0.1, 0, 0, -1.0, -0.1, 0, 0, 0.0, -3.0, 0, 0])
    rcs = [
        api.ReferenceCost(xf[4 * i : 4 * (i + 1)], np.eye(4), np.eye(2),
                          100 * np.eye(4), id_)
        for i, id_ in enumerate(ids)
    ]
    game = api.GameCost(rcs, api.ProximityCost([4] * 3, radius, [2] * 3))
    prob = api.ilqrProblem(dynamics, game)

    # Neighborhood of agents 100+101; agent 102 is solo elsewhere.
    graph = {100: [100, 101], 101: [100, 101]}
    sub = prob.split(graph)[0]
    x0_sub = x0[:8]
    U = np.zeros((N, 4))
    Xi, Ui, id_ = api.solve_subproblem((sub, x0_sub, U, 100, False))
    assert id_ == 100
    assert Xi.shape == (N + 1, 4) and Ui.shape == (N, 2)
    assert np.isfinite(Xi).all()
    # starmap wrapper: same result through the positional-args surface.
    Xi2, Ui2, id2 = api.solve_subproblem_starmap(sub, x0_sub, U, 100)
    assert id2 == 100
    np.testing.assert_allclose(Xi2, Xi, atol=1e-10)
    np.testing.assert_allclose(Ui2, Ui, atol=1e-10)
