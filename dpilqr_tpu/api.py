"""Reference-compatible object facade.

Users of labicon/dp-ilqr interact with ``UnicycleDynamics4D``, ``GameCost``,
``ilqrProblem``, ``ilqrSolver``, ``solve_distributed`` etc. on flat
concatenated state vectors.  This module provides that exact surface
(signatures and semantics mirroring dpilqr/__init__.py) as a thin object
layer over the JAX array core: building one of these objects
assembles a ``Fleet`` + array ``GameCost``; ``solve`` calls the jitted
solver and returns flat numpy arrays like the reference.

The facade is host-side convenience -- performance-critical users should
drive the array API (``dpilqr_tpu.ilqr_solve`` / ``solve_distributed``)
directly.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .config import DEFAULT_CONFIG, SolverConfig
from .models import fleet as _fleet_mod
from .models import specs as _specs
from .ops import costs as _costs
from .ops import ilqr as _ilqr
from . import parallel as _parallel
from .utils.geometry import pairwise_distances as _pairwise_block

__all__ = [
    "DynamicalModel",
    "SymbolicModel",
    "MultiDynamicalModel",
    "DoubleIntDynamics4D",
    "DoubleIntDynamics6D",
    "CarDynamics3D",
    "UnicycleDynamics4D",
    "QuadcopterDynamics6D",
    "QuadcopterDynamics12D",
    "HumanDynamics6D",
    "HumanDynamicsLin6D",
    "BikeDynamics5D",
    "Cost",
    "ReferenceCost",
    "ProximityCost",
    "GameCost",
    "ilqrProblem",
    "ilqrSolver",
    "RecedingHorizonController",
    "solve_centralized",
    "solve_distributed",
    "solve_subproblem",
    "solve_subproblem_starmap",
    "solve_rhc",
    "define_inter_graph_threshold",
    "Point",
    "split_agents",
    "split_agents_gen",
    "split_graph",
    "pos_mask",
    "uniform_block_diag",
    "compute_pairwise_distance",
    "compute_pairwise_distance_nd",
    "_reset_ids",
    "quadraticize_distance",
    "quadraticize_finite_difference",
    "linearize_finite_difference",
    "Model",
    "f",
    "integrate",
    "linearize",
    "set_bounds",
    "plot_solve",
    "plot_interaction_graph",
    "plot_pairwise_distances",
    "make_trajectory_gif",
    "eyeball_scenario",
    "repopath",
    "π",
]


# ------------------------------------------------------------------ dynamics
class DynamicalModel:
    """Facade mirroring the reference ABC (dpilqr/dynamics.py:54-92):
    ``(n_x, n_u, dt, id)`` metadata plus __call__/f/linearize on flat
    numpy vectors."""

    _id = 0

    def __init__(self, spec: _specs.ModelSpec, dt: float, id=None):
        if id is None:
            id = DynamicalModel._id
            DynamicalModel._id += 1
        self.spec = spec
        self.n_x = spec.n_x
        self.n_u = spec.n_u
        self.dt = dt
        self.id = id
        self._fleet = _fleet_mod.Fleet((spec,), dt)

    @classmethod
    def _reset_ids(cls):
        cls._id = 0

    def __call__(self, x, u):
        x = np.asarray(x, float).flatten()[None, : self.n_x]
        u = np.asarray(u, float).flatten()[None, : self.n_u]
        return np.asarray(self._fleet.step(jnp.asarray(x), jnp.asarray(u)))[0]

    def f(self, x, u):
        x = np.asarray(x, float).flatten()[None, : self.n_x]
        u = np.asarray(u, float).flatten()[None, : self.n_u]
        return np.asarray(self._fleet.f(jnp.asarray(x), jnp.asarray(u)))[0]

    def linearize(self, x, u):
        x = np.asarray(x, float).flatten()[None, : self.n_x]
        u = np.asarray(u, float).flatten()[None, : self.n_u]
        A, B = self._fleet.linearize(jnp.asarray(x), jnp.asarray(u))
        return np.asarray(A[0]), np.asarray(B[0])

    def __repr__(self):
        return (
            f"{type(self).__name__}(n_x: {self.n_x}, n_u: {self.n_u}, "
            f"id: {self.id})"
        )


def _concrete(spec):
    class _Model(DynamicalModel):
        def __init__(self, dt, id=None):
            super().__init__(spec, dt, id)

    _Model.__name__ = f"{spec.name.replace('Int', 'IntDynamics')}"
    return _Model


class DoubleIntDynamics4D(DynamicalModel):
    def __init__(self, dt, id=None):
        super().__init__(_specs.DOUBLE_INT_4D, dt, id)


class DoubleIntDynamics6D(DynamicalModel):
    def __init__(self, dt, id=None):
        super().__init__(_specs.DOUBLE_INT_6D, dt, id)


class CarDynamics3D(DynamicalModel):
    def __init__(self, dt, id=None):
        super().__init__(_specs.CAR_3D, dt, id)


class UnicycleDynamics4D(DynamicalModel):
    def __init__(self, dt, id=None):
        super().__init__(_specs.UNICYCLE_4D, dt, id)


class QuadcopterDynamics6D(DynamicalModel):
    def __init__(self, dt, id=None):
        super().__init__(_specs.QUAD_6D, dt, id)


class QuadcopterDynamics12D(DynamicalModel):
    def __init__(self, dt, id=None):
        super().__init__(_specs.QUAD_12D, dt, id)


class HumanDynamics6D(DynamicalModel):
    def __init__(self, dt, id=None):
        super().__init__(_specs.HUMAN_6D, dt, id)


class HumanDynamicsLin6D(DynamicalModel):
    def __init__(self, dt, id=None):
        super().__init__(_specs.HUMAN_LIN_6D, dt, id)


class BikeDynamics5D(DynamicalModel):
    def __init__(self, dt, id=None):
        super().__init__(_specs.BIKE_5D, dt, id)


class SymbolicModel(DynamicalModel):
    """User-extensibility mechanism for new dynamics models (reference
    dynamics.py:95-114): subclass, call ``super().__init__(n_x, n_u, dt)``,
    then hand the sympy state/control symbols and vector field to
    ``self._build(x, u, x_dot)``.  That derives the Jacobians symbolically
    (like the reference's BikeDynamics5D, dynamics.py:254-277), sets the
    reference-compatible ``_f``/``A_num``/``B_num`` numpy lambdas, AND
    lambdifies the vector field into a JAX-traceable ``ModelSpec`` so the
    custom model runs through the whole array core (Fleet dispatch, batched
    solves, distributed decomposition) like any built-in model.

    Object semantics match the reference: ``__call__`` integrates with
    single-substep RK4 over ``dt`` (dynamics.py:70-74), ``linearize``
    returns the Euler-discretized Jacobians ``(I + dt*A_c, dt*B_c)``
    (dynamics.py:112-114).

    A subclass that instead assigns ``_f``/``A_num``/``B_num`` directly (the
    verbatim reference pattern) still works at the object level (f,
    linearize, __call__, single-model solves via finite differencing is NOT
    implied -- only _build wires the array path).
    """

    # Custom model ids live far above the built-in registry (specs.py ids
    # 0-8) so Fleet's unique-spec dedup never conflates them.
    _next_custom_id = 1000

    def __init__(self, n_x, n_u, dt, id=None, n_pos: int = 2):
        if id is None:
            id = DynamicalModel._id
            DynamicalModel._id += 1
        self.n_x = n_x
        self.n_u = n_u
        self.dt = dt
        self.id = id
        self.n_pos = n_pos
        self.spec = None
        self._fleet = None

    def _build(self, x_sym, u_sym, x_dot_sym):
        """Derive Jacobians + lambdify (numpy for the object surface, JAX
        for the array core) from sympy ``x``, ``u``, ``x_dot`` matrices."""
        import sympy as sym
        import jax.numpy as _jnp

        A = x_dot_sym.jacobian(x_sym)
        B = x_dot_sym.jacobian(u_sym)
        # Reference-compatible numpy lambdas (dynamics.py:273-277).
        self._f = sym.lambdify((x_sym, u_sym), sym.Array(x_dot_sym)[:, 0])
        self.A_num = sym.lambdify((x_sym, u_sym), A)
        self.B_num = sym.lambdify((x_sym, u_sym), B)
        # JAX-traceable vector field for the array core (flat expression list;
        # sympy's code printer cannot print NDimArray for arbitrary modules).
        fj = sym.lambdify((x_sym, u_sym), list(x_dot_sym), modules=_jnp)
        n_x = self.n_x

        def f_jax(x, u):
            parts = [jnp.asarray(p, dtype=x.dtype) for p in fj(x, u)]
            return jnp.stack(jnp.broadcast_arrays(*parts)).reshape(n_x)

        mid = SymbolicModel._next_custom_id
        SymbolicModel._next_custom_id += 1
        self.spec = _specs.ModelSpec(
            name=type(self).__name__,
            model_id=mid,
            n_x=self.n_x,
            n_u=self.n_u,
            f=f_jax,
            rk4_substeps=1,  # reference SymbolicModel integrates dh=dt
            n_pos=self.n_pos,
        )
        self._fleet = _fleet_mod.Fleet((self.spec,), self.dt)

    def f(self, x, u):
        return np.asarray(self._f(np.asarray(x, float), np.asarray(u, float)))

    def linearize(self, x, u):
        """Euler-discretized symbolic Jacobians (reference dynamics.py:112-114)."""
        x = np.asarray(x, float)
        u = np.asarray(u, float)
        return (
            np.eye(x.size) + self.dt * np.asarray(self.A_num(x, u)),
            self.dt * np.asarray(self.B_num(x, u)),
        )

    def __call__(self, x, u):
        """Single-substep RK4 over dt (reference dynamics.py:70-74,18-38)."""
        x = np.asarray(x, float)
        u = np.asarray(u, float)
        h = self.dt
        k0 = self.f(x, u)
        k1 = self.f(x + 0.5 * h * k0, u)
        k2 = self.f(x + 0.5 * h * k1, u)
        k3 = self.f(x + h * k2, u)
        return x + h * (k0 + 2 * k1 + 2 * k2 + k3) / 6.0


class MultiDynamicalModel(DynamicalModel):
    """Composition of submodels (reference dynamics.py:133-202)."""

    def __init__(self, submodels):
        self.submodels = submodels
        self.n_players = len(submodels)
        self.x_dims = [m.n_x for m in submodels]
        self.u_dims = [m.n_u for m in submodels]
        self.ids = [m.id for m in submodels]
        self.n_x = sum(self.x_dims)
        self.n_u = sum(self.u_dims)
        self.dt = submodels[0].dt
        self.id = -1
        self._fleet = _fleet_mod.Fleet(
            tuple(m.spec for m in submodels), self.dt
        )

    def __call__(self, x, u):
        xb = self._fleet.pad_states(np.asarray(x, float))
        ub = self._fleet.pad_controls(np.asarray(u, float))
        out = self._fleet.step(jnp.asarray(xb), jnp.asarray(ub))
        return self._fleet.unpad_states(out).flatten()

    def f(self, x, u):
        xb = self._fleet.pad_states(np.asarray(x, float))
        ub = self._fleet.pad_controls(np.asarray(u, float))
        out = self._fleet.f(jnp.asarray(xb), jnp.asarray(ub))
        return self._fleet.unpad_states(out).flatten()

    def linearize(self, x, u):
        """Dense block-diagonal joint Jacobians (API parity with
        dynamics.py:173-186; the solver itself never densifies)."""
        xb = self._fleet.pad_states(np.asarray(x, float))
        ub = self._fleet.pad_controls(np.asarray(u, float))
        A, B = self._fleet.linearize(jnp.asarray(xb), jnp.asarray(ub))
        A, B = np.asarray(A), np.asarray(B)
        nX, nU = self.n_x, self.n_u
        Ad = np.zeros((nX, nX))
        Bd = np.zeros((nX, nU))
        ox = ou = 0
        for i, m in enumerate(self.submodels):
            Ad[ox : ox + m.n_x, ox : ox + m.n_x] = A[i, : m.n_x, : m.n_x]
            Bd[ox : ox + m.n_x, ou : ou + m.n_u] = B[i, : m.n_x, : m.n_u]
            ox += m.n_x
            ou += m.n_u
        return Ad, Bd

    def split(self, graph):
        """Sub-models per interaction-graph problem (dynamics.py:188-198)."""
        return [
            MultiDynamicalModel(
                [m for m in self.submodels if m.id in graph[pid]]
            )
            for pid in graph
        ]

    def __repr__(self):
        subs = ",\n\t".join(repr(m) for m in self.submodels)
        return f"MultiDynamicalModel(\n\t{subs}\n)"


# ------------------------------------------------------------------ costs
class Cost:
    pass


class ReferenceCost(Cost):
    """Quadratic tracking cost (reference cost.py:37-107)."""

    _id = 0

    def __init__(self, xf, Q, R, Qf=None, id=None):
        if Qf is None:
            Qf = np.eye(Q.shape[0])
        if id is None:
            id = ReferenceCost._id
            ReferenceCost._id += 1
        self.xf = np.asarray(xf, float).flatten()
        self.Q = np.asarray(Q, float)
        self.R = np.asarray(R, float)
        self.Qf = np.asarray(Qf, float)
        self.id = id

    @property
    def x_dim(self):
        return self.Q.shape[0]

    @property
    def u_dim(self):
        return self.R.shape[0]

    @classmethod
    def _reset_ids(cls):
        cls._id = 0

    def __call__(self, x, u, terminal=False):
        x = np.asarray(x, float).flatten()
        e = x - self.xf
        if terminal:
            return float(e @ self.Qf @ e)
        u = np.asarray(u, float).flatten()
        return float(e @ self.Q @ e + u @ self.R @ u)

    def quadraticize(self, x, u, terminal=False):
        x = np.asarray(x, float).flatten()
        u = np.asarray(u, float).flatten()
        e = x - self.xf
        if terminal:
            L_x = e @ (self.Qf + self.Qf.T)
            L_xx = self.Qf + self.Qf.T
            L_u = np.zeros(self.u_dim)
            L_uu = np.zeros((self.u_dim, self.u_dim))
        else:
            L_x = e @ (self.Q + self.Q.T)
            L_u = u @ (self.R + self.R.T)
            L_xx = self.Q + self.Q.T
            L_uu = self.R + self.R.T
        L_ux = np.zeros((self.u_dim, self.x_dim))
        return L_x, L_u, L_xx, L_uu, L_ux


class ProximityCost(Cost):
    """Pairwise penalty ``sum min(0, d - r)^2`` (reference cost.py:110-171).

    ``eval_n_d``: position dimensionality used to EVALUATE the penalty.  The
    default "reference" reproduces the reference exactly: uniform-dimension
    fleets evaluate with 2-D distances -- even all-3-D fleets -- via
    ``compute_pairwise_distance``'s ``n_d=2`` default (cost.py:121-123,
    util.py:48), while mixed fleets evaluate per-pair ``min(n_dims)``
    (cost.py:125-130).  Quadraticization always uses per-pair
    ``min(n_dims)`` (cost.py:135-171).  Pass ``eval_n_d=None`` for the
    self-consistent mode (evaluation matches the derivatives), or an int to
    force a specific evaluation dimensionality.
    """

    def __init__(self, x_dims, radius, n_dims=None, eval_n_d="reference"):
        self.x_dims = list(x_dims)
        self.radius = radius
        self.n_dims = list(n_dims) if n_dims is not None else [2] * len(x_dims)
        if eval_n_d == "reference":
            eval_n_d = 2 if len(set(self.n_dims)) == 1 else None
        self.eval_n_d = eval_n_d
        self.n_agents = len(x_dims)

    def _block(self, x):
        x = np.asarray(x, float).flatten()
        nx = self.x_dims[0]
        return x.reshape(self.n_agents, nx)

    def _spec(self, dtype=float):
        n, nx = self.n_agents, self.x_dims[0]
        return _costs.make_game_cost(
            np.zeros((n, nx)),
            np.zeros((n, nx, nx)),
            np.zeros((n, 1, 1)),
            np.zeros((n, nx, nx)),
            radius=self.radius,
            n_pos=np.asarray(self.n_dims),
            prox_eval_n_d=self.eval_n_d,
        )

    def __call__(self, x):
        if self.n_agents == 1:
            return 0.0
        return float(
            _costs.proximity_cost(self._spec(), jnp.asarray(self._block(x)))
        )

    def quadraticize(self, x):
        xb = jnp.asarray(self._block(x))
        L_x, L_xx = _costs.proximity_quadraticize(self._spec(), xb)
        nX = sum(self.x_dims)
        return (
            np.asarray(L_x).reshape(nX),
            np.asarray(L_xx).reshape(nX, nX),
        )


class GameCost(Cost):
    """Potential-game sum (reference cost.py:174-266)."""

    REF_WEIGHT = 1.0
    PROX_WEIGHT = 200.0

    def __init__(self, reference_costs, proximity_cost=None):
        self.ref_costs = reference_costs
        self.prox_cost = proximity_cost
        self.x_dims = [rc.x_dim for rc in reference_costs]
        self.u_dims = [rc.u_dim for rc in reference_costs]
        self.ids = [rc.id for rc in reference_costs]
        self.n_agents = len(reference_costs)

    @property
    def xf(self):
        return np.concatenate([rc.xf for rc in self.ref_costs])

    def __call__(self, x, u, terminal=False):
        x = np.asarray(x, float).flatten()
        u = np.asarray(u, float).flatten()
        total = 0.0
        ox = ou = 0
        for rc in self.ref_costs:
            total += rc(
                x[ox : ox + rc.x_dim], u[ou : ou + rc.u_dim], terminal
            )
            ox += rc.x_dim
            ou += rc.u_dim
        prox = self.prox_cost(x) if self.prox_cost else 0.0
        return self.REF_WEIGHT * total + self.PROX_WEIGHT * prox

    def quadraticize(self, x, u, terminal=False):
        x = np.asarray(x, float).flatten()
        u = np.asarray(u, float).flatten()
        nX, nU = sum(self.x_dims), sum(self.u_dims)
        L_x = np.zeros(nX)
        L_u = np.zeros(nU)
        L_xx = np.zeros((nX, nX))
        L_uu = np.zeros((nU, nU))
        L_ux = np.zeros((nU, nX))
        ox = ou = 0
        for rc in self.ref_costs:
            lx, lu, lxx, luu, _ = rc.quadraticize(
                x[ox : ox + rc.x_dim], u[ou : ou + rc.u_dim], terminal
            )
            L_x[ox : ox + rc.x_dim] = lx
            L_u[ou : ou + rc.u_dim] = lu
            L_xx[ox : ox + rc.x_dim, ox : ox + rc.x_dim] = lxx
            L_uu[ou : ou + rc.u_dim, ou : ou + rc.u_dim] = luu
            ox += rc.x_dim
            ou += rc.u_dim
        L_x *= self.REF_WEIGHT
        L_u *= self.REF_WEIGHT
        L_xx *= self.REF_WEIGHT
        L_uu *= self.REF_WEIGHT
        if self.n_agents > 1 and self.prox_cost:
            lp_x, lp_xx = self.prox_cost.quadraticize(x)
            L_x += self.PROX_WEIGHT * lp_x
            L_xx += self.PROX_WEIGHT * lp_xx
        return L_x, L_u, L_xx, L_uu, L_ux

    def split(self, graph):
        """Sub game-costs per interaction-graph problem (cost.py:241-262)."""
        n_states = self.ref_costs[0].x_dim
        radius = self.prox_cost.radius if self.prox_cost else 0.0
        n_dims = (
            self.prox_cost.n_dims
            if self.prox_cost
            else [2] * self.n_agents
        )
        out = []
        for prob_ids in graph.values():
            rcs, nds = [], []
            for nd, rc in zip(n_dims, self.ref_costs):
                if rc.id in prob_ids:
                    rcs.append(rc)
                    nds.append(nd)
            eval_n_d = self.prox_cost.eval_n_d if self.prox_cost else None
            out.append(
                GameCost(
                    rcs,
                    ProximityCost(
                        [n_states] * len(rcs), radius, nds, eval_n_d=eval_n_d
                    ),
                )
            )
        return out

    # ---- array-spec assembly for the array core ---------------------------
    def to_array_spec(self, fleet: _fleet_mod.Fleet) -> _costs.GameCost:
        nxp, nup = fleet.nx_p, fleet.nu_p
        n = self.n_agents
        xf = np.zeros((n, nxp))
        Q = np.zeros((n, nxp, nxp))
        R = np.zeros((n, nup, nup))
        Qf = np.zeros((n, nxp, nxp))
        for i, rc in enumerate(self.ref_costs):
            xf[i, : rc.x_dim] = rc.xf
            Q[i, : rc.x_dim, : rc.x_dim] = rc.Q
            R[i, : rc.u_dim, : rc.u_dim] = rc.R
            Qf[i, : rc.x_dim, : rc.x_dim] = rc.Qf
        radius = self.prox_cost.radius if self.prox_cost else 0.0
        n_pos = (
            np.asarray(self.prox_cost.n_dims)
            if self.prox_cost
            else np.full(n, 2)
        )
        return _costs.make_game_cost(
            xf, Q, R, Qf, radius=radius, n_pos=n_pos,
            prox_weight=self.PROX_WEIGHT, ref_weight=self.REF_WEIGHT,
            prox_eval_n_d=(
                self.prox_cost.eval_n_d if self.prox_cost else None
            ),
        )


# ------------------------------------------------------------------ problem
class ilqrProblem:
    """Dynamics + cost (reference problem.py:15-94)."""

    def __init__(self, dynamics, cost):
        self.dynamics = dynamics
        self.game_cost = cost
        self.n_agents = (
            len(cost.ref_costs) if isinstance(cost, GameCost) else 1
        )

    @property
    def ids(self):
        if not isinstance(self.dynamics, MultiDynamicalModel):
            raise NotImplementedError(
                "Only MultiDynamicalModel's have an 'ids' attribute"
            )
        if self.dynamics.ids != self.game_cost.ids:
            raise ValueError(
                f"Dynamics and cost have inconsistent ID's: {self}"
            )
        return list(self.dynamics.ids)

    def _as_game(self):
        """Normalize single-agent problems to 1-agent game form."""
        if isinstance(self.game_cost, GameCost):
            return self.game_cost
        return GameCost([self.game_cost])

    def _fleet(self) -> _fleet_mod.Fleet:
        if isinstance(self.dynamics, MultiDynamicalModel):
            return self.dynamics._fleet
        return self.dynamics._fleet

    def split(self, graph):
        return [
            ilqrProblem(d, c)
            for d, c in zip(
                self.dynamics.split(graph), self.game_cost.split(graph)
            )
        ]

    def extract(self, X, U, id_):
        """One agent's rows from a concatenated solution (problem.py:49-64;
        assumes uniform dims, like the reference)."""
        ids = self.ids
        if id_ not in ids:
            raise IndexError(f"Index {id_} not in ids: {ids}.")
        i = ids.index(id_)
        nx = self.game_cost.x_dims[0]
        nu = self.game_cost.u_dims[0]
        return X[:, i * nx : (i + 1) * nx], U[:, i * nu : (i + 1) * nu]

    def selfish_warmstart(self, x0, N):
        """Per-agent solo warm start (problem.py:66-91), batched on device."""
        fleet = self._fleet()
        game = self._as_game()
        spec = game.to_array_spec(fleet)
        xb = fleet.pad_states(np.asarray(x0, float))
        U = _parallel.selfish_warmstart(fleet, spec, jnp.asarray(xb), N)
        return fleet.unpad_controls(np.asarray(U))

    def __repr__(self):
        return f"ilqrProblem(\n\t{self.dynamics},\n\t{self.game_cost}\n)"


# ------------------------------------------------------------------ solver
class ilqrSolver:
    """Reference-shaped solver facade (control.py:15-249) over the jitted
    array core.  ``solve`` returns flat numpy ``(X, U, J)``."""

    def __init__(self, problem: ilqrProblem, N: int = 10):
        self.problem = problem
        self.N = N

    @property
    def dt(self):
        return self.problem.dynamics.dt

    @property
    def n_x(self):
        return self.problem.dynamics.n_x

    @property
    def n_u(self):
        return self.problem.dynamics.n_u

    def _rollout(self, x0, U):
        fleet = self.problem._fleet()
        game = self.problem._as_game()
        spec = game.to_array_spec(fleet)
        xb = fleet.pad_states(np.asarray(x0, float))
        Ub = fleet.pad_controls(np.asarray(U, float))
        X, J = _ilqr.rollout(fleet, spec, jnp.asarray(xb), jnp.asarray(Ub))
        return fleet.unpad_states(np.asarray(X)), float(J)

    def solve(
        self,
        x0,
        U=None,
        n_lqr_iter: int = 50,
        tol: float = 1e-3,
        t_kill: float | None = None,
        verbose: bool = True,
    ):
        fleet = self.problem._fleet()
        game = self.problem._as_game()
        spec = game.to_array_spec(fleet)
        xb = jnp.asarray(fleet.pad_states(np.asarray(x0, float)))
        if U is None:
            U = np.zeros((self.N, self.n_u))
        if U.shape != (self.N, self.n_u):
            raise ValueError(
                f"U must be ({self.N}, {self.n_u}), got {U.shape}"
            )
        Ub = jnp.asarray(fleet.pad_controls(np.asarray(U, float)))
        cfg = SolverConfig(n_lqr_iter=n_lqr_iter, tol=tol)
        if t_kill is not None:
            res = _ilqr.ilqr_solve_steppable(
                fleet, spec, xb, U0=Ub, config=cfg, t_kill=t_kill,
                verbose=verbose,
            )
        else:
            res = _ilqr.ilqr_solve(fleet, spec, xb, U0=Ub, config=cfg)
        if verbose:
            print(
                f"{int(res.iters)}/{n_lqr_iter}\tJ: {float(res.J):g}"
                f"\tconverged: {bool(res.converged)}"
            )
        X = fleet.unpad_states(np.asarray(res.X))
        Uo = fleet.unpad_controls(np.asarray(res.U))
        return X, Uo, float(res.J)

    def __repr__(self):
        return f"ilqrSolver(problem: {self.problem}, N: {self.N})"


class RecedingHorizonController:
    """Generator-based MPC wrapper (reference control.py:253-326)."""

    def __init__(self, x0, controller: ilqrSolver, step_size: int = 1):
        self.x = np.asarray(x0, float).flatten()
        self._controller = controller
        self.step_size = step_size

    @property
    def N(self):
        return self._controller.N

    def solve(self, U0, J_converge: float = 1.0, **kwargs):
        U = U0
        while True:
            if U.shape != (self._controller.N, self._controller.n_u):
                raise RuntimeError
            X, U, J = self._controller.solve(self.x, U, **kwargs)
            self.x = X[self.step_size]
            yield X[: self.step_size], U[: self.step_size], J
            U = np.vstack(
                [
                    U[self.step_size :],
                    np.zeros((self.step_size, self._controller.n_u)),
                ]
            )
            if J < J_converge:
                break


def solve_subproblem(args, **kwargs):
    """Solve one neighborhood subproblem and extract the owner's slice
    (reference problem.py:97-105): ``args = (subproblem, x0, U, id_[,
    verbose])``, returns ``(Xi, Ui, id_)``.  Kept for drop-in callers; the
    array path batches all subproblems into one program instead
    (parallel/distributed.py)."""
    subproblem, x0, U, id_, *rest = args
    # Pop the kwarg unconditionally so it is never forwarded twice when a
    # caller passes BOTH the 5-tuple args and verbose= (ADVICE r4).
    verbose = kwargs.pop("verbose", False)
    if rest:
        verbose = rest[0]
    solver = ilqrSolver(subproblem, U.shape[0])
    Xi, Ui, _ = solver.solve(x0, U, verbose=verbose, **kwargs)
    return (*subproblem.extract(Xi, Ui, id_), id_)


def solve_subproblem_starmap(subproblem, x0, U, id_):
    """Positional-argument wrapper for pool ``starmap`` compatibility
    (reference problem.py:108-110)."""
    return solve_subproblem((subproblem, x0, U, id_))


# ------------------------------------------------------------------ distributed
def define_inter_graph_threshold(X, radius, x_dims, ids, n_d: int = 2):
    """Thresholded-distance interaction graph on flat trajectories
    (reference distributed.py:224-247; planar distances like the reference)."""
    X = np.atleast_2d(np.asarray(X, float))
    n = len(x_dims)
    nx = x_dims[0]
    Xb = X.reshape(X.shape[0], n, nx)
    M = _parallel.interaction_graph(jnp.asarray(Xb), radius, n_d=n_d)
    return _parallel.graph_to_dict(M, ids=ids)


def solve_centralized(solver: ilqrSolver, xi, U, ids, verbose=False, **kwargs):
    """Timing wrapper (reference distributed.py:250-258)."""
    from time import perf_counter as pc

    t0 = pc()
    X, U, J = solver.solve(xi, U, verbose=verbose, **kwargs)
    dt_ = pc() - t0
    return X, U, J, {id_: (dt_, ids) for id_ in ids}


def solve_distributed(
    problem: ilqrProblem,
    X,
    U,
    radius,
    ignore_ids=None,
    pool=None,
    verbose=False,
    **kwargs,
):
    """Decomposed solve on flat arrays (reference distributed.py:25-103).

    ``pool`` is accepted for signature parity and ignored: subproblems solve
    as ONE batched device program instead of worker processes.
    """
    del pool
    fleet = problem._fleet()
    game = problem._as_game()
    spec = game.to_array_spec(fleet)
    ids = problem.ids
    n = len(ids)
    nx, nu = game.x_dims[0], game.u_dims[0]

    X = np.atleast_2d(np.asarray(X, float))
    Xb = X.reshape(X.shape[0], n, nx)
    N = U.shape[0]
    Ub = np.asarray(U, float).reshape(N, n, nu)

    ignore_mask = None
    if ignore_ids:
        bad = [i for i in ignore_ids if i not in ids]
        if bad:
            raise ValueError(f"Some of {ignore_ids} not in {ids}.")
        ignore_mask = np.array([i in ignore_ids for i in ids])

    from time import perf_counter as pc

    t0 = pc()
    res = _parallel.solve_distributed(
        fleet, spec, jnp.asarray(Xb), jnp.asarray(Ub), radius,
        ignore_mask=ignore_mask, **kwargs,
    )
    dt_ = pc() - t0

    graph = _parallel.graph_to_dict(res.membership, ids=ids)
    # Per-subproblem wall-time attribution (reference distributed.py:65-77
    # reports real per-subproblem times; the batch runs in lockstep, so a
    # subproblem's share of the wall clock scales with the iterations it
    # actually executed before converging/failing).
    iters = np.asarray(res.iters, float)
    max_it = max(float(iters.max()), 1.0)
    solve_info = {}
    for k, id_ in enumerate(ids):
        if ignore_mask is not None and ignore_mask[k]:
            solve_info[id_] = (0.0, [id_])
        else:
            solve_info[id_] = (dt_ * iters[k] / max_it, graph[id_])
    X_dec = np.asarray(res.X).reshape(N + 1, n * nx)
    U_dec = np.asarray(res.U).reshape(N, n * nu)
    if verbose:
        print(f"Interaction Graph: {graph}")
    return X_dec, U_dec, float(res.J), solve_info


def solve_rhc(
    problem: ilqrProblem,
    x0,
    N,
    radius=None,
    centralized=True,
    n_d=2,
    step_size=1,
    J_converge=None,
    dist_converge=None,
    t_diverge=None,
    t_kill=None,
    ignore_ids=None,
    verbose=False,
    **kwargs,
):
    """Receding-horizon driver on flat arrays (reference distributed.py:106-221)."""
    fleet = problem._fleet()
    game = problem._as_game()
    spec = game.to_array_spec(fleet)
    ids = problem.ids
    ignore_mask = (
        np.array([i in ignore_ids for i in ids]) if ignore_ids else None
    )
    res = _parallel.solve_rhc(
        fleet, spec, fleet.pad_states(np.asarray(x0, float)), N,
        radius=radius, centralized=centralized, step_size=step_size,
        J_converge=J_converge, dist_converge=dist_converge, n_d=n_d,
        t_diverge=t_diverge, t_kill=t_kill, ignore_mask=ignore_mask,
        verbose=verbose, **kwargs,
    )
    X_full = fleet.unpad_states(res.X)
    U_full = fleet.unpad_controls(res.U)
    return X_full, U_full, res.J


# ------------------------------------------------------------------ util parity
from dataclasses import dataclass as _dataclass


@_dataclass
class Point:
    """3D point (reference util.py:20-45)."""

    x: float
    y: float
    z: float = 0

    @property
    def ndim(self):
        return 2 if self.z == 0 else 3

    def __add__(self, o):
        return Point(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Point(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o):
        return Point(self.x * o.x, self.y * o.y, self.z * o.z)

    def hypot2(self):
        return self.x**2 + self.y**2 + self.z**2

    def __repr__(self):
        return str((self.x, self.y, self.z))


def split_agents(Z, z_dims):
    """Column-partition a flat multi-agent array (reference util.py:90-92)."""
    return np.split(np.atleast_2d(Z), np.cumsum(z_dims[:-1]), axis=1)


def split_agents_gen(z, z_dims):
    """Generator version assuming uniform dims (reference util.py:95-99)."""
    dim = z_dims[0]
    for i in range(len(z_dims)):
        yield z[i * dim : (i + 1) * dim]


def split_graph(Z, z_dims, graph):
    """Group flat columns by interaction-graph membership
    (same surface as reference util.py:102-117): one flat array per
    graph entry, holding that neighborhood's member columns in order."""
    assert len(set(z_dims)) == 1, "split_graph assumes uniform agent dims"
    Z = np.atleast_2d(Z)
    nz = z_dims[0]
    order = {agent: k for k, agent in enumerate(graph)}
    blocks = Z.reshape(Z.shape[0], len(z_dims), nz)
    return [
        blocks[:, [order[i] for i in ids]].reshape(Z.shape[0], -1)
        for ids in graph.values()
    ]


def pos_mask(x_dims, n_d=2):
    """Boolean mask of position components in the flat layout
    (reference util.py:120-122)."""
    return np.array([i % x_dims[0] < n_d for i in range(sum(x_dims))])


def compute_pairwise_distance_nd(X, x_dims, n_dims, dec_ind=None):
    """Heterogeneous-dimension pairwise distances (reference util.py:64-87)."""
    import itertools

    X = np.atleast_2d(np.asarray(X, float))
    n_states = x_dims[0]
    n_agents = len(x_dims)
    pair_inds = list(itertools.combinations(range(n_agents), 2))
    if dec_ind is not None:
        pair_inds = [p for p in pair_inds if dec_ind in p]
    cols = []
    for i, j in pair_inds:
        nd = min(n_dims[i], n_dims[j])
        Xi = X[:, i * n_states : i * n_states + nd]
        Xj = X[:, j * n_states : j * n_states + nd]
        cols.append(np.linalg.norm(Xi - Xj, axis=1).reshape(-1, 1))
    return np.concatenate(cols, axis=1) if cols else np.zeros((X.shape[0], 0))


def uniform_block_diag(*arrs):
    """Dense block-diagonal assembly (reference util.py:229-236)."""
    r, c = arrs[0].shape
    out = np.zeros((len(arrs) * r, len(arrs) * c))
    for i, a in enumerate(arrs):
        out[r * i : r * (i + 1), c * i : c * (i + 1)] = a
    return out


def compute_pairwise_distance(X, x_dims, n_d=2):
    """Pairwise distances on flat trajectories (reference util.py:48-61)."""
    X = np.atleast_2d(np.asarray(X, float))
    n = len(x_dims)
    Xb = X.reshape(X.shape[0], n, x_dims[0])
    return np.asarray(_pairwise_block(jnp.asarray(Xb), n_d=n_d))


def _reset_ids():
    """Reset facade id counters (reference problem.py:113-116)."""
    DynamicalModel._reset_ids()
    ReferenceCost._reset_ids()


π = np.pi


def repopath():
    """Repository root (reference util.py:17 exposes the analogous path)."""
    import pathlib

    return pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------- derivative-check parity
def quadraticize_distance(point_a: Point, point_b: Point, radius, n_d):
    """Gradient/Hessian of ``min(0, d - r)^2`` wrt ``point_a`` in ``n_d``
    dims (reference cost.py:269-315; same closed form the array core uses:
    ``H = (2 - 2r/d) I + (2r/d^3) dd^T`` inside the radius, zero outside)."""
    assert point_a.ndim == point_b.ndim
    delta = np.array(
        [point_a.x - point_b.x, point_a.y - point_b.y, point_a.z - point_b.z]
    )
    d = np.linalg.norm(delta)
    if d > radius:
        return np.zeros(n_d), np.zeros((n_d, n_d))
    L_x = 2.0 * (d - radius) / d * delta
    L_xx = (2.0 - 2.0 * radius / d) * np.eye(3) + (
        2.0 * radius / d**3
    ) * np.outer(delta, delta)
    return L_x[:n_d], L_xx[:n_d, :n_d]


def _fd_jacobian(fun, z, eps):
    """Forward-difference Jacobian of vector-valued ``fun`` at ``z``:
    rows index ``fun``'s output, columns the perturbed coordinate."""
    f0 = np.atleast_1d(np.asarray(fun(z), float))
    J = np.empty((f0.size, z.size))
    for j in range(z.size):
        zp = z.copy()
        zp[j] += eps
        J[:, j] = (np.atleast_1d(np.asarray(fun(zp), float)) - f0) / eps
    return J


def quadraticize_finite_difference(cost, x, u, terminal=False, jac_eps=None):
    """Finite-difference quadraticization (same surface as reference
    cost.py:318-349); the model-agnostic derivative check for custom Cost
    objects.  Gradients use step ``jac_eps`` (default sqrt(machine eps));
    Hessians difference those gradients with step ``sqrt(jac_eps)``."""
    x = np.asarray(x, float).ravel()
    u = np.asarray(u, float).ravel()
    eps = jac_eps if jac_eps else np.sqrt(np.finfo(float).eps)
    heps = np.sqrt(eps)

    def grad_x(x_, u_):
        return _fd_jacobian(lambda z: cost(z, u_, terminal), x_, eps)[0]

    def grad_u(x_, u_):
        return _fd_jacobian(lambda z: cost(x_, z, terminal), u_, eps)[0]

    L_xx = _fd_jacobian(lambda z: grad_x(z, u), x, heps)
    L_uu = _fd_jacobian(lambda z: grad_u(x, z), u, heps)
    L_ux = _fd_jacobian(lambda z: grad_u(z, u), x, heps)
    return grad_x(x, u), grad_u(x, u), L_xx, L_uu, L_ux


def linearize_finite_difference(f_, x, u):
    """Finite-difference dynamics linearization (same surface as reference
    dynamics.py:281-290): continuous-time Jacobians A = df/dx, B = df/du."""
    x = np.asarray(x, float).ravel()
    u = np.asarray(u, float).ravel()
    eps = np.sqrt(np.finfo(float).eps)
    A = _fd_jacobian(lambda z: f_(z, u), x, eps)
    B = _fd_jacobian(lambda z: f_(x, z), u, eps)
    return A, B


# ---------------------------------------------------- flat kernel surface
import enum as _enum


class Model(_enum.IntEnum):
    """Native-kernel model enum (reference bbdynamicswrap.pyx:8-16; values
    match the ModelSpec registry ids, models/specs.py:166-173)."""

    DoubleInt4D = 0
    DoubleInt6D = 1
    Car3D = 2
    Unicycle4D = 3
    Human6D = 4
    HumanLin6D = 5
    Quad6D = 6
    Quad12D = 7


def f(x, u, model):
    """Continuous dynamics of one model (reference bbdynamicswrap.pyx:61-92)."""
    spec = _specs.MODEL_REGISTRY[int(model)]
    x = np.asarray(x, float).flatten()[: spec.n_x]
    u = np.asarray(u, float).flatten()[: spec.n_u]
    from .native import host as _host

    if _host.available():
        xp = np.zeros((1, spec.n_x))
        up = np.zeros((1, spec.n_u))
        xp[0], up[0] = x, u
        return _host.f([spec.model_id], xp, up)[0]
    return np.asarray(spec.f(jnp.asarray(x), jnp.asarray(u)))


def integrate(x, u, dt, model):
    """RK4 step of one model (reference bbdynamicswrap.pyx:93-124; the C
    kernel uses each model's reference substep count)."""
    spec = _specs.MODEL_REGISTRY[int(model)]
    x = np.asarray(x, float).flatten()[: spec.n_x]
    u = np.asarray(u, float).flatten()[: spec.n_u]
    from .native import host as _host

    if _host.available():
        return _host.step([spec.model_id], x[None], u[None], dt)[0]
    fleet = _fleet_mod.Fleet((spec,), dt)
    return np.asarray(fleet.step(jnp.asarray(x[None]), jnp.asarray(u[None])))[0]


def linearize(x, u, dt, model):
    """Euler-discretized Jacobians of one model
    (reference bbdynamicswrap.pyx:125-164)."""
    spec = _specs.MODEL_REGISTRY[int(model)]
    x = np.asarray(x, float).flatten()[: spec.n_x]
    u = np.asarray(u, float).flatten()[: spec.n_u]
    from .native import host as _host

    if _host.available():
        A, B = _host.linearize([spec.model_id], x[None], u[None], dt)
        return A[0], B[0]
    fleet = _fleet_mod.Fleet((spec,), dt)
    A, B = fleet.linearize(jnp.asarray(x[None]), jnp.asarray(u[None]))
    return np.asarray(A[0]), np.asarray(B[0])


# ---------------------------------------------------- graphics (flat layout)
from .utils import viz as _viz

set_bounds = _viz.set_bounds
plot_interaction_graph = _viz.plot_interaction_graph


def _to_block(X, x_dims):
    X = np.atleast_2d(np.asarray(X, float))
    n = len(x_dims)
    return X.reshape(X.shape[0], n, x_dims[0])


def plot_solve(X, J, x_goal, x_dims=None, color_agents=False, n_d=2, ax=None):
    """Trajectory plot on flat arrays (reference graphics.py:93-143)."""
    if x_dims is None:
        x_dims = [np.atleast_2d(np.asarray(X)).shape[1]]
    Xb = _to_block(X, x_dims)
    xfb = np.asarray(x_goal, float).reshape(len(x_dims), x_dims[0])
    return _viz.plot_solve(
        Xb, J, xfb, color_agents=color_agents, n_d=n_d, ax=ax
    )


def plot_pairwise_distances(X, x_dims, n_dims, radius):
    """Pairwise-distance plot on flat arrays (reference graphics.py:146-156)."""
    return _viz.plot_pairwise_distances(
        _to_block(X, x_dims), radius, n_pos=np.asarray(n_dims)
    )


def make_trajectory_gif(gifname, X, xf, x_dims, radius):
    """Animated trajectory GIF on flat arrays (reference graphics.py:220-236)."""
    xfb = np.asarray(xf, float).reshape(len(x_dims), x_dims[0])
    return _viz.make_trajectory_gif(
        str(gifname), _to_block(X, x_dims), xfb, radius
    )


def eyeball_scenario(x0, xf, n_agents, n_states):
    """Start->goal arrows on flat arrays (reference graphics.py:239-252)."""
    return _viz.eyeball_scenario(
        np.asarray(x0, float).reshape(n_agents, n_states),
        np.asarray(xf, float).reshape(n_agents, n_states),
    )
