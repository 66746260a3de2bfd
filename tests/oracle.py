"""Independent numpy oracle: a literal, dense implementation of the reference
algorithm (labicon/dp-ilqr) used to validate the JAX solver's numerics.

Everything here is plain Python/numpy with data-dependent control flow --
exactly the computation the reference performs (control.py, cost.py,
bbdynamics.cpp) -- so agreement in float64 validates the JAX solver
end to end.
"""

from __future__ import annotations

import itertools

import numpy as np

G = 9.80665


# ---------------------------------------------------------------- dynamics
def rk4(f, x, u, dt, substeps=5):
    dh = dt / substeps
    x = x.astype(float).copy()
    for _ in range(substeps):
        k0 = f(x, u)
        k1 = f(x + 0.5 * dh * k0, u)
        k2 = f(x + 0.5 * dh * k1, u)
        k3 = f(x + dh * k2, u)
        x = x + dh * (k0 + 2 * k1 + 2 * k2 + k3) / 6.0
    return x


def f_unicycle(x, u):
    return np.array([x[2] * np.cos(x[3]), x[2] * np.sin(x[3]), u[0], u[1]])


def jac_unicycle(x, u, dt):
    A = np.zeros((4, 4))
    A[0, 2] = np.cos(x[3])
    A[0, 3] = -x[2] * np.sin(x[3])
    A[1, 2] = np.sin(x[3])
    A[1, 3] = x[2] * np.cos(x[3])
    B = np.zeros((4, 2))
    B[2, 0] = 1.0
    B[3, 1] = 1.0
    return np.eye(4) + dt * A, dt * B


def f_double_int_4d(x, u):
    return np.array([x[2], x[3], u[0], u[1]])


def jac_double_int_4d(x, u, dt):
    A = np.zeros((4, 4))
    A[0, 2] = A[1, 3] = 1.0
    B = np.zeros((4, 2))
    B[2, 0] = B[3, 1] = 1.0
    return np.eye(4) + dt * A, dt * B


def f_quad6d(x, u):
    return np.array(
        [x[3], x[4], x[5], G * np.tan(u[2]), -G * np.tan(u[1]), u[0] - G]
    )


def jac_quad6d(x, u, dt):
    A = np.zeros((6, 6))
    A[0, 3] = A[1, 4] = A[2, 5] = 1.0
    B = np.zeros((6, 3))
    B[3, 2] = G * np.tan(u[2]) ** 2 + G
    B[4, 1] = -G * np.tan(u[1]) ** 2 - G
    B[5, 0] = 1.0
    return np.eye(6) + dt * A, dt * B


ORACLE_MODELS = {
    "Unicycle4D": (f_unicycle, jac_unicycle, 4, 2, 2),
    "DoubleInt4D": (f_double_int_4d, jac_double_int_4d, 4, 2, 2),
    "Quad6D": (f_quad6d, jac_quad6d, 6, 3, 3),
}


class OracleMultiModel:
    """Block-diagonal multi-agent dynamics (dense)."""

    def __init__(self, model_name, n_agents, dt):
        self.f_i, self.jac_i, self.nx, self.nu, self.n_pos = ORACLE_MODELS[
            model_name
        ]
        self.n = n_agents
        self.dt = dt
        self.n_x = self.nx * n_agents
        self.n_u = self.nu * n_agents

    def step(self, x, u):
        out = np.zeros_like(x)
        for i in range(self.n):
            xi = x[i * self.nx : (i + 1) * self.nx]
            ui = u[i * self.nu : (i + 1) * self.nu]
            out[i * self.nx : (i + 1) * self.nx] = rk4(self.f_i, xi, ui, self.dt)
        return out

    def linearize(self, x, u):
        A = np.zeros((self.n_x, self.n_x))
        B = np.zeros((self.n_x, self.n_u))
        for i in range(self.n):
            xi = x[i * self.nx : (i + 1) * self.nx]
            ui = u[i * self.nu : (i + 1) * self.nu]
            Ai, Bi = self.jac_i(xi, ui, self.dt)
            A[i * self.nx : (i + 1) * self.nx, i * self.nx : (i + 1) * self.nx] = Ai
            B[i * self.nx : (i + 1) * self.nx, i * self.nu : (i + 1) * self.nu] = Bi
        return A, B


# ---------------------------------------------------------------- costs
class OracleGameCost:
    """Dense potential-game cost: sum of quadratic tracking + 200 * proximity."""

    REF_W = 1.0
    PROX_W = 200.0

    def __init__(
        self, xf, Q, R, Qf, radius, nx, nu, n_agents, n_pos=2,
        n_pos_eval=None,
    ):
        self.xf = xf.flatten()
        self.Q, self.R, self.Qf = Q, R, Qf  # per-agent lists
        self.radius = radius
        self.nx, self.nu, self.n = nx, nu, n_agents
        self.n_pos = n_pos
        # Reference quirk (cost.py:121-123 via util.py:48): uniform-dim
        # fleets EVALUATE the proximity penalty with n_pos_eval (=2)
        # dimensions while quadraticizing with n_pos.
        self.n_pos_eval = n_pos if n_pos_eval is None else n_pos_eval

    def _pairs(self):
        return itertools.combinations(range(self.n), 2)

    def prox(self, x):
        total = 0.0
        nd = self.n_pos_eval
        for i, j in self._pairs():
            pi = x[i * self.nx : i * self.nx + nd]
            pj = x[j * self.nx : j * self.nx + nd]
            d = np.linalg.norm(pi - pj)
            total += min(0.0, d - self.radius) ** 2
        return total

    def __call__(self, x, u, terminal=False):
        total = 0.0
        for i in range(self.n):
            e = x[i * self.nx : (i + 1) * self.nx] - self.xf[
                i * self.nx : (i + 1) * self.nx
            ]
            W = self.Qf[i] if terminal else self.Q[i]
            total += e @ W @ e
            if not terminal:
                ui = u[i * self.nu : (i + 1) * self.nu]
                total += ui @ self.R[i] @ ui
        return self.REF_W * total + self.PROX_W * self.prox(x)

    def prox_quad(self, x):
        n_x = self.n * self.nx
        L_x = np.zeros(n_x)
        L_xx = np.zeros((n_x, n_x))
        r = self.radius
        nd = self.n_pos
        for i, j in self._pairs():
            pi = x[i * self.nx : i * self.nx + nd]
            pj = x[j * self.nx : j * self.nx + nd]
            delta = pi - pj
            d = np.linalg.norm(delta)
            if d >= r:
                continue
            g = 2.0 * (d - r) / d * delta
            H = (2.0 - 2.0 * r / d) * np.eye(nd) + (
                2.0 * r / d**3
            ) * np.outer(delta, delta)
            si = slice(i * self.nx, i * self.nx + nd)
            sj = slice(j * self.nx, j * self.nx + nd)
            L_x[si] += g
            L_x[sj] -= g
            L_xx[si, si.start : si.stop] += H
            L_xx[sj, sj.start : sj.stop] += H
            L_xx[si, sj.start : sj.stop] -= H
            L_xx[sj, si.start : si.stop] -= H
        return L_x, L_xx

    def quadraticize(self, x, u, terminal=False):
        n_x, n_u = self.n * self.nx, self.n * self.nu
        L_x = np.zeros(n_x)
        L_u = np.zeros(n_u)
        L_xx = np.zeros((n_x, n_x))
        L_uu = np.zeros((n_u, n_u))
        for i in range(self.n):
            sx = slice(i * self.nx, (i + 1) * self.nx)
            su = slice(i * self.nu, (i + 1) * self.nu)
            e = x[sx] - self.xf[sx]
            W = self.Qf[i] if terminal else self.Q[i]
            WWt = W + W.T
            L_x[sx] = e @ WWt
            L_xx[sx, sx.start : sx.stop] = WWt
            if not terminal:
                RRt = self.R[i] + self.R[i].T
                L_u[su] = u[su] @ RRt
                L_uu[su, su.start : su.stop] = RRt
        if self.n > 1:
            Lp_x, Lp_xx = self.prox_quad(x)
            L_x += self.PROX_W * Lp_x
            L_xx += self.PROX_W * Lp_xx
        return L_x, L_u, L_xx, L_uu


# ---------------------------------------------------------------- solver
def oracle_ilqr(
    model,
    cost,
    x0,
    U=None,
    N=None,
    n_lqr_iter=50,
    tol=1e-3,
):
    """Dense iLQR exactly following reference control.py:150-242."""
    if U is None:
        U = np.zeros((N, model.n_u))
    N = U.shape[0]
    mu, delta = 1.0, 2.0
    MU_MIN, DELTA_0 = 1e-6, 2.0
    alphas = 1.1 ** (-np.arange(10, dtype=np.float32) ** 2)

    def roll(x0, U):
        X = np.zeros((U.shape[0] + 1, model.n_x))
        X[0] = x0
        J = 0.0
        for t in range(U.shape[0]):
            X[t + 1] = model.step(X[t], U[t])
            J += cost(X[t], U[t])
        J += cost(X[-1], np.zeros(model.n_u), terminal=True)
        return X, J

    def forward(X, U, K, d, a):
        Xn = np.zeros_like(X)
        Un = np.zeros_like(U)
        Xn[0] = X[0]
        J = 0.0
        for t in range(N):
            dx = Xn[t] - X[t]
            Un[t] = U[t] + K[t] @ dx + a * d[t]
            Xn[t + 1] = model.step(Xn[t], Un[t])
            J += cost(Xn[t], Un[t])
        J += cost(Xn[-1], np.zeros(model.n_u), terminal=True)
        return Xn, Un, J

    def backward(X, U, mu):
        K = np.zeros((N, model.n_u, model.n_x))
        d = np.zeros((N, model.n_u))
        reg = mu * np.eye(model.n_x)
        L_x, _, L_xx, _ = cost.quadraticize(X[-1], np.zeros(model.n_u), True)
        p, P = L_x, L_xx
        for t in range(N - 1, -1, -1):
            L_x, L_u, L_xx, L_uu = cost.quadraticize(X[t], U[t])
            A, B = model.linearize(X[t], U[t])
            Q_x = L_x + A.T @ p
            Q_u = L_u + B.T @ p
            Q_xx = L_xx + A.T @ P @ A
            Q_uu = L_uu + B.T @ (P + reg) @ B
            Q_ux = B.T @ (P + reg) @ A
            K[t] = -np.linalg.solve(Q_uu, Q_ux)
            d[t] = -np.linalg.solve(Q_uu, Q_u)
            p = Q_x + K[t].T @ Q_uu @ d[t] + K[t].T @ Q_u + Q_ux.T @ d[t]
            P = Q_xx + K[t].T @ Q_uu @ K[t] + K[t].T @ Q_ux + Q_ux.T @ K[t]
            P = 0.5 * (P + P.T)
        return K, d

    X, J_star = roll(x0, U)
    converged = False
    n_iters = 0
    for _ in range(n_lqr_iter):
        n_iters += 1
        K, d = backward(X, U, mu)
        accept = False
        for a in alphas:
            Xn, Un, J = forward(X, U, K, d, a)
            if J < J_star:
                if abs((J_star - J) / J_star) < tol:
                    converged = True
                X, U, J_star = Xn, Un, J
                delta = min(1.0, delta) / DELTA_0
                mu *= delta
                if mu <= MU_MIN:
                    mu = 0.0
                accept = True
                break
        if not accept:
            break
        if converged:
            break
    return X, U, J_star, n_iters, converged
