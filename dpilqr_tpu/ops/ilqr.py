"""iLQR solver core: fully jittable, vmap-able over problems.

Algorithm parity with the reference solver (dpilqr/control.py:15-242):

- initial rollout of the warm-start controls (control.py:80-93),
- backward Riccati/DDP recursion with Tassa-style state regularization
  ``B^T (P + mu I) B`` (control.py:116-148),
- backtracking line search over ``alpha = 1.1 ** (-i^2)`` accepting the first
  cost decrease (control.py:162,179-193),
- convergence when the relative decrease falls below ``tol``; bail-out when
  the line search fails (control.py:184,195-198),
- regularization schedule reset/decrease (control.py:227-237).

Design departures from the reference:

- The time loops are ``lax.scan``s; the outer iteration is a
  ``lax.while_loop`` with masked termination -- one compiled program.
- The line search evaluates all ``n_ls_iter`` alphas as one batched forward
  rollout (vmap over the alpha axis) and selects the first improving one --
  identical accept decision to the reference's sequential early-exit, but one
  wide program instead of up to 10 narrow ones.
- The backward pass exploits the block-diagonal structure of A and B: the
  heavy sandwiches ``A^T P A``, ``B^T P B``, ``B^T P A`` are batched block
  einsums (O(n^2) small matmuls instead of O(n^3) dense work), while the gain
  solve and value update stay dense in the flat space where they are genuinely
  dense.  The reference densifies everything (dpilqr/dynamics.py:173-186).
- Every float32 contraction is pinned to ``Precision.HIGHEST`` (true
  float32): a GPU would otherwise run it in TF32, whose three decimal
  digits the Riccati sandwiches cannot absorb.

The core (`solve_core`) is parameterized by dynamics callables so the same
engine serves: the static-fleet centralized solve, vmapped batched subproblem
solves with data-dependent model dispatch (parallel/distributed.py), and the
host-steppable real-time variant with wall-clock deadlines (``t_kill``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, SolverConfig
from ..models.fleet import Fleet
from . import riccati_triton
from .costs import (
    HIGHEST,
    GameCost,
    quadraticize_stage,
    quadraticize_terminal,
    stage_cost,
    terminal_cost,
)


class SolveResult(NamedTuple):
    X: jnp.ndarray  # (N+1, n, nx_p) state trajectory
    U: jnp.ndarray  # (N, n, nu_p) control trajectory
    J: jnp.ndarray  # () cost of (X, U)
    iters: jnp.ndarray  # () iLQR iterations executed
    converged: jnp.ndarray  # () bool: relative decrease < tol
    failed_line_search: jnp.ndarray  # () bool: bailed out


class IlqrCarry(NamedTuple):
    X: jnp.ndarray
    U: jnp.ndarray
    J_star: jnp.ndarray
    mu: jnp.ndarray
    delta: jnp.ndarray
    i: jnp.ndarray
    converged: jnp.ndarray
    failed: jnp.ndarray


def line_search_alphas(n_ls_iter: int, dtype) -> np.ndarray:
    """``1.1 ** (-i^2)`` computed in float32 like the reference
    (dpilqr/control.py:162), cast to the solve dtype."""
    i = np.arange(n_ls_iter, dtype=np.float32)
    return np.asarray(np.float32(1.1) ** (-(i**2)), dtype=dtype)


def _rollout_fn(step_fn, cost: GameCost, x0, U):
    """Nonlinear rollout accumulating cost (reference control.py:80-93)."""

    def body(carry, u_t):
        x, J = carry
        J = J + stage_cost(cost, x, u_t)
        x_next = step_fn(x, u_t)
        return (x_next, J), x_next

    (x_last, J), X_rest = jax.lax.scan(body, (x0, jnp.zeros((), x0.dtype)), U)
    X = jnp.concatenate([x0[None], X_rest], axis=0)
    J = J + terminal_cost(cost, x_last)
    return X, J


@partial(jax.jit, static_argnums=0)
def _rollout_jit(step_fn, cost: GameCost, x0, U):
    return _rollout_fn(step_fn, cost, x0, U)


def rollout(fleet: Fleet, cost: GameCost, x0, U):
    """Public rollout on a static fleet.

    Jitted (keyed on the fleet's cached ``step`` callable): re-tracing the
    scan eagerly on every call costs ~300 ms of host time per call."""
    return _rollout_jit(fleet.step, cost, x0, U)


def _rollout_batched_cost(step_fn, cost: GameCost, x0, U):
    """Rollout with the cost evaluated time-batched after the state scan.

    Same math as ``_rollout_fn`` (reference control.py:80-93) but only the
    dynamics stay in the sequential scan; the stage costs -- the expensive
    part at fleet scale (O(n^2) proximity pairs per step) -- evaluate as one
    vmap over the horizon.  Summation order differs from the sequential
    accumulation by a float rounding (~1 ulp per step), so this variant is
    kept away from the solver's per-iteration accept decisions.  It computes
    the stitched-plan joint cost (reference distributed.py:99-103), which
    besides being reported also feeds the RHC loop's coarse ``J_converge``
    stopping threshold (parallel/rhc.py) -- a user-set, order-of-magnitude
    predicate where the ~1e-6 relative drift is immaterial; use
    ``_rollout_fn`` instead wherever bitwise-stable J is required.
    """

    def body(x, u_t):
        x_next = step_fn(x, u_t)
        return x_next, x_next

    x_last, X_rest = jax.lax.scan(body, x0, U)
    X = jnp.concatenate([x0[None], X_rest], axis=0)
    J = jnp.sum(jax.vmap(lambda x, u: stage_cost(cost, x, u))(X[:-1], U))
    J = J + terminal_cost(cost, x_last)
    return X, J


def _forward_pass(step_fn, cost: GameCost, X, U, K, d, alpha):
    """Closed-loop rollout ``du = K dx + alpha d`` (reference control.py:95-114)."""
    n = X.shape[1]
    nu_p = U.shape[2]

    def body(carry, inp):
        x, J = carry
        X_t, U_t, K_t, d_t = inp
        dx = (x - X_t).reshape(-1)
        du = jnp.matmul(K_t, dx, precision=HIGHEST) + alpha * d_t
        u_new = U_t + du.reshape(n, nu_p)
        J = J + stage_cost(cost, x, u_new)
        x_next = step_fn(x, u_new)
        return (x_next, J), (x, u_new)

    (x_last, J), (X_prev, U_new) = jax.lax.scan(
        body, (X[0], jnp.zeros((), X.dtype)), (X[:-1], U, K, d)
    )
    J = J + terminal_cost(cost, x_last)
    X_new = jnp.concatenate([X_prev, x_last[None]], axis=0)
    return X_new, U_new, J


def gauss_jordan_solve(M, R):
    """Solve ``M X = R`` via Gauss-Jordan without pivoting.

    ``M`` is the (symmetric positive definite) ``Q_uu``; elimination without
    pivoting on an SPD matrix is stable (equivalent to LDL^T).  Pure
    elementwise/reduction ops: it vmaps into batched elementwise work
    instead of a batched LU library call, and the same one-hot form lowers
    inside the Triton sweep kernel (ops/riccati_triton.py).
    """
    m = M.shape[0]
    MR = jnp.concatenate([M, R], axis=1)  # (m, q)
    q = MR.shape[1]
    dtype = MR.dtype
    row_iota = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (1, q), 1)

    def body(k, MR):
        row_hot = (row_iota == k).astype(dtype)  # (m, 1)
        col_hot = (col_iota == k).astype(dtype)  # (1, q)
        pivot_row = jnp.sum(MR * row_hot, axis=0, keepdims=True)  # (1, q)
        pivot_val = jnp.sum(pivot_row * col_hot)  # MR[k, k]
        pivot_row = pivot_row / pivot_val
        col = jnp.sum(MR * col_hot, axis=1, keepdims=True)  # (m, 1)
        col = col * (1.0 - row_hot)  # zero the pivot row's own entry
        MR = MR - col * pivot_row
        MR = MR * (1.0 - row_hot) + row_hot * pivot_row
        return MR

    # int32 bounds: under x64 a python-int bound makes the loop index int64.
    MR = jax.lax.fori_loop(jnp.int32(0), jnp.int32(m), body, MR)
    return MR[:, m:]


def _backward_pass(lin_fn, cost: GameCost, X, U, mu):
    """Block Riccati recursion (reference control.py:116-148).

    Returns flat gains ``K: (N, n*nu_p, n*nx_p)`` and ``d: (N, n*nu_p)``.

    Structure: quadraticization and linearization depend only on (X, U), so
    they hoist OUT of the sequential sweep as one time-batched computation
    (wide batched work); the scan carries only the genuinely sequential
    value-function recursion.  The proximity coupling enters the scan in
    compact per-pair form and is assembled with the incidence sandwich
    (2 batched matmuls) per step.
    """
    from .costs import (
        assemble_pair_hessian,
        block_diag,
        diag_embed,
        quadraticize_stage_compact,
    )

    n, nx_p = X.shape[1], X.shape[2]
    nu_p = U.shape[2]
    nxf, nuf = n * nx_p, n * nu_p
    dtype = X.dtype
    bmask = cost.agent_mask

    L_xT, L_xxT = quadraticize_terminal(cost, X[-1])
    p0 = L_xT.reshape(nxf)
    P0 = L_xxT.reshape(nxf, nxf)
    eye_f = jnp.eye(nxf, dtype=dtype)

    def mm(a, b):
        return jnp.matmul(a, b, precision=HIGHEST)

    # ---- time-batched phase (no sequential dependency) --------------------
    L_x, L_u, L_xx_diag, L_uu, H = jax.vmap(
        lambda x_t, u_t: quadraticize_stage_compact(cost, x_t, u_t)
    )(X[:-1], U)
    A, B = jax.vmap(lin_fn)(X[:-1], U)  # (N, n, nx, nx), (N, n, nx, nu)
    # Zero padded-slot input maps: keeps the padded Riccati recursion
    # exactly decoupled from real agents (see ops/costs.py docstring).
    B = B * bmask[None, :, None, None]
    # Block-diag L_uu embedded once for all t: (N, nuf, nuf).
    L_uu_f = block_diag(L_uu)

    # ---- sequential sweep --------------------------------------------------
    def bw_step(carry, inp):
        p, P = carry
        L_x_t, L_u_t, L_xx_diag_t, L_uu_t, H_t, A_t, B_t = inp

        L_xx = diag_embed(L_xx_diag_t)
        if n > 1:
            L_xx = L_xx + assemble_pair_hessian(H_t, n, nx_p)

        P4 = P.reshape(n, nx_p, n, nx_p)
        Preg4 = (P + mu * eye_f).reshape(n, nx_p, n, nx_p)
        p2 = p.reshape(n, nx_p)

        Q_x = L_x_t + jnp.einsum("iba,ib->ia", A_t, p2, precision=HIGHEST)
        Q_u = L_u_t + jnp.einsum("iba,ib->ia", B_t, p2, precision=HIGHEST)
        # Block sandwiches: only the (i, j) block pairs couple, through P.
        sandwich = "iba,ibjc,jcd->iajd"
        Q_xx = L_xx + jnp.einsum(sandwich, A_t, P4, A_t, precision=HIGHEST)
        Q_uu4 = jnp.einsum(sandwich, B_t, Preg4, B_t, precision=HIGHEST)
        Q_ux4 = jnp.einsum(sandwich, B_t, Preg4, A_t, precision=HIGHEST)

        Quu = Q_uu4.reshape(nuf, nuf) + L_uu_t
        Qux = Q_ux4.reshape(nuf, nxf)
        Qu = Q_u.reshape(nuf)
        Qx = Q_x.reshape(nxf)
        Qxx = Q_xx.reshape(nxf, nxf)

        rhs = jnp.concatenate([Qux, Qu[:, None]], axis=1)
        # Gauss-Jordan instead of jnp.linalg.solve: Q_uu is SPD (mu-
        # regularized), so pivoting is unnecessary (see gauss_jordan_solve).
        sol = gauss_jordan_solve(Quu, rhs)
        K_t = -sol[:, :nxf]
        d_t = -sol[:, nxf]

        KtQuu = mm(K_t.T, Quu)
        p_new = Qx + mm(KtQuu, d_t) + mm(K_t.T, Qu) + mm(Qux.T, d_t)
        P_new = Qxx + mm(KtQuu, K_t) + mm(K_t.T, Qux) + mm(Qux.T, K_t)
        P_new = 0.5 * (P_new + P_new.T)
        return (p_new, P_new), (K_t, d_t)

    _, (K, d) = jax.lax.scan(
        bw_step, (p0, P0), (L_x, L_u, L_xx_diag, L_uu_f, H, A, B), reverse=True
    )
    return K, d


KNOWN_SWEEP_BACKENDS = ("auto", "xla", "pscan", "triton")

# Widest padded flat state (``riccati_triton.padded_width(n * nx_p)``) at
# which "auto" picks the Triton sweep: end to end on an H100 the kernel won
# at width 32 (Unicycle4D K=8: 3.8x at 100 agents, 2.8x at 500) and lost at
# width 64 (Quad6D K=8: 0.73x) -- chip_smoke.py's kernel decision phase,
# PERF.md Findings.
TRITON_MAX_WIDTH = 32


def env_sweep_backend() -> str | None:
    """The validated ``DPILQR_SWEEP_BACKEND`` override (None if unset or
    "auto"); a typo'd value raises here instead of surfacing as an
    unrelated downstream dispatch error."""
    import os

    env = os.environ.get("DPILQR_SWEEP_BACKEND")
    if env and env not in KNOWN_SWEEP_BACKENDS:
        raise ValueError(
            f"DPILQR_SWEEP_BACKEND={env!r} is not one of "
            f"{KNOWN_SWEEP_BACKENDS}"
        )
    return env if env and env != "auto" else None


def array_platform(x) -> str:
    """Platform of the device holding ``x`` ("cpu", "gpu", ...); the
    default backend's for anything that is not a committed array."""
    if isinstance(x, jax.Array) and not isinstance(x, jax.core.Tracer):
        return next(iter(x.devices())).platform
    return jax.default_backend()


def resolve_sweep_backend(
    cfg: SolverConfig, nxf: int, dtype, platform: str
) -> str:
    """Resolve ``cfg.sweep_backend`` for one (sub)problem of flat state
    width ``nxf``: an explicit choice (or ``DPILQR_SWEEP_BACKEND``) wins;
    "auto" is the Triton sweep for float32 problems on a GPU within
    ``TRITON_MAX_WIDTH``, the plain XLA scan otherwise."""
    env = env_sweep_backend()
    if env:
        return env
    if cfg.sweep_backend != "auto":
        return cfg.sweep_backend
    if (
        platform == "gpu"
        and jnp.dtype(dtype) == jnp.float32
        and riccati_triton.padded_width(nxf) <= TRITON_MAX_WIDTH
    ):
        return "triton"
    return "xla"


def _backward(backend: str):
    """The backward pass of a resolved backend ("auto" that reached the
    core unresolved means the plain scan)."""
    if backend == "triton":
        # Looked up at trace time so tests can substitute interpret mode.
        return riccati_triton.backward_pass_triton
    if backend == "pscan":
        # Parallel-scan Riccati (ops/pscan.py): O(log N) sequential depth.
        from .pscan import backward_pass_pscan

        return backward_pass_pscan
    if backend in ("xla", "auto"):
        return _backward_pass
    raise ValueError(
        f"sweep_backend={backend!r} is not one of {KNOWN_SWEEP_BACKENDS}"
    )


def make_iteration_fn(
    step_fn: Callable, lin_fn: Callable, cfg: SolverConfig
) -> Callable:
    """One iLQR iteration: backward pass + batched line search + accept.

    ``iterate(cost, carry) -> carry``.  Used by both the fused while_loop
    solve and the host-steppable real-time solve.  The line search is the
    closed-loop rollout vmapped over all alphas.
    """

    def iterate(cost: GameCost, c: IlqrCarry) -> IlqrCarry:
        dtype = c.X.dtype
        alphas = jnp.asarray(line_search_alphas(cfg.n_ls_iter, dtype))

        K, d = _backward(cfg.sweep_backend)(lin_fn, cost, c.X, c.U, c.mu)

        def _fwd(alpha):
            return _forward_pass(step_fn, cost, c.X, c.U, K, d, alpha)

        X_c, U_c, J_c = jax.vmap(_fwd)(alphas)

        improved = J_c < c.J_star  # (n_ls,)
        accept = jnp.any(improved)
        a_idx = jnp.argmax(improved)  # first improving alpha
        X_new = jnp.where(accept, X_c[a_idx], c.X)
        U_new = jnp.where(accept, U_c[a_idx], c.U)
        J_new = jnp.where(accept, J_c[a_idx], c.J_star)

        converged = accept & (
            jnp.abs(
                (c.J_star - J_new)
                / jnp.maximum(jnp.abs(c.J_star), jnp.finfo(dtype).tiny)
            )
            < cfg.tol
        )

        # Decrease regularization on acceptance (reference control.py:232-237).
        # With cfg.mu_floor, mu bottoms out at mu_min instead of snapping to
        # 0 (conditioning guard; see SolverConfig.mu_floor).
        delta_dec = jnp.minimum(1.0, c.delta) / cfg.delta_0
        mu_dec = c.mu * delta_dec
        mu_lo = cfg.mu_min if cfg.mu_floor else 0.0
        mu_dec = jnp.where(mu_dec <= cfg.mu_min, mu_lo, mu_dec)
        if cfg.on_failed_ls == "increase":
            # The reference's (dead) regularization-increase path
            # (control.py:198-208): raise mu, keep iterating, abort at
            # mu_max.
            delta_inc = jnp.maximum(1.0, c.delta) * cfg.delta_0
            mu_inc = jnp.maximum(cfg.mu_min, c.mu * delta_inc)
            mu_new = jnp.where(accept, mu_dec, mu_inc)
            delta_new = jnp.where(accept, delta_dec, delta_inc)
            failed = ~accept & (mu_inc >= cfg.mu_max)
        else:
            mu_new = jnp.where(accept, mu_dec, c.mu)
            delta_new = jnp.where(accept, delta_dec, c.delta)
            failed = ~accept

        return IlqrCarry(
            X=X_new,
            U=U_new,
            J_star=J_new,
            mu=mu_new,
            delta=delta_new,
            i=c.i + 1,
            converged=converged,
            failed=failed,
        )

    return iterate


def init_carry(step_fn, cfg: SolverConfig, cost: GameCost, x0, U0) -> IlqrCarry:
    dtype = x0.dtype
    X0, J0 = _rollout_fn(step_fn, cost, x0, U0)
    return IlqrCarry(
        X=X0,
        U=U0,
        J_star=J0,
        mu=jnp.asarray(cfg.mu_init, dtype),
        delta=jnp.asarray(cfg.delta_0, dtype),
        i=jnp.zeros((), jnp.int32),
        converged=jnp.zeros((), bool),
        failed=jnp.zeros((), bool),
    )


def solve_core(
    step_fn: Callable,
    lin_fn: Callable,
    cfg: SolverConfig,
    cost: GameCost,
    x0,
    U0,
    enabled=True,
) -> SolveResult:
    """Full iLQR solve given dynamics callables.

    ``enabled=False`` skips all iterations (used for ignored agents in the
    distributed layer, reference distributed.py:59-63) -- the result is the
    plain rollout of ``U0``.
    """
    iterate = make_iteration_fn(step_fn, lin_fn, cfg)
    c0 = init_carry(step_fn, cfg, cost, x0, U0)
    enabled = jnp.asarray(enabled, bool)

    def cond(c: IlqrCarry):
        return enabled & (c.i < cfg.n_lqr_iter) & ~c.converged & ~c.failed

    out = jax.lax.while_loop(cond, partial_iterate(iterate, cost), c0)
    return SolveResult(
        X=out.X,
        U=out.U,
        J=out.J_star,
        iters=out.i,
        converged=out.converged,
        failed_line_search=out.failed,
    )


def partial_iterate(iterate, cost):
    def body(c):
        return iterate(cost, c)

    return body


@partial(jax.jit, static_argnums=(0, 1, 2))
def _ilqr_solve(fleet: Fleet, N: int, cfg: SolverConfig, cost: GameCost, x0, U0):
    dtype = x0.dtype
    n = x0.shape[0]
    nu_p = fleet.nu_p
    # The solve is dtype-polymorphic in x0: cast the cost pytree so a float32
    # problem stays float32 end to end.
    cost = jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        cost,
    )
    if U0 is None:
        U0 = jnp.zeros((N, n, nu_p), dtype=dtype)
    else:
        U0 = U0.astype(dtype)
    return solve_core(fleet.step, fleet.linearize, cfg, cost, x0, U0)


def make_solver(fleet: Fleet, N: int, config: SolverConfig = DEFAULT_CONFIG):
    """Build the jitted solve function for a fleet and horizon.

    Returns ``solve(cost: GameCost, x0: (n, nx_p), U0: (N, n, nu_p))
    -> SolveResult``, pure and vmap-able over a leading problem axis.
    """
    import dataclasses

    def solve(cost: GameCost, x0, U0):
        backend = resolve_sweep_backend(
            config, fleet.n_agents * fleet.nx_p, x0.dtype,
            jax.default_backend(),
        )
        cfg = dataclasses.replace(config, sweep_backend=backend)
        return _ilqr_solve(fleet, N, cfg, cost, x0, U0)

    return jax.jit(solve)


def ilqr_solve(
    fleet: Fleet,
    cost: GameCost,
    x0,
    U0=None,
    N: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
) -> SolveResult:
    """Convenience single-problem entry point.

    ``x0: (n, nx_p)``; ``U0: (N, n, nu_p)`` or None (zero init, like the
    reference control.py:152-153).
    """
    x0 = jnp.asarray(x0)
    n = fleet.n_agents
    if x0.shape != (n, fleet.nx_p):
        raise ValueError(
            f"x0 must have shape (n_agents, nx_p) = ({n}, {fleet.nx_p}), "
            f"got {x0.shape}"
        )
    if U0 is None:
        if N is None:
            raise ValueError("Provide U0 or N")
        U0 = jnp.zeros((N, n, fleet.nu_p), dtype=x0.dtype)
    U0 = jnp.asarray(U0, dtype=x0.dtype)
    if U0.ndim != 3 or U0.shape[1:] != (n, fleet.nu_p):
        raise ValueError(
            f"U0 must have shape (N, n_agents, nu_p) = (N, {n}, {fleet.nu_p}), "
            f"got {U0.shape}"
        )
    if cost.xf.shape[0] != n:
        raise ValueError(f"cost has {cost.xf.shape[0]} agents but fleet has {n}")
    import dataclasses

    backend = resolve_sweep_backend(
        config, n * fleet.nx_p, x0.dtype, array_platform(x0)
    )
    config = dataclasses.replace(config, sweep_backend=backend)
    return _ilqr_solve(fleet, U0.shape[0], config, cost, x0, U0)


def ilqr_solve_steppable(
    fleet: Fleet,
    cost: GameCost,
    x0,
    U0=None,
    N: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
    t_kill: float | None = None,
    verbose: bool = False,
) -> SolveResult:
    """Host-stepped solve honoring a wall-clock deadline.

    Mirrors the reference's ``t_kill`` contract (control.py:213-218): each
    iLQR iteration is one jitted device program; between iterations the host
    checks the deadline and stops accepting further work.  Slightly slower
    than the fused solve (one dispatch per iteration) -- use only when a
    real-time deadline is required.
    """
    from time import perf_counter

    x0 = jnp.asarray(x0)
    # Match _ilqr_solve: follow the input dtype end to end (a float32 x0 with
    # a float64 cost must not silently mix precision in the deadline path).
    cost = jax.tree.map(
        lambda a: a.astype(x0.dtype)
        if jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        cost,
    )
    if U0 is None:
        U0 = jnp.zeros((N, fleet.n_agents, fleet.nu_p), dtype=x0.dtype)
    U0 = jnp.asarray(U0, dtype=x0.dtype)
    import dataclasses

    backend = resolve_sweep_backend(
        config, fleet.n_agents * fleet.nx_p, x0.dtype, array_platform(x0)
    )
    cfg = dataclasses.replace(config, sweep_backend=backend)

    iterate = jax.jit(make_iteration_fn(fleet.step, fleet.linearize, cfg))
    carry = init_carry(fleet.step, cfg, cost, x0, U0)

    t0 = perf_counter()
    for i in range(cfg.n_lqr_iter):
        carry = iterate(cost, carry)
        # Host sync: J_star is tiny; this also paces the deadline check.
        J = float(carry.J_star)
        if verbose:
            print(f"{i + 1}/{cfg.n_lqr_iter}\tJ: {J:g}")
        if bool(carry.failed) or bool(carry.converged):
            break
        if t_kill is not None and perf_counter() - t0 > t_kill:
            break

    return SolveResult(
        X=carry.X,
        U=carry.U,
        J=carry.J_star,
        iters=carry.i,
        converged=carry.converged,
        failed_line_search=carry.failed,
    )
