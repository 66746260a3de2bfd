"""Wall-clock-deadline (``t_kill``) distributed solve.

The reference threads ``t_kill`` from ``solve_distributed`` into every
subproblem's solver (dpilqr/distributed.py:170-176 kwargs ->
problem.py:97-105 -> control.py:213-218), and its real-time analysis mode
caps every solve at ``t_kill = dt`` (scripts/analysis.py:145-148).  Here the
batched subproblem solve is host-stepped: each iLQR iteration over the WHOLE
batch is one jitted device program; between iterations the host checks the
deadline and stops accepting further work.  The deadline therefore caps the
combined wall clock of all subproblems -- stricter than the reference,
which grants each sequential subproblem its own ``t_kill``.

Each step is the vmapped per-problem iteration (ops/ilqr.make_iteration_fn,
Triton sweep kernel included when resolved) with finished subproblems
frozen, so per-subproblem accept/convergence decisions are identical to
the fused while_loop solve.
"""

from __future__ import annotations

from functools import partial
from time import perf_counter
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, SolverConfig
from ..models.fleet import Fleet
from ..ops.costs import GameCost
from ..ops.ilqr import (
    IlqrCarry,
    _rollout_batched_cost,
    _rollout_fn,
    array_platform,
    make_iteration_fn,
    resolve_sweep_backend,
)
from .distributed import DistributedResult
from .graph import interaction_graph
from .subproblems import (
    extract_owner,
    gather_controls,
    gather_cost,
    gather_states,
    gather_subproblems,
)


class _BatchCarry(NamedTuple):
    """Per-subproblem iteration state of the host-stepped batch."""

    X: jnp.ndarray  # (S, N+1, K, nx_p)
    U: jnp.ndarray  # (S, N, K, nu_p)
    J: jnp.ndarray  # (S,)
    mu: jnp.ndarray
    delta: jnp.ndarray
    i: jnp.ndarray  # (S,) int32 iterations executed
    converged: jnp.ndarray
    failed: jnp.ndarray
    active: jnp.ndarray  # (S,) bool: still iterating


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _prep(fleet: Fleet, cfg: SolverConfig, K: int, graph_n_d,
          cost: GameCost, X, U, radius, ignore_mask, membership=None):
    """Graph construction + batched gather (steps 1-2 of _solve_distributed)."""
    dtype = X.dtype
    cost = jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        cost,
    )
    if membership is None:
        membership = interaction_graph(
            X, radius, n_pos=cost.n_pos, n_d=graph_n_d
        )
    batch = gather_subproblems(membership, K)
    sub_cost = gather_cost(cost, batch, dtype)
    x0_s = gather_states(X[0], batch)
    U_s = gather_controls(U, batch)
    mids_s = jnp.asarray(fleet.branch_index_array)[batch.member_idx]
    enabled = ~ignore_mask
    return cost, membership, batch, sub_cost, x0_s, U_s, mids_s, enabled


@partial(jax.jit, static_argnums=(0,))
def _finish(fleet: Fleet, cost: GameCost, membership, batch,
            X_sub, U_sub, J_s, iters, converged, x0, ignore_mask):
    """Owner extraction + joint-cost rollout (steps 4-5 of _solve_distributed)."""
    dtype = X_sub.dtype
    X_dec, U_dec = extract_owner(batch, X_sub, U_sub)
    keep = (~ignore_mask).astype(dtype)
    X_dec = X_dec * keep[None, :, None]
    U_dec = U_dec * keep[None, :, None]
    _, J_full = _rollout_batched_cost(fleet.step, cost, x0, U_dec)
    return DistributedResult(
        X=X_dec,
        U=U_dec,
        J=J_full,
        membership=membership,
        iters=iters,
        converged=converged,
        sizes=batch.sizes,
        truncated=jnp.any(batch.sizes > batch.member_idx.shape[1]),
    )


@partial(jax.jit, static_argnums=(0, 1))
def _init_xla(fleet: Fleet, cfg: SolverConfig, sub_cost, x0_s, U0_s,
              mids_s, enabled) -> _BatchCarry:
    def roll_one(cost_b, mids_b, x0_b, U_b):
        step = lambda x, u: fleet.step_dyn(mids_b, x, u)
        X0, J0 = _rollout_fn(step, cost_b, x0_b, U_b)
        return X0, J0

    X0, J0 = jax.vmap(roll_one)(sub_cost, mids_s, x0_s, U0_s)
    S = x0_s.shape[0]
    dtype = x0_s.dtype
    return _BatchCarry(
        X=X0,
        U=U0_s,
        J=J0,
        mu=jnp.full((S,), cfg.mu_init, dtype),
        delta=jnp.full((S,), cfg.delta_0, dtype),
        i=jnp.zeros((S,), jnp.int32),
        converged=jnp.zeros((S,), bool),
        failed=jnp.zeros((S,), bool),
        active=jnp.asarray(enabled, bool) & (cfg.n_lqr_iter > 0),
    )


@partial(jax.jit, static_argnums=(0, 1))
def _iterate_xla(fleet: Fleet, cfg: SolverConfig, sub_cost, mids_s,
                 c: _BatchCarry) -> _BatchCarry:
    """One vmapped-XLA iteration with inactive subproblems frozen.

    Reuses the per-problem iteration (ops/ilqr.make_iteration_fn) --
    bitwise the same accept/regularization decisions as solve_core."""

    def one(cost_b, mids_b, ic: IlqrCarry):
        step = lambda x, u: fleet.step_dyn(mids_b, x, u)
        lin = lambda x, u: fleet.linearize_dyn(mids_b, x, u)
        return make_iteration_fn(step, lin, cfg)(cost_b, ic)

    ic = IlqrCarry(
        X=c.X, U=c.U, J_star=c.J, mu=c.mu, delta=c.delta, i=c.i,
        converged=c.converged, failed=c.failed,
    )
    nc = jax.vmap(one)(sub_cost, mids_s, ic)

    a = c.active

    def keep(new, old):
        mask = a.reshape((-1,) + (1,) * (new.ndim - 1))
        return jnp.where(mask, new, old)

    i = c.i + a.astype(jnp.int32)
    converged = c.converged | (a & nc.converged)
    failed = c.failed | (a & nc.failed)
    active = a & ~nc.converged & ~nc.failed & (i < cfg.n_lqr_iter)
    return _BatchCarry(
        X=keep(nc.X, c.X),
        U=keep(nc.U, c.U),
        J=keep(nc.J_star, c.J),
        mu=keep(nc.mu, c.mu),
        delta=keep(nc.delta, c.delta),
        i=i,
        converged=converged,
        failed=failed,
        active=active,
    )


def solve_distributed_steppable(
    fleet: Fleet,
    cost: GameCost,
    X,
    U,
    radius,
    ignore_mask=None,
    K: int | None = None,
    graph_n_d: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
    t_kill: float | None = None,
    verbose: bool = False,
) -> DistributedResult:
    """``solve_distributed`` with a wall-clock deadline.

    Same arguments/result as ``solve_distributed`` plus ``t_kill`` (seconds;
    None = no deadline, but still host-stepped).  Matches the reference's
    real-time contract (scripts/analysis.py:145-148, control.py:213-218):
    once the deadline passes, no further iLQR iterations are started and the
    best plan so far is stitched and returned.
    """
    t0 = perf_counter()
    X = jnp.asarray(X)
    U = jnp.asarray(U, dtype=X.dtype)
    n = fleet.n_agents
    if X.ndim == 2:
        X = X[None]
    if ignore_mask is None:
        ignore_mask = jnp.zeros((n,), bool)
    ignore_mask = jnp.asarray(ignore_mask, bool)
    radius = jnp.asarray(radius, dtype=X.dtype)
    membership_in = None
    if K is None:
        from .distributed import _graph_prog, _width_from_kmax

        membership_in, k_max = _graph_prog(X, radius, cost.n_pos, graph_n_d)
        K = _width_from_kmax(int(k_max), n)
    import dataclasses

    backend = resolve_sweep_backend(
        config, K * fleet.nx_p, X.dtype, array_platform(X)
    )
    config = dataclasses.replace(config, sweep_backend=backend)
    cost_c, membership, batch, sub_cost, x0_s, U_s, mids_s, enabled = _prep(
        fleet, config, K, graph_n_d, cost, X, U, radius, ignore_mask,
        membership_in,
    )
    carry = _init_xla(fleet, config, sub_cost, x0_s, U_s, mids_s, enabled)

    # Host-stepped loop: the per-iteration host sync that paces the
    # deadline fetches whether any subproblem is still active.
    for it in range(config.n_lqr_iter):
        if not bool(jnp.any(carry.active)):
            break
        if t_kill is not None and perf_counter() - t0 > t_kill:
            if verbose:
                print(f"t_kill reached after {it} iterations")
            break
        carry = _iterate_xla(fleet, config, sub_cost, mids_s, carry)

    return _finish(
        fleet, cost_c, membership, batch, carry.X, carry.U, carry.J,
        carry.i, carry.converged, X[0], ignore_mask,
    )
