"""Device-mesh scaling: shard the subproblem batch across devices.

The reference's scaling story is a multiprocessing pool on one host
(distributed.py:79-97) plus SLURM job placement (cluster/sim.sbatch).  Here
the subproblem axis of the batched decomposed solve is laid out over a flat
1-D ``jax.sharding.Mesh`` (the cards of a host are all-to-all on NVLink, so
the mesh follows the algorithm alone): graph construction and the gather of
neighbor "ghost" agents run replicated, ``shard_map`` places one batched
iLQR solve on every device (the same ``_solve_subproblem_batch`` as the
single-device ``solve_distributed``, Triton sweep kernel included), and
XLA inserts the collectives that gather the owner rows for stitching.
Monte-Carlo trials (``solve_trials_sharded``) flatten the (trial,
subproblem) axes into ONE batch -- the trial axis is just more independent
subproblems.

Agent-state arrays stay replicated (they are tiny: n * nx_p floats).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DEFAULT_CONFIG, SolverConfig
from ..models.fleet import Fleet
from ..ops.costs import GameCost
from ..ops.ilqr import _rollout_fn, resolve_sweep_backend
from .distributed import DistributedResult, _solve_subproblem_batch
from .graph import interaction_graph
from .subproblems import (
    extract_owner,
    gather_controls,
    gather_cost,
    gather_states,
    gather_subproblems,
)

SUB_AXIS = "sub"


def make_mesh(devices=None, axis_name: str = SUB_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = jax.devices() if devices is None else devices
    import numpy as np

    return Mesh(np.asarray(devices), (axis_name,))


def _cast_cost(cost: GameCost, dtype) -> GameCost:
    return jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        cost,
    )


def _resolve(cfg: SolverConfig, fleet: Fleet, K: int, dtype, mesh: Mesh):
    """The sweep backend for one shard's subproblems, on the mesh's devices
    (not wherever the input arrays happen to live)."""
    import dataclasses

    backend = resolve_sweep_backend(
        cfg, K * fleet.nx_p, dtype, mesh.devices.flat[0].platform
    )
    return dataclasses.replace(cfg, sweep_backend=backend)


def _shard_solve(
    fleet: Fleet, cfg: SolverConfig, mesh: Mesh, sub_cost: GameCost, x0_s,
    U_s, mids_s, enabled,
):
    """Solve a subproblem batch with one ``_solve_subproblem_batch`` per
    device: pad the batch to an equal per-shard count with disabled
    subproblems, ``shard_map`` the solve over the subproblem axis (no
    cross-shard communication -- subproblems are independent), and
    truncate the padding off the gathered result.
    """
    S0 = x0_s.shape[0]
    n_dev = mesh.shape[SUB_AXIS]
    pad = -(-S0 // n_dev) * n_dev - S0

    def pad0(a):
        if pad == 0:
            return a
        fill = jnp.zeros((pad, *a.shape[1:]), a.dtype)
        return jnp.concatenate([a, fill], axis=0)

    sub_cost, x0_s, U_s, mids_s, enabled = jax.tree.map(
        pad0, (sub_cost, x0_s, U_s, mids_s, jnp.asarray(enabled, bool))
    )
    res = jax.shard_map(
        partial(_solve_subproblem_batch, fleet, cfg),
        mesh=mesh,
        in_specs=(P(SUB_AXIS),) * 5,
        out_specs=P(SUB_AXIS),
        # pallas_call does not annotate varying-mesh-axes metadata on its
        # outputs; the body is collective-free so the check is moot.
        check_vma=False,
    )(sub_cost, x0_s, U_s, mids_s, enabled)
    if pad:
        res = jax.tree.map(lambda a: a[:S0], res)
    return res


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _solve_distributed_sharded(
    fleet: Fleet,
    cfg: SolverConfig,
    K: int,
    graph_n_d,
    mesh: Mesh,
    cost: GameCost,
    X,
    U,
    radius,
    ignore_mask,
):
    dtype = X.dtype
    cost = _cast_cost(cost, dtype)

    membership = interaction_graph(X, radius, n_pos=cost.n_pos, n_d=graph_n_d)
    batch = gather_subproblems(membership, K)
    sub_cost = gather_cost(cost, batch, dtype)
    x0_s = gather_states(X[0], batch)
    U_s = gather_controls(U, batch)
    mids_s = jnp.asarray(fleet.branch_index_array)[batch.member_idx]
    enabled = ~ignore_mask

    res = _shard_solve(fleet, cfg, mesh, sub_cost, x0_s, U_s, mids_s, enabled)

    X_dec, U_dec = extract_owner(batch, res.X, res.U)
    keep = (~ignore_mask).astype(dtype)
    X_dec = X_dec * keep[None, :, None]
    U_dec = U_dec * keep[None, :, None]
    _, J_full = _rollout_fn(fleet.step, cost, X[0], U_dec)

    return DistributedResult(
        X=X_dec,
        U=U_dec,
        J=J_full,
        membership=membership,
        iters=res.iters,
        converged=res.converged,
        sizes=batch.sizes,
        truncated=jnp.any(batch.sizes > K),
    )


def solve_distributed_sharded(
    fleet: Fleet,
    cost: GameCost,
    X,
    U,
    radius,
    mesh: Mesh,
    ignore_mask=None,
    K: int | None = None,
    graph_n_d: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
) -> DistributedResult:
    """`solve_distributed` with the subproblem batch sharded over ``mesh``.

    Backend resolution matches the unsharded solve, on the mesh's
    platform.  The number of agents should be a multiple of the mesh size
    for an even layout (ragged batches are padded with disabled
    subproblems).
    """
    X = jnp.asarray(X)
    U = jnp.asarray(U, dtype=X.dtype)
    n = fleet.n_agents
    if X.ndim == 2:
        X = X[None]
    if ignore_mask is None:
        ignore_mask = jnp.zeros((n,), bool)
    ignore_mask = jnp.asarray(ignore_mask, bool)
    radius = jnp.asarray(radius, dtype=X.dtype)
    if K is None:
        from .distributed import auto_subproblem_width

        K = auto_subproblem_width(X, radius, cost, graph_n_d)

    cfg = _resolve(config, fleet, K, X.dtype, mesh)
    return _solve_distributed_sharded(
        fleet, cfg, K, graph_n_d, mesh, cost, X, U, radius, ignore_mask
    )


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _solve_trials_sharded(
    fleet: Fleet, cfg: SolverConfig, K: int, graph_n_d, mesh: Mesh,
    cost_T: GameCost, X_T, U_T, radius, ignore_mask,
):
    n = X_T.shape[2]

    def prep(cost, X, U):
        dtype = X.dtype
        cost = _cast_cost(cost, dtype)
        membership = interaction_graph(
            X, radius, n_pos=cost.n_pos, n_d=graph_n_d
        )
        batch = gather_subproblems(membership, K)
        sub_cost = gather_cost(cost, batch, dtype)
        x0_s = gather_states(X[0], batch)
        U_s = gather_controls(U, batch)
        mids_s = jnp.asarray(fleet.branch_index_array)[batch.member_idx]
        return cost, membership, batch, sub_cost, x0_s, U_s, mids_s

    cost_c, membership, batch, sub_cost, x0_s, U_s, mids_s = jax.vmap(prep)(
        cost_T, X_T, U_T
    )
    T, S = x0_s.shape[:2]
    enabled = jnp.broadcast_to(~ignore_mask, (T, n))

    # Trials x subproblems flatten into ONE batch: the batched solver
    # treats subproblems independently, so a trial axis is just more
    # subproblems (the reference runs trials as a host loop,
    # cluster/sim.sbatch).
    flat = jax.tree.map(
        lambda a: a.reshape(T * S, *a.shape[2:]),
        (sub_cost, x0_s, U_s, mids_s, enabled),
    )
    res = _shard_solve(fleet, cfg, mesh, *flat)
    res = jax.tree.map(lambda a: a.reshape(T, S, *a.shape[1:]), res)

    def stitch(cost, membership, batch, res, X):
        dtype = X.dtype
        X_dec, U_dec = extract_owner(batch, res.X, res.U)
        keep = (~ignore_mask).astype(dtype)
        X_dec = X_dec * keep[None, :, None]
        U_dec = U_dec * keep[None, :, None]
        _, J_full = _rollout_fn(fleet.step, cost, X[0], U_dec)
        return DistributedResult(
            X=X_dec, U=U_dec, J=J_full, membership=membership,
            iters=res.iters, converged=res.converged, sizes=batch.sizes,
            truncated=jnp.any(batch.sizes > K),
        )

    return jax.vmap(stitch)(cost_c, membership, batch, res, X_T)


def solve_trials_sharded(
    fleet: Fleet,
    cost_T: GameCost,
    X_T,
    U_T,
    radius,
    mesh: Mesh,
    K: int,
    ignore_mask=None,
    graph_n_d: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
) -> DistributedResult:
    """Monte-Carlo trials as a SHARDED BATCH AXIS (SURVEY 2.3: the
    reference's SLURM job runs trials as a host loop on one 16-core node,
    cluster/sim.sbatch; here T independent trials solve as one device
    program with (trial, subproblem) lanes laid out over the mesh).

    ``cost_T``: GameCost with a leading trial axis on every leaf;
    ``X_T (T, Tw, n, nx_p)`` previous trajectories; ``U_T (T, N, n, nu_p)``.
    The flattened (T * n)-subproblem batch is sharded over the mesh.
    Returns a DistributedResult with a leading trial axis.
    """
    X_T = jnp.asarray(X_T)
    U_T = jnp.asarray(U_T, dtype=X_T.dtype)
    n = fleet.n_agents
    if ignore_mask is None:
        ignore_mask = jnp.zeros((n,), bool)
    cfg = _resolve(config, fleet, K, X_T.dtype, mesh)
    return _solve_trials_sharded(
        fleet, cfg, K, graph_n_d, mesh, cost_T, X_T, U_T,
        jnp.asarray(radius, X_T.dtype), jnp.asarray(ignore_mask, bool),
    )
