"""Potential-game cost: per-agent quadratic tracking + pairwise proximity.

Semantics follow the reference (dpilqr/cost.py):

- ReferenceCost (cost.py:79-101): stage ``(x-xf)^T Q (x-xf) + u^T R u``,
  terminal ``(x-xf)^T Qf (x-xf)``; gradients use ``Q+Q^T``/``R+R^T``.
- ProximityCost (cost.py:117-171): ``sum_pairs min(0, d_ij - radius)^2`` with
  per-pair position dimensionality ``nd = min(n_pos_i, n_pos_j)``.
- GameCost (cost.py:185-239): ``REF_WEIGHT * sum_i ref_i + PROX_WEIGHT * prox``
  with weights 1.0 / 200.0; proximity terms apply at the terminal state too.

The pair gradient/Hessian here is the exact derivative of the penalty
(the reference's closed form at cost.py:269-315 is algebraically identical:
``H = (2 - 2r/d) I + (2r/d^3) dd^T`` inside the radius, zero outside).

Reference quirk, behind a flag: for fleets with uniform ``n_dims`` the
reference *evaluates* proximity with 2-D distances (cost.py:122-123 defaults
``n_d=2``) while *quadraticizing* with ``min(n_dims)`` -- an inconsistency
between the cost and its derivatives.  ``make_game_cost(...,
prox_eval_n_d=2)`` reproduces that behavior exactly (``n_pos_eval`` governs
evaluation, ``n_pos`` the derivatives); the default (``None``) keeps both
consistent at ``min(n_pos_i, n_pos_j)`` (SURVEY 7: both modes, exact mode
as the better-conditioned default).

Everything is expressed on the padded block layout ``x: (n, nx_p)``,
``u: (n, nu_p)``.  ``agent_mask`` zeroes padded subproblem slots (a slot with
mask 0 contributes no reference or proximity cost and gets an identity
control Hessian so the Riccati recursion stays nonsingular and exactly
decoupled).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-12

# Every float32 contraction of the solve runs in true float32: on a GPU
# the default lets XLA use TF32 (about three decimal digits), which the
# incidence-matrix identities below and the Riccati sweep cannot absorb.
HIGHEST = jax.lax.Precision.HIGHEST


class GameCost(NamedTuple):
    """Array-valued cost specification (a pytree; vmap-able over problems)."""

    xf: jnp.ndarray  # (n, nx_p) goal states (padded)
    Q: jnp.ndarray  # (n, nx_p, nx_p) stage state weights
    R: jnp.ndarray  # (n, nu_p, nu_p) stage control weights
    Qf: jnp.ndarray  # (n, nx_p, nx_p) terminal state weights
    radius: jnp.ndarray  # () proximity radius
    n_pos: jnp.ndarray  # (n,) int: 2 or 3 position coords (derivatives)
    agent_mask: jnp.ndarray  # (n,) 1.0 = real agent, 0.0 = padded slot
    prox_weight: jnp.ndarray  # () default 200.0
    ref_weight: jnp.ndarray  # () default 1.0
    n_pos_eval: jnp.ndarray  # (n,) position coords for EVALUATION (parity)


def make_game_cost(
    xf,
    Q,
    R,
    Qf,
    radius=0.0,
    n_pos=None,
    agent_mask=None,
    prox_weight=200.0,
    ref_weight=1.0,
    dtype=None,
    prox_eval_n_d=None,
) -> GameCost:
    """Build a GameCost from per-agent arrays.

    ``xf: (n, nx_p)``; ``Q/Qf: (n, nx_p, nx_p)``; ``R: (n, nu_p, nu_p)``.
    ``prox_eval_n_d``: if set (e.g. 2), the proximity *penalty* is evaluated
    with that many position dimensions while its derivatives keep
    ``n_pos`` -- the reference's exact behavior for uniform-dimension
    fleets (dpilqr/cost.py:122-133 vs :135-171).
    """
    xf = jnp.asarray(xf, dtype=dtype)
    n = xf.shape[0]
    dtype = xf.dtype
    if n_pos is None:
        n_pos = np.full((n,), 2, dtype=np.int32)
    if agent_mask is None:
        agent_mask = np.ones((n,))
    n_pos = jnp.asarray(n_pos, dtype=jnp.int32)
    if prox_eval_n_d is None:
        n_pos_eval = n_pos
    else:
        n_pos_eval = jnp.full((n,), int(prox_eval_n_d), dtype=jnp.int32)
    return GameCost(
        xf=xf,
        Q=jnp.asarray(Q, dtype=dtype),
        R=jnp.asarray(R, dtype=dtype),
        Qf=jnp.asarray(Qf, dtype=dtype),
        radius=jnp.asarray(radius, dtype=dtype),
        n_pos=n_pos,
        agent_mask=jnp.asarray(agent_mask, dtype=dtype),
        prox_weight=jnp.asarray(prox_weight, dtype=dtype),
        ref_weight=jnp.asarray(ref_weight, dtype=dtype),
        n_pos_eval=n_pos_eval,
    )


def _pair_indices(n: int):
    """Static upper-triangle pair indices (i < j)."""
    return np.triu_indices(n, k=1)


def _pair_geometry(cost: GameCost, x, n_pos_src=None):
    """Common pair quantities.

    Returns (delta, d, w_pair, comp) where ``delta: (npairs, 3)`` is the
    component-masked position difference, ``d: (npairs,)`` the distance and
    ``w_pair`` the pair activity weight (mask_i * mask_j * [d < r]).
    ``n_pos_src`` selects the per-agent position dimensionality (defaults
    to ``cost.n_pos``; evaluation passes ``cost.n_pos_eval`` -- the
    reference-parity split, see module docstring).

    All per-pair reductions are expressed through the signed/absolute
    incidence matrices (matmuls) instead of gathers.  Identities used:
    ``a_i - a_j = (W^T a)_p``, ``a_i a_j = ((|W|^T a)^2 - (W^T a)^2)/4``,
    ``min(a_i, a_j) = (|W|^T a - |W^T a|)/2``.
    """
    n, nx_p = x.shape
    k = min(3, nx_p)
    pos = jnp.zeros((n, 3), dtype=x.dtype).at[:, :k].set(x[:, :k])
    W = _signed_incidence(n, x.dtype)  # (n, npairs)
    Wa = jnp.abs(W)

    # pos_i - pos_j per pair
    delta_raw = jnp.einsum("ip,ia->pa", W, pos, precision=HIGHEST)
    n_pos = (cost.n_pos if n_pos_src is None else n_pos_src).astype(x.dtype)
    # min per pair
    nd_pair = 0.5 * (_mv(Wa.T, n_pos) - jnp.abs(_mv(W.T, n_pos)))
    comp = jnp.arange(3, dtype=x.dtype)[None, :] < nd_pair[:, None]
    delta = delta_raw * comp
    d = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
    active = (d < cost.radius).astype(x.dtype)
    m = cost.agent_mask
    m_pair = 0.25 * (_mv(Wa.T, m) ** 2 - _mv(W.T, m) ** 2)  # mask_i * mask_j
    w_pair = m_pair * active
    return delta, d, w_pair, comp


def proximity_cost(cost: GameCost, x):
    """Unweighted ``sum_pairs min(0, d - r)^2`` (reference cost.py:117-133)."""
    n = x.shape[0]
    if n < 2:
        return jnp.zeros((), dtype=x.dtype)
    _, d, w_pair, _ = _pair_geometry(cost, x, cost.n_pos_eval)
    pen = jnp.minimum(0.0, d - cost.radius) ** 2
    return jnp.sum(w_pair * pen)


def _signed_incidence(n: int, dtype):
    """(n, npairs) matrix W with W[i, p] = +1, W[j, p] = -1 for pair p=(i,j).

    Static per n; lets pair quantities scatter into agent blocks as einsums
    instead of scatter ops.  Built on device from the pair index vectors:
    as a literal it would be an n^3-sized constant inside every compiled
    program (hundreds of MB at 500 agents), and the barrier keeps XLA from
    folding it back into one.
    """
    ii, jj = _pair_indices(n)
    ii, jj = jax.lax.optimization_barrier(
        (jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32))
    )
    agents = jnp.arange(n, dtype=jnp.int32)[:, None]
    return (agents == ii[None]).astype(dtype) - (
        agents == jj[None]
    ).astype(dtype)


def proximity_quadraticize_compact(cost: GameCost, x):
    """Exact proximity gradient + per-pair Hessian blocks.

    Returns ``L_x: (n, nx_p)`` (already scattered into agent blocks) and the
    compact pair Hessians ``H: (npairs, k, k)`` with ``k = min(3, nx_p)``.
    The full coupling matrix is the signed-incidence sandwich ``W H W^T``
    (see ``assemble_pair_hessian``) -- the compact form is what the Riccati
    sweep stores per timestep (O(npairs * 9) instead of O((n nx)^2)).
    """
    n, nx_p = x.shape
    k = min(3, nx_p)
    delta, d, w_pair, comp = _pair_geometry(cost, x)
    r = cost.radius
    d_safe = jnp.maximum(d, _EPS)

    # grad wrt pos_i: 2 (d - r)/d * delta
    g = (w_pair * 2.0 * (d - r) / d_safe)[:, None] * delta  # (npairs, 3)

    # Hessian: (2 - 2r/d) I + (2r/d^3) delta delta^T, masked to active comps.
    eye3 = jnp.eye(3, dtype=x.dtype)
    H = (2.0 - 2.0 * r / d_safe)[:, None, None] * eye3 + (
        2.0 * r / d_safe**3
    )[:, None, None] * (delta[:, :, None] * delta[:, None, :])
    cm = comp.astype(x.dtype)
    H = H * (cm[:, :, None] * cm[:, None, :]) * w_pair[:, None, None]

    W = _signed_incidence(n, x.dtype)  # (n, npairs)
    L_x = jnp.zeros((n, nx_p), dtype=x.dtype)
    L_x = L_x.at[:, :k].set(
        jnp.einsum("ip,pa->ia", W, g[:, :k], precision=HIGHEST)
    )
    return L_x, H[:, :k, :k]


def assemble_pair_hessian(H, n: int, nx_p: int):
    """Compact pair Hessians ``(npairs, k, k)`` -> full block coupling
    ``(n, nx_p, n, nx_p)`` via the incidence sandwich ``W H W^T``:
    per pair p=(i,j) the block H_p lands at ``(+ii, +jj, -ij, -ji)``
    (reference cost.py:160-166), as two batched matmuls instead of scatters.
    """
    k = H.shape[-1]
    W = _signed_incidence(n, H.dtype)  # (n, npairs)
    L_xx = jnp.zeros((n, nx_p, n, nx_p), dtype=H.dtype)
    return L_xx.at[:, :k, :, :k].set(
        jnp.einsum("ip,pab,jp->iajb", W, H, W, precision=HIGHEST)
    )


def proximity_quadraticize(cost: GameCost, x):
    """Exact gradient/Hessian of the proximity penalty in block layout.

    Returns ``L_x: (n, nx_p)`` and ``L_xx: (n, nx_p, n, nx_p)``
    (reference closed form, cost.py:269-315).
    """
    n, nx_p = x.shape
    if n < 2:
        return (
            jnp.zeros((n, nx_p), dtype=x.dtype),
            jnp.zeros((n, nx_p, n, nx_p), dtype=x.dtype),
        )
    L_x, H = proximity_quadraticize_compact(cost, x)
    return L_x, assemble_pair_hessian(H, n, nx_p)


def stage_cost(cost: GameCost, x, u):
    """Weighted game stage cost (reference cost.py:197-206)."""
    e = x - cost.xf
    ref = jnp.einsum(
        "ia,iab,ib->i", e, cost.Q, e, precision=HIGHEST
    ) + jnp.einsum("ia,iab,ib->i", u, cost.R, u, precision=HIGHEST)
    total = cost.ref_weight * jnp.sum(cost.agent_mask * ref)
    total = total + cost.prox_weight * proximity_cost(cost, x)
    # Padded slots: tiny control regularizer keeps the padded problem
    # consistent with its quadraticization (contributes 0 when u_slot == 0).
    total = total + jnp.sum((1.0 - cost.agent_mask) * jnp.sum(u * u, axis=-1))
    return total


def terminal_cost(cost: GameCost, x):
    """Weighted terminal cost; proximity applies here too (cost.py:197-206)."""
    e = x - cost.xf
    ref = jnp.einsum("ia,iab,ib->i", e, cost.Qf, e, precision=HIGHEST)
    total = cost.ref_weight * jnp.sum(cost.agent_mask * ref)
    return total + cost.prox_weight * proximity_cost(cost, x)


def quadraticize_stage_compact(cost: GameCost, x, u):
    """Stage quadraticization in compact block form.

    Returns ``(L_x (n, nx_p), L_u (n, nu_p), L_xx_diag (n, nx_p, nx_p),
    L_uu (n, nu_p, nu_p), H_pair (npairs, k, k))`` with all weights applied.
    The full state Hessian is ``diag-embed(L_xx_diag) +
    assemble_pair_hessian(H_pair)``.  Compact form exists so the Riccati
    sweep can quadraticize ALL timesteps as one batched computation and
    carry only O(npairs * 9) coupling data into the sequential scan.
    """
    n, nx_p = x.shape
    m = cost.agent_mask
    e = x - cost.xf
    QQt = cost.Q + jnp.swapaxes(cost.Q, -1, -2)
    RRt = cost.R + jnp.swapaxes(cost.R, -1, -2)

    w = cost.ref_weight * m[:, None]
    L_x = w * jnp.einsum("ia,iab->ib", e, QQt, precision=HIGHEST)
    L_u = w * jnp.einsum("ia,iab->ib", u, RRt, precision=HIGHEST)
    L_xx_diag = cost.ref_weight * m[:, None, None] * QQt
    L_uu = cost.ref_weight * m[:, None, None] * RRt

    # Padded-slot control regularizer: d/du of (1-m) u^T u.
    nu_p = u.shape[-1]
    eye_u = jnp.eye(nu_p, dtype=x.dtype)
    L_u = L_u + 2.0 * (1.0 - m)[:, None] * u
    L_uu = L_uu + 2.0 * (1.0 - m)[:, None, None] * eye_u

    k = min(3, nx_p)
    if n > 1:
        Lp_x, H = proximity_quadraticize_compact(cost, x)
        L_x = L_x + cost.prox_weight * Lp_x
        H = cost.prox_weight * H
    else:
        H = jnp.zeros((0, k, k), dtype=x.dtype)
    return L_x, L_u, L_xx_diag, L_uu, H


def quadraticize_terminal_compact(cost: GameCost, x):
    """Terminal analog of ``quadraticize_stage_compact``:
    ``(L_x, L_xx_diag, H_pair)`` using Qf (proximity included,
    reference cost.py:208-239)."""
    n, nx_p = x.shape
    m = cost.agent_mask
    e = x - cost.xf
    QfQft = cost.Qf + jnp.swapaxes(cost.Qf, -1, -2)
    L_x = cost.ref_weight * m[:, None] * jnp.einsum(
        "ia,iab->ib", e, QfQft, precision=HIGHEST
    )
    L_xx_diag = cost.ref_weight * m[:, None, None] * QfQft
    k = min(3, nx_p)
    if n > 1:
        Lp_x, H = proximity_quadraticize_compact(cost, x)
        L_x = L_x + cost.prox_weight * Lp_x
        H = cost.prox_weight * H
    else:
        H = jnp.zeros((0, k, k), dtype=x.dtype)
    return L_x, L_xx_diag, H


def _mv(M, v):
    return jnp.matmul(M, v, precision=HIGHEST)


def diag_embed(blocks):
    """(n, a, b) block-diagonal embed -> (n, a, n, b) via eye-broadcast."""
    n = blocks.shape[0]
    eye_n = jnp.eye(n, dtype=blocks.dtype)
    return eye_n[:, None, :, None] * blocks[:, :, None, :]


def block_diag(blocks):
    """(..., n, a, b) agent blocks -> dense (..., n*a, n*b) block-diagonal."""
    *lead, n, a, b = blocks.shape
    eye_n = jnp.eye(n, dtype=blocks.dtype)
    dense = eye_n[:, None, :, None] * blocks[..., :, :, None, :]
    return dense.reshape(*lead, n * a, n * b)


def quadraticize_stage(cost: GameCost, x, u):
    """Stage quadraticization in block layout (reference cost.py:208-239).

    Returns ``L_x (n, nx_p)``, ``L_u (n, nu_p)``, ``L_xx (n, nx_p, n, nx_p)``,
    ``L_uu (n, nu_p, nu_p)`` (block-diagonal; L_ux is identically zero for
    this cost family, reference cost.py:93).
    """
    n, nx_p = x.shape
    L_x, L_u, L_xx_diag, L_uu, H = quadraticize_stage_compact(cost, x, u)
    L_xx = diag_embed(L_xx_diag)
    if n > 1:
        L_xx = L_xx + assemble_pair_hessian(H, n, nx_p)
    return L_x, L_u, L_xx, L_uu


def quadraticize_terminal(cost: GameCost, x):
    """Terminal quadraticization: uses Qf; proximity included (cost.py:208-239)."""
    n, nx_p = x.shape
    L_x, L_xx_diag, H = quadraticize_terminal_compact(cost, x)
    L_xx = diag_embed(L_xx_diag)
    if n > 1:
        L_xx = L_xx + assemble_pair_hessian(H, n, nx_p)
    return L_x, L_xx
