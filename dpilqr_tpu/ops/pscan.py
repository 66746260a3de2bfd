"""Associative-scan (parallel) Riccati backward pass.

The sequential Riccati sweep (ops/ilqr._backward_pass, reference
control.py:116-148) has an O(N) dependency chain.  Following the
parallel-LQT construction of Sarkka & Garcia-Fernandez ("Temporal
Parallelization of Bayesian Smoothers", IEEE TAC 2021; see PAPERS.md
"Parallelization of Riccati Recursion"), the value recursion decomposes
into elements ``e = (A, b, C, eta, J)`` representing the optimally
controlled flow and cost-to-go of a time INTERVAL, with an associative
combine -- so the whole sweep runs in O(log N) depth via
``jax.lax.associative_scan``.

Handling the reference's Tassa-style regularization: the mu-regularized
recursion (``B^T (P + mu I) B`` sandwiches, control.py:137-140) equals the
UNREGULARIZED recursion of a modified stage cost with
``L_uu' = L_uu + mu B^T B`` and cross term ``L_ux' = mu B^T A``; the cross
term is then removed by the standard change of variables
``u = v - L_uu'^{-1} L_ux' x`` giving ``A~ = A - B L_uu'^{-1} L_ux'``,
``L~xx = L_xx - L_ux'^T L_uu'^{-1} L_ux'`` -- an exact reduction, verified
element-for-element against the sequential sweep (tests/test_pscan.py).

Enabled with ``sweep_backend="pscan"``: the combines are wide time-batched
matmuls + vmapped Gauss-Jordan solves, so depth grows with log N instead of
N (scripts/bench_pscan.py compares it with the sequential sweep; not yet
measured on the H100).  The per-alpha line-search rollout stays sequential
(nonlinear dynamics do not scan associatively).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .ilqr import gauss_jordan_solve
from .costs import (
    HIGHEST,
    GameCost,
    assemble_pair_hessian,
    block_diag,
    diag_embed,
    quadraticize_stage_compact,
    quadraticize_terminal,
)


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


def _ein(spec, *ops):
    return jnp.einsum(spec, *ops, precision=HIGHEST)


def _batched_solve(M, R):
    """Solve with arbitrary leading batch dims via vmapped Gauss-Jordan."""
    lead = M.shape[:-2]
    f = gauss_jordan_solve
    for _ in lead:
        f = jax.vmap(f)
    return f(M, R)


def _combine(e1, e2):
    """Associative combine of value elements: e1 covers [i, k), e2 [k, j).

    ``A (.., nxf, nxf)``: closed-loop transition of the interval;
    ``b (.., nxf)``: affine drift; ``C (.., nxf, nxf)``: control-induced
    "covariance" (B Luu^-1 B^T accumulated); ``eta (.., nxf)``, ``J (..,
    nxf, nxf)``: linear/quadratic cost-to-go parameters.

    One Gauss-Jordan pass instead of the textbook two inverses (round-5
    pscan optimization): with ``M2 = (I + J2 C1)^{-1}`` the other factor
    satisfies ``M1 = (I + C1 J2)^{-1} = I - C1 M2 J2`` (push-through
    identity), so solving the SINGLE system
    ``(I + J2 C1) [T | m] = [J2 | eta2 - J2 b1]`` yields everything:
    every M1-product becomes ``X - C1 (T X)`` and every M2-product reads
    off ``T`` / ``m`` directly.  Batched Gauss-Jordan (as in ops/ilqr's
    gain solve); its sequential nxf-pivot elimination is the combine's
    dominant cost, and one pass instead of two halves it.
    """
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2

    rhs = jnp.concatenate(
        [J2, (eta2 - _ein("...ij,...j->...i", J2, b1))[..., None]],
        axis=-1,
    )
    Tm = _batched_solve(
        jnp.eye(J2.shape[-1], dtype=J2.dtype) + _mm(J2, C1), rhs
    )
    T = Tm[..., :-1]  # M2 J2
    m = Tm[..., -1]  # M2 (eta2 - J2 b1)

    TA1 = _mm(T, A1)
    M1A1 = A1 - _mm(C1, TA1)  # M1 A1
    A = _mm(A2, M1A1)
    J = _mm(jnp.swapaxes(A1, -1, -2), TA1) + J1
    eta = _ein("...ji,...j->...i", A1, m) + eta1

    v = b1 + _ein("...ij,...j->...i", C1, eta2)
    Tv = _ein("...ij,...j->...i", T, v)
    M1v = v - _ein("...ij,...j->...i", C1, Tv)
    b = _ein("...ij,...j->...i", A2, M1v) + b2

    TC1 = _mm(T, C1)
    M1C1 = C1 - _mm(C1, TC1)
    C = _mm(_mm(A2, M1C1), jnp.swapaxes(A2, -1, -2)) + C2
    return (A, b, C, eta, J)


def _flatten_blocks(cost: GameCost, X, U, lin_fn, mu):
    """Time-batched quadraticize + linearize, flattened to dense per-step
    matrices with the mu-regularization folded in as (L_uu', L_ux')."""
    N, n, nu_p = U.shape
    nx_p = X.shape[2]
    nxf, nuf = n * nx_p, n * nu_p

    L_x, L_u, L_xx_diag, L_uu, H = jax.vmap(
        lambda x_t, u_t: quadraticize_stage_compact(cost, x_t, u_t)
    )(X[:-1], U)
    A, B = jax.vmap(lin_fn)(X[:-1], U)
    B = B * cost.agent_mask[None, :, None, None]

    A_f = block_diag(A)
    B_f = block_diag(B)
    L_uu_f = block_diag(L_uu)
    L_xx = jax.vmap(diag_embed)(L_xx_diag)
    if n > 1:
        L_xx = L_xx + jax.vmap(lambda h: assemble_pair_hessian(h, n, nx_p))(H)
    L_xx_f = L_xx.reshape(N, nxf, nxf)
    L_x_f = L_x.reshape(N, nxf)
    L_u_f = L_u.reshape(N, nuf)

    # mu-regularization as modified cost (see module docstring).
    Bt = jnp.swapaxes(B_f, -1, -2)
    L_uu_r = L_uu_f + mu * _mm(Bt, B_f)
    L_ux_r = mu * _mm(Bt, A_f)
    return A_f, B_f, L_uu_r, L_ux_r, L_xx_f, L_x_f, L_u_f


def backward_pass_pscan(lin_fn, cost: GameCost, X, U, mu):
    """Parallel-scan Riccati: same (K, d) as ops/ilqr._backward_pass.

    O(log N) sequential depth; all per-step work is batched over time.
    """
    N, n, nu_p = U.shape
    nx_p = X.shape[2]
    nxf, nuf = n * nx_p, n * nu_p
    dtype = X.dtype

    A_f, B_f, L_uu_r, L_ux_r, L_xx_f, L_x_f, L_u_f = _flatten_blocks(
        cost, X, U, lin_fn, mu
    )

    # Cross-term elimination: u = v - Kp x with Kp = L_uu'^{-1} L_ux'.
    Kpd = _batched_solve(
        L_uu_r, jnp.concatenate([L_ux_r, L_u_f[..., None]], axis=-1)
    )
    Kp, dp = Kpd[..., :nxf], Kpd[..., nxf]
    A_t = A_f - _mm(B_f, Kp)
    Lxx_t = L_xx_f - _mm(jnp.swapaxes(L_ux_r, -1, -2), Kp)
    Lx_t = L_x_f - _ein("tux,tu->tx", L_ux_r, dp)
    C_t = _mm(
        B_f, _batched_solve(L_uu_r, jnp.swapaxes(B_f, -1, -2))
    )  # B Luu'^{-1} B^T
    b_t = -_ein("txu,tu->tx", B_f, dp)
    # Quadratic completion of the eliminated control's own cost:
    # -1/2-free convention (matches the reference's unhalved Taylor form):
    # the constant term is dropped; the linear term keeps Lx_t.

    # Leaf elements, time-reversed so the scan accumulates suffixes, plus
    # the terminal leaf in front.
    L_xT, L_xxT = quadraticize_terminal(cost, X[-1])
    zero_A = jnp.zeros((1, nxf, nxf), dtype)
    term = (
        zero_A,
        jnp.zeros((1, nxf), dtype),
        jnp.zeros((1, nxf, nxf), dtype),
        -L_xT.reshape(1, nxf),
        L_xxT.reshape(1, nxf, nxf),
    )
    leaves = (A_t, b_t, C_t, -Lx_t, Lxx_t)
    rev = lambda a: jnp.flip(a, axis=0)
    elems = tuple(
        jnp.concatenate([t, rev(l)], axis=0) for t, l in zip(term, leaves)
    )
    # After the scan, position r holds the combined element for the suffix
    # [N - r, N]: A-leaves enter as e_rev = leaf_{N-1}, leaf_{N-2}, ...;
    # combine(acc, new) must compose NEW interval BEFORE the accumulated
    # suffix, i.e. combine(e_new_first, e_acc_second) = e_new (x) e_acc.
    scanned = jax.lax.associative_scan(
        lambda a, b: _combine(b, a), elems, axis=0
    )
    J_suf = rev(scanned[4])  # (N+1, nxf, nxf): P_t for t = 0..N
    eta_suf = rev(scanned[3])  # (N+1, nxf): -p_t

    P_next = J_suf[1:]  # (N, nxf, nxf): P_{t+1}
    p_next = -eta_suf[1:]  # (N, nxf)

    # Gains from (P_{t+1}, p_{t+1}) exactly like the sequential sweep.
    Bt = jnp.swapaxes(B_f, -1, -2)
    Q_uu = L_uu_r + _mm(_mm(Bt, P_next), B_f)
    Q_ux = L_ux_r + _mm(_mm(Bt, P_next), A_f)
    Q_u = L_u_f + _ein("txu,tx->tu", B_f, p_next)
    rhs = jnp.concatenate([Q_ux, Q_u[..., None]], axis=-1)
    sol = _batched_solve(Q_uu, rhs)
    K = -sol[..., :nxf]
    d = -sol[..., nxf]
    return K, d
