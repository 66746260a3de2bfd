"""Riccati backward sweep as one Pallas kernel on the Triton route (GPU).

The contract is exactly the sequential part of ``ops.ilqr._backward_pass``
(reference dpilqr/control.py:116-148): given the hoisted linearization and
quadraticization of every time step, run the reverse value recursion and
return the flat gains ``K: (N, n*nu_p, n*nx_p)`` and ``d: (N, n*nu_p)``.
Linearization and quadraticization stay in XLA, batched over time.

Why a kernel: the plain sweep is a ``lax.scan`` whose every step runs a
dozen small contractions plus a pivot-by-pivot Gauss-Jordan loop; on a GPU
each of those is a separate launch, so the sweep costs launches, not
arithmetic.  Here the whole reverse time loop is one program per problem:

- one program per (sub)problem; ``vmap`` over a batch of problems adds the
  grid axis, so a distributed solve launches one grid over its subproblems;
- the value function ``p``/``P`` is the loop carry (registers);
- the per-step ``A, B, L_xx, L_uu, L_x, L_u`` tiles stream from global
  memory inside the loop (``num_stages`` lets Triton prefetch them);
- every product is a ``dot_general`` on power-of-two tiles padded to at
  least 16 (Triton's minimum dot width), at ``Precision.HIGHEST`` -- IEEE
  float32, never TF32, which would break the conditioning the recursion
  relies on;
- the ``Q_uu`` solve is the same one-hot Gauss-Jordan elimination as
  ``ops.ilqr.gauss_jordan_solve`` (``Q_uu`` is SPD; no pivoting).

Padding keeps the recursion exact: padded state rows/columns of ``A``,
``B``, ``L_xx`` and ``P`` are zero, and padded control rows get an identity
``L_uu`` block, so their gains come out zero and are sliced away.

Float32 only on the card (the route has no float64 dot); ``interpret=True``
runs the same kernel through the Pallas interpreter, which is how the CPU
tests check it, in either dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .costs import (
    GameCost,
    assemble_pair_hessian,
    block_diag,
    quadraticize_stage_compact,
    quadraticize_terminal,
)

HIGHEST = jax.lax.Precision.HIGHEST

# Triton's dot takes no operand dimension below 16.
MIN_TILE = 16


def padded_width(m: int) -> int:
    """Tile width for a flat dimension of size ``m``: the next power of
    two, at least ``MIN_TILE``."""
    return max(MIN_TILE, 1 << (m - 1).bit_length())


def _dot(a, b, trans_a=False):
    """``a @ b`` (or ``a.T @ b``) in the operands' dtype at HIGHEST precision
    (``pl.dot`` would return float32 even for float64 interpret runs)."""
    dims = (((0 if trans_a else 1,), (0,)), ((), ()))
    return jax.lax.dot_general(
        a, b, dims, precision=HIGHEST, preferred_element_type=a.dtype
    )


def _sweep_kernel(
    A_ref, B_ref, Lxx_ref, Luu_ref, Lx_ref, Lu_ref, p0_ref, P0_ref, mu_ref,
    K_ref, d_ref, *, n_steps: int, n_pivots: int,
):
    D = P0_ref.shape[-1]
    E = Luu_ref.shape[-1]
    rows_d = jax.lax.broadcasted_iota(jnp.int32, (D, D), 0)
    cols_d = jax.lax.broadcasted_iota(jnp.int32, (D, D), 1)
    diag_d = rows_d == cols_d
    iota_e = jax.lax.broadcasted_iota(jnp.int32, (E,), 0)
    mu = mu_ref[...]  # (D,): the problem's regularizer, broadcast

    def solve(Quu, Qux, Qu):
        """Gauss-Jordan on ``Quu [X | x] = [Qux | Qu]`` with one-hot row and
        column masks (ops.ilqr.gauss_jordan_solve, split into tiles)."""
        dtype = Quu.dtype

        def pivot(k, carry):
            M, R, r = carry
            row_hot = (iota_e == k).astype(dtype)  # (E,)
            keep = 1.0 - row_hot
            pM = jnp.sum(M * row_hot[:, None], axis=0)  # pivot row (E,)
            pR = jnp.sum(R * row_hot[:, None], axis=0)  # (D,)
            pr = jnp.sum(r * row_hot)
            pv = jnp.sum(pM * row_hot)  # M[k, k]
            pM, pR, pr = pM / pv, pR / pv, pr / pv
            col = jnp.sum(M * row_hot[None, :], axis=1) * keep  # (E,)
            M = (M - col[:, None] * pM[None, :]) * keep[:, None] + (
                row_hot[:, None] * pM[None, :]
            )
            R = (R - col[:, None] * pR[None, :]) * keep[:, None] + (
                row_hot[:, None] * pR[None, :]
            )
            r = (r - col * pr) * keep + row_hot * pr
            return M, R, r

        _, X, x = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(n_pivots), pivot, (Quu, Qux, Qu)
        )
        return X, x

    def step(i, carry):
        p, P = carry
        t = n_steps - 1 - i
        A = A_ref[t]  # (D, D)
        B = B_ref[t]  # (D, E)

        Qx = Lx_ref[t] + jnp.sum(A * p[:, None], axis=0)
        Qu = Lu_ref[t] + jnp.sum(B * p[:, None], axis=0)
        Qxx = Lxx_ref[t] + _dot(_dot(A, P, trans_a=True), A)
        BtPreg = _dot(B, P + jnp.where(diag_d, mu[None, :], 0.0), trans_a=True)
        Quu = Luu_ref[t] + _dot(BtPreg, B)  # (E, E)
        Qux = _dot(BtPreg, A)  # (E, D)

        X, x = solve(Quu, Qux, Qu)
        K = -X
        d = -x
        K_ref[t] = K
        d_ref[t] = d

        KtQuu = _dot(K, Quu, trans_a=True)  # (D, E)
        p_new = (
            Qx
            + jnp.sum(KtQuu * d[None, :], axis=1)
            + jnp.sum(K * Qu[:, None], axis=0)
            + jnp.sum(Qux * d[:, None], axis=0)
        )
        P_new = (
            Qxx
            + _dot(KtQuu, K)
            + _dot(K, Qux, trans_a=True)
            + _dot(Qux, K, trans_a=True)
        )
        return p_new, 0.5 * (P_new + P_new.T)

    jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(n_steps), step, (p0_ref[...], P0_ref[...])
    )


def _pad(a, *widths):
    """Zero-pad the trailing ``len(widths)`` dims of ``a`` up to ``widths``."""
    lead = [(0, 0)] * (a.ndim - len(widths))
    tail = [(0, w - s) for s, w in zip(a.shape[a.ndim - len(widths):], widths)]
    return jnp.pad(a, lead + tail)


def riccati_sweep(A, B, L_xx, L_uu, L_x, L_u, p0, P0, mu, *, interpret=False):
    """Reverse Riccati recursion over dense flat per-step terms.

    ``A: (N, nxf, nxf)``, ``B: (N, nxf, nuf)``, ``L_xx: (N, nxf, nxf)``,
    ``L_uu: (N, nuf, nuf)``, ``L_x: (N, nxf)``, ``L_u: (N, nuf)``, terminal
    ``p0: (nxf,)``, ``P0: (nxf, nxf)``, scalar ``mu``.  Returns
    ``K: (N, nuf, nxf)``, ``d: (N, nuf)``.  Batch with ``jax.vmap``.
    """
    N, nxf, nuf = B.shape
    D, E = padded_width(nxf), padded_width(nuf)
    dtype = A.dtype
    pad_u = (jnp.arange(E) >= nuf).astype(dtype)
    L_uu = _pad(L_uu, E, E) + jnp.diag(pad_u)[None]
    args = (
        _pad(A, D, D), _pad(B, D, E), _pad(L_xx, D, D), L_uu,
        _pad(L_x, D), _pad(L_u, E), _pad(p0, D), _pad(P0, D, D),
        jnp.broadcast_to(jnp.asarray(mu, dtype), (D,)),
    )
    kernel = lambda *refs: _sweep_kernel(*refs, n_steps=N, n_pivots=nuf)
    K, d = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((N, E, D), dtype),
            jax.ShapeDtypeStruct((N, E), dtype),
        ),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=4 if D <= 32 else 8, num_stages=2
        ),
        interpret=interpret,
        name="riccati_sweep",
    )(*args)
    return K[:, :nuf, :nxf], d[:, :nuf]


def backward_pass_triton(lin_fn, cost: GameCost, X, U, mu, *, interpret=False):
    """Drop-in for ``ops.ilqr._backward_pass`` with the sweep in the kernel.

    The time-batched phase (quadraticization, linearization, assembly of
    the dense per-step terms) runs in XLA exactly as in the plain pass.
    """
    n, nx_p = X.shape[1], X.shape[2]
    nu_p = U.shape[2]
    nxf, nuf = n * nx_p, n * nu_p
    N = U.shape[0]

    L_xT, L_xxT = quadraticize_terminal(cost, X[-1])
    L_x, L_u, L_xx_diag, L_uu, H = jax.vmap(
        lambda x_t, u_t: quadraticize_stage_compact(cost, x_t, u_t)
    )(X[:-1], U)
    A, B = jax.vmap(lin_fn)(X[:-1], U)
    B = B * cost.agent_mask[None, :, None, None]

    L_xx = block_diag(L_xx_diag)
    if n > 1:
        L_xx = L_xx + jax.vmap(
            lambda h: assemble_pair_hessian(h, n, nx_p).reshape(nxf, nxf)
        )(H)
    return riccati_sweep(
        block_diag(A), block_diag(B), L_xx, block_diag(L_uu),
        L_x.reshape(N, nxf), L_u.reshape(N, nuf),
        L_xT.reshape(nxf), L_xxT.reshape(nxf, nxf), mu,
        interpret=interpret,
    )
