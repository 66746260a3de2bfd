"""Interaction graph construction.

The "DP" in DP-iLQR: agents within twice the proximity radius of each other
at any of ~10 sampled knots of the previous trajectory are planned together
(reference distributed.py:224-247).  The graph is represented on device as
a dense boolean membership matrix ``M: (n, n)`` with ``M[i, j] = True`` iff
agent j belongs to agent i's subproblem (diagonal always True) -- a static
shape regardless of the data-dependent neighborhood sizes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.geometry import pair_indices, pairwise_distances


def interaction_graph(
    X,
    radius,
    n_pos=None,
    n_d: int | None = None,
    n_samples: int = 10,
):
    """Threshold-distance interaction graph.

    ``X: (T, n, nx_p)`` previous trajectory (T >= 1); ``radius`` the
    proximity radius (planning radius is ``2 * radius``, reference
    distributed.py:229).  Returns ``(n, n)`` bool membership matrix.
    """
    T, n = X.shape[0], X.shape[1]
    step = max(T // n_samples, 1)
    Xs = X[::step]  # static strided sampling (reference :233-236)
    d = pairwise_distances(Xs, n_pos=n_pos, n_d=n_d)  # (S, npairs)
    close = jnp.any(d < 2.0 * radius, axis=0)  # (npairs,)

    ii, jj = pair_indices(n)
    M = jnp.eye(n, dtype=bool)
    M = M.at[ii, jj].set(close)
    M = M.at[jj, ii].set(close)
    return M


def graph_to_dict(M, ids=None) -> dict:
    """Render a membership matrix as the reference's ``{id: [ids]}`` dict
    (for logging/plotting parity)."""
    M = np.asarray(M)
    n = M.shape[0]
    ids = list(range(n)) if ids is None else list(ids)
    return {
        ids[i]: sorted(ids[j] for j in range(n) if M[i, j]) for i in range(n)
    }
