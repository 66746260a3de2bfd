"""Columnar (agent-batched) dynamics and Jacobians.

Pallas kernels cannot vmap a per-agent function, so every model also has a
columnar form operating on whole batched arrays.  Two layouts are provided
from ONE definition per model:

- rows layout ``(n, nx_p)``: agents on sublanes -- used by XLA-phase code.
- state-major layout ``(nx_p, n)``: agents on LANES -- used inside Pallas
  sweep kernels, where a (4, 128)-shaped op is ONE vreg instruction while
  the rows layout would burn ceil(n/8) vregs per op.

Each model's continuous-time RHS is declared as a function of component
getters ``X(i), U(j) -> batched column`` returning a ``{component: value}``
map; the layout adapters assemble the padded xdot with one-hot broadcast
multiply-adds (NOT ``.at[].set``: scatter does not lower inside Pallas
kernels).

The math matches models/specs.py exactly (same reference formulas,
dpilqr/bbdynamics.cpp); tests cross-check both paths bit-for-bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .specs import GRAVITY, ModelSpec
from .specs import (
    _Q12_CX,
    _Q12_CY,
    _Q12_CZ,
    _Q12_KF,
    _Q12_KTX,
    _Q12_KTY,
    _Q12_KTZ,
)


# --- model RHS declarations (layout-agnostic) --------------------------------
# Each takes getters X(i), U(j) and returns {state component: dx/dt value}.

def rhs_double_int_4d(X, U):
    return {0: X(2), 1: X(3), 2: U(0), 3: U(1)}


def rhs_double_int_6d(X, U):
    return {0: X(3), 1: X(4), 2: X(5), 3: U(0), 4: U(1), 5: U(2)}


def rhs_car_3d(X, U):
    return {0: U(0) * jnp.cos(X(2)), 1: U(0) * jnp.sin(X(2)), 2: U(1)}


def rhs_unicycle_4d(X, U):
    return {
        0: X(2) * jnp.cos(X(3)),
        1: X(2) * jnp.sin(X(3)),
        2: U(0),
        3: U(1),
    }


def rhs_human_6d(X, U):
    return {0: X(3) * jnp.cos(U(0)), 1: X(3) * jnp.sin(U(0)), 3: U(1)}


def rhs_human_lin_6d(X, U):
    return {0: X(3), 1: X(4), 3: U(0), 4: U(1)}


def rhs_quad_6d(X, U):
    g = GRAVITY
    return {
        0: X(3),
        1: X(4),
        2: X(5),
        3: g * jnp.tan(U(2)),
        4: -g * jnp.tan(U(1)),
        5: U(0) - g,
    }


def rhs_quad_12d(X, U):
    g = GRAVITY
    psi, th, ph = X(3), X(4), X(5)
    vx, vy, vz = X(6), X(7), X(8)
    wx, wy, wz = X(9), X(10), X(11)
    sps, cps = jnp.sin(psi), jnp.cos(psi)
    sth, cth = jnp.sin(th), jnp.cos(th)
    sph, cph = jnp.sin(ph), jnp.cos(ph)
    tth = jnp.tan(th)
    return {
        0: vx * cps * cth + vy * (sph * sth * cps - sps * cph)
           + vz * (sph * sps + sth * cph * cps),
        1: vx * sps * cth + vy * (sph * sps * sth + cph * cps)
           + vz * (-sph * cps + sps * sth * cph),
        2: -vx * sth + vy * sph * cth + vz * cph * cth,
        3: wy * sph / cth + wz * cph / cth,
        4: wy * cph - wz * sph,
        5: wx + wy * sph * tth + wz * cph * tth,
        6: vy * wz - vz * wy + g * sth,
        7: -vx * wz + vz * wx - g * sph * cth,
        8: _Q12_KF * U(3) + vx * wy - vy * wx - g * cph * cth,
        9: _Q12_KTX * U(0) - _Q12_CX * wy * wz,
        10: _Q12_KTY * U(1) + _Q12_CY * wx * wz,
        11: _Q12_KTZ * U(2) - _Q12_CZ * wx * wy,
    }


def rhs_bike_5d(X, U):
    return {
        0: X(2) * jnp.cos(X(3)),
        1: X(2) * jnp.sin(X(3)),
        2: U(0),
        3: X(2) * jnp.tan(X(4)),
        4: U(1),
    }


RHS = {
    "DoubleInt4D": rhs_double_int_4d,
    "DoubleInt6D": rhs_double_int_6d,
    "Car3D": rhs_car_3d,
    "Unicycle4D": rhs_unicycle_4d,
    "Human6D": rhs_human_6d,
    "HumanLin6D": rhs_human_lin_6d,
    "Quad6D": rhs_quad_6d,
    "Quad12D": rhs_quad_12d,
    "Bike5D": rhs_bike_5d,
}


# --- layout adapters ----------------------------------------------------------

def _rows_f(rhs, x, u, nx_p):
    """Rows layout: x (n, nx_p), u (n, nu_p) -> xdot (n, nx_p)."""
    cols = rhs(lambda i: x[:, i], lambda j: u[:, j])
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, nx_p), 1)
    out = jnp.zeros((x.shape[0], nx_p), dtype=x.dtype)
    for c, v in cols.items():
        hot = (col_ids == c).astype(x.dtype)
        out = out + v[:, None] * hot
    return out


def _smajor_f(rhs, x, u, nx_p):
    """State-major layout: x (nx_p, n), u (nu_p, n) -> xdot (nx_p, n).

    Component getters return (1, n) row slices (rank-preserving static
    slices; Mosaic-safe), assembly is one-hot rows.
    """
    cols = rhs(lambda i: x[i : i + 1, :], lambda j: u[j : j + 1, :])
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (nx_p, 1), 0)
    out = jnp.zeros((nx_p, x.shape[1]), dtype=x.dtype)
    for c, v in cols.items():
        hot = (row_ids == c).astype(x.dtype)
        out = out + v * hot
    return out


# Rows-layout per-model table (public API; tests cross-check vs specs).
def _make_vf(name):
    def vf(x, u, nx_p):
        return _rows_f(RHS[name], x, u, nx_p)
    vf.__name__ = f"vf_{name}"
    return vf


VEC_F = {name: _make_vf(name) for name in RHS}


def _unique_branches(specs: tuple[ModelSpec, ...]):
    seen: dict[int, ModelSpec] = {}
    for s in specs:
        seen.setdefault(s.model_id, s)
    return list(seen.values())


def blended_f(specs: tuple[ModelSpec, ...], nx_p: int):
    """Rows-layout fleet RHS: unique branches blended by per-agent masks.

    Returns ``f(x, u, branch_masks) -> xdot`` where ``branch_masks`` is
    ``(n_branches, n)`` (1.0 where the agent uses that branch).  With one
    unique model the mask argument is ignored.
    """
    branches = [RHS[s.name] for s in _unique_branches(specs)]

    if len(branches) == 1:
        rhs = branches[0]

        def f_homog(x, u, branch_masks=None):
            return _rows_f(rhs, x, u, nx_p)

        return f_homog

    def f_mixed(x, u, branch_masks):
        out = jnp.zeros((x.shape[0], nx_p), dtype=x.dtype)
        for b, rhs in enumerate(branches):
            out = out + branch_masks[b][:, None] * _rows_f(rhs, x, u, nx_p)
        return out

    return f_mixed


def blended_f_smajor(specs: tuple[ModelSpec, ...], nx_p: int):
    """State-major fleet RHS: ``f(x (nx_p, n), u (nu_p, n), branch_masks)``.

    ``branch_masks`` here is ``(n_branches, n)`` and broadcasts onto the
    lanes axis directly (``masks[b:b+1, :]``).
    """
    branches = [RHS[s.name] for s in _unique_branches(specs)]

    if len(branches) == 1:
        rhs = branches[0]

        def f_homog(x, u, branch_masks=None):
            return _smajor_f(rhs, x, u, nx_p)

        return f_homog

    def f_mixed(x, u, branch_masks):
        out = jnp.zeros((nx_p, x.shape[1]), dtype=x.dtype)
        for b, rhs in enumerate(branches):
            out = out + branch_masks[b : b + 1, :] * _smajor_f(
                rhs, x, u, nx_p
            )
        return out

    return f_mixed


def branch_masks_for(fleet) -> np.ndarray:
    """(n_branches, n) float32 selection masks from a Fleet."""
    idx = fleet.branch_index_array
    n_branches = idx.max() + 1 if len(idx) else 1
    out = np.zeros((max(n_branches, 1), len(idx)), dtype=np.float32)
    out[idx, np.arange(len(idx))] = 1.0
    return out


def columnar_rk4(f, x, u, dt, substeps: int, branch_masks=None):
    """Classic RK4 over dt on columnar dynamics (all agents at once)."""
    dh = dt / substeps
    for _ in range(substeps):
        k0 = f(x, u, branch_masks)
        k1 = f(x + 0.5 * dh * k0, u, branch_masks)
        k2 = f(x + 0.5 * dh * k1, u, branch_masks)
        k3 = f(x + dh * k2, u, branch_masks)
        x = x + dh * (k0 + 2.0 * k1 + 2.0 * k2 + k3) / 6.0
    return x
