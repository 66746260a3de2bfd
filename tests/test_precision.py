"""Every float32 contraction of a solve is pinned to true float32.

On a GPU a ``dot_general`` at the default precision may run in TF32
(about three decimal digits), which the Riccati sandwiches and the
incidence-matrix pair geometry (ops/costs.py) cannot absorb.  The solver
code pins ``Precision.HIGHEST`` on each of them; these tests walk the
traced programs of small solves and fail on any float32 ``dot_general``
left at the default.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import dpilqr_tpu as dtl
from dpilqr_tpu.config import SolverConfig

HIGHEST = jax.lax.Precision.HIGHEST


def _subjaxprs(eqn):
    for v in eqn.params.values():
        for item in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(item, jax.extend.core.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jax.extend.core.Jaxpr):
                yield item


def _f32_dots(jaxpr):
    """(precision, operand shapes) of every float32 dot_general, nested
    jaxprs (scan, while, cond, pjit, custom rules) included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            yield eqn.params["precision"], [v.aval.shape for v in eqn.invars]
        for sub in _subjaxprs(eqn):
            yield from _f32_dots(sub)


def _problem(n, N=6):
    rng = np.random.default_rng(0)
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=5.0, n_d=2)
    f32 = jnp.float32
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    cost = dtl.make_game_cost(
        jnp.asarray(xf, f32),
        np.tile(np.eye(4), (n, 1, 1)),
        np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)),
        radius=0.5,
    )
    x0 = jnp.asarray(x0, f32)
    X0 = jnp.broadcast_to(x0[None], (N + 1, n, 4))
    U0 = jnp.zeros((N, n, 2), f32)
    return fleet, cost, x0, X0, U0


def _centralized(backend):
    from dpilqr_tpu.ops.ilqr import _ilqr_solve

    fleet, cost, x0, _, U0 = _problem(2)
    cfg = SolverConfig(n_lqr_iter=3, sweep_backend=backend)
    return jax.make_jaxpr(
        lambda c, x, u: _ilqr_solve(fleet, U0.shape[0], cfg, c, x, u)
    )(cost, x0, U0)


def _distributed(backend):
    from dpilqr_tpu.parallel.distributed import _solve_distributed

    fleet, cost, _, X0, U0 = _problem(2)
    cfg = SolverConfig(n_lqr_iter=3, sweep_backend=backend)
    return jax.make_jaxpr(
        lambda c, X, U: _solve_distributed(
            fleet, cfg, 2, None, c, X, U, jnp.float32(0.5),
            jnp.zeros((2,), bool),
        )
    )(cost, X0, U0)


@pytest.mark.parametrize(
    "program, backend",
    [
        (_centralized, "xla"),
        (_centralized, "pscan"),
        (_distributed, "xla"),
        (_distributed, "triton"),
    ],
)
def test_no_default_precision_float32_dot(program, backend):
    dots = list(_f32_dots(program(backend).jaxpr))
    assert dots, "the solve traced no float32 dot_general at all"
    loose = [
        shapes for prec, shapes in dots
        if prec is None or any(p != HIGHEST for p in prec)
    ]
    assert not loose, f"float32 dot_general below HIGHEST: {loose[:5]}"
