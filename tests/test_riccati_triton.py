"""The Triton Riccati sweep (ops/riccati_triton.py).

On the CPU the kernel runs through the Pallas interpreter: parity with the
plain ``_backward_pass`` (model x agents x horizon x dtype, padded slots
and padded tile widths included), the solves that route through it, and
its lowering to a Triton custom call for CUDA at the widths the benchmark
uses (lowering needs no card).  The compiled kernel is checked on the card
by the ``gpu``-marked test and by chip_smoke.py's correctness phase.
"""

from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import dpilqr_tpu as dtl
from dpilqr_tpu.config import SolverConfig
from dpilqr_tpu.ops import riccati_triton
from dpilqr_tpu.ops.ilqr import (
    TRITON_MAX_WIDTH,
    _backward_pass,
    resolve_sweep_backend,
)

MODELS = {
    "unicycle": [dtl.UNICYCLE_4D],
    "doubleint": [dtl.DOUBLE_INT_4D],
    "quad6d": [dtl.QUAD_6D],
    "mixed": [dtl.UNICYCLE_4D, dtl.BIKE_5D, dtl.CAR_3D],
}


def _fleet(model, n):
    kinds = MODELS[model]
    return dtl.Fleet(tuple(kinds[i % len(kinds)] for i in range(n)), 0.1)


def _batch(model, n, N, dtype, S=2, seed=0):
    """S random subproblems of n slots; the last slot is padding (mask 0)
    whenever n > 2."""
    rng = np.random.default_rng(seed)
    fleet = _fleet(model, n)
    nx, nu = fleet.nx_p, fleet.nu_p
    mask = np.ones(n)
    if n > 2:
        mask[-1] = 0.0
    cost = dtl.make_game_cost(
        jnp.asarray(rng.normal(size=(n, nx)), dtype),
        np.tile(np.eye(nx), (n, 1, 1)),
        np.tile(np.eye(nu), (n, 1, 1)),
        np.tile(100 * np.eye(nx), (n, 1, 1)),
        radius=1.5,
        agent_mask=mask,
    )
    X = jnp.asarray(0.4 * rng.normal(size=(S, N + 1, n, nx)), dtype)
    U = jnp.asarray(0.1 * rng.normal(size=(S, N, n, nu)), dtype)
    U = U * jnp.asarray(fleet.control_mask, dtype)
    mu = jnp.asarray(rng.uniform(0.1, 1.0, S), dtype)
    return fleet, cost, X, U, mu


def _sweep(fleet, cost, fn):
    def one(X, U, mu):
        return fn(fleet.linearize, cost, X, U, mu)

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("N", [4, 9])
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_sweep_matches_plain_backward_pass(model, n, N, dtype):
    fleet, cost, X, U, mu = _batch(model, n, N, dtype)
    K_x, d_x = _sweep(fleet, cost, _backward_pass)(X, U, mu)
    K_k, d_k = _sweep(
        fleet, cost,
        partial(riccati_triton.backward_pass_triton, interpret=True),
    )(X, U, mu)
    assert K_k.shape == K_x.shape == (2, N, n * fleet.nu_p, n * fleet.nx_p)
    assert d_k.shape == d_x.shape
    # Same recursion, dense padded tiles vs agent blocks: only the
    # summation order differs, and a float32 recursion amplifies that by
    # the conditioning of the random problems (~1e-4 seen at n=8, N=9).
    rtol = 1e-3 if dtype == jnp.float32 else 1e-10
    for got, ref in ((K_k, K_x), (d_k, d_x)):
        scale = float(jnp.max(jnp.abs(ref)))
        assert scale > 0
        err = float(jnp.max(jnp.abs(got - ref)))
        assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize(
    "m, width", [(1, 16), (16, 16), (17, 32), (32, 32), (40, 64), (96, 128)]
)
def test_padded_width(m, width):
    assert riccati_triton.padded_width(m) == width


@pytest.mark.parametrize(
    "model, n",
    [("unicycle", 8), ("quad6d", 8), ("unicycle", 10), ("mixed", 8)],
)
def test_lowers_to_triton_for_cuda(model, n):
    """The kernel lowers to a Triton custom call at the benchmark's widths
    (the Pallas-to-Triton lowering runs on the host; only the final PTX
    compile needs the card)."""
    fleet, cost, X, U, mu = _batch(model, n, 50, jnp.float32, S=4)
    fn = _sweep(fleet, cost, riccati_triton.backward_pass_triton)
    text = fn.trace(X, U, mu).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "riccati_sweep" in text


@pytest.mark.parametrize(
    "platform, dtype, nxf, expected",
    [
        ("gpu", np.float32, 16, "triton"),
        ("gpu", np.float32, TRITON_MAX_WIDTH, "triton"),
        ("gpu", np.float32, 40, "xla"),
        ("gpu", np.float32, 96, "xla"),
        ("gpu", np.float64, 32, "xla"),
        ("cpu", np.float32, 32, "xla"),
    ],
)
def test_auto_resolution(platform, dtype, nxf, expected):
    cfg = SolverConfig(sweep_backend="auto")
    assert resolve_sweep_backend(cfg, nxf, dtype, platform) == expected


@pytest.mark.parametrize("backend", ["xla", "pscan", "triton"])
def test_explicit_backend_wins(backend):
    cfg = SolverConfig(sweep_backend=backend)
    assert resolve_sweep_backend(cfg, 96, np.float64, "cpu") == backend


def _distributed_problem(n, N, dtype, models=None, seed=3):
    rng = np.random.default_rng(seed)
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=5.0, n_d=2)
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1) if models is None \
        else dtl.Fleet(tuple(models), 0.1)
    nx_p, nu_p = fleet.nx_p, fleet.nu_p
    x0p = np.zeros((n, nx_p))
    x0p[:, :4] = x0
    xfp = np.zeros((n, nx_p))
    xfp[:, :4] = xf
    cost = dtl.make_game_cost(
        jnp.asarray(xfp, dtype),
        np.tile(np.eye(nx_p), (n, 1, 1)),
        np.tile(np.eye(nu_p), (n, 1, 1)),
        np.tile(1e3 * np.eye(nx_p), (n, 1, 1)),
        radius=0.5,
    )
    X0 = jnp.broadcast_to(jnp.asarray(x0p, dtype)[None], (N + 1, n, nx_p))
    U0 = jnp.zeros((N, n, nu_p), dtype)
    return fleet, cost, X0, U0


@pytest.mark.parametrize(
    "models, K",
    [
        (None, 4),
        ([dtl.UNICYCLE_4D, dtl.DOUBLE_INT_4D] * 2, 4),
        (None, 2),  # narrower than some neighborhoods: truncation path
    ],
)
def test_distributed_solve_matches_xla(triton_interpret, models, K):
    n = 4 if models is not None else 5
    fleet, cost, X0, U0 = _distributed_problem(n, 6, jnp.float64, models)
    out = {}
    for backend in ("xla", "triton"):
        cfg = SolverConfig(n_lqr_iter=5, tol=1e-3, sweep_backend=backend)
        out[backend] = dtl.solve_distributed(
            fleet, cost, X0, U0, 0.5, K=K, config=cfg
        )
    rx, rk = out["xla"], out["triton"]
    np.testing.assert_array_equal(np.asarray(rx.iters), np.asarray(rk.iters))
    np.testing.assert_array_equal(
        np.asarray(rx.converged), np.asarray(rk.converged)
    )
    np.testing.assert_allclose(float(rk.J), float(rx.J), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(rk.X), np.asarray(rx.X), atol=1e-8)
    assert int(np.asarray(rx.iters).sum()) > 0


@pytest.mark.parametrize("n", [2, 3])
def test_centralized_solve_matches_xla(triton_interpret, n):
    rng = np.random.default_rng(n)
    x0, xf = dtl.random_setup(n, 4, rng=rng, energy=5.0, n_d=2)
    fleet = dtl.homogeneous_fleet(dtl.UNICYCLE_4D, n, 0.1)
    cost = dtl.make_game_cost(
        xf, np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(2), (n, 1, 1)),
        np.tile(1e3 * np.eye(4), (n, 1, 1)), radius=0.5,
    )
    res = {
        b: dtl.ilqr_solve(
            fleet, cost, jnp.asarray(x0), N=12,
            config=SolverConfig(n_lqr_iter=8, sweep_backend=b),
        )
        for b in ("xla", "triton")
    }
    assert int(res["xla"].iters) == int(res["triton"].iters) > 0
    np.testing.assert_allclose(
        float(res["triton"].J), float(res["xla"].J), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(res["triton"].X), np.asarray(res["xla"].X), atol=1e-8
    )


def test_deadline_solve_through_kernel(triton_interpret):
    """The host-stepped deadline solve reaches the kernel through
    make_iteration_fn and matches the fused kernel solve."""
    from dpilqr_tpu.parallel.deadline import solve_distributed_steppable

    fleet, cost, X0, U0 = _distributed_problem(5, 6, jnp.float64)
    cfg = SolverConfig(n_lqr_iter=5, tol=1e-3, sweep_backend="triton")
    fused = dtl.solve_distributed(fleet, cost, X0, U0, 0.5, K=4, config=cfg)
    stepped = solve_distributed_steppable(
        fleet, cost, X0, U0, 0.5, K=4, config=cfg, t_kill=None
    )
    np.testing.assert_array_equal(
        np.asarray(fused.iters), np.asarray(stepped.iters)
    )
    np.testing.assert_allclose(float(stepped.J), float(fused.J), rtol=1e-12)


def test_triton_backend_without_interpreter_fails_on_cpu():
    """Off the card the compiled kernel cannot run, and the solve says so
    instead of carrying on in interpret mode."""
    fleet, cost, X0, U0 = _distributed_problem(3, 4, jnp.float32)
    cfg = SolverConfig(n_lqr_iter=2, sweep_backend="triton")
    with pytest.raises(ValueError, match="interpret mode"):
        dtl.solve_distributed(fleet, cost, X0, U0, 0.5, K=2, config=cfg)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_sweep_on_gpu(gpu_device):
    fleet, cost, X, U, mu = _batch("unicycle", 8, 50, jnp.float32, S=64)
    X, U, mu, cost = jax.device_put((X, U, mu, cost), gpu_device)
    K_x, d_x = _sweep(fleet, cost, _backward_pass)(X, U, mu)
    K_k, d_k = _sweep(fleet, cost, riccati_triton.backward_pass_triton)(
        X, U, mu
    )
    for got, ref in ((K_k, K_x), (d_k, d_x)):
        err = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
        assert err <= 1e-3, err
