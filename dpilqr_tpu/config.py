"""Global configuration for dpilqr_tpu.

The reference implementation (labicon/dp-ilqr) computes everything in float64
(numpy default).  On the GPU, float32 is the fast precision, so the library
is dtype-polymorphic: every solver follows the dtype of its inputs.  For
parity testing against float64 oracles we enable the JAX x64 flag here so
float64 inputs stay float64; benchmarks simply pass float32 arrays.
"""

import os
from dataclasses import dataclass
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself,
# so when it is set nothing is configured here.  Otherwise the cache lives
# at a fixed path inside the checkout (listed in .gitignore), so a later
# process finds what an earlier one compiled.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compilation_cache_dir(environ=os.environ) -> str:
    """The directory the persistent compilation cache uses."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())


@dataclass(frozen=True)
class SolverConfig:
    """Hyperparameters of the iLQR solve.

    Defaults mirror the reference solver (dpilqr/control.py:48-51,150):
    ``DELTA_0=2.0, MU_MIN=1e-6, MU_MAX=1e3, N_LS_ITER=10`` with
    ``n_lqr_iter=50`` outer iterations and relative tolerance ``1e-3``.
    """

    n_lqr_iter: int = 50
    tol: float = 1e-3
    delta_0: float = 2.0
    mu_min: float = 1e-6
    mu_max: float = 1e3
    n_ls_iter: int = 10
    mu_init: float = 1.0

    # When True the returned cost is the cost of the returned trajectory
    # (J_star).  The reference returns the last line-search cost even when the
    # line search failed (dpilqr/control.py:225) -- a quirk we do not copy.
    # There is no flag for that behavior; this field documents the delta.
    return_accepted_cost: bool = True

    # Failed-line-search policy.  "bail" stops iterating immediately -- the
    # reference's actual behavior (its regularization-increase code at
    # control.py:198-208 sits after a break and is dead).  "increase"
    # implements that dead path: raise mu by the delta schedule and keep
    # iterating, aborting only when mu exceeds ``mu_max`` (which is
    # load-bearing only in this mode).
    on_failed_ls: str = "bail"

    # Backward-sweep implementation: "xla" (the lax.scan Riccati sweep),
    # "triton" (ops/riccati_triton.py: the sweep as one Pallas kernel on
    # the Triton route, float32 on a GPU), "pscan" (ops/pscan.py: parallel
    # scan over time), or "auto" (ops/ilqr.resolve_sweep_backend).
    # Resolved by the solver entry points before tracing.
    sweep_backend: str = "auto"

    # Conditioning guard (default off = exact reference behavior).  The
    # reference zeroes mu once it decays past MU_MIN (control.py:236), so a
    # deep proximity penetration can drive the unregularized Q_uu solve to
    # cond ~1e13, past which ANY two implementations diverge macroscopically
    # (BASELINE.md caveat).  With this flag mu is floored at ``mu_min``
    # instead of snapping to 0, bounding kappa(Q_uu) without measurably
    # changing well-conditioned solves.
    mu_floor: bool = False


DEFAULT_CONFIG = SolverConfig()
