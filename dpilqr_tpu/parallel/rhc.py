"""Receding-horizon control driver.

Equivalent of the reference's ``solve_rhc`` (distributed.py:106-221) and
``RecedingHorizonController`` (control.py:253-326): a host loop that
repeatedly solves (centralized or decomposed), advances ``step_size`` steps,
and shift-and-pads the warm start.  The per-step solves are single jitted
device programs; the MPC loop itself is host-side by nature (it models
simulated/real time and sensor feedback).

Unlike the reference -- whose inner loop is all-numpy so host work is free --
the per-step host overhead here is real latency between device programs, so
the loop is device-resident: trajectories stay on device, the advance /
warm-start shift is one jitted program (``_advance_shift``), executed slices
accumulate as device arrays, and exactly ONE small host transfer per step
carries the scalars the loop logic needs (J, per-agent goal distances, max
neighborhood size).  Interaction-graph dicts and per-subproblem iteration
counts are converted after the loop unless a per-step consumer (``log_fn``,
``verbose``, checkpointing) needs them live.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from time import perf_counter
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, SolverConfig
from ..models.fleet import Fleet
from ..ops.costs import GameCost
from ..ops.ilqr import ilqr_solve, ilqr_solve_steppable, rollout
from ..utils.geometry import distance_to_goal
from .distributed import solve_distributed
from .graph import graph_to_dict


class RhcStepInfo:
    """Per-MPC-step record (the reference's solve_info + CSV row,
    distributed.py:187-194).

    ``graph`` and ``iters`` materialize lazily: in the fast path the loop
    holds only device handles and the host conversion (one batched transfer
    for ALL steps of the run) happens on first access.  The constructor
    keeps the original dataclass field order ``(t, J, solve_time, graph,
    iters, distance_left)``; ``to_dict`` and pickling materialize the lazy
    fields first."""

    __slots__ = ("t", "J", "solve_time", "distance_left", "_graph", "_iters",
                 "_resolve")

    _FIELDS = ("t", "J", "solve_time", "graph", "iters", "distance_left")

    def __init__(self, t, J, solve_time, graph=None, iters=None,
                 distance_left=None):
        self.t = t
        self.J = J
        self.solve_time = solve_time
        self.distance_left = [] if distance_left is None else distance_left
        self._graph = graph
        self._iters = [] if iters is None else iters
        self._resolve = None

    @property
    def graph(self) -> dict | None:
        if self._resolve is not None:
            self._resolve()
        return self._graph

    @property
    def iters(self) -> list:
        if self._resolve is not None:
            self._resolve()
        return self._iters

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._FIELDS}

    def __getstate__(self):
        return self.to_dict()  # materializes; closures never pickle

    def __setstate__(self, state):
        self.__init__(**state)

    def __repr__(self):
        return (
            f"RhcStepInfo(t={self.t!r}, J={self.J!r}, "
            f"solve_time={self.solve_time!r})"
        )


@dataclass
class RhcResult:
    X: np.ndarray  # (T, n, nx_p) executed trajectory
    U: np.ndarray  # (T, n, nu_p) executed controls
    J: float  # joint cost of the executed plan
    converged: bool
    steps: list = field(default_factory=list)  # list[RhcStepInfo]


@partial(jax.jit, static_argnames=("step_size", "n_d"))
def _advance_shift(X, U, xf, step_size: int, n_d: int):
    """Advance the simulated system and shift-and-pad the warm start
    (reference distributed.py:178-185) as one device program.

    Returns ``(xi, X_exec, U_exec, X_warm, U_warm, dists)`` where ``dists``
    is the per-agent distance-to-goal at the new state (the convergence
    predicate input, distributed.py:135-139)."""
    xi = X[step_size]
    X_exec = X[:step_size]
    U_exec = U[:step_size]
    X_warm = jnp.concatenate(
        [X[step_size:], jnp.tile(X[-1], (step_size, 1, 1))], axis=0
    )
    U_warm = jnp.concatenate(
        [U[step_size:], jnp.zeros((step_size,) + U.shape[1:], U.dtype)],
        axis=0,
    )
    dists = distance_to_goal(xi, xf, n_d)
    return xi, X_exec, U_exec, X_warm, U_warm, dists


def solve_rhc(
    fleet: Fleet,
    cost: GameCost,
    x0,
    N: int,
    radius: float | None = None,
    centralized: bool = True,
    step_size: int = 1,
    J_converge: float | None = None,
    dist_converge: float | None = None,
    n_d: int = 2,
    t_diverge: float | None = None,
    t_kill: float | None = None,
    ignore_mask=None,
    K: int | None = None,
    config: SolverConfig = DEFAULT_CONFIG,
    rng=None,
    U0=None,
    verbose: bool = False,
    log_fn: Callable | None = None,
    checkpoint_path=None,
    resume_state=None,
) -> RhcResult:
    """Receding-horizon solve, centralized or decomposed.

    Convergence: exactly one of ``J_converge`` (stop when J drops below) or
    ``dist_converge`` (stop when every agent is within this distance of its
    goal) must be given (reference distributed.py:125-143).  ``t_diverge``
    aborts after that much simulated time; ``t_kill`` caps wall-clock per
    solve (reference control.py:213-218).

    ``U0 (N, n, nu_p)`` seeds the first solve's warm start instead of the
    default small random controls -- e.g. ``selfish_warmstart(...)`` (the
    reference's problem.py:66-91 solo warm start, which its examples feed
    into the receding-horizon run; at 500 agents it makes the first solve
    1.2x faster with a ~5x lower joint cost, logs/r5_warmstart.jsonl).
    """
    if (J_converge is None) == (dist_converge is None):
        raise ValueError("Specify exactly one of J_converge or dist_converge")
    if not centralized and radius is None:
        raise ValueError("Decomposed mode needs the proximity radius")

    rng = np.random.default_rng() if rng is None else rng
    n, nx_p, nu_p = fleet.n_agents, fleet.nx_p, fleet.nu_p
    dt = fleet.dt

    # Follow the caller's dtype (float32 on the GPU -- the Triton sweep has
    # no 64-bit path; float64 for CPU parity runs).
    x0 = np.asarray(x0)
    if not np.issubdtype(x0.dtype, np.floating):
        x0 = x0.astype(float)
    dtype = x0.dtype
    x0 = x0.reshape(n, nx_p)
    xf = np.asarray(cost.xf)
    xf_dev = jnp.asarray(xf, dtype)

    def stop(J, dists):
        if J_converge is not None:
            return J < J_converge
        return bool(np.all(dists <= dist_converge))

    if resume_state is not None:
        # Resume a checkpointed run (utils/checkpoint.py).
        xi = jnp.asarray(resume_state.xi)
        X = jnp.asarray(resume_state.X_warm)
        U = jnp.asarray(resume_state.U_warm)
        t = resume_state.t
        X_exec_parts = [jnp.asarray(resume_state.X_full)]
        U_exec_parts = [jnp.asarray(resume_state.U_full)]
        step_count = resume_state.step
    else:
        if U0 is not None:
            U_np = np.asarray(U0, dtype).reshape(N, n, nu_p)
        else:
            # Small random warm start (reference distributed.py:152).
            U_np = (rng.uniform(size=(N, n, nu_p)) * 0.01).astype(dtype)
        U_np = U_np * np.asarray(fleet.control_mask, dtype)[None]
        U = jnp.asarray(U_np)
        X = jnp.asarray(x0[None])  # (1, n, nx) until the first solve
        xi = jnp.asarray(x0)
        t = 0.0
        X_exec_parts = []
        U_exec_parts = []
        step_count = 0

    J = np.inf
    # Initial goal distances are only needed by the dist_converge predicate
    # (one host round trip saved in J_converge mode).
    dists = (
        np.asarray(distance_to_goal(xi, xf_dev, n_d))
        if dist_converge is not None
        else None
    )
    converged = True
    steps: list[RhcStepInfo] = []
    # Deferred per-step device payloads, converted after the loop (one
    # transfer instead of a host sync per MPC step).
    deferred: list[tuple] = []
    # Per-step consumers force eager conversion (old behavior).
    eager = verbose or log_fn is not None or checkpoint_path is not None
    # Subproblem width is cached across MPC steps (it changes rarely under
    # power-of-2 bucketing): computed from the returned neighborhood sizes
    # of the previous step instead of an extra graph build + host sync per
    # step (round-1 weakness: parallel/distributed.py auto width).
    K_cur = K

    def _materialize_exec():
        if X_exec_parts:
            X_out = np.asarray(jnp.concatenate(X_exec_parts, axis=0))
            U_out = np.asarray(jnp.concatenate(U_exec_parts, axis=0))
            if X_out.size:
                return X_out, U_out
        # Immediate convergence without optimization (distributed.py:206-208).
        return x0[None].copy(), np.zeros((1, n, nu_p), dtype)

    def dispatch(t_step, xi_cur, X_w, U_w):
        """Dispatch one MPC step (solve + advance/shift) asynchronously.

        Everything returned is a device handle; nothing here blocks on the
        device (one async program chain per step)."""
        t0 = perf_counter()
        if centralized:
            if t_kill is not None:
                res = ilqr_solve_steppable(
                    fleet, cost, xi_cur, U0=U_w, config=config, t_kill=t_kill
                )
            else:
                res = ilqr_solve(fleet, cost, xi_cur, U0=U_w, config=config)
            X_sol, U_sol, J_dev = res.X, res.U, res.J
            membership = None
            iters_dev = jnp.asarray(res.iters)[None]
            kmax_dev = None
            truncated_dev = None
        else:
            if t_kill is not None:
                # Deadline-capped batched solve (reference forwards t_kill
                # into every subproblem solve, distributed.py:170-176).
                from .deadline import solve_distributed_steppable

                dres = solve_distributed_steppable(
                    fleet, cost, X_w, U_w, radius,
                    ignore_mask=ignore_mask, K=K_cur, config=config,
                    t_kill=t_kill,
                )
            else:
                dres = solve_distributed(
                    fleet, cost, X_w, U_w, radius,
                    ignore_mask=ignore_mask, K=K_cur, config=config,
                )
            X_sol, U_sol, J_dev = dres.X, dres.U, dres.J
            membership = dres.membership
            iters_dev = dres.iters
            kmax_dev = jnp.max(dres.sizes)
            truncated_dev = dres.truncated

        xi_n, X_exec, U_exec, X_n, U_n, dists_dev = _advance_shift(
            jnp.asarray(X_sol), jnp.asarray(U_sol), xf_dev, step_size, n_d
        )
        return {
            "t": t_step, "t0": t0, "J": J_dev, "dists": dists_dev,
            "kmax": kmax_dev, "membership": membership, "iters": iters_dev,
            "truncated": truncated_dev, "K_used": K_cur,
            "X_exec": X_exec, "U_exec": U_exec, "xi": xi_n,
            "X": X_n, "U": U_n,
            # Inputs, kept so a truncated step can be re-dispatched with a
            # wider K from the exact same warm state.
            "xi_in": xi_cur, "X_in": X_w, "U_in": U_w,
        }

    def resolve(rec):
        """Block on the step's loop-control scalars and commit the step.

        Returns (stop, diverged, redo); with ``redo`` True nothing was
        committed and the caller must re-dispatch the same step (wider K).
        """
        nonlocal K_cur, step_count, converged, last_resolve_end
        # The ONE host sync of the step: loop-control scalars only.
        J_h, dists_h, kmax, trunc = jax.device_get(
            (rec["J"], rec["dists"], rec["kmax"], rec["truncated"])
        )
        J_h = float(J_h)
        # Per-step latency as cadence: under pipelining this step was
        # dispatched while the previous one was still executing, so measure
        # from the later of its dispatch and the previous resolve.
        now = perf_counter()
        solve_time = now - max(rec["t0"], last_resolve_end)
        last_resolve_end = now

        if trunc is not None and bool(trunc):
            # A neighborhood outgrew the slot count (the reference never
            # truncates, problem.py:36-47).  Under auto-K, redo this step
            # with a wider K than THE WIDTH IT USED, from the same warm
            # state; with a caller-pinned K, warn and proceed (the caller
            # chose the width).  K_used is None only when the step computed
            # its width from its own graph (exact fit, cannot truncate).
            K_used = rec["K_used"]
            if K is None and K_used is not None and K_used < n:
                k_need = int(kmax)
                k_need = 1 << (k_need - 1).bit_length() if k_need > 1 else 1
                K_cur = min(max(k_need, K_used * 2), n)
                return False, False, True
            import warnings

            warnings.warn(
                f"neighborhood exceeded the subproblem width K={K_used}: "
                "coupling partners were dropped from some subproblem(s)",
                RuntimeWarning,
                stacklevel=3,
            )

        if K is None and kmax is not None:
            # Grow immediately; shrink with hysteresis (each width change
            # costs one compile, amortized by the cache).  Under pipelining
            # the width update lags one extra step (the next dispatch is
            # already in flight when this resolves); the truncation redo
            # above catches the rare case where the lag matters.
            k_need = int(kmax)
            k_need = 1 << (k_need - 1).bit_length() if k_need > 1 else 1
            k_need = min(k_need, n)
            if K_cur is None or k_need > K_cur or k_need <= K_cur // 2:
                K_cur = k_need

        X_exec_parts.append(rec["X_exec"])
        U_exec_parts.append(rec["U_exec"])

        info = RhcStepInfo(
            t=rec["t"], J=J_h, solve_time=solve_time,
            distance_left=dists_h.tolist(),
        )
        if eager:
            info._graph = (
                graph_to_dict(rec["membership"])
                if rec["membership"] is not None
                else None
            )
            info._iters = np.asarray(rec["iters"]).tolist()
        else:
            deferred.append((info, rec["membership"], rec["iters"]))
        steps.append(info)
        step_count += 1
        if checkpoint_path is not None:
            from ..utils.checkpoint import RhcState, save_rhc_state

            X_full_np, U_full_np = _materialize_exec()
            # Store the NEXT iteration's simulated time so a resumed run
            # continues exactly where this one left off.
            save_rhc_state(
                checkpoint_path,
                RhcState(
                    xi=np.asarray(rec["xi"]), X_warm=np.asarray(rec["X"]),
                    U_warm=np.asarray(rec["U"]),
                    t=rec["t"] + step_size * dt,
                    X_full=X_full_np, U_full=U_full_np, step=step_count,
                ),
            )
        if log_fn:
            log_fn(info)
        if verbose:
            print(
                f"t: {rec['t']:.3g}\tJ: {J_h:g}\tsolve: {solve_time:.3g}s"
            )

        diverged = t_diverge is not None and rec["t"] >= t_diverge
        if diverged:
            converged = False
            if verbose:
                print("Failed to converge within allotted time...")
        return stop(J_h, dists_h), diverged, False

    # Depth-1 pipeline: the next step is dispatched from the device-resident
    # warm start BEFORE the current step's scalars are fetched, so the
    # ~per-sync host<->device round trip hides under the next solve's device
    # time.  A step dispatched past the stopping point is simply discarded
    # (never committed), so results are identical to the sequential loop.
    # t_kill mode steps the solver host-side (parallel/deadline.py), which
    # blocks anyway -- no pipelining there.
    pipeline = t_kill is None
    last_resolve_end = perf_counter()
    if not stop(J, dists):
        rec = dispatch(t, xi, X, U)
        xi, X, U = rec["xi"], rec["X"], rec["U"]
        while True:
            will_diverge = t_diverge is not None and rec["t"] >= t_diverge
            nxt = None
            if pipeline and not will_diverge:
                t_next = rec["t"] + step_size * dt
                nxt = dispatch(t_next, xi, X, U)
            stopped, diverged, redo = resolve(rec)
            if redo:
                # Truncated neighborhood under auto-K: re-dispatch the SAME
                # step with the widened K from its original warm state; the
                # speculative `nxt` (built on the discarded result) is
                # dropped.
                rec = dispatch(
                    rec["t"], rec["xi_in"], rec["X_in"], rec["U_in"]
                )
                xi, X, U = rec["xi"], rec["X"], rec["U"]
                continue
            if stopped or diverged:
                break  # in-flight `nxt` (if any) is discarded
            if nxt is None:
                t_next = rec["t"] + step_size * dt
                nxt = dispatch(t_next, xi, X, U)
            rec = nxt
            xi, X, U = rec["xi"], rec["X"], rec["U"]

    # Deferred graph/iteration fields resolve lazily on first access: stack
    # on device and fetch ALL steps in one transfer (per-array fetches each
    # pay a full host round trip; many callers never read these fields).
    if deferred:

        def _resolve_deferred():
            its_host = np.asarray(jnp.stack([it for _, _, it in deferred]))
            mems = [m for _, m, _ in deferred]
            mems_host = (
                np.asarray(jnp.stack(mems)) if mems[0] is not None else None
            )
            for k, (info, _, _) in enumerate(deferred):
                info._graph = (
                    graph_to_dict(mems_host[k])
                    if mems_host is not None
                    else None
                )
                info._iters = its_host[k].tolist()
                info._resolve = None

        for info, _, _ in deferred:
            info._resolve = _resolve_deferred

        # Laziness pins the per-step device arrays (membership is (n, n)
        # per step) in accelerator memory for the result's lifetime; for
        # long runs / big fleets resolve now and release them.
        if len(deferred) * (n * n + n * 4) > 8 << 20:
            _resolve_deferred()

    # Executed trajectory + its joint cost (distributed.py:206-211), fetched
    # in ONE host round trip.
    if X_exec_parts and sum(p.shape[0] for p in X_exec_parts) > 0:
        Xc = jnp.concatenate(X_exec_parts, axis=0)
        Uc = jnp.concatenate(U_exec_parts, axis=0)
        _, J_dev = rollout(fleet, cost, jnp.asarray(x0), Uc)
        X_full, U_full, J_full = jax.device_get((Xc, Uc, J_dev))
    else:
        # Immediate convergence without optimization (distributed.py:206-208).
        X_full = x0[None].copy()
        U_full = np.zeros((1, n, nu_p), dtype)
        _, J_full = rollout(
            fleet, cost, jnp.asarray(x0), jnp.asarray(U_full)
        )

    return RhcResult(
        X=np.asarray(X_full), U=np.asarray(U_full), J=float(J_full),
        converged=converged, steps=steps,
    )


def selfish_warmstart(
    fleet: Fleet,
    cost: GameCost,
    x0,
    N: int,
    config: SolverConfig = DEFAULT_CONFIG,
):
    """Per-agent solo warm start (reference problem.py:66-91).

    Solves every agent's reference-tracking problem ignoring all others --
    batched as one decomposed solve on the empty interaction graph -- and
    returns the stacked controls ``(N, n, nu_p)``.
    """
    x0 = jnp.asarray(x0)
    n = fleet.n_agents
    U0 = jnp.zeros((N, n, fleet.nu_p), dtype=x0.dtype)
    # radius <= 0 means no pair is ever within 2*radius: singleton graph.
    res = solve_distributed(
        fleet, cost, x0[None], U0, radius=-1.0, config=config
    )
    return res.U
