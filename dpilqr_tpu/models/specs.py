"""Dynamics model registry.

Each model is a pure continuous-time vector field ``f(x, u) -> x_dot`` on its
native state/control dimensions, registered with static metadata.  Jacobians
are obtained with ``jax.jacfwd`` (exact, and constant-folded by XLA for the
linear models), discretized with the same forward-Euler rule the reference
uses: ``A_d = I + dt * A_c``, ``B_d = dt * B_c``
(reference: dpilqr/bbdynamics.cpp:95-106, dpilqr/dynamics.py:112-114).

Model catalogue mirrors the reference's eight native models plus the symbolic
bicycle (dpilqr/bbdynamics.cpp:108-711, dpilqr/dynamics.py:205-277).

Heterogeneous fleets are handled the array way: every agent's state/control is
zero-padded to the fleet-wide maximum, so all per-agent tensors stack into
rectangular arrays and batch onto the device (the reference hints at the
same trick in its Human6D padding, dpilqr/bbdynamics.cpp:311-316).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax.numpy as jnp

# Acceleration due to gravity (reference: dpilqr/bbdynamics.cpp:11).
GRAVITY = 9.80665

# Quadrotor 12D physical constants (reference: dpilqr/bbdynamics.cpp:507-510,
# 696-707).  These are thrust/inertia ratios of the Crazyflie-style model:
#   KF  = 1 / m                (force input gain)
#   KTX/KTY/KTZ = 1 / I_{xx,yy,zz}  (torque input gains)
#   CX  = (I_zz - I_yy) / I_xx etc.  (gyroscopic coupling ratios)
_Q12_KF = 2000.0 / 63.0
_Q12_KTX = 625000000000000000.0 / 10982593196059.0
_Q12_KTY = 5000000000000000000.0 / 92848985528431.0
_Q12_KTZ = 10000000000000000000.0 / 271597947137541.0
_Q12_CX = 85899976080679.0 / 175721491136944.0
_Q12_CY = 95876456000597.0 / 185697971056862.0
_Q12_CZ = 9976479919918.0 / 271597947137541.0


@dataclass(frozen=True)
class ModelSpec:
    """Static description of one dynamics model."""

    name: str
    model_id: int
    n_x: int
    n_u: int
    f: Callable  # f(x, u) -> x_dot on native dims
    # Number of RK4 sub-steps per control period.  The reference's C++ kernel
    # uses 5 (bbdynamics.cpp:49); its Python/sympy path uses 1
    # (dynamics.py:74).  We preserve each model's reference behavior.
    rk4_substeps: int = 5
    # Number of leading position coordinates (used by proximity coupling).
    n_pos: int = 2


def _f_double_int_4d(x, u):
    """[px, py, vx, vy], [ax, ay] (reference: bbdynamics.cpp:108-117)."""
    return jnp.stack([x[2], x[3], u[0], u[1]])


def _f_double_int_6d(x, u):
    """[p(3), v(3)], [a(3)] (reference: bbdynamics.cpp:150-161)."""
    return jnp.concatenate([x[3:6], u[0:3]])


def _f_car_3d(x, u):
    """[px, py, theta], [v, omega] (reference: bbdynamics.cpp:230-239)."""
    return jnp.stack([u[0] * jnp.cos(x[2]), u[0] * jnp.sin(x[2]), u[1]])


def _f_unicycle_4d(x, u):
    """[px, py, v, theta], [a, omega] (reference: bbdynamics.cpp:264-274)."""
    return jnp.stack([x[2] * jnp.cos(x[3]), x[2] * jnp.sin(x[3]), u[0], u[1]])


def _f_quad_6d(x, u):
    """[p(3), v(3)], [thrust, roll, pitch] (reference: bbdynamics.cpp:417-429)."""
    zero = jnp.zeros_like(x[0])
    return jnp.stack(
        [
            x[3],
            x[4],
            x[5],
            GRAVITY * jnp.tan(u[2]) + zero,
            -GRAVITY * jnp.tan(u[1]) + zero,
            u[0] - GRAVITY,
        ]
    )


def _f_human_6d(x, u):
    """Constant-height unicycle padded to 6 states / 3 controls.

    x = [px, py, pz, v, 0, 0], u = [theta, a, 0]
    (reference: bbdynamics.cpp:308-329).
    """
    zero = jnp.zeros_like(x[0])
    return jnp.stack(
        [x[3] * jnp.cos(u[0]), x[3] * jnp.sin(u[0]), zero, u[1], zero, zero]
    )


def _f_human_lin_6d(x, u):
    """2D double integrator at constant height (reference: bbdynamics.cpp:393-405)."""
    zero = jnp.zeros_like(x[0])
    return jnp.stack([x[3], x[4], zero, u[0], u[1], zero])


def _f_quad_12d(x, u):
    """Full 12-state rigid-body quadrotor (reference: bbdynamics.cpp:493-511).

    x = [px, py, pz, psi, theta, phi, vx, vy, vz, wx, wy, wz]
    u = [tau_x, tau_y, tau_z, f_z]
    """
    g = GRAVITY
    psi, th, ph = x[3], x[4], x[5]
    vx, vy, vz = x[6], x[7], x[8]
    wx, wy, wz = x[9], x[10], x[11]
    spsi, cpsi = jnp.sin(psi), jnp.cos(psi)
    sth, cth = jnp.sin(th), jnp.cos(th)
    sph, cph = jnp.sin(ph), jnp.cos(ph)
    tth = jnp.tan(th)

    return jnp.stack(
        [
            vx * cpsi * cth
            + vy * (sph * sth * cpsi - spsi * cph)
            + vz * (sph * spsi + sth * cph * cpsi),
            vx * spsi * cth
            + vy * (sph * spsi * sth + cph * cpsi)
            + vz * (-sph * cpsi + spsi * sth * cph),
            -vx * sth + vy * sph * cth + vz * cph * cth,
            wy * sph / cth + wz * cph / cth,
            wy * cph - wz * sph,
            wx + wy * sph * tth + wz * cph * tth,
            vy * wz - vz * wy + g * sth,
            -vx * wz + vz * wx - g * sph * cth,
            _Q12_KF * u[3] + vx * wy - vy * wx - g * cph * cth,
            _Q12_KTX * u[0] - _Q12_CX * wy * wz,
            _Q12_KTY * u[1] + _Q12_CY * wx * wz,
            _Q12_KTZ * u[2] - _Q12_CZ * wx * wy,
        ]
    )


def _f_bike_5d(x, u):
    """Kinematic bicycle [px, py, v, theta, phi], [a, rho]
    (reference: dpilqr/dynamics.py:254-277, sympy-derived)."""
    return jnp.stack(
        [
            x[2] * jnp.cos(x[3]),
            x[2] * jnp.sin(x[3]),
            u[0],
            x[2] * jnp.tan(x[4]),
            u[1],
        ]
    )


# Registry.  IDs are stable public constants; order mirrors the reference's
# Model enum (dpilqr/bbdynamicswrap.pyx:8-16) with Bike5D appended.
DOUBLE_INT_4D = ModelSpec("DoubleInt4D", 0, 4, 2, _f_double_int_4d, n_pos=2)
DOUBLE_INT_6D = ModelSpec("DoubleInt6D", 1, 6, 3, _f_double_int_6d, n_pos=3)
CAR_3D = ModelSpec("Car3D", 2, 3, 2, _f_car_3d, n_pos=2)
UNICYCLE_4D = ModelSpec("Unicycle4D", 3, 4, 2, _f_unicycle_4d, n_pos=2)
HUMAN_6D = ModelSpec("Human6D", 4, 6, 3, _f_human_6d, n_pos=3)
HUMAN_LIN_6D = ModelSpec("HumanLin6D", 5, 6, 3, _f_human_lin_6d, n_pos=3)
QUAD_6D = ModelSpec("Quad6D", 6, 6, 3, _f_quad_6d, n_pos=3)
QUAD_12D = ModelSpec("Quad12D", 7, 12, 4, _f_quad_12d, n_pos=3)
BIKE_5D = ModelSpec("Bike5D", 8, 5, 2, _f_bike_5d, rk4_substeps=1, n_pos=2)

MODEL_REGISTRY: tuple[ModelSpec, ...] = (
    DOUBLE_INT_4D,
    DOUBLE_INT_6D,
    CAR_3D,
    UNICYCLE_4D,
    HUMAN_6D,
    HUMAN_LIN_6D,
    QUAD_6D,
    QUAD_12D,
    BIKE_5D,
)

MODEL_BY_NAME = {spec.name: spec for spec in MODEL_REGISTRY}


def get_model(name_or_id) -> ModelSpec:
    if isinstance(name_or_id, ModelSpec):
        return name_or_id
    if isinstance(name_or_id, str):
        return MODEL_BY_NAME[name_or_id]
    return MODEL_REGISTRY[int(name_or_id)]
