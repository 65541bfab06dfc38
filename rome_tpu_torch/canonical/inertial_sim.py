"""Simulated IMU measurement streams — test/benchmark fixtures (a numpy-only
copy of ``rome_tpu/canonical/inertial_sim.py``: the same ``default_rng``
draws, so the same seed gives the same stream in both packages).

Re-expression of the reference generateField_InertialMeasurement family
(the reference's src/canonical/GenerateCommon.jl:210-269): simulate body-rate
gyro and world-frame-target accelerometer streams with optional white noise,
returning dense (N, 3) arrays ready for ``preintegrate_imu``'s scan.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class InertialField:
    tspan: tuple
    gyros: np.ndarray   # (N, 3) body angular rate [rad/s]
    accels: np.ndarray  # (N, 3) body specific force [m/s^2]
    Sigma_y: np.ndarray  # (6, 6) accel+gyro measurement covariance


def _rodrigues(phi):
    th = np.linalg.norm(phi)
    K = np.array(
        [[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]]
    )
    if th < 1e-12:
        return np.eye(3) + K
    return (
        np.eye(3)
        + np.sin(th) / th * K
        + (1 - np.cos(th)) / th**2 * (K @ K)
    )


def generate_field_inertial_measurement(
    dt: float = 0.01,
    N: int = 401,
    rate=(0.0, 0.0, np.pi / 2),
    w_R_b=None,
    gravity=(0.0, 0.0, 0.0),
    accel0=None,
    b_a=(0.0, 0.0, 0.0),
    sigma_a: float = 0.0,
    sigma_w: float = 0.0,
    seed: int = 0,
) -> InertialField:
    """Constant body rate + constant world-frame acceleration target, with
    accel rotated into the body frame as attitude integrates
    (GenerateCommon.jl:210-243)."""
    rng = np.random.default_rng(seed)
    rate = np.asarray(rate, dtype=np.float64)
    gravity = np.asarray(gravity, dtype=np.float64)
    accel0 = (
        gravity.copy() if accel0 is None else np.asarray(accel0, dtype=np.float64)
    )
    b_a = np.asarray(b_a, dtype=np.float64)
    R = np.eye(3) if w_R_b is None else np.asarray(w_R_b, dtype=np.float64).copy()

    def gn():
        return (
            rng.multivariate_normal(np.zeros(3), np.eye(3) * sigma_w**2 / dt)
            if sigma_w > 1e-14
            else np.zeros(3)
        )

    def an():
        return (
            rng.multivariate_normal(np.zeros(3), np.eye(3) * sigma_a**2 / dt)
            if sigma_a > 1e-14
            else np.zeros(3)
        )

    gyros = np.stack([rate + gn() for _ in range(N)])
    accels = [accel0 + an()]
    for g in gyros[:-1]:
        R = R @ _rodrigues(g * dt)
        accels.append(b_a + an() + R.T @ accel0)
    accels = np.stack(accels)

    Sigma_y = np.diag(
        np.concatenate([np.ones(3) * sigma_a**2, np.ones(3) * sigma_w**2])
    )
    return InertialField(
        tspan=(0.0, dt * (N - 1)), gyros=gyros, accels=accels, Sigma_y=Sigma_y
    )


def generate_field_inertial_measurement_noise(
    dt: float = 0.1,
    N: int = 11,
    rate=(0.0, 0.0, 0.001),
    gravity=(0.0, 0.0, 9.81),
    accel0=None,
    sigma_a: float = 1e-4,
    sigma_w: float = np.deg2rad(0.0001),
    seed: int = 0,
) -> InertialField:
    """Noisy wrapper with z-up gravity defaults (GenerateCommon.jl:254-269)."""
    gravity = np.asarray(gravity, dtype=np.float64)
    accel0 = (
        np.array([0.0, 0.0, -1.0]) + gravity if accel0 is None else np.asarray(accel0)
    )
    return generate_field_inertial_measurement(
        dt=dt,
        N=N,
        rate=rate,
        gravity=gravity,
        accel0=accel0,
        sigma_a=sigma_a,
        sigma_w=sigma_w,
        seed=seed,
    )


# reference-style aliases
generateField_InertialMeasurement = generate_field_inertial_measurement
generateField_InertialMeasurement_RateZ = generate_field_inertial_measurement
generateField_InertialMeasurement_noise = generate_field_inertial_measurement_noise
