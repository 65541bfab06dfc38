"""ODE-defined relative factors (DERelative) — inertial kinematic dynamics
(counterpart of ``rome_tpu/factors/ode.py``; reference
ext/RoMEDiffEqExt.jl:13-39 and ext/factors/InertialDynamic.jl:14-37).

The ODE integrates inside the residual as a fixed-step RK4 loop: a static
step count (one step per IMU sample), the signals linearly interpolated,
differentiable end to end, so the parametric solver gets exact
sensitivities through the flow. The backward problem (slot 0 from slot 1)
is the same flow run with a negative step.
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, MvNormal
from rome_tpu_torch.factors.base import Factor, FactorType, gaussian_params, register_factor_type
from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.variables import RotVelPos

_RVP_M = RotVelPos.manifold

GRAVITY = (0.0, 0.0, 9.81)


def imu_kinematic(state, omega, accel, g):
    """du/dt of the (q, v, p) state (imuKinematic!, InertialDynamic.jl:14-37):
    qdot = 0.5 q x (0, w); vdot = R(q) a - g; pdot = v."""
    q, v = state[..., :4], state[..., 4:7]
    zw = torch.zeros_like(omega[..., :1])
    qdot = 0.5 * Q.qmul(q, torch.cat([zw, omega], dim=-1))
    vdot = Q.qrotate(q, accel) - g
    return torch.cat([qdot, vdot, v], dim=-1)


def _interp_signal(sig, t0, dt, t):
    """Linear interpolation of an (..., N, 3) signal sampled at t0 + k*dt,
    at times t of the signal's batch shape."""
    f = torch.clamp((t - t0) / dt, 0.0, sig.shape[-2] - 1.001)
    k = torch.floor(f)
    w = (f - k)[..., None]
    idx = k.long()[..., None, None].expand(*k.shape, 1, sig.shape[-1])
    lo = torch.gather(sig, -2, idx)[..., 0, :]
    hi = torch.gather(sig, -2, idx + 1)[..., 0, :]
    return lo * (1 - w) + hi * w


def _integrate_rvp(params, x0_rvp, direction=1.0):
    """RK4 flow of the IMU kinematics from a RotVelPos point over the
    factor's timespan: N samples cover N steps of dt_step (each reading
    integrates one step, as in preintegration), the interpolation clamped
    at the signal's ends. ``direction`` = -1 runs the backward problem.
    Params may carry a batch shape (the particles of a convolution), the
    point the same batch shape."""
    gyros, accels = params["gyros"], params["accels"]
    t0, h = params["t0"], params["dt_step"]
    g = params["gravity"]
    n = gyros.shape[-2]
    dt = h * direction
    t = t0 if direction > 0 else t0 + h * n
    hs = dt[..., None]

    def rhs(t, s):
        return imu_kinematic(s, _interp_signal(gyros, t0, h, t),
                             _interp_signal(accels, t0, h, t), g)

    s = x0_rvp
    for _ in range(n):
        k1 = rhs(t, s)
        k2 = rhs(t + 0.5 * dt, s + 0.5 * hs * k1)
        k3 = rhs(t + 0.5 * dt, s + 0.5 * hs * k2)
        k4 = rhs(t + dt, s + hs * k3)
        s = s + hs / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        s = torch.cat([Q.qnormalize(s[..., :4]), s[..., 4:]], dim=-1)
        t = t + dt
    return s


def _inertial_dynamic_res(params, xi, xj):
    xhat = _integrate_rvp(params, xi, direction=1.0)
    return params["z"] - _RVP_M.local(xhat, xj)


def _inertial_dynamic_init1(params, pts):
    return _integrate_rvp(params, pts[0], direction=1.0)


def _inertial_dynamic_init0(params, pts):
    return _integrate_rvp(params, pts[1], direction=-1.0)


INERTIAL_DYNAMIC = register_factor_type(
    FactorType(
        name="InertialDynamic",
        variable_types=(RotVelPos, RotVelPos),
        zdim=9,
        residual=_inertial_dynamic_res,
        initializers={1: _inertial_dynamic_init1, 0: _inertial_dynamic_init0},
        coord_types=("c",) * 3 + ("e",) * 6,
        doc="DERelative ODE factor on RotVelPos: RK4 flow of the IMU "
        "kinematics (RoMEDiffEqExt.jl:13-39; imuKinematic! "
        "InertialDynamic.jl:14-37). The backward problem is the same flow "
        "integrated with negative step.",
    )
)


def InertialDynamic(
    tspan,
    dt: float,
    gyros,
    accels,
    Z: Distribution = None,
    gravity=GRAVITY,
) -> Factor:
    """The ODE inertial factor from sampled gyro/accel signals
    (RoMEDiffEqExt.jl:14-39 signature)."""
    gyros = np.asarray(gyros, dtype=np.float64).reshape(-1, 3)
    accels = np.asarray(accels, dtype=np.float64).reshape(-1, 3)
    assert gyros.shape == accels.shape
    Z = Z or MvNormal(np.zeros(9), np.diag([1e-3] * 3 + [1e-2] * 6))
    params = gaussian_params(Z.mean(), Z.cov())
    params.update(
        gyros=gyros,
        accels=accels,
        t0=np.float64(tspan[0]),
        dt_step=np.float64(dt),
        gravity=np.asarray(gravity, dtype=np.float64),
    )
    return Factor(ftype=INERTIAL_DYNAMIC, variables=(), params=params, dists=(Z,))
