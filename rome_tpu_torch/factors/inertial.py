"""Inertial factors — IMU preintegration on SGal(3) and support factors
(counterpart of ``rome_tpu/factors/inertial.py``; reference
IMUDeltaFactor.jl:293-496, PriorIMUBias.jl:13-37, PriorVelPos3.jl:13-33,
VelPosRotVelPos.jl:6-26, VelAlign.jl:6-42).

Preintegration is graph construction, not part of the solve: it runs once
per factor in float64 on the CPU, as the JAX package runs its ``lax.scan``
on the host at graph-build time. The factor residuals are SGal(3) functions
of the points, batched by the solvers like every other residual.

Variable layouts (see rome_tpu_torch.variables):
  RotVelPos = [q(4), v(3), p(3)]        (SO(3) x T(3) x T(3))
  VelPos3   = [v(3), p(3)]              (T(3) x T(3))
  IMUBias   = [b_a(3), b_w(3)]          (T(3) x T(3))
  Pose3     = [t(3), q(4)]              (SE(3))
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, MvNormal
from rome_tpu_torch.factors.base import Factor, FactorType, make_gaussian_factor, register_factor_type
from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.manifolds import sgal3 as G
from rome_tpu_torch.utils.math import matvec
from rome_tpu_torch.variables import IMUBias, Pose3, Rotation3, RotVelPos, VelPos3

_RVP_M = RotVelPos.manifold
_VP_M = VelPos3.manifold


def _f64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# ---------------------------------------------------------------------------
# Preintegration (IMUDeltaFactor.jl:411-458)
# ---------------------------------------------------------------------------

def _tau_dt(dt):
    """(..., 10, 6) map from (accel, gyro) noise to tangent coords for dt of
    shape (..., 1): nu rows get dt*I from accel, theta rows dt*I from gyro
    (IMUDeltaFactor.jl:403-409)."""
    eye = torch.eye(3, dtype=dt.dtype, device=dt.device)
    tau = torch.zeros((*dt.shape[:-1], 10, 6), dtype=dt.dtype, device=dt.device)
    tau[..., 3:6, 0:3] = dt[..., None] * eye
    tau[..., 6:9, 3:6] = dt[..., None] * eye
    return tau


def _sample_terms(a, w, a_b, w_b, dt, Sigma_y):
    """Per-sample (batched) terms of one preintegration step: the sample's
    SGal(3) delta, the noise Jacobian Jy and the noise it adds,
    Jy Sigma_y Jy^T."""
    Xc = torch.cat([torch.zeros_like(a), (a - a_b) * dt, (w - w_b) * dt, dt], dim=-1)
    Jy = G.right_jacobian(Xc) @ _tau_dt(dt)
    return G.exp(Xc), Jy, Jy @ Sigma_y @ Jy.transpose(-1, -2)


def integrate_imu_delta(delta, Sigma, J_b, a, w, a_b, w_b, dt, Sigma_y):
    """One preintegration step with covariance and bias-Jacobian propagation
    (IMUDeltaFactor.jl:411-445); ``dt`` of shape (..., 1)."""
    djk, Jy, noise = _sample_terms(a, w, a_b, w_b, dt, Sigma_y)
    A = G.Adjoint_matrix(G.inverse(djk))  # the composition's Jacobian wrt delta
    Sigma_new = A @ Sigma @ A.transpose(-1, -2) + noise
    return G.compose(delta, djk), Sigma_new, A @ J_b - Jy


def _running_compose(d):
    """(n, 11) running compositions d_0 ∘ d_1 ∘ ... ∘ d_k of (n, 11) SGal(3)
    points, in ceil(log2 n) batched ``compose`` steps (an inclusive scan)."""
    off = 1
    while off < d.shape[0]:
        d = torch.cat([d[:off], G.compose(d[:-off], d[off:])])
        off *= 2
    return d


def preintegrate_imu(accels, gyros, deltatimes, Sigma_y, a_b=None, w_b=None):
    """Preintegrate an IMU stream -> (delta point (11,), Sigma (10,10), J_b
    (10,6)), float64 numpy (IMUDeltaFactor.jl:448-458).

    The ``integrate_imu_delta`` steps from the identity, in float64 on the
    CPU, batched over the samples: each sample's own terms (its delta d_k,
    A_k = Ad(d_k^-1), Jy_k), the running deltas P_k = d_1 ∘ ... ∘ d_k as a
    scan, and the recursions Sigma <- A Sigma A^T + Jy Sigma_y Jy^T and
    J_b <- A J_b - Jy in closed form: A_n ... A_{k+1} = Ad(P_n^-1 ∘ P_k), so
    Sigma = sum_k M_k Jy_k Sigma_y Jy_k^T M_k^T and J_b = -sum_k M_k Jy_k with
    M_k = Ad(P_n^-1 ∘ P_k). Equal to the steps up to rounding (held by test).
    """
    a = _f64(accels).reshape(-1, 3)
    w = _f64(gyros).reshape(-1, 3)
    dts = _f64(deltatimes).reshape(-1, 1)
    a_b = torch.zeros(3, dtype=torch.float64) if a_b is None else _f64(a_b)
    w_b = torch.zeros(3, dtype=torch.float64) if w_b is None else _f64(w_b)
    djk, Jy, noise = _sample_terms(a, w, a_b, w_b, dts, _f64(Sigma_y))
    P = _running_compose(djk)
    M = G.Adjoint_matrix(G.compose(G.inverse(P[-1]).expand_as(P), P))
    Sigma = (M @ noise @ M.transpose(-1, -2)).sum(0)
    J_b = -(M @ Jy).sum(0)
    return P[-1].numpy(), Sigma.numpy(), J_b.numpy()


# ---------------------------------------------------------------------------
# IMUDeltaFactor residuals (IMUDeltaFactor.jl:342-401)
# ---------------------------------------------------------------------------

def _imu_residual(params, pi_pt, pj_pt, b):
    """Core 9-dof residual: vee(log(Δi⁻¹ ∘ (p ⊟ q)))[1:9] with first-order
    bias correction Δi = Δmeas ∘ exp(J_b (b - b̄)) (IMUDeltaFactor.jl:342-361)."""
    corr = G.exp(matvec(params["J_b"], b - params["b0"]))
    Di = G.compose(params["delta"], corr)
    Dhat = G.boxminus(pi_pt, pj_pt, gravity=params["gravity"])
    return G.log(G.compose(G.inverse(Di), Dhat))[..., :9]


def _zero_t(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def _rvp_to_sgal(x, t):
    return G.make_point(x[..., :4], x[..., 4:7], x[..., 7:10], t)


def _imu_rvp_res(params, xi, xj):
    return _imu_residual(
        params, _rvp_to_sgal(xi, _zero_t(xi)), _rvp_to_sgal(xj, params["dt"]), params["b0"]
    )


def _imu_rvp_bias_res(params, xi, xj, b):
    return _imu_residual(
        params, _rvp_to_sgal(xi, _zero_t(xi)), _rvp_to_sgal(xj, params["dt"]), b
    )


def _pose3velpos_to_sgal(pose, velpos, t):
    # the reference maps (Pose3, vel) -> (R, v, p) (IMUDeltaFactor.jl:390-401)
    return G.make_point(pose[..., 3:7], velpos[..., :3], pose[..., :3], t)


def _imu_p3vp_res(params, pose_i, vp_i, pose_j, vp_j):
    return _imu_residual(
        params,
        _pose3velpos_to_sgal(pose_i, vp_i, _zero_t(pose_i)),
        _pose3velpos_to_sgal(pose_j, vp_j, params["dt"]),
        params["b0"],
    )


def _imu_initializer(params, pts):
    """Slot 1 by gravity-compensated forward propagation of slot 0: the q
    with boxminus(p, q) = delta. (The JAX package evaluates this in float32;
    here it runs in the dtype of its inputs.)"""
    xi = pts[0]
    d = params["delta"]
    g = params["gravity"]
    dt = d[..., 10:11]
    qi, vi, pi = xi[..., :4], xi[..., 4:7], xi[..., 7:10]
    qj = Q.qmul(qi, d[..., :4])
    vj = vi + Q.qrotate(qi, d[..., 4:7]) - g * dt
    pj = pi + vi * dt - 0.5 * g * (dt * dt) + Q.qrotate(qi, d[..., 7:10])
    return torch.cat([qj, vj, pj], dim=-1)


_IMU_COORDS = ("e",) * 6 + ("c",) * 3

IMU_DELTA_RVP = register_factor_type(
    FactorType(
        name="IMUDeltaRotVelPos",
        variable_types=(RotVelPos, RotVelPos),
        zdim=9,
        residual=_imu_rvp_res,
        initializers={1: _imu_initializer},
        coord_types=_IMU_COORDS,
        doc="Preintegrated IMU odometry between RotVelPos states "
        "(IMUDeltaFactor.jl:342-361).",
    )
)

IMU_DELTA_RVP_BIAS = register_factor_type(
    FactorType(
        name="IMUDeltaRotVelPosBias",
        variable_types=(RotVelPos, RotVelPos, IMUBias),
        zdim=9,
        residual=_imu_rvp_bias_res,
        initializers={1: _imu_initializer},
        coord_types=_IMU_COORDS,
        doc="Preintegrated IMU odometry with first-order bias correction "
        "through an IMUBias variable (IMUDeltaFactor.jl:342-361).",
    )
)

IMU_DELTA_P3VP = register_factor_type(
    FactorType(
        name="IMUDeltaPose3VelPos3",
        variable_types=(Pose3, VelPos3, Pose3, VelPos3),
        zdim=9,
        residual=_imu_p3vp_res,
        coord_types=_IMU_COORDS,
        doc="Preintegrated IMU odometry on the Pose3 + VelPos3 variable split "
        "(IMUDeltaFactor.jl:390-401).",
    )
)

_SIGNATURES = {
    "RotVelPos": IMU_DELTA_RVP,
    "RotVelPosBias": IMU_DELTA_RVP_BIAS,
    "Pose3VelPos3": IMU_DELTA_P3VP,
}


def IMUDeltaFactor(
    accels,
    gyros,
    deltatimes,
    Sigma_y,
    a_b=(0.0, 0.0, 0.0),
    w_b=(0.0, 0.0, 0.0),
    gravity=G.GRAVITY,
    signature: str = "RotVelPos",
) -> Factor:
    """The preintegrated IMU factor from a raw measurement stream
    (IMUDeltaFactor.jl:460-496): preintegrates, SPD-repairs the 9x9
    covariance, and packs the (delta, J_b, b0, dt, gravity) params.

    ``signature`` picks the variable split: "RotVelPos" (2 vars),
    "RotVelPosBias" (3 vars incl. IMUBias), "Pose3VelPos3" (4 vars).
    """
    ftype = _SIGNATURES[signature]
    delta, Sigma, J_b = preintegrate_imu(accels, gyros, deltatimes, Sigma_y, a_b, w_b)

    S = Sigma[:9, :9]
    S = 0.5 * (S + S.T)
    # SPD repair as the reference does (IMUDeltaFactor.jl:476-483)
    S = S + np.diag((np.diag(S) == 0.0) * 1e-15)
    w = np.linalg.eigvalsh(S)
    if w.min() <= 0:
        S = S + (1e-12 - min(w.min(), 0.0)) * np.eye(9)

    Xc = G.log(torch.as_tensor(delta)).numpy()
    sqrt_info = np.linalg.inv(np.linalg.cholesky(S))
    b0 = np.concatenate([np.asarray(a_b, np.float64), np.asarray(w_b, np.float64)])
    params = {
        "z": Xc[:9],
        "sqrt_info": sqrt_info,
        "delta": delta,
        "J_b": J_b,
        "b0": b0,
        "dt": np.float64(delta[10]),
        "gravity": np.asarray(gravity, np.float64),
    }
    return Factor(ftype=ftype, variables=(), params=params, dists=(MvNormal(Xc[:9], S),))


# ---------------------------------------------------------------------------
# Support factors
# ---------------------------------------------------------------------------

def _prior_rvp_res(params, x):
    return _RVP_M.local(x, _RVP_M.exp(params["z"]))


PRIOR_ROTVELPOS = register_factor_type(
    FactorType(
        name="PriorRotVelPos",
        variable_types=(RotVelPos,),
        zdim=9,
        residual=_prior_rvp_res,
        initializers={0: lambda params, pts: _RVP_M.exp(params["z"])},
        coord_types=("c",) * 3 + ("e",) * 6,
        doc="Full prior on a RotVelPos state (cf. ManifoldPrior use in "
        "test/inertial/testIMUDeltaFactor.jl:237-251).",
    )
)


def PriorRotVelPos(Z: Distribution = None):
    return make_gaussian_factor(
        PRIOR_ROTVELPOS, (), Z or MvNormal(np.zeros(9), np.eye(9) * 1e-3)
    )


def _prior_velpos_res(params, x):
    return _VP_M.local(x, _VP_M.exp(params["z"]))


PRIOR_VELPOS3 = register_factor_type(
    FactorType(
        name="PriorVelPos3",
        variable_types=(VelPos3,),
        zdim=6,
        residual=_prior_velpos_res,
        initializers={0: lambda params, pts: _VP_M.exp(params["z"])},
        coord_types=("e",) * 6,
        doc="Prior on a VelPos3 state (PriorVelPos3.jl:13-33).",
    )
)


def PriorVelPos3(Z: Distribution = None):
    return make_gaussian_factor(
        PRIOR_VELPOS3, (), Z or MvNormal(np.zeros(6), np.diag([1, 1, 0.1, 1, 1, 1.0]))
    )


def _prior_imubias_res(params, b):
    return params["z"] - b


PRIOR_IMUBIAS = register_factor_type(
    FactorType(
        name="PriorIMUBias",
        variable_types=(IMUBias,),
        zdim=6,
        residual=_prior_imubias_res,
        initializers={0: lambda params, pts: params["z"]},
        coord_types=("e",) * 6,
        doc="Prior on accelerometer+gyro bias (PriorIMUBias.jl:13-37: m .- p).",
    )
)


def PriorIMUBias(Z: Distribution = None):
    return make_gaussian_factor(
        PRIOR_IMUBIAS, (), Z or MvNormal(np.zeros(6), np.eye(6) * 0.5)
    )


def _velpos_rvp_res(params, p, q):
    # [z_v - (q.v - p.v); z_p - (q.p - p.p)] (VelPosRotVelPos.jl:20-30)
    dv = q[..., 4:7] - p[..., :3]
    dp = q[..., 7:10] - p[..., 3:6]
    return params["z"] - torch.cat([dv, dp], dim=-1)


VELPOS_ROTVELPOS = register_factor_type(
    FactorType(
        name="VelPosRotVelPos",
        variable_types=(VelPos3, RotVelPos),
        zdim=6,
        residual=_velpos_rvp_res,
        coord_types=("e",) * 6,
        doc="Linear offset link VelPos3 <-> RotVelPos (VelPosRotVelPos.jl:6-26).",
    )
)


def VelPosRotVelPos(Z: Distribution = None):
    return make_gaussian_factor(
        VELPOS_ROTVELPOS, (), Z or MvNormal(np.zeros(6), np.eye(6) * 0.1)
    )


def _velalign_res(params, vp, rvp, rot):
    # p_V = |vp.vel| * z ; q_V = R(rvp)^T rvp.vel ; res = p_V - R(rot) q_V
    # (VelAlign.jl:30-42)
    speed = torch.linalg.norm(vp[..., :3], dim=-1, keepdim=True)
    p_V = speed * params["z"]
    q_V = Q.qrotate(Q.qconj(rvp[..., :4]), rvp[..., 4:7])
    return p_V - Q.qrotate(rot, q_V)


VELALIGN = register_factor_type(
    FactorType(
        name="VelAlign",
        variable_types=(VelPos3, RotVelPos, Rotation3),
        zdim=3,
        residual=_velalign_res,
        coord_types=("e",) * 3,
        doc="Velocity-direction alignment across VelPos3/RotVelPos/Rotation3 "
        "(VelAlign.jl:6-42).",
    )
)


def VelAlign(Z: Distribution = None):
    return make_gaussian_factor(
        VELALIGN, (), Z or MvNormal([1.0, 0, 0], np.eye(3) * 0.1)
    )
