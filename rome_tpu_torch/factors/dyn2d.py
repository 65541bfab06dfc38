"""Velocity-augmented 2D factors — constant-velocity kinematics
(counterpart of ``rome_tpu/factors/dyn2d.py``).

dt comes from the bound variables' nanosecond timestamps through the
``needs_dt`` FactorType flag (``FactorGraph.add_factor`` fills
``params["dt"]``). Variable layouts: DynPoint2 = (x, y, vx, vy) on T(4);
DynPose2 = (x, y, theta, vx, vy) on SE(2) x T(2).

Residuals and initializers act on trailing dims: ``dt`` is 0-dim per factor
under ``vmap`` and (M,) per particle in the nonparametric convolution, so it
always enters as ``dt[..., None]``.
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, MvNormal
from rome_tpu_torch.factors.base import (
    Factor,
    FactorType,
    gaussian_params,
    make_gaussian_factor,
    register_factor_type,
)
from rome_tpu_torch.manifolds.base import SE2_
from rome_tpu_torch.variables import DynPoint2, DynPose2, Pose2

_DP2_M = DynPose2.manifold

_SQRT_EPS = 1e-12


def _safe_sqrt(x):
    # the reference takes a bare sqrt (VelPoint2D.jl:30); the epsilon keeps
    # its derivative finite at 0
    return torch.sqrt(x + _SQRT_EPS)


def _dt(params):
    return params["dt"][..., None]


# --- DynPoint2VelocityPrior (DynPoint2D.jl:7-11) ---------------------------

def _dp2_vel_prior_res(params, x):
    return params["z"] - x


DYNPOINT2_VELOCITY_PRIOR = register_factor_type(
    FactorType(
        name="DynPoint2VelocityPrior",
        variable_types=(DynPoint2,),
        zdim=4,
        residual=_dp2_vel_prior_res,
        initializers={0: lambda params, pts: params["z"]},
        coord_types=("e",) * 4,
        doc="T(4) prior on (x, y, vx, vy) (DynPoint2D.jl:7-11).",
    )
)


def DynPoint2VelocityPrior(Z: Distribution = None):
    return make_gaussian_factor(
        DYNPOINT2_VELOCITY_PRIOR, (), Z or MvNormal(np.zeros(4), np.eye(4) * 0.1)
    )


# --- DynPoint2DynPoint2 (DynPoint2D.jl:16-29) ------------------------------

def _dp2dp2_res(params, xi, xj):
    dt = _dt(params)
    z = params["z"]
    r12 = z[..., :2] - (xj[..., :2] - (xi[..., :2] + dt * xi[..., 2:4]))
    r34 = z[..., 2:4] - (xj[..., 2:4] - xi[..., 2:4])
    return torch.cat([r12, r34], dim=-1)


def _dp2dp2_init1(params, pts):
    xi = pts[0]
    z = params["z"]
    p = xi[..., :2] + _dt(params) * xi[..., 2:4] + z[..., :2]
    v = xi[..., 2:4] + z[..., 2:4]
    return torch.cat([p, v], dim=-1)


DYNPOINT2_DYNPOINT2 = register_factor_type(
    FactorType(
        name="DynPoint2DynPoint2",
        variable_types=(DynPoint2, DynPoint2),
        zdim=4,
        residual=_dp2dp2_res,
        initializers={1: _dp2dp2_init1},
        coord_types=("e",) * 4,
        needs_dt=True,
        doc="Position delta via constant velocity + velocity delta "
        "(DynPoint2D.jl:16-29).",
    )
)


def DynPoint2DynPoint2(Z: Distribution = None):
    return make_gaussian_factor(
        DYNPOINT2_DYNPOINT2, (), Z or MvNormal(np.zeros(4), np.eye(4) * 0.1)
    )


# --- Point2Point2Velocity (DynPoint2D.jl:35-53) ----------------------------

def _p2p2vel_res(params, xi, xj):
    dp = xj[..., :2] - xi[..., :2]
    r12 = params["z"][..., :2] - dp
    # midpoint integration constraint
    r34 = dp / _dt(params) - 0.5 * (xj[..., 2:4] + xi[..., 2:4])
    return torch.cat([r12, r34], dim=-1)


POINT2POINT2_VELOCITY = register_factor_type(
    FactorType(
        name="Point2Point2Velocity",
        variable_types=(DynPoint2, DynPoint2),
        zdim=4,
        residual=_p2p2vel_res,
        coord_types=("e",) * 4,
        needs_dt=True,
        doc="Midpoint-integration velocity constraint (DynPoint2D.jl:35-53).",
    )
)


def Point2Point2Velocity(Z: Distribution = None):
    return make_gaussian_factor(
        POINT2POINT2_VELOCITY, (), Z or MvNormal(np.zeros(4), np.eye(4) * 0.1)
    )


# --- VelPoint2VelPoint2 (VelPoint2D.jl:9-56) -------------------------------

def _vp2vp2_res(params, xi, xj):
    z = params["z"]
    dp = xj[..., :2] - xi[..., :2]
    dv = xj[..., 2:4] - xi[..., 2:4]
    r12 = z[..., :2] - dp
    # sqrt-of-squares cross-coupled velocity residual (VelPoint2D.jl:25-30)
    r34 = _safe_sqrt((z[..., 2:4] - dv) ** 2 + (dp / _dt(params) - xi[..., 2:4]) ** 2)
    return torch.cat([r12, r34], dim=-1)


VELPOINT2_VELPOINT2 = register_factor_type(
    FactorType(
        name="VelPoint2VelPoint2",
        variable_types=(DynPoint2, DynPoint2),
        zdim=4,
        residual=_vp2vp2_res,
        initializers={1: _dp2dp2_init1},
        coord_types=("e",) * 4,
        needs_dt=True,
        doc="Cross-coupled position/velocity odometry with sqrt-of-squares "
        "residual (VelPoint2D.jl:9-56).",
    )
)


def VelPoint2VelPoint2(Z: Distribution = None):
    return make_gaussian_factor(
        VELPOINT2_VELPOINT2, (), Z or MvNormal(np.zeros(4), np.eye(4) * 0.1)
    )


# --- DynPose2VelocityPrior (DynPose2D.jl:7-55) -----------------------------

def _dpose2_vel_prior_res(params, x):
    z = params["z"]
    # pose part: se2vee(SE2(meas) \ SE2(X)) (DynPose2D.jl:47-55)
    pose_res = SE2_.local(SE2_.exp(z[..., :3]), x[..., :3])
    vel_res = z[..., 3:5] - x[..., 3:5]
    return torch.cat([pose_res, vel_res], dim=-1)


DYNPOSE2_VELOCITY_PRIOR = register_factor_type(
    FactorType(
        name="DynPose2VelocityPrior",
        variable_types=(DynPose2,),
        zdim=5,
        residual=_dpose2_vel_prior_res,
        initializers={0: lambda params, pts: _DP2_M.exp(params["z"])},
        coord_types=("e", "e", "c", "e", "e"),
        doc="SE(2) x T(2) prior on (x, y, theta, vx, vy) (DynPose2D.jl:7-55).",
    )
)


def _block_gaussian(Zpose, Zvel, ftype, extra=None):
    """Block-diagonal (pose, vel) measurement stack, as the reference's
    getMeasurementParametric (DynPose2D.jl:30-43)."""
    mp = np.asarray(Zpose.mean(), dtype=np.float64).reshape(-1)
    mv = np.asarray(Zvel.mean(), dtype=np.float64).reshape(-1)
    cp = np.asarray(Zpose.cov(), dtype=np.float64)
    cv = np.asarray(Zvel.cov(), dtype=np.float64)
    n = len(mp) + len(mv)
    cov = np.zeros((n, n))
    cov[: len(mp), : len(mp)] = cp
    cov[len(mp):, len(mp):] = cv
    params = gaussian_params(np.concatenate([mp, mv]), cov)
    if extra:
        params.update(extra)
    return Factor(ftype=ftype, variables=(), params=params, dists=(Zpose, Zvel))


def DynPose2VelocityPrior(Zpose: Distribution = None, Zvel: Distribution = None):
    return _block_gaussian(
        Zpose or MvNormal(np.zeros(3), np.eye(3) * 0.01),
        Zvel or MvNormal(np.zeros(2), np.eye(2) * 0.1),
        DYNPOSE2_VELOCITY_PRIOR,
    )


# --- DynPose2Pose2 (DynPose2D.jl:60-87): partial (1,2,3) -------------------

def _dpose2pose2_res(params, xi, xj):
    qhat = SE2_.compose(xi[..., :3], SE2_.exp(params["z"]))
    return SE2_.local(xj, qhat)


DYNPOSE2_POSE2 = register_factor_type(
    FactorType(
        name="DynPose2Pose2",
        variable_types=(DynPose2, Pose2),
        zdim=3,
        residual=_dpose2pose2_res,
        initializers={
            1: lambda params, pts: SE2_.compose(pts[0][..., :3], SE2_.exp(params["z"]))
        },
        coord_types=("e", "e", "c"),
        partial=(0, 1, 2),
        doc="Pose-only link DynPose2 -> Pose2, partial (1,2,3) "
        "(DynPose2D.jl:60-87).",
    )
)


def DynPose2Pose2(Z: Distribution = None):
    return make_gaussian_factor(
        DYNPOSE2_POSE2, (), Z or MvNormal(np.zeros(3), np.eye(3) * 0.01)
    )


# --- DynPose2DynPose2 (DynPose2D.jl:144-172): legacy SE2-coordinate form ---

def _dpose2dpose2_res(params, xi, xj):
    z = params["z"]
    wpj = xi[..., :2] + _dt(params) * xi[..., 3:5] + z[..., :2]
    zero2 = torch.zeros_like(xi[..., :2])
    thetaj = SE2_.compose(
        torch.cat([zero2, xi[..., 2:3]], dim=-1),
        torch.cat([zero2, z[..., 2:3]], dim=-1),
    )[..., 2:3]
    target = torch.cat([wpj, thetaj], dim=-1)
    r13 = SE2_.local(xj[..., :3], target)
    r45 = z[..., 3:5] - (xj[..., 3:5] - xi[..., 3:5])
    return torch.cat([r13, r45], dim=-1)


def _dpose2dpose2_init1(params, pts):
    xi = pts[0]
    z = params["z"]
    wpj = xi[..., :2] + _dt(params) * xi[..., 3:5] + z[..., :2]
    th = xi[..., 2:3] + z[..., 2:3]
    th = torch.atan2(torch.sin(th), torch.cos(th))
    return torch.cat([wpj, th, xi[..., 3:5] + z[..., 3:5]], dim=-1)


DYNPOSE2_DYNPOSE2 = register_factor_type(
    FactorType(
        name="DynPose2DynPose2",
        variable_types=(DynPose2, DynPose2),
        zdim=5,
        residual=_dpose2dpose2_res,
        initializers={1: _dpose2dpose2_init1},
        coord_types=("e", "e", "c", "e", "e"),
        needs_dt=True,
        doc="Legacy SE2-coordinate dynamic pose odometry "
        "(DynPose2D.jl:144-172).",
    )
)


def DynPose2DynPose2(Z: Distribution = None):
    return make_gaussian_factor(
        DYNPOSE2_DYNPOSE2,
        (),
        Z or MvNormal(np.zeros(5), np.diag([0.01, 0.01, 0.001, 0.1, 0.1]) ** 2),
    )


# --- VelPose2VelPose2 (VelPose2D.jl:6-73) ----------------------------------

def _body_rot(c, s, v):
    """R(theta)^T v for width-1 cos/sin slices and (..., 2) v."""
    return torch.cat([c * v[..., 0:1] + s * v[..., 1:2], -s * v[..., 0:1] + c * v[..., 1:2]],
                     dim=-1)


def _vpose2vpose2_res(params, p, q):
    z = params["z"]
    p1, q1 = p[..., :3], q[..., :3]
    p2, q2 = p[..., 3:5], q[..., 3:5]
    # pose part == Pose2Pose2 (VelPose2D.jl:49-53)
    qhat = SE2_.compose(p1, SE2_.exp(z[..., :3]))
    pose_res = SE2_.local(q1, qhat)
    # velocity part (VelPose2D.jl:56-70): world delta-v into body frame of p
    c, s = torch.cos(p1[..., 2:3]), torch.sin(p1[..., 2:3])
    bdx = _body_rot(c, s, q2 - p2)
    dx = SE2_.local(p1, q1)[..., :2]
    vel_res = _safe_sqrt(
        (z[..., 3:5] - bdx) ** 2 + (dx / _dt(params) - 0.5 * (p2 + q2)) ** 2
    )
    return torch.cat([pose_res, vel_res], dim=-1)


def _vpose2vpose2_init1(params, pts):
    p = pts[0]
    z = params["z"]
    pose = SE2_.compose(p[..., :3], SE2_.exp(z[..., :3]))
    c, s = torch.cos(p[..., 2:3]), torch.sin(p[..., 2:3])
    z3, z4 = z[..., 3:4], z[..., 4:5]
    vel = p[..., 3:5] + torch.cat([c * z3 - s * z4, s * z3 + c * z4], dim=-1)
    return torch.cat([pose, vel], dim=-1)


VELPOSE2_VELPOSE2 = register_factor_type(
    FactorType(
        name="VelPose2VelPose2",
        variable_types=(DynPose2, DynPose2),
        zdim=5,
        residual=_vpose2vpose2_res,
        initializers={1: _vpose2vpose2_init1},
        coord_types=("e", "e", "c", "e", "e"),
        needs_dt=True,
        doc="Composite Zpose+Zvel dynamic odometry with manifold-split "
        "residual (VelPose2D.jl:6-73).",
    )
)


def VelPose2VelPose2(Zpose: Distribution = None, Zvel: Distribution = None):
    return _block_gaussian(
        Zpose or MvNormal(np.zeros(3), np.eye(3) * 0.01),
        Zvel or MvNormal(np.zeros(2), np.eye(2) * 0.1),
        VELPOSE2_VELPOSE2,
    )
