"""SE(2) pose factors (counterpart of ``rome_tpu/factors/pose2.py``):
PriorPose2, Pose2Pose2, PartialPriorYawPose2, MutablePose2Pose2Gaussian and
Pose2Point2.

Points are (x, y, theta); tangents are hybrid (vx, vy, w) — see
rome_tpu_torch.manifolds.base.SE2.
"""

from __future__ import annotations

import numpy as np

from rome_tpu_torch.distributions import Distribution, MvNormal
from rome_tpu_torch.factors.base import (
    FactorType,
    gaussian_params,
    make_gaussian_factor,
    register_factor_type,
)
from rome_tpu_torch.manifolds.base import SE2_
from rome_tpu_torch.utils.math import matvec, rot2, sym_rem
from rome_tpu_torch.variables import Point2, Pose2


# --- PriorPose2 (PriorPose2.jl:37-47): vee(log(M, p, m)) -------------------

def _prior_pose2_res(params, p):
    m = SE2_.exp(params["z"])  # measurement coords -> SE(2) point
    return SE2_.local(p, m)


PRIOR_POSE2 = register_factor_type(
    FactorType(
        name="PriorPose2",
        variable_types=(Pose2,),
        zdim=3,
        residual=_prior_pose2_res,
        initializers={0: lambda params, pts: SE2_.exp(params["z"])},
        coord_types=("e", "e", "c"),
        doc="Full SE(2) unary prior (PriorPose2.jl:37-47).",
    )
)


def PriorPose2(Z: Distribution):
    return make_gaussian_factor(PRIOR_POSE2, (), Z)


# --- Pose2Pose2 (Pose2D.jl:48-67): vee(log(M, q, p ∘ exp(X))) --------------

def _pose2pose2_res(params, p, q):
    qhat = SE2_.compose(p, SE2_.exp(params["z"]))
    return SE2_.local(q, qhat)


_POSE2POSE2_INIT = {
    1: lambda params, pts: SE2_.compose(pts[0], SE2_.exp(params["z"])),
    0: lambda params, pts: SE2_.compose(
        pts[1], SE2_.inverse(SE2_.exp(params["z"]))
    ),
}

POSE2POSE2 = register_factor_type(
    FactorType(
        name="Pose2Pose2",
        variable_types=(Pose2, Pose2),
        zdim=3,
        residual=_pose2pose2_res,
        initializers=_POSE2POSE2_INIT,
        coord_types=("e", "e", "c"),
        doc="Canonical SE(2) odometry factor (Pose2D.jl:30-67).",
    )
)


def Pose2Pose2(Z: Distribution = None):
    if Z is None:
        Z = MvNormal(np.zeros(3), np.eye(3))
    return make_gaussian_factor(POSE2POSE2, (), Z)


# --- PartialPriorYawPose2 (PartialPriorPose2.jl:7-27) ----------------------

def _partial_yaw_res(params, p):
    return sym_rem(params["z"] - p[..., 2:3])


PARTIAL_PRIOR_YAW_POSE2 = register_factor_type(
    FactorType(
        name="PartialPriorYawPose2",
        variable_types=(Pose2,),
        zdim=1,
        residual=_partial_yaw_res,
        coord_types=("c",),
        partial=(2,),  # constrains theta only (reference partial=(3,), 1-based)
        doc="Partial prior on Pose2 yaw (PartialPriorPose2.jl:7-27).",
    )
)


def PartialPriorYawPose2(Z: Distribution):
    return make_gaussian_factor(PARTIAL_PRIOR_YAW_POSE2, (), Z)


# --- MutablePose2Pose2Gaussian (MutablePose2Pose2.jl:11-36) ----------------
# Same residual as Pose2Pose2; its params may be reset in place.

MUTABLE_POSE2POSE2 = register_factor_type(
    FactorType(
        name="MutablePose2Pose2Gaussian",
        variable_types=(Pose2, Pose2),
        zdim=3,
        residual=_pose2pose2_res,
        initializers=_POSE2POSE2_INIT,
        coord_types=("e", "e", "c"),
        doc="Mutable-Z odometry factor (MutablePose2Pose2.jl:11-36).",
    )
)


def MutablePose2Pose2Gaussian(Z: Distribution = None):
    if Z is None:
        Z = MvNormal(np.zeros(3), np.diag([1e-6, 1e-6, 1e-6]))
    return make_gaussian_factor(MUTABLE_POSE2POSE2, (), Z)


def update_mutable_odo(factor, mean, cov):
    """Reset the measurement of a MutablePose2Pose2Gaussian in place
    (cf. resetFactor!, OdometryUtils.jl:93)."""
    factor.params.update(gaussian_params(mean, cov))
    factor.dists = (MvNormal(mean, np.asarray(cov)),)
    return factor


# --- Pose2Point2 (Pose2Point2.jl:22-40): l - (wTp ∘ pTq)[1:2] --------------

def _sighted(p, z):
    return p[..., :2] + matvec(rot2(p[..., 2]), z[..., :2])


def _pose2point2_res(params, p, l):
    return l[..., :2] - _sighted(p, params["z"])


POSE2POINT2 = register_factor_type(
    FactorType(
        name="Pose2Point2",
        variable_types=(Pose2, Point2),
        zdim=2,
        residual=_pose2point2_res,
        initializers={1: lambda params, pts: _sighted(pts[0], params["z"])},
        coord_types=("e", "e"),
        partial=(0, 1),
        doc="Body-frame offset sighting of a Point2 from a Pose2 "
        "(Pose2Point2.jl:22-40).",
    )
)


def Pose2Point2(Z: Distribution):
    return make_gaussian_factor(POSE2POINT2, (), Z)
