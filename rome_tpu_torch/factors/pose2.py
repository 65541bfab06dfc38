"""SE(2) pose factors (counterpart of ``rome_tpu/factors/pose2.py``):
PriorPose2, Pose2Pose2 and MutablePose2Pose2Gaussian.

Points are (x, y, theta); tangents are hybrid (vx, vy, w) — see
rome_tpu_torch.manifolds.base.SE2.
"""

from __future__ import annotations

import numpy as np

from rome_tpu_torch.distributions import Distribution, MvNormal
from rome_tpu_torch.factors.base import (
    FactorType,
    make_gaussian_factor,
    register_factor_type,
)
from rome_tpu_torch.manifolds.base import SE2_
from rome_tpu_torch.variables import Pose2


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
