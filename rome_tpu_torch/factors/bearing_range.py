"""Bearing / range factors from Pose2 to Point2 (counterpart of
``rome_tpu/factors/bearing_range.py``): Pose2Point2Bearing,
Pose2Point2Range and Pose2Point2BearingRange.

Residuals index the trailing dim only, so they run batched over leading dims
and per sample under ``torch.func.vmap``.
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, MvNormal, Normal
from rome_tpu_torch.factors.base import (
    Factor,
    FactorType,
    gaussian_params,
    make_gaussian_factor,
    register_factor_type,
)
from rome_tpu_torch.utils.math import matvec, rot2, safe_norm, sym_rem
from rome_tpu_torch.variables import Point2, Pose2


def _body_frame_point(p, l):
    """pl = R(theta)^T (l - t): landmark expressed in the pose body frame."""
    return matvec(rot2(-p[..., 2]), l[..., :2] - p[..., :2])


# --- Pose2Point2Bearing (Bearing2D.jl:23-32) -------------------------------

def _bearing_res(params, p, l):
    pl = _body_frame_point(p, l)
    return sym_rem(params["z"] - torch.atan2(pl[..., 1], pl[..., 0])[..., None])


POSE2POINT2BEARING = register_factor_type(
    FactorType(
        name="Pose2Point2Bearing",
        variable_types=(Pose2, Point2),
        zdim=1,
        residual=_bearing_res,
        coord_types=("c",),
        doc="Bearing-only sighting, 1-dof on SO(2) (Bearing2D.jl:23-32).",
    )
)


def Pose2Point2Bearing(Z: Distribution):
    return make_gaussian_factor(POSE2POINT2BEARING, (), Z)


# --- Pose2Point2Range (Range2D.jl:42-54) -----------------------------------

def _pose_range_res(params, p, l):
    return params["z"] - safe_norm(l[..., :2] - p[..., :2])[..., None]


POSE2POINT2RANGE = register_factor_type(
    FactorType(
        name="Pose2Point2Range",
        variable_types=(Pose2, Point2),
        zdim=1,
        residual=_pose_range_res,
        coord_types=("e",),
        doc="Range-only sighting from Pose2 to Point2 (Range2D.jl:42-54).",
    )
)


def Pose2Point2Range(Z: Distribution):
    return make_gaussian_factor(POSE2POINT2RANGE, (), Z)


# --- Pose2Point2BearingRange (BearingRange2D.jl:48-64) ---------------------
# residual = [sym_rem(z_theta - atan2(pl)), z_r - ||pl||], bearing FIRST.

def _bearing_range_res(params, p, l):
    pl = _body_frame_point(p, l)
    z = params["z"]
    dth = sym_rem(z[..., 0] - torch.atan2(pl[..., 1], pl[..., 0]))
    dr = z[..., 1] - safe_norm(pl)
    return torch.stack([dth, dr], dim=-1)


def _bearing_range_init_landmark(params, pts):
    p, z = pts[0], params["z"]
    th = p[..., 2] + z[..., 0]
    return p[..., :2] + z[..., 1:2] * torch.stack([torch.cos(th), torch.sin(th)], dim=-1)


POSE2POINT2BEARINGRANGE = register_factor_type(
    FactorType(
        name="Pose2Point2BearingRange",
        variable_types=(Pose2, Point2),
        zdim=2,
        residual=_bearing_range_res,
        initializers={1: _bearing_range_init_landmark},
        coord_types=("c", "e"),
        doc="Polar body-frame sighting, coords (bearing, range) "
        "(BearingRange2D.jl:10-64).",
    )
)


def Pose2Point2BearingRange(
    bearing: Distribution, range_: Distribution = None, cov=None, **kw
):
    """Two independent scalar beliefs, bearing first. ``cov``: optional full
    2x2 (bearing, range) covariance; when given, the measurement becomes one
    joint MvNormal."""
    if range_ is None:
        range_ = Normal(1.0, 1.0)
    mean = np.array([bearing.mean()[0], range_.mean()[0]])
    if cov is None:
        cov = np.diag([bearing.cov()[0, 0], range_.cov()[0, 0]])
        dists = (bearing, range_)
    else:
        cov = np.asarray(cov, dtype=np.float64)
        dists = (MvNormal(mean, cov),)
    return Factor(
        ftype=POSE2POINT2BEARINGRANGE,
        variables=(),
        params=gaussian_params(mean, cov),
        dists=dists,
        **kw,
    )
