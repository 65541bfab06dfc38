"""Sensor-model factors: DIDSON sonar range/bearing/elevation, multi-feature
angle constraints, and the range/azimuth/elevation conversion helpers
(counterpart of ``rome_tpu/factors/sensors.py``; reference
SensorModels.jl:22-95, MultipleFeaturesConstraint.jl:35-136,
RangeAzimuthElevation.jl:4-29).
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Normal, Uniform
from rome_tpu_torch.factors.base import Factor, FactorType, gaussian_params, register_factor_type
from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.manifolds.base import SE2_
from rome_tpu_torch.utils.math import sym_rem
from rome_tpu_torch.variables import Point2, Point3, Pose2, Pose3


def _scalar(x) -> float:
    return float(np.asarray(x).reshape(()))


# --- LinearRangeBearingElevation (SensorModels.jl:22-95) -------------------

def _lrbe_res(params, pose, landm):
    # body-frame landmark: bTl = R(q)^T (L - t)  (SensorModels.jl:57-64)
    t, q = pose[..., :3], pose[..., 3:7]
    b = Q.qrotate(Q.qconj(q), landm - t)
    rng = torch.linalg.norm(b, dim=-1, keepdim=True)
    bearing = torch.atan2(b[..., 1:2], b[..., 0:1])
    elev = -torch.atan2(b[..., 2:3], b[..., 0:1])
    return params["z"] - torch.cat([rng, bearing, elev], dim=-1)


LINEAR_RANGE_BEARING_ELEVATION = register_factor_type(
    FactorType(
        name="LinearRangeBearingElevation",
        variable_types=(Pose3, Point3),
        zdim=3,
        residual=_lrbe_res,
        coord_types=("e", "c", "c"),
        doc="DIDSON sonar range/bearing/elevation factor "
        "(SensorModels.jl:22-95: residualLRBE!).",
    )
)


def LinearRangeBearingElevation(range_, bearing, elev=None) -> Factor:
    """Range/bearing as (mu, sigma) tuples or Normal beliefs; elevation
    defaults to Uniform(-0.25133, 0.25133) (SensorModels.jl:28)."""
    rng = Normal(*range_) if isinstance(range_, tuple) else range_
    brg = Normal(*bearing) if isinstance(bearing, tuple) else bearing
    elev = elev or Uniform(-0.25133, 0.25133)
    beliefs = (rng, brg, elev)
    mean = np.array([_scalar(b.mean()) for b in beliefs])
    cov = np.diag([_scalar(b.cov()) for b in beliefs])
    return Factor(
        ftype=LINEAR_RANGE_BEARING_ELEVATION,
        variables=(),
        params=gaussian_params(mean, cov),
        dists=beliefs,
    )


# --- MultipleFeatures2D (MultipleFeaturesConstraint.jl:35-136) -------------

def _cam_angle(pose2, bTc, lm):
    """Bearing angle of landmark lm from the camera frame wTb * bTc."""
    cam = SE2_.compose(pose2, bTc)
    rel = SE2_.compose(SE2_.inverse(cam), torch.cat([lm, torch.zeros_like(lm[..., :1])], dim=-1))
    return torch.atan2(rel[..., 1:2], rel[..., 0:1])


def _mf2d_res(params, pi, pj, l1, l2, l3):
    bTc = params["bTc"]
    # six angles: (xi -> l1, l2, l3, xj -> l1, l2, l3)
    ais = torch.cat(
        [_cam_angle(pi, bTc, l) for l in (l1, l2, l3)]
        + [_cam_angle(pj, bTc, l) for l in (l1, l2, l3)],
        dim=-1,
    )
    return sym_rem(params["z"] - ais)


MULTIPLE_FEATURES_2D = register_factor_type(
    FactorType(
        name="MultipleFeatures2D",
        variable_types=(Pose2, Pose2, Point2, Point2, Point2),
        zdim=6,
        residual=_mf2d_res,
        coord_types=("c",) * 6,
        doc="Two poses sight three landmarks through a body-to-camera lever "
        "arm; residual = six bearing-angle errors "
        "(MultipleFeaturesConstraint.jl:35-136; the reference's built-in "
        "Categorical bimodality is superseded by add_factor's multihypo=).",
    )
)


def MultipleFeatures2D(xir1, xir2, xir3, xjr1, xjr2, xjr3, bTc=None) -> Factor:
    """Angles as Normal beliefs or (mu, sigma) tuples; bTc is the SE(2)
    body-to-camera transform coords (default identity)."""
    beliefs = tuple(Normal(*x) if isinstance(x, tuple) else x
                    for x in (xir1, xir2, xir3, xjr1, xjr2, xjr3))
    mean = np.array([_scalar(b.mean()) for b in beliefs])
    cov = np.diag([_scalar(b.cov()) for b in beliefs])
    params = gaussian_params(mean, cov)
    params["bTc"] = np.zeros(3) if bTc is None else np.asarray(bTc, np.float64)
    return Factor(ftype=MULTIPLE_FEATURES_2D, variables=(), params=params, dists=beliefs)


# --- RangeAzimuthElevation (RangeAzimuthElevation.jl:4-29) -----------------

class RangeAzimuthElevation:
    """Conversion record; elevation may be None for 2-dof sightings."""

    def __init__(self, range_, azimuth, elevation=None):
        self.range = float(range_)
        self.azimuth = float(azimuth)
        self.elevation = None if elevation is None else float(elevation)

    def __repr__(self):
        return f"RangeAzimuthElevation({self.range}, {self.azimuth}, {self.elevation})"

    @classmethod
    def from_tuple(cls, val):
        """convert((:rangeazimuth|:rangeazimuthelevation, values))
        (RangeAzimuthElevation.jl:10-18)."""
        kind, vals = val
        kind = str(kind).lstrip(":")
        if kind == "rangeazimuth":
            return cls(vals[0], vals[1])
        if kind == "rangeazimuthelevation":
            return cls(vals[0], vals[1], vals[2])
        raise ValueError(f"Unknown conversion from {kind} to RangeAzimuthElevation")


def range_azimuth_elevation(pose3_point, translation) -> RangeAzimuthElevation:
    """``\\(s::SE3, wTr::Translation)`` (RangeAzimuthElevation.jl:22-29):
    body-frame range/azimuth/elevation of a world point seen from a Pose3."""
    p = torch.as_tensor(np.asarray(pose3_point, dtype=np.float64))
    w = torch.as_tensor(np.asarray(translation, dtype=np.float64))
    b = Q.qrotate(Q.qconj(p[3:7]), w - p[:3]).numpy()
    return RangeAzimuthElevation(
        float(np.linalg.norm(b)), float(np.arctan2(b[1], b[0])), float(np.arctan2(b[2], b[0]))
    )
