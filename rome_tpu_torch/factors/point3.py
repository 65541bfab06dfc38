"""3-D point factors (counterpart of ``rome_tpu/factors/point3.py``):
PriorPoint3 and Point3Point3."""

from __future__ import annotations

from rome_tpu_torch.distributions import Distribution
from rome_tpu_torch.factors.base import FactorType, make_gaussian_factor, register_factor_type
from rome_tpu_torch.variables import Point3


def _prior_point3_res(params, x):
    return params["z"] - x[..., :3]


PRIOR_POINT3 = register_factor_type(
    FactorType(
        name="PriorPoint3",
        variable_types=(Point3,),
        zdim=3,
        residual=_prior_point3_res,
        initializers={0: lambda params, pts: params["z"]},
        coord_types=("e", "e", "e"),
        doc="Euclidean 3D prior (Point3D.jl:8-23).",
    )
)


def PriorPoint3(Z: Distribution):
    return make_gaussian_factor(PRIOR_POINT3, (), Z)


def _point3point3_res(params, xi, xj):
    return params["z"] - (xj[..., :3] - xi[..., :3])


POINT3POINT3 = register_factor_type(
    FactorType(
        name="Point3Point3",
        variable_types=(Point3, Point3),
        zdim=3,
        residual=_point3point3_res,
        initializers={
            1: lambda params, pts: pts[0] + params["z"],
            0: lambda params, pts: pts[1] - params["z"],
        },
        coord_types=("e", "e", "e"),
        doc="Linear 3D offset between two Point3 (Point3Point3.jl:6-17).",
    )
)


def Point3Point3(Z: Distribution):
    return make_gaussian_factor(POINT3POINT3, (), Z)
