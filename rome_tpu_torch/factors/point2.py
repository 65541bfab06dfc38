"""2-D point factors (counterpart of ``rome_tpu/factors/point2.py``):
PriorPoint2, Point2Point2 and Point2Point2Range.

Residuals index the trailing dim only, so they run batched over leading dims
and per sample under ``torch.func.vmap``.
"""

from __future__ import annotations

from rome_tpu_torch.distributions import Distribution, Normal
from rome_tpu_torch.factors.base import (
    FactorType,
    make_gaussian_factor,
    register_factor_type,
)
from rome_tpu_torch.utils.math import safe_norm
from rome_tpu_torch.variables import Point2


# --- PriorPoint2 (Point2D.jl:7-18): meas - x ------------------------------

def _prior_point2_res(params, x):
    return params["z"] - x[..., :2]


PRIOR_POINT2 = register_factor_type(
    FactorType(
        name="PriorPoint2",
        variable_types=(Point2,),
        zdim=2,
        residual=_prior_point2_res,
        initializers={0: lambda params, pts: params["z"]},
        coord_types=("e", "e"),
        doc="Direct observation prior on a Point2 (Point2D.jl:7-18).",
    )
)


def PriorPoint2(Z: Distribution):
    return make_gaussian_factor(PRIOR_POINT2, (), Z)


# --- Point2Point2 (Point2D.jl:23-35): meas - (xj - xi) ---------------------

def _point2point2_res(params, xi, xj):
    return params["z"] - (xj[..., :2] - xi[..., :2])


POINT2POINT2 = register_factor_type(
    FactorType(
        name="Point2Point2",
        variable_types=(Point2, Point2),
        zdim=2,
        residual=_point2point2_res,
        initializers={
            1: lambda params, pts: pts[0] + params["z"],
            0: lambda params, pts: pts[1] - params["z"],
        },
        coord_types=("e", "e"),
        doc="Linear offset between two Point2 (Point2D.jl:23-35).",
    )
)


def Point2Point2(Z: Distribution):
    return make_gaussian_factor(POINT2POINT2, (), Z)


# --- Point2Point2Range (Range2D.jl:7-20): rho - ||lm - xi|| ----------------

def _point2point2range_res(params, xi, lm):
    return params["z"] - safe_norm(lm[..., :2] - xi[..., :2])[..., None]


POINT2POINT2RANGE = register_factor_type(
    FactorType(
        name="Point2Point2Range",
        variable_types=(Point2, Point2),
        zdim=1,
        residual=_point2point2range_res,
        coord_types=("e",),
        doc="Range-only constraint between two Point2 (Range2D.jl:7-20).",
    )
)


def Point2Point2Range(Z: Distribution):
    if isinstance(Z, (int, float)):
        Z = Normal(float(Z), 1.0)
    return make_gaussian_factor(POINT2POINT2RANGE, (), Z)
