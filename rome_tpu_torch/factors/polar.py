"""Polar-coordinate factors (counterpart of ``rome_tpu/factors/polar.py``):
PriorPolar and PolarPolar. Polar variable coords are (range, angle); the
angle dim is circular."""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Normal
from rome_tpu_torch.factors.base import Factor, FactorType, gaussian_params, register_factor_type
from rome_tpu_torch.utils.math import sym_rem
from rome_tpu_torch.variables import Polar


def _wrapped(d):
    return torch.cat([d[..., 0:1], sym_rem(d[..., 1:2])], dim=-1)


def _prior_polar_res(params, x):
    return _wrapped(params["z"] - x)


PRIOR_POLAR = register_factor_type(
    FactorType(
        name="PriorPolar",
        variable_types=(Polar,),
        zdim=2,
        residual=_prior_polar_res,
        initializers={0: lambda params, pts: params["z"]},
        coord_types=("e", "c"),
        doc="Prior on a Polar variable, coords (range, angle) (Polar.jl:14-28).",
    )
)


def _polar_polar_res(params, p1, p2):
    return _wrapped(params["z"] - (p2 - p1))


POLAR_POLAR = register_factor_type(
    FactorType(
        name="PolarPolar",
        variable_types=(Polar, Polar),
        zdim=2,
        residual=_polar_polar_res,
        initializers={
            1: lambda params, pts: pts[0] + params["z"],
            0: lambda params, pts: pts[1] - params["z"],
        },
        coord_types=("e", "c"),
        doc="Linear offset between two Polar variables (Polar.jl:30-52).",
    )
)


def _polar_gauss(ftype, Zrange, Zangle, **kw):
    Zrange = Zrange or Normal(1, 1)
    Zangle = Zangle or Normal(0, 0.1)
    mean = np.array([Zrange.mean()[0], Zangle.mean()[0]])
    cov = np.diag([Zrange.cov()[0, 0], Zangle.cov()[0, 0]])
    return Factor(
        ftype=ftype,
        variables=(),
        params=gaussian_params(mean, cov),
        dists=(Zrange, Zangle),
        **kw,
    )


def PriorPolar(Zrange: Normal = None, Zangle: Normal = None, **kw):
    return _polar_gauss(PRIOR_POLAR, Zrange, Zangle, **kw)


def PolarPolar(Zrange: Normal = None, Zangle: Normal = None, **kw):
    return _polar_gauss(POLAR_POLAR, Zrange, Zangle, **kw)
