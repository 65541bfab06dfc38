"""Factor-type machinery: typed residual kernels + instance records
(counterpart of ``rome_tpu/factors/base.py``).

Each factor *type* is one pure residual ``residual(params, *points) ->
(..., zdim)`` written in torch ops over the trailing dims; all instances of a
type stack into a dense batch. ``params`` is a dict of per-factor tensors;
the canonical keys are

  ``z``         (zdim,)        measurement mean in tangent/measurement coords
  ``sqrt_info`` (zdim, zdim)   whitening matrix S with S^T S = inv(cov)

Residuals return RAW (unwhitened) errors; the solver applies ``sqrt_info``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from rome_tpu_torch.distributions import Distribution


@dataclass(frozen=True)
class FactorType:
    """A factor family: fixed variable signature + one residual kernel."""

    name: str
    variable_types: tuple  # tuple[VariableType, ...]
    zdim: int
    residual: Callable  # (params: dict, *points) -> (..., zdim) raw residual
    # closed-form solve of slot k given the measurement and the other
    # variables' points: {slot: fn(params, points) -> point}; used by
    # graph init
    initializers: dict = field(default_factory=dict, compare=False)
    coord_types: tuple = ()
    # which tangent dims of the LAST variable the factor constrains (the
    # reference's ``partial=``, 0-based); None = all dims
    partial: Optional[tuple] = None
    # True: ``add_factor`` sets params["dt"] = (t_last - t_first) seconds
    # from the bound variables' timestamps, unless the ctor already set it
    needs_dt: bool = False
    doc: str = ""

    @property
    def arity(self) -> int:
        return len(self.variable_types)

    @property
    def is_prior(self) -> bool:
        return self.arity == 1

    def __repr__(self):
        return f"FactorType({self.name})"


_FACTOR_REGISTRY: dict = {}


def register_factor_type(ft: FactorType) -> FactorType:
    _FACTOR_REGISTRY[ft.name] = ft
    return ft


def get_factor_type(name: str) -> FactorType:
    return _FACTOR_REGISTRY[name]


def list_factor_types():
    return sorted(_FACTOR_REGISTRY)


@dataclass
class Factor:
    """One factor instance (host-side record; lowered to batches at solve)."""

    ftype: FactorType
    variables: tuple  # tuple[str, ...] labels
    params: dict  # str -> np.ndarray, stacked later
    dists: tuple = ()  # measurement Distribution objects
    label: str = ""
    multihypo: Optional[Sequence[float]] = None
    nullhypo: float = 0.0
    solvable: int = 1
    tags: tuple = ()
    timestamp_ns: int = 0
    inflation: Optional[float] = None

    def __post_init__(self):
        if not self.label:
            self.label = (
                self.ftype.name.lower() + "_" + "_".join(self.variables)
            )
        # standardize params to float64 numpy (lowered to device dtype later)
        self.params = {
            k: np.asarray(v, dtype=np.float64) for k, v in self.params.items()
        }

    def __repr__(self):
        return f"{self.ftype.name}({','.join(self.variables)})"


def gaussian_params(mean, cov) -> dict:
    """Standard (z, sqrt_info) params from a Gaussian measurement model."""
    mean = np.asarray(mean, dtype=np.float64).reshape(-1)
    cov = np.asarray(cov, dtype=np.float64)
    cov = 0.5 * (cov + cov.T)
    L = np.linalg.cholesky(cov + 1e-14 * np.eye(cov.shape[0]))
    sqrt_info = np.linalg.inv(L)  # S with S^T S = inv(cov)
    return {"z": mean, "sqrt_info": sqrt_info}


def make_gaussian_factor(ftype: FactorType, variables, dist: Distribution, extra_params=None, **kw) -> Factor:
    """Build a Factor whose measurement model is a single Gaussian belief."""
    params = gaussian_params(dist.mean(), dist.cov())
    if extra_params:
        params.update(extra_params)
    return Factor(ftype=ftype, variables=tuple(variables), params=params, dists=(dist,), **kw)
