"""Measurement-model distributions (counterpart of ``rome_tpu/distributions.py``).

Julia convention parity, as in the JAX package:
  - ``Normal(mu, sigma)``: sigma is a STANDARD DEVIATION.
  - ``MvNormal(mu, v::Vector)``: vector argument is STANDARD DEVIATIONS.
  - ``MvNormal(mu, S::Matrix)``: matrix argument is a COVARIANCE.

Means and covariances are host numpy; they lower to tensors at graph-lowering
time. Sampling belongs to the nonparametric engine, which is not ported yet.
"""

from __future__ import annotations

import numpy as np


class Distribution:
    """Base: a belief with a (mean, cov) parametric summary."""

    dim: int

    def mean(self) -> np.ndarray:
        raise NotImplementedError

    def cov(self) -> np.ndarray:
        raise NotImplementedError


class Normal(Distribution):
    """Scalar Gaussian; sigma is a standard deviation (Julia parity)."""

    def __init__(self, mu: float = 0.0, sigma: float = 1.0):
        self.mu = float(mu)
        self.sigma = float(sigma)
        self.dim = 1

    def mean(self):
        return np.array([self.mu])

    def cov(self):
        return np.array([[self.sigma**2]])

    def __repr__(self):
        return f"Normal({self.mu}, {self.sigma})"


class MvNormal(Distribution):
    """Multivariate Gaussian: 1-D ``cov_or_sigmas`` are standard deviations,
    2-D is a covariance matrix."""

    def __init__(self, mu, cov_or_sigmas=None):
        self.mu = np.asarray(mu, dtype=np.float64).reshape(-1)
        self.dim = self.mu.size
        if cov_or_sigmas is None:
            self._cov = np.eye(self.dim)
        else:
            arr = np.asarray(cov_or_sigmas, dtype=np.float64)
            if arr.ndim == 1:
                self._cov = np.diag(arr**2)
            else:
                self._cov = 0.5 * (arr + arr.T)

    def mean(self):
        return self.mu.copy()

    def cov(self):
        return self._cov.copy()

    def __repr__(self):
        return f"MvNormal(dim={self.dim})"
