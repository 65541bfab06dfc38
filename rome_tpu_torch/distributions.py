"""Measurement-model distributions (counterpart of ``rome_tpu/distributions.py``).

Julia convention parity, as in the JAX package:
  - ``Normal(mu, sigma)``: sigma is a STANDARD DEVIATION.
  - ``MvNormal(mu, v::Vector)``: vector argument is STANDARD DEVIATIONS.
  - ``MvNormal(mu, S::Matrix)``: matrix argument is a COVARIANCE.

Means and covariances are host numpy; they lower to tensors at graph-lowering
time. ``sample(generator, n, device, dtype)`` draws ``(n, dim)`` samples on
``device`` (default: the generator's) from the caller's ``torch.Generator``
(the nonparametric engine's measurement sampling).
"""

from __future__ import annotations

import numpy as np
import torch


class Distribution:
    """Base: a samplable belief with a (mean, cov) parametric summary."""

    dim: int

    def mean(self) -> np.ndarray:
        raise NotImplementedError

    def cov(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, generator, n: int, device=None, dtype=torch.float32) -> torch.Tensor:
        """Draw (n, dim) samples."""
        raise NotImplementedError


def _on(generator, device):
    return generator.device if device is None else device


def _randn(generator, shape, device, dtype):
    return torch.randn(shape, generator=generator, device=_on(generator, device), dtype=dtype)


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

    def sample(self, generator, n, device=None, dtype=torch.float32):
        return self.mu + self.sigma * _randn(generator, (n, 1), device, dtype)

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

    def sample(self, generator, n, device=None, dtype=torch.float32):
        L = np.linalg.cholesky(self._cov + 1e-12 * np.eye(self.dim))
        device = _on(generator, device)
        z = _randn(generator, (n, self.dim), device, dtype)
        mu = torch.as_tensor(self.mu, dtype=dtype, device=device)
        return mu + z @ torch.as_tensor(L, dtype=dtype, device=device).T

    def __repr__(self):
        return f"MvNormal(dim={self.dim})"


class Uniform(Distribution):
    def __init__(self, a: float = 0.0, b: float = 1.0):
        self.a, self.b = float(a), float(b)
        self.dim = 1

    def mean(self):
        return np.array([0.5 * (self.a + self.b)])

    def cov(self):
        return np.array([[(self.b - self.a) ** 2 / 12.0]])

    def sample(self, generator, n, device=None, dtype=torch.float32):
        u = torch.rand((n, 1), generator=generator, device=_on(generator, device), dtype=dtype)
        return self.a + (self.b - self.a) * u

    def __repr__(self):
        return f"Uniform({self.a}, {self.b})"


def _categorical(generator, p, n, device, dtype):
    """(n,) int64 draws from the probabilities ``p`` (Gumbel-max)."""
    from rome_tpu_torch.solvers.multimodal.kde import categorical

    logits = torch.log(torch.as_tensor(p, dtype=dtype, device=_on(generator, device)))
    return categorical(logits.expand(n, len(p)), generator)


class Categorical(Distribution):
    """Discrete distribution over 1..K (hypothesis weights, multihypo); draws
    are the 0-based category indices as floats, as the JAX package's are."""

    def __init__(self, p):
        self.p = np.asarray(p, dtype=np.float64)
        self.p = self.p / self.p.sum()
        self.dim = 1

    def mean(self):
        return np.array([float(np.argmax(self.p))])

    def cov(self):
        return np.array([[1.0]])

    def sample(self, generator, n, device=None, dtype=torch.float32):
        return _categorical(generator, self.p, n, device, dtype)[:, None].to(dtype)

    def __repr__(self):
        return f"Categorical({self.p})"


class Mixture(Distribution):
    """Weighted mixture of component beliefs (cf. IIF ``Mixture`` factors)."""

    def __init__(self, components, weights=None):
        self.components = list(components)
        k = len(self.components)
        self.weights = np.full(k, 1.0 / k) if weights is None else np.asarray(weights, float)
        self.weights = self.weights / self.weights.sum()
        self.dim = self.components[0].dim

    def mean(self):
        return sum(w * c.mean() for w, c in zip(self.weights, self.components))

    def cov(self):
        # moment-matched covariance
        m = self.mean()
        out = np.zeros((self.dim, self.dim))
        for w, c in zip(self.weights, self.components):
            d = (c.mean() - m).reshape(-1, 1)
            out += w * (c.cov() + d @ d.T)
        return out

    def sample(self, generator, n, device=None, dtype=torch.float32):
        device = _on(generator, device)
        labels = _categorical(generator, self.weights, n, device, dtype)
        comps = torch.stack([c.sample(generator, n, device, dtype) for c in self.components])
        return comps[labels, torch.arange(n, device=device)]  # (n, dim)

    def __repr__(self):
        return f"Mixture({len(self.components)} comps)"


def dist_mean_cov(d: Distribution):
    return d.mean(), d.cov()
