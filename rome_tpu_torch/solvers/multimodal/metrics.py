"""Belief-comparison metrics: k-NN KL divergence between particle sets
(counterpart of ``rome_tpu/solvers/multimodal/metrics.py``).

The Wang–Kulkarni–Verdú nearest-neighbor estimator of KL(P || Q) from
samples, with distances measured through the manifold ``local`` map so
circular dimensions wrap correctly:

    KL(P||Q) ~= (d/n) * sum_i log( s_k(x_i; Q) / r_k(x_i; P) ) + log(m / (n - 1))
"""

from __future__ import annotations

import math

import torch

from rome_tpu_torch.manifolds.base import Manifold


def _pairwise_dist(man: Manifold, X, Y):
    """(n, m) geodesic-coordinate distances via the manifold local map."""
    d = man.local(X[:, None, :], Y[None, :, :])
    return torch.sqrt(torch.sum(d * d, dim=-1))


def kl_divergence_knn(man: Manifold, P, Q, k: int = 1) -> float:
    """Estimate KL(P || Q) from particle arrays P (n, pdim), Q (m, pdim)."""
    P, Q = torch.as_tensor(P), torch.as_tensor(Q)
    n, m = P.shape[0], Q.shape[0]
    dPP = _pairwise_dist(man, P, P)
    # exclude the self-distance
    dPP = dPP + (dPP.max() + 1.0) * torch.eye(n, dtype=dPP.dtype, device=dPP.device)
    r_k = torch.sort(dPP, dim=1).values[:, k - 1]
    s_k = torch.sort(_pairwise_dist(man, P, Q), dim=1).values[:, k - 1]
    eps = 1e-12
    est = (man.dof / n) * torch.sum(torch.log((s_k + eps) / (r_k + eps)))
    return float(est) + math.log(m / (n - 1.0))


def symmetric_kl_knn(man: Manifold, P, Q, k: int = 1) -> float:
    """0.5 (KL(P||Q) + KL(Q||P)) — the band metric of the acceptance tests."""
    return 0.5 * (kl_divergence_knn(man, P, Q, k) + kl_divergence_knn(man, Q, P, k))
