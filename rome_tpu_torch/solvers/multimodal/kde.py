"""Manifold kernel-density estimation and belief products (counterpart of
``rome_tpu/solvers/multimodal/kde.py``).

- a belief is a dense particle tensor ``(..., N, point_dim)`` plus a per-dof
  bandwidth; every function here broadcasts over leading dims, so a whole
  variable type is one call;
- the multi-density product is a parallel Gibbs label sampler over kernel
  selections (the prodAppxMSGibbsS analogue), whose pairwise scores and
  Gumbel-max label draws run in the kernels K2/K3 (``ops/pairwise.py``) on
  the manifolds they cover, and as torch ops (``generic_pairwise_logw``)
  on the others.

Random draws come from the ``torch.Generator`` the caller passes; nothing
here touches the global RNG. Categorical draws are Gumbel-max, as
``jax.random.categorical`` draws.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from rome_tpu_torch.manifolds.base import Manifold
from rome_tpu_torch.ops.pairwise import gumbel_argmax, pairwise_draw_for, pairwise_logw_for


def manifold_mean(man: Manifold, points, iters: int = 3):
    """Karcher-style mean over the particle dim: start at the first particle
    and iterate mu <- mu ⊕ mean(local(mu, p)) ``iters`` times.
    (..., N, pdim) -> (..., pdim)."""
    mu = points[..., 0, :]
    for _ in range(iters):
        d = man.local(mu[..., None, :], points)
        mu = man.normalize(man.boxplus(mu, d.mean(dim=-2)))
    return mu


def silverman_bandwidth(man: Manifold, points):
    """Per-dof rule-of-thumb bandwidth from the tangent spread about the
    mean (population std, as ``jnp.std``). (..., N, pdim) -> (..., dof)."""
    n = points.shape[-2]
    mu = manifold_mean(man, points, 3)
    loc = man.local(mu[..., None, :], points)
    std = torch.std(loc, dim=-2, correction=0) + 1e-6
    dof = loc.shape[-1]
    return std * (4.0 / (dof + 2.0) / max(n, 2)) ** (1.0 / (dof + 4.0))


def categorical(logits, generator):
    """One draw per row from softmax(logits) over the last dim (Gumbel-max)."""
    u = torch.rand(
        logits.shape, generator=generator, dtype=logits.dtype, device=logits.device
    )
    return gumbel_argmax(logits, u)


def generic_pairwise_logw(man: Manifold, ref, mu, pts, inv_var):
    """The Gibbs pairwise score for any manifold, in torch ops: the JAX
    package's vmapped form for the manifolds no kernel covers (SO(3), SE(3),
    SE(2) x T(2), ...). ``local(ref[v, n], pts[v, j])`` for every pair, then

        logw[v, n, j] = -0.5 * sum_d (C[v, n, j, d] - mu[v, n, d])**2 * inv_var[v, d]

    ref (V, N, point_dim), mu (V, N, dof), pts (V, Nj, point_dim), inv_var
    (V, dof) -> (V, N, Nj); the unbatched (N, ·) / (Nj, ·) / (dof,) form is
    accepted as V = 1."""
    if ref.dim() == 2:
        return generic_pairwise_logw(man, ref[None], mu[None], pts[None], inv_var[None])[0]
    C = man.local(ref[:, :, None, :], pts[:, None, :, :])            # (V, N, Nj, dof)
    d2 = (C - mu[:, :, None, :]) ** 2 * inv_var[:, None, None, :]
    return -0.5 * torch.sum(d2, dim=-1)


def generic_gibbs_draw(man: Manifold, ref, mu, pts, inv_var, u):
    """The generic score, then the label draw of :func:`categorical` from
    the uniforms u: (V, N) labels."""
    return gumbel_argmax(generic_pairwise_logw(man, ref, mu, pts, inv_var), u)


def pairwise_logw(man: Manifold):
    """The Gibbs scoring function (ref, mu, pts, inv_var) -> logw for
    ``man``: K2 for SE(2), K3 for T(n), SO(2) and their products (dof <= 8),
    else the generic score (:func:`generic_pairwise_logw`)."""
    fn = pairwise_logw_for(man)
    return fn if fn is not None else functools.partial(generic_pairwise_logw, man)


def pairwise_draw(man: Manifold):
    """The Gibbs label update (ref, mu, pts, inv_var, u) -> labels for
    ``man``: K2's or K3's draw epilogue (the score and the Gumbel-max draw of
    :func:`categorical` from the uniforms u in one launch) where one covers
    the manifold, else the generic score and the same draw."""
    fn = pairwise_draw_for(man)
    return fn if fn is not None else functools.partial(generic_gibbs_draw, man)


@dataclass
class ManifoldKernelDensity:
    """manikde! analogue: particle kernel density on a manifold."""

    manifold: Manifold
    points: torch.Tensor         # (N, point_dim)
    bandwidth: torch.Tensor      # (dof,) kernel std-devs

    @classmethod
    def from_points(cls, man: Manifold, points, bandwidth=None):
        points = torch.as_tensor(points)
        bw = (
            torch.as_tensor(bandwidth, dtype=points.dtype, device=points.device)
            if bandwidth is not None
            else silverman_bandwidth(man, points)
        )
        return cls(man, points, bw.clamp_min(1e-5))

    @property
    def N(self):
        return self.points.shape[0]

    def mean(self):
        return manifold_mean(self.manifold, self.points)

    def logpdf(self, x):
        """Log density at point(s) x (…, point_dim)."""
        man, bw = self.manifold, self.bandwidth
        xb = x.reshape(-1, x.shape[-1])
        d = man.local(self.points[None], xb[:, None, :])       # (M, N, dof)
        q = -0.5 * torch.sum((d / bw) ** 2, dim=-1)
        logz = torch.sum(torch.log(bw)) + 0.5 * d.shape[-1] * math.log(2 * math.pi)
        out = torch.logsumexp(q, dim=-1) - math.log(self.N) - logz
        return out.reshape(x.shape[:-1])

    def sample(self, generator, n: int):
        """Draw n samples: pick kernels uniformly, perturb in the tangent."""
        dev = self.points.device
        idx = torch.randint(0, self.N, (n,), generator=generator, device=dev)
        eps = torch.randn(
            (n, self.bandwidth.shape[0]), generator=generator,
            dtype=self.points.dtype, device=dev,
        ) * self.bandwidth
        return self.manifold.normalize(self.manifold.boxplus(self.points[idx], eps))

    def max_point(self):
        """getKDEMax analogue: the particle of highest density."""
        return self.points[torch.argmax(self.logpdf(self.points))]


def gibbs_product(generator, densities, n_out: int = None, sweeps: int = 3):
    """Product of kernel densities on a shared manifold — the
    ``prodAppxMSGibbsS`` analogue.

    Parallel Gibbs over kernel-label assignments: every output particle
    holds one selected kernel per input density; sweeps resample each
    density's label from the Gaussian-product conditional given the other
    selections; the output particle is the tangent-space Gaussian-product
    mean of its selected kernels (plus product-covariance noise).
    """
    man = densities[0].manifold
    N = n_out or densities[0].N
    m = len(densities)
    if m == 1:
        return densities[0].sample(generator, N)
    dev = densities[0].points.device
    labels = [
        torch.randint(0, d.N, (N,), generator=generator, device=dev) for d in densities
    ]
    lam = [1.0 / (d.bandwidth ** 2) for d in densities]  # (dof,) precisions
    draw_fn = pairwise_draw(man)

    def product_estimate(sel, exclude=None):
        """Tangent-space precision-weighted mean of the selected kernels,
        linearized at the first included selection."""
        include = [j for j in range(m) if j != exclude]
        ref = sel[include[0]]
        num = torch.zeros((N, man.dof), dtype=ref.dtype, device=dev)
        den = torch.zeros((man.dof,), dtype=ref.dtype, device=dev)
        for j in include:
            num = num + lam[j] * man.local(ref, sel[j])
            den = den + lam[j]
        return ref, num / den, den

    for _ in range(sweeps):
        for j in range(m):
            sel = [d.points[l] for d, l in zip(densities, labels)]
            ref, mu_c, prec = product_estimate(sel, exclude=j)
            var = 1.0 / prec + densities[j].bandwidth ** 2
            # the uniforms categorical() would draw for the (N, Nj) scores
            u = torch.rand((1, N, densities[j].N), generator=generator,
                           dtype=torch.float32, device=dev)
            labels[j] = draw_fn(
                ref[None].contiguous(), mu_c[None].contiguous(),
                densities[j].points[None].contiguous(), (1.0 / var)[None].contiguous(), u,
            )[0]

    sel = [d.points[l] for d, l in zip(densities, labels)]
    ref, mu_c, prec = product_estimate(sel)
    eps = torch.randn(mu_c.shape, generator=generator, dtype=mu_c.dtype, device=dev)
    return man.normalize(man.boxplus(ref, mu_c + eps * torch.sqrt(1.0 / prec)))
