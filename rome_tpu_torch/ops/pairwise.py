"""Gibbs pairwise scores of the multimodal belief product: the plain PyTorch
versions of the kernels K2 and K3, and their static dispatch.

The Gibbs kernel-label sampler scores every kernel j of one density against
the Gaussian product-of-others conditional of every output particle n:

    logw[v, n, j] = -0.5 * sum_d inv_var[v, d] * (local(ref[v, n], pts[v, j])[d] - mu[v, n, d])**2

for every variable v of a type at once (the JAX package ran its Pallas
kernels ``rome_tpu/ops/pairwise.py`` once per variable under ``jax.vmap``),
and draws each row's new kernel label by Gumbel-max from uniforms u:

    labels[v, n] = argmax_j logw[v, n, j] - log(-log(max(u[v, n, j], tiny)))

The plain versions here materialise the (V, N, Nj, dof) tangent tensor and
the scores; the CUDA kernels (``ops/pairwise_cuda.py``) keep the tangent in
registers, and their draw epilogue keeps the scores out of device memory.

Shapes: ref, mu (V, N, d); pts (V, Nj, d); inv_var (V, d); circ (d,);
u (V, N, Nj) -> logw (V, N, Nj) float32, labels (V, N) int64. The unbatched
JAX signature (N, d) / (Nj, d) / (d,) -> (N, Nj) is accepted as V = 1.
"""

from __future__ import annotations

import math

import torch

from rome_tpu_torch.manifolds.base import SE2, SO2, ProductGroup, TranslationGroup

TWO_PI = 2.0 * math.pi
# largest dof of the per-dim kernel K3 (the Pallas kernel's _DPAD)
MAX_DOF = 8


def _wrap(x):
    """Onto [-pi, pi) as the Pallas kernels compute it:
    x - 2 pi floor((x + pi) / (2 pi))."""
    return x - TWO_PI * torch.floor((x + math.pi) / TWO_PI)


def se2_pairwise_logw_plain(ref, mu, pts, inv_var):
    """K2's plain version, (V, N, 3) / (V, Nj, 3) / (V, 3) -> (V, N, Nj)."""
    rx, ry, rth = (ref[..., k, None] for k in range(3))      # (V, N, 1)
    px, py, pth = (pts[:, None, :, k] for k in range(3))     # (V, 1, Nj)
    cth, sth = torch.cos(rth), torch.sin(rth)
    dx, dy = px - rx, py - ry
    # local(ref, p) = [R(-th_r) (t_p - t_r); wrap(th_p - th_r)]
    cx = cth * dx + sth * dy
    cy = cth * dy - sth * dx
    ex = cx - mu[..., 0, None]
    ey = cy - mu[..., 1, None]
    eth = _wrap(pth - rth) - mu[..., 2, None]
    iv = inv_var[:, None, None, :]
    return -0.5 * (iv[..., 0] * ex * ex + iv[..., 1] * ey * ey + iv[..., 2] * eth * eth)


def euclid_pairwise_logw_plain(ref, mu, pts, inv_var, circ):
    """K3's plain version: per-dim difference, wrapped where circ is 1."""
    dof = ref.shape[-1]
    acc = torch.zeros(
        (ref.shape[0], ref.shape[1], pts.shape[1]), dtype=ref.dtype, device=ref.device
    )
    for d in range(dof):
        diff = pts[:, None, :, d] - ref[:, :, None, d]
        diff = diff - (circ[d] * TWO_PI) * torch.floor((diff + math.pi) / TWO_PI)
        e = diff - mu[:, :, None, d]
        acc = acc + inv_var[:, d, None, None] * e * e
    return -0.5 * acc


def gumbel_argmax(logits, u):
    """One Gumbel-max draw per row over the last dim, given uniforms ``u`` of
    the logits' shape; among equal values the first index (``torch.argmax``).
    ``kde.categorical`` with its ``torch.rand`` lifted out."""
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def se2_gibbs_draw_plain(ref, mu, pts, inv_var, u):
    """K2's draw epilogue, plain: (V, N) int64 labels."""
    return gumbel_argmax(se2_pairwise_logw_plain(ref, mu, pts, inv_var), u)


def euclid_gibbs_draw_plain(ref, mu, pts, inv_var, circ, u):
    """K3's draw epilogue, plain: (V, N) int64 labels."""
    return gumbel_argmax(euclid_pairwise_logw_plain(ref, mu, pts, inv_var, circ), u)


def _per_dim(man) -> bool:
    """True when ``local`` is a per-dim difference, wrapped on circular dims:
    T(n), SO(2) and products of them (Polar, BearingRange2, ...)."""
    if isinstance(man, (TranslationGroup, SO2)):
        return True
    if isinstance(man, ProductGroup):
        return all(_per_dim(p) for p in man.parts)
    return False


def _for(man, se2_fn, euclid_fn):
    """``se2_fn`` for SE(2); for a per-dim linear/circular manifold (T(n),
    SO(2) and their products) with point_dim == dof <= 8, ``euclid_fn`` with
    the manifold's circular-dim mask bound; else None."""
    if isinstance(man, SE2):
        return se2_fn
    if _per_dim(man) and man.dof <= MAX_DOF and man.point_dim == man.dof:
        circ = [1.0 if c == "c" else 0.0 for c in man.coord_types]
        cache = {}

        def euclid(ref, mu, pts, inv_var, *rest):
            c = cache.get(ref.device)
            if c is None:
                c = cache[ref.device] = torch.tensor(
                    circ, dtype=torch.float32, device=ref.device
                )
            return euclid_fn(ref, mu, pts, inv_var, c, *rest)

        return euclid
    return None


def pairwise_logw_for(man):
    """The fused scoring function matching ``man``'s local map, or None when
    no fused variant applies. SE(2) takes K2; a per-dim linear/circular
    manifold (T(n), SO(2) and their products) with point_dim == dof <= 8
    takes K3 with its circular-dim mask. Returned functions take (ref, mu, pts, inv_var)."""
    from rome_tpu_torch.ops import pairwise_cuda

    return _for(man, pairwise_cuda.se2_pairwise_logw, pairwise_cuda.euclid_pairwise_logw)


def pairwise_draw_for(man):
    """The fused score + Gumbel-max label draw for ``man`` (K2's or K3's draw
    epilogue), chosen as :func:`pairwise_logw_for` chooses, or None.
    Returned functions take (ref, mu, pts, inv_var, u) -> (V, N) labels."""
    from rome_tpu_torch.ops import pairwise_cuda

    return _for(man, pairwise_cuda.se2_gibbs_draw, pairwise_cuda.euclid_gibbs_draw)
