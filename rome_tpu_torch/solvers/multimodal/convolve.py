"""The per-particle factor solve of the nonparametric convolution
(counterpart of ``rome_tpu/solvers/multimodal/convolve.py``; the part the
batched engine uses).

To propagate a belief through a factor toward a target variable, each
particle's sampled measurement is solved for ``residual = 0`` on the
target's few tangent dofs: a fixed-iteration damped Gauss-Newton, batched
over every (factor, particle) pair at once.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from rome_tpu_torch.utils.math import matvec


def approx_conv(*args, **kwargs):
    """approxConv: the per-factor convolution with distribution sampling and
    multihypo data association."""
    raise NotImplementedError(
        "approx_conv and distribution sampling are not ported yet (ROADMAP slice C)"
    )


approxConv = approx_conv


def _gn_solve_target(ftype, slot, mans, z, params, other_pts, x0, iters=10, damping=1e-6):
    """Damped GN on the target variable only, batched over M particles.

    z (M, zdim) measurement samples; params: dict of (M, ...) per-particle
    factor parameters (``sqrt_info`` among them); other_pts: tuple of
    (M, point_dim) points for every slot (the target's entry is ignored);
    x0 (M, point_dim) start. Returns (M, point_dim).
    """
    man = mans[slot]

    def resid(d, x, z, params, others):
        pts = tuple(
            man.boxplus(x, d) if k == slot else others[k] for k in range(len(mans))
        )
        p = dict(params)
        p["z"] = z
        r = matvec(params["sqrt_info"], ftype.residual(p, *pts))
        return r, r

    jac = vmap(jacfwd(resid, has_aux=True))
    others = tuple(other_pts)
    zeros = torch.zeros((x0.shape[0], man.dof), dtype=x0.dtype, device=x0.device)
    eye = torch.eye(man.dof, dtype=x0.dtype, device=x0.device)
    x = x0
    for _ in range(iters):
        J, r = jac(zeros, x, z, params, others)          # (M, zdim, dof), (M, zdim)
        H = J.transpose(-1, -2) @ J
        # trace-scaled damping: underdetermined factors (range-only) give a
        # rank-deficient H whose tiny absolute damping cancels in f32
        mu = 1e-3 * torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / man.dof + damping
        H = H + mu[:, None, None] * eye
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        d = torch.linalg.solve_ex(H, g)[0]
        x = man.normalize(man.boxplus(x, -d))
    return x
