"""Small numerical utilities shared across the port.

Counterpart of ``rome_tpu/utils/math.py``. Every function is
shape-polymorphic over leading dims and keeps the dtype and device of its
input.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


def sym_rem(theta: torch.Tensor) -> torch.Tensor:
    """Symmetric remainder: wrap angle(s) to the interval [-pi, pi).

    ``torch.remainder`` takes the sign of the divisor, like ``jnp.mod``, so
    this is the same arithmetic as the JAX package's ``sym_rem``.
    """
    if theta.dim() == 0:
        # forward-mode AD (torch.func.jacfwd under vmap) promotes the tangent
        # of a 0-dim float32 tensor plus a Python float to float64; constants
        # of theta's own dtype keep it float32 (same values)
        pi = torch.full((), math.pi, dtype=theta.dtype, device=theta.device)
        return torch.remainder(theta + pi, 2.0 * pi) - pi
    return torch.remainder(theta + math.pi, TWO_PI) - math.pi


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Alias of :func:`sym_rem`."""
    return sym_rem(theta)


def spd_repair(mat: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Symmetrize a covariance, ``(M + M^T) / 2``, and add ``eps * I`` when
    ``eps`` is not 0 (the g2o parser's and the IMU preintegration's repair)."""
    mat = 0.5 * (mat + mat.transpose(-1, -2))
    if eps:
        mat = mat + eps * torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    return mat


def sqrt_info_from_cov(cov: torch.Tensor) -> torch.Tensor:
    """The lower-triangular whitener ``S = inv(chol(cov))`` with
    ``S^T S = inv(cov)``, over leading dims."""
    L = torch.linalg.cholesky(spd_repair(cov))
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device).expand(cov.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def cont2disc(F: torch.Tensor, G: torch.Tensor, Qc: torch.Tensor, dt):
    """First-order continuous-to-discrete noise integration: ``Phi = I + F
    dt``, ``Qd = Phi G Qc G^T Phi^T dt``. Returns ``(Phi, spd_repair(Qd))``."""
    Phi = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device) + F * dt
    M = G @ Qc @ G.transpose(-1, -2)
    Qd = Phi @ M @ Phi.transpose(-1, -2) * dt
    return Phi, spd_repair(Qd)


def skew2(omega: torch.Tensor) -> torch.Tensor:
    """so(2) hat map: (...,) -> (...,2,2)."""
    z = torch.zeros_like(omega)
    return torch.stack([torch.stack([z, -omega], -1), torch.stack([omega, z], -1)], -2)


def skew3(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat map: (...,3) -> (...,3,3). Components are taken as width-1
    slices (see the note in sym_rem)."""
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    o = torch.zeros_like(x)
    m = torch.cat([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(*m.shape[:-1], 3, 3)


def rot2(theta: torch.Tensor) -> torch.Tensor:
    """SO(2) rotation matrix from angle, (...,) -> (...,2,2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX-style type promotion: operands of mixed float
    dtypes are computed in their common (widest) dtype."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``A @ x`` over leading dims, (..., m, k) x (..., k) -> (..., m),
    in the operands' common dtype."""
    dt = torch.promote_types(A.dtype, x.dtype)
    return (A.to(dt) @ x.to(dt)[..., None])[..., 0]


def safe_norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Euclidean norm over the last dim, differentiable at zero (particles
    can land on top of each other in the nonparametric convolution)."""
    s = torch.sum(v * v, dim=-1)
    # a tensor constant of s's dtype: see the note in sym_rem
    return torch.sqrt(s + torch.full((), eps, dtype=s.dtype, device=s.device))


def sym_rem_np(theta):
    """Numpy twin of sym_rem for host-side code paths."""
    return np.arctan2(np.sin(theta), np.cos(theta))
