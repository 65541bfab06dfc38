"""Lie-group manifolds with flat-vector point storage, in PyTorch.

Counterpart of ``rome_tpu/manifolds/base.py``: T(n), SO(2), SO(3) (unit
quaternions), SE(2), SE(3) and products of them. Every point is a flat
fixed-width vector, so the variables of one type pack into one dense
``(n, point_dim)`` tensor; all ops act on the trailing dim and broadcast
over leading dims, which keeps them usable batched and under
``torch.func.vmap``.

Tangent convention ("hybrid", as in the JAX package):

    boxplus(p, xi) = compose(p, exp(xi))      right/body perturbation
    local(p, q)    = log(compose(inv(p), q))  body-frame difference
    SE(2): exp(v, w) = ((vx, vy), R(w)),  log(t, R) = (t, theta(R))
    SE(3): exp(v, w) = (v, qexp(w)),      log(t, q) = (t, qlog(q))
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.utils.math import matvec, rot2, sym_rem


class Manifold:
    """A Lie group with flat-vector point storage.

    Subclasses define: name, point_dim, dof, coord_types, identity, compose,
    inverse, exp, log (all batched over leading dims).
    """

    name: str = "abstract"
    point_dim: int = 0
    dof: int = 0
    coord_types: tuple = ()

    def identity(self, dtype=torch.float64, device="cpu"):
        return torch.zeros(self.point_dim, dtype=dtype, device=device)

    def compose(self, a, b):
        raise NotImplementedError

    def inverse(self, a):
        raise NotImplementedError

    def exp(self, xi):
        """Tangent coords (…, dof) -> group element (…, point_dim)."""
        raise NotImplementedError

    def log(self, p):
        """Group element (…, point_dim) -> tangent coords (…, dof)."""
        raise NotImplementedError

    def normalize(self, p):
        """Re-project onto the manifold (wrap angles / renormalise quats)."""
        return p

    def boxplus(self, p, xi):
        """Right (body-frame) retraction: p ∘ exp(xi)."""
        return self.compose(p, self.exp(xi))

    def local(self, p, q):
        """Coords of q relative to p: log(p⁻¹ ∘ q). boxplus(p, local(p,q)) == q."""
        return self.log(self.compose(self.inverse(p), q))

    def dist(self, p, q):
        """Geodesic distance: the norm of ``local(p, q)`` over the last dim."""
        return torch.linalg.vector_norm(self.local(p, q), dim=-1)

    def random_tangent_scale(self):
        """Per-dim scale hints for random sampling (1.0 everywhere)."""
        return np.ones(self.dof)

    def __repr__(self):
        return f"<{self.name}>"


class TranslationGroup(Manifold):
    """T(n) — Euclidean vector addition group."""

    def __init__(self, n: int):
        self.n = n
        self.name = f"TranslationGroup({n})"
        self.point_dim = n
        self.dof = n
        self.coord_types = ("e",) * n

    def compose(self, a, b):
        return a + b

    def inverse(self, a):
        return -a

    def exp(self, xi):
        return xi

    def log(self, p):
        return p


class SO2(Manifold):
    """SO(2), point stored as wrapped angle (…, 1)."""

    name = "SpecialOrthogonal(2)"
    point_dim = 1
    dof = 1
    coord_types = ("c",)

    def compose(self, a, b):
        return sym_rem(a + b)

    def inverse(self, a):
        return -a

    def exp(self, xi):
        return sym_rem(xi)

    def log(self, p):
        return sym_rem(p)

    def normalize(self, p):
        return sym_rem(p)


class SE2(Manifold):
    """SE(2), point stored as (x, y, theta) (…, 3); hybrid tangent (vx, vy, w)."""

    name = "SpecialEuclidean(2)"
    point_dim = 3
    dof = 3
    coord_types = ("e", "e", "c")

    def compose(self, a, b):
        t = a[..., :2] + matvec(rot2(a[..., 2]), b[..., :2])
        th = sym_rem(a[..., 2] + b[..., 2])
        return torch.cat([t, th[..., None]], dim=-1)

    def inverse(self, a):
        th = -a[..., 2]
        t = -matvec(rot2(th), a[..., :2])
        return torch.cat([t, th[..., None]], dim=-1)

    def exp(self, xi):
        # hybrid: translation passes through linearly, angle wraps
        return torch.cat([xi[..., :2], sym_rem(xi[..., 2:3])], dim=-1)

    def log(self, p):
        return torch.cat([p[..., :2], sym_rem(p[..., 2:3])], dim=-1)

    def normalize(self, p):
        return torch.cat([p[..., :2], sym_rem(p[..., 2:3])], dim=-1)


class SO3(Manifold):
    """SO(3), point stored as unit quaternion (w,x,y,z) (…, 4)."""

    name = "SpecialOrthogonal(3)"
    point_dim = 4
    dof = 3
    coord_types = ("c", "c", "c")

    def identity(self, dtype=torch.float64, device="cpu"):
        return Q.qidentity(dtype, device)

    def compose(self, a, b):
        return Q.qmul(a, b)

    def inverse(self, a):
        return Q.qconj(a)

    def exp(self, xi):
        return Q.qexp(xi)

    def log(self, p):
        return Q.qlog(p)

    def normalize(self, p):
        return Q.qnormalize(p)


class SE3(Manifold):
    """SE(3), point stored as (t[3], q[4]) (…, 7); hybrid tangent (v[3], w[3])."""

    name = "SpecialEuclidean(3)"
    point_dim = 7
    dof = 6
    coord_types = ("e", "e", "e", "c", "c", "c")

    def identity(self, dtype=torch.float64, device="cpu"):
        return torch.cat([torch.zeros(3, dtype=dtype, device=device), Q.qidentity(dtype, device)])

    def compose(self, a, b):
        t = a[..., :3] + Q.qrotate(a[..., 3:], b[..., :3])
        q = Q.qmul(a[..., 3:], b[..., 3:])
        return torch.cat([t, q], dim=-1)

    def inverse(self, a):
        qi = Q.qconj(a[..., 3:])
        t = -Q.qrotate(qi, a[..., :3])
        return torch.cat([t, qi], dim=-1)

    def exp(self, xi):
        return torch.cat([xi[..., :3], Q.qexp(xi[..., 3:])], dim=-1)

    def log(self, p):
        return torch.cat([p[..., :3], Q.qlog(p[..., 3:])], dim=-1)

    def normalize(self, p):
        return torch.cat([p[..., :3], Q.qnormalize(p[..., 3:])], dim=-1)


class ProductGroup(Manifold):
    """Direct product of manifolds, points and tangents concatenated."""

    def __init__(self, parts, name=None):
        self.parts = tuple(parts)
        self.name = name or ("ProductGroup(" + "x".join(p.name for p in self.parts) + ")")
        self.point_dim = sum(p.point_dim for p in self.parts)
        self.dof = sum(p.dof for p in self.parts)
        self.coord_types = tuple(c for p in self.parts for c in p.coord_types)
        # slices into point / tangent storage
        self._pslices, self._tslices = [], []
        po = to = 0
        for p in self.parts:
            self._pslices.append(slice(po, po + p.point_dim))
            self._tslices.append(slice(to, to + p.dof))
            po += p.point_dim
            to += p.dof

    def _each(self, fn_name, x, slices):
        return torch.cat(
            [getattr(p, fn_name)(x[..., s]) for p, s in zip(self.parts, slices)], dim=-1
        )

    def identity(self, dtype=torch.float64, device="cpu"):
        return torch.cat([p.identity(dtype, device) for p in self.parts])

    def compose(self, a, b):
        return torch.cat(
            [p.compose(a[..., s], b[..., s]) for p, s in zip(self.parts, self._pslices)], dim=-1
        )

    def inverse(self, a):
        return self._each("inverse", a, self._pslices)

    def exp(self, xi):
        return self._each("exp", xi, self._tslices)

    def log(self, pt):
        return self._each("log", pt, self._pslices)

    def normalize(self, pt):
        return self._each("normalize", pt, self._pslices)


T1 = TranslationGroup(1)
T2 = TranslationGroup(2)
T3 = TranslationGroup(3)
T4 = TranslationGroup(4)
SO2_ = SO2()
SO3_ = SO3()
SE2_ = SE2()
SE3_ = SE3()
