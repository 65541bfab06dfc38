"""Unit-quaternion functions (w, x, y, z storage) — the SO(3) point type
(counterpart of ``rome_tpu/manifolds/quat.py``).

Every function acts on trailing-dim-4 tensors and broadcasts over leading
dims. Branches are ``torch.where`` selections with the same Taylor guards as
the JAX package, so both sides of every selection stay finite (forward-mode
AD differentiates both). Components are taken as width-1 slices, never as
0-dim tensors: under ``torch.func.vmap(jacfwd)`` a 0-dim float32 tangent
combined with a Python float is promoted to float64.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _split(q):
    return q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]


def qidentity(dtype=torch.float64, device="cpu"):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def qnormalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qmul(a, b):
    """Hamilton product a ⊗ b, (...,4)x(...,4)->(...,4)."""
    a, b = _promote(a, b)
    aw, ax, ay, az = _split(a)
    bw, bx, by, bz = _split(b)
    return torch.cat(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a, b):
    """Cross product over the last dim, (...,3)x(...,3)->(...,3), in the
    operands' common dtype (``jnp.cross``'s formula and promotion)."""
    a, b = _promote(a, b)
    a0, a1, a2 = a[..., 0:1], a[..., 1:2], a[..., 2:3]
    b0, b1, b2 = b[..., 0:1], b[..., 1:2], b[..., 2:3]
    return torch.cat([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def qrotate(q, v):
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v, (...,4),(...,3)->(...,3)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def qexp(phi):
    """so(3) coords -> unit quaternion, exp map. (...,3)->(...,4)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS)
    half = 0.5 * theta
    # sin(t/2)/t with Taylor guard: 1/2 - t^2/48 for small t
    small = theta2 < 1e-8
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def qlog(q):
    """Unit quaternion -> so(3) coords (minimal rotation). (...,4)->(...,3)."""
    # canonicalize to w >= 0 so the log is the minimal-angle representative
    q = torch.where(q[..., :1] < 0.0, -q, q)
    w = q[..., :1]
    v = q[..., 1:]
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    n = torch.sqrt(n2 + _EPS)
    angle = 2.0 * torch.atan2(n, w)
    small = n2 < 1e-12
    k = torch.where(
        small,
        2.0 / torch.clamp(w, min=0.5) * (1.0 - n2 / (3.0 * torch.clamp(w * w, min=0.25))),
        angle / n,
    )
    return k * v


def qto_matrix(q):
    """(...,4) -> (...,3,3) rotation matrix."""
    w, x, y, z = _split(q)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.cat(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(*r.shape[:-1], 3, 3)


def qfrom_matrix(R):
    """(...,3,3) -> (...,4) quaternion (w>=0). Shepperd's method, branch-free:
    all four candidate constructions, the one with the largest pivot kept
    (the first among equal pivots, as ``jnp.argmax`` picks)."""
    m00, m01, m02 = R[..., 0, 0:1], R[..., 0, 1:2], R[..., 0, 2:3]
    m10, m11, m12 = R[..., 1, 0:1], R[..., 1, 1:2], R[..., 1, 2:3]
    m20, m21, m22 = R[..., 2, 0:1], R[..., 2, 1:2], R[..., 2, 2:3]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) / 2.0
    q0 = torch.cat([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], -1)

    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) / 2.0
    q1 = torch.cat([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], -1)

    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) / 2.0
    q2 = torch.cat([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], -1)

    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) / 2.0
    q3 = torch.cat([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], -1)

    pivots = torch.cat([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    best = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], -2)  # (...,4cand,4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(qs, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0.0, -q, q)
    return qnormalize(q)
