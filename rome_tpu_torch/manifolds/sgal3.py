"""SGal(3) — the Special Galilean group of IMU preintegration (counterpart of
``rome_tpu/manifolds/sgal3.py``; reference IMUDeltaFactor.jl:9-291).

Point storage (flat, batched over leading dims): 11 floats
    [q(4) unit quaternion, v(3) velocity delta, p(3) position delta, t(1)]
Tangent coordinates (the reference's vee order): 10 floats
    [rho(3) = v*dt, nu(3) = a*dt, theta(3) = w*dt, dt(1)]

Every scalar per point (t, the theta coefficients, a determinant) is kept
as a width-1 slice, never a 0-dim tensor: under ``torch.func.vmap(jacfwd)``
a 0-dim float32 tangent combined with a Python float is promoted to
float64 (see ``manifolds/quat.py``).

The coefficients of the Q/P rotation integrals are evaluated by their
Taylor series below theta^2 = 1e-2 (``_theta_coeffs``). The JAX package
switches at theta^2 = 1e-8 and evaluates the closed forms above, where they
cancel: in float32 c3 is exactly 0 from theta = 1e-3 to 2e-2, and the
float32 Jacobian of ``log`` is off by up to 1.09 (entries up to 2.0) at
theta = 2e-4, inside the band an IMU factor's residual rotation sits in.
The series holds float32 Jacobians to the float64 ones (held by
tests/test_torch_sgal3.py), so the solver keeps float32 Jacobians here as
for every other factor.
"""

from __future__ import annotations

import torch

from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.utils.math import matvec, skew3

GRAVITY = (0.0, 0.0, 9.81)  # the reference boxminus default (IMUDeltaFactor.jl:214)

# below this theta^2 the Q/P coefficients come from their Taylor series to
# theta^8 (truncation < 3e-19 at the switch, where the closed forms start to
# cancel; they keep no digit in float32 near theta = 1e-3)
SERIES_T2 = 1e-2
# c1 = (1 - cos t)/t^2, c2 = (t - sin t)/t^3, c3 = (cos t + t^2/2 - 1)/t^4:
# the coefficients of (t^2)^k are (-1)^k / (2k + 2)!, / (2k + 3)!, / (2k + 4)!
_C1 = (1 / 2, -1 / 24, 1 / 720, -1 / 40320, 1 / 3628800)
_C2 = (1 / 6, -1 / 120, 1 / 5040, -1 / 362880, 1 / 39916800)
_C3 = (1 / 24, -1 / 720, 1 / 40320, -1 / 3628800, 1 / 479001600)


def identity(dtype=torch.float64, device="cpu"):
    return torch.cat([Q.qidentity(dtype, device), torch.zeros(7, dtype=dtype, device=device)])


def _split(pt):
    return pt[..., :4], pt[..., 4:7], pt[..., 7:10], pt[..., 10:11]


def make_point(q, v, p, t):
    """(q, v, p) with the time ``t`` (a number or a tensor of q's batch
    shape, or of that shape plus a trailing 1) as one SGal(3) point."""
    if isinstance(t, torch.Tensor):
        t = t.to(q.dtype)
    else:
        t = torch.tensor(t, dtype=q.dtype, device=q.device)
    if t.dim() < q.dim():
        t = t[..., None]
    return torch.cat([q, v, p, t.expand(q[..., :1].shape)], dim=-1)


def compose(a, b):
    """(R,v,p,t) ∘ (r,w,s,u) = (Rr, v+Rw, p+v·u+Rs, t+u) (IMUDeltaFactor.jl:80-97)."""
    qa, va, pa, ta = _split(a)
    qb, vb, pb, tb = _split(b)
    q = Q.qmul(qa, qb)
    v = va + Q.qrotate(qa, vb)
    p = pa + va * tb + Q.qrotate(qa, pb)
    return torch.cat([q, v, p, ta + tb], dim=-1)


def inverse(a):
    """(Rᵀ, -Rᵀv, -Rᵀ(p - v t), -t) (IMUDeltaFactor.jl:66-78)."""
    q, v, p, t = _split(a)
    qi = Q.qconj(q)
    vi = -Q.qrotate(qi, v)
    pi = -Q.qrotate(qi, p - v * t)
    return torch.cat([qi, vi, pi, -t], dim=-1)


def _horner(coefs, t2):
    out = torch.full_like(t2, coefs[-1])
    for c in coefs[-2::-1]:
        out = out * t2 + c
    return out


def _theta_coeffs(theta_vec):
    """The scalar coefficients of the Q/P rotation integrals, (..., 1) each:

    Q = I + c1·thx + c2·thx²   with c1 = (1-cosθ)/θ², c2 = (θ-sinθ)/θ³
    P = I/2 + c2·thx + c3·thx² with c3 = (cosθ+θ²/2-1)/θ⁴
    (IMUDeltaFactor.jl:123-149), by series below θ² = SERIES_T2. Both
    branches stay finite everywhere."""
    t2 = torch.sum(theta_vec * theta_vec, dim=-1, keepdim=True)
    small = t2 < SERIES_T2
    # the closed forms, evaluated at theta >= 0.1 only (clamped below it),
    # with 1 - cos t = 2 sin^2(t/2): c3's numerator then cancels against
    # t^2/2 instead of 1 (at theta = 0.1: 5e-15 absolute in float64, where
    # the cos form loses 1.4e-12)
    tc2 = torch.clamp(t2, min=SERIES_T2)
    t = torch.sqrt(tc2)
    h = torch.sin(0.5 * t)
    one_m_cos = 2.0 * h * h
    c1 = torch.where(small, _horner(_C1, t2), one_m_cos / tc2)
    c2 = torch.where(small, _horner(_C2, t2), (t - torch.sin(t)) / (tc2 * t))
    c3 = torch.where(small, _horner(_C3, t2), (0.5 * tc2 - one_m_cos) / (tc2 * tc2))
    return c1, c2, c3


skew = skew3


def _QP_mats(theta_vec):
    c1, c2, c3 = (c[..., None] for c in _theta_coeffs(theta_vec))
    thx = skew(theta_vec)
    thx2 = thx @ thx
    eye = torch.eye(3, dtype=theta_vec.dtype, device=theta_vec.device)
    Qm = eye + c1 * thx + c2 * thx2
    Pm = 0.5 * eye + c2 * thx + c3 * thx2
    return Qm, Pm


def _inv3(A):
    """Closed-form 3x3 inverse (adjugate / det), batched over leading dims."""
    a, b, c = A[..., 0, 0:1], A[..., 0, 1:2], A[..., 0, 2:3]
    d, e, f = A[..., 1, 0:1], A[..., 1, 1:2], A[..., 1, 2:3]
    g, h, i = A[..., 2, 0:1], A[..., 2, 1:2], A[..., 2, 2:3]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.cat([A11, A12, A13, A21, A22, A23, A31, A32, A33], dim=-1)
    return adj.reshape(*adj.shape[:-1], 3, 3) / det[..., None]


def exp(xc):
    """Tangent coords [rho, nu, theta, dt] -> group point (IMUDeltaFactor.jl:153-175).

    R = Exp(theta); v = Q·nu; p = Q·rho + P·nu·dt; t = dt.
    """
    rho, nu, theta, dt = xc[..., 0:3], xc[..., 3:6], xc[..., 6:9], xc[..., 9:10]
    Qm, Pm = _QP_mats(theta)
    v = matvec(Qm, nu)
    p = matvec(Qm, rho) + dt * matvec(Pm, nu)
    return torch.cat([Q.qexp(theta), v, p, dt], dim=-1)


def log(pt):
    """Group point -> tangent coords [rho, nu, theta, dt] (IMUDeltaFactor.jl:184-203).

    nu = Q⁻¹ v; rho = Q⁻¹ (p - P·nu·t); dt = t.
    """
    q, v, p, t = _split(pt)
    theta = Q.qlog(q)
    Qm, Pm = _QP_mats(theta)
    iQ = _inv3(Qm)
    nu = matvec(iQ, v)
    rho = matvec(iQ, p - t * matvec(Pm, nu))
    return torch.cat([rho, nu, theta, t], dim=-1)


def boxminus(p, q, gravity=GRAVITY):
    """Gravity-compensated expected delta from p to q (IMUDeltaFactor.jl:214-237).

    ΔR = Rᵢᵀ Rⱼ;  Δv = Rᵢᵀ (vⱼ - vᵢ + g Δt);  Δp = Rᵢᵀ (pⱼ - pᵢ - vᵢ Δt + ½ g Δt²).
    """
    qi, vi, pi, ti = _split(p)
    qj, vj, pj, tj = _split(q)
    if isinstance(gravity, torch.Tensor):
        g = gravity.to(p.dtype)
    else:
        g = torch.tensor(gravity, dtype=p.dtype, device=p.device)
    dt = tj - ti
    qiT = Q.qconj(qi)
    dq = Q.qmul(qiT, qj)
    dv = Q.qrotate(qiT, vj - vi + g * dt)
    dp = Q.qrotate(qiT, pj - pi - vi * dt + 0.5 * g * (dt * dt))
    return torch.cat([dq, dv, dp, dt], dim=-1)


def adjoint_matrix(xc):
    """Small adjoint ad(X), (…,10,10), coords [rho, nu, theta, dt]
    (IMUDeltaFactor.jl:240-260)."""
    rho, nu, theta, dt = xc[..., 0:3], xc[..., 3:6], xc[..., 6:9], xc[..., 9:10]
    thx = skew(theta)
    z33 = torch.zeros_like(thx)
    z31 = torch.zeros_like(nu[..., None])
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device)
    row0 = torch.cat([thx, -dt[..., None] * eye, skew(rho), nu[..., None]], dim=-1)
    row1 = torch.cat([z33, thx, skew(nu), z31], dim=-1)
    row2 = torch.cat([z33, z33, thx, z31], dim=-1)
    return torch.cat([row0, row1, row2, torch.zeros_like(row0[..., :1, :])], dim=-2)


def Adjoint_matrix(pt):
    """Big adjoint Ad(p), (…,10,10) (IMUDeltaFactor.jl:263-282)."""
    q, v, p, t = _split(pt)
    R = Q.qto_matrix(q)
    z33 = torch.zeros_like(R)
    z31 = torch.zeros_like(v[..., None])
    row0 = torch.cat([R, -t[..., None] * R, skew(p - v * t) @ R, v[..., None]], dim=-1)
    row1 = torch.cat([z33, R, skew(v) @ R, z31], dim=-1)
    row2 = torch.cat([z33, z33, R, z31], dim=-1)
    last = torch.cat([torch.zeros_like(row0[..., :1, :9]), torch.ones_like(row0[..., :1, :1])],
                     dim=-1)
    return torch.cat([row0, row1, row2, last], dim=-2)


def right_jacobian(xc, order: int = 5):
    """Truncated-series right Jacobian Jr = Σ (-ad)^i / (i+1)!
    (IMUDeltaFactor.jl:286-291)."""
    nad = -adjoint_matrix(xc)
    eye = torch.eye(10, dtype=xc.dtype, device=xc.device).expand(nad.shape)
    out = eye
    term = eye
    fact = 1.0
    for i in range(1, order + 1):
        term = term @ nad
        fact *= i + 1
        out = out + term / fact
    return out
