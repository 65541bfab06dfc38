"""The benchmark's plain reference for SE(3) pose graphs: float64 PyTorch on
the CPU and a scipy ``splu`` Levenberg-Marquardt, as ``reference.py`` solves
SE(2).

Written from the published definitions that the port's manifolds follow
(rome_tpu_torch/manifolds/base.py, the JAX package's "hybrid" tangent):

- a pose is (t[3], q[4]), q a unit quaternion stored (w, x, y, z);
- compose (t_a + R_a t_b, q_a q_b), inverse (-R_a^T t_a, q_a^*);
- exp(v, w) = (v, Exp(w)), log(t, q) = (t, Log(q)), Exp and Log of SO(3)
  through the quaternion (Log the minimal rotation: |Log| <= pi);
- retraction p [+] d = compose(p, exp(d)), renormalised;
  local(p, q) = log(compose(inverse(p), q));
- Pose3Pose3 (RoME.jl Pose3Pose3.jl:17-29, the port's
  ``factors/pose3.py``): r = local(q, p o exp(z)); PriorPose3 (Pose3D.jl:
  9-19): r = local(p, exp(z)); whitened by S, S^T S = inverse covariance;
  cost 0.5 * sum |S r|^2.

Jacobians are analytic, with respect to each pose's body-frame perturbation
(d_t, d_w): for Pose3Pose3, with E = R_q^T R_p R_z and phi = Log(E),

    dr_t/dd_tp = R_q^T R_p,  dr_t/dd_wp = -R_q^T R_p [z_t]x,
    dr_w/dd_wp = Jr^-1(phi) R_z^T,
    dr_t/dd_tq = -I,  dr_t/dd_wq = [r_t]x,  dr_w/dd_wq = -Jl^-1(phi),

and for PriorPose3 the second pose's rows. Jr^-1 and Jl^-1 are SO(3)'s
right and left Jacobian inverses (Barfoot, State Estimation for Robotics,
7.1.5).

Departures, each a simplification the benchmark's graphs allow:

- every factor's weight is 1 (a g2o file carries none);
- the LM is ``reference.py``'s ``solve_lm`` (lambda from 1e-6, x 0.25 on an
  accepted step and x 8 on a rejected one, damping lambda * max(diag H,
  1e-8)) stopped at a relative cost change of 1e-12 or 20 rejections in a
  row, with a scipy ``splu`` of the damped normal equations (its default
  COLAMD order);
- ``round_to``: the control, every input and every pose it keeps rounded to
  bfloat16 (``reference.bf16``).

It runs on the CPU and touches no CUDA device; :func:`solve` still turns
TF32 off, so nothing it computes can take a lower precision. Imports torch,
numpy and scipy only: nothing of the solver under test and no JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

F64 = torch.float64
DOF = 6


# -- SO(3) through unit quaternions (w, x, y, z) -----------------------------

def qmul(a, b):
    """The Hamilton product a b."""
    aw, ax, ay, az = a[..., 0:1], a[..., 1:2], a[..., 2:3], a[..., 3:4]
    bw, bx, by, bz = b[..., 0:1], b[..., 1:2], b[..., 2:3], b[..., 3:4]
    return torch.cat([aw * bw - ax * bx - ay * by - az * bz,
                      aw * bx + ax * bw + ay * bz - az * by,
                      aw * by - ax * bz + ay * bw + az * bx,
                      aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def cross(a, b):
    a0, a1, a2 = a[..., 0:1], a[..., 1:2], a[..., 2:3]
    b0, b1, b2 = b[..., 0:1], b[..., 1:2], b[..., 2:3]
    return torch.cat([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qrotate(q, v):
    """R(q) v."""
    u, w = q[..., 1:], q[..., :1]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def qmatrix(q):
    """(..., 4) -> (..., 3, 3) rotation matrices."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def qexp(phi):
    """Exp of so(3) coordinates as a unit quaternion."""
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)
    small = theta < 1e-8
    safe = torch.where(small, torch.ones_like(theta), theta)
    k = torch.where(small, 0.5 - theta * theta / 48.0, torch.sin(0.5 * safe) / safe)
    return torch.cat([torch.cos(0.5 * theta), k * phi], dim=-1)


def qlog(q):
    """Log of a unit quaternion: the rotation vector of the minimal
    rotation (q and -q are one rotation)."""
    q = torch.where(q[..., :1] < 0.0, -q, q)
    w, u = q[..., :1], q[..., 1:]
    n = torch.linalg.norm(u, dim=-1, keepdim=True)
    small = n < 1e-8
    safe = torch.where(small, torch.ones_like(n), n)
    # 2 atan2(n, w) / n, and its series 2 / w (1 - n^2 / (3 w^2)) near 0
    k = torch.where(small, 2.0 / w * (1.0 - n * n / (3.0 * w * w)),
                    2.0 * torch.atan2(safe, w) / safe)
    return k * u


def qfrom_matrix(R):
    """Rotation matrices -> unit quaternions with w >= 0 (Shepperd's
    method: of the four constructions, the one of the largest pivot)."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    pivots = torch.stack([tr, m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                          -m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                          -m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1)
    s = torch.sqrt(torch.clamp(1.0 + pivots, min=1e-12)) / 2.0
    d21, d02, d10 = m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]
    s01, s02, s12 = m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1]
    cands = torch.stack([
        torch.stack([s[..., 0], d21 / (4 * s[..., 0]), d02 / (4 * s[..., 0]), d10 / (4 * s[..., 0])], -1),
        torch.stack([d21 / (4 * s[..., 1]), s[..., 1], s01 / (4 * s[..., 1]), s02 / (4 * s[..., 1])], -1),
        torch.stack([d02 / (4 * s[..., 2]), s01 / (4 * s[..., 2]), s[..., 2], s12 / (4 * s[..., 2])], -1),
        torch.stack([d10 / (4 * s[..., 3]), s02 / (4 * s[..., 3]), s12 / (4 * s[..., 3]), s[..., 3]], -1),
    ], -2)
    best = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return qnormalize(torch.where(q[..., :1] < 0.0, -q, q))


def hat(v):
    """(..., 3) -> (..., 3, 3) with hat(a) b = a x b."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1), torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def jr_inv(phi):
    """SO(3)'s right Jacobian inverse at ``phi``; its transpose is the left
    one's."""
    theta = torch.linalg.norm(phi, dim=-1)
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    c = torch.where(small, 1.0 / 12.0 + theta * theta / 720.0,
                    1.0 / safe ** 2 - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)))
    P = hat(phi)
    return torch.eye(3, dtype=phi.dtype) + 0.5 * P + c[..., None, None] * (P @ P)


# -- SE(3), hybrid tangent ------------------------------------------------------

def compose(a, b):
    return torch.cat([a[..., :3] + qrotate(a[..., 3:], b[..., :3]),
                      qmul(a[..., 3:], b[..., 3:])], dim=-1)


def inverse(a):
    qi = qconj(a[..., 3:])
    return torch.cat([-qrotate(qi, a[..., :3]), qi], dim=-1)


def exp(xi):
    return torch.cat([xi[..., :3], qexp(xi[..., 3:])], dim=-1)


def log(p):
    return torch.cat([p[..., :3], qlog(p[..., 3:])], dim=-1)


def local(p, q):
    return log(compose(inverse(p), q))


def retract(p, d):
    x = compose(p, exp(d))
    return torch.cat([x[..., :3], qnormalize(x[..., 3:])], dim=-1)


# -- the factors ------------------------------------------------------------------

def between_residual(z, p, q):
    """Pose3Pose3's raw residual local(q, p o exp(z))."""
    return local(q, compose(p, exp(z)))


def prior_residual(z, p):
    """PriorPose3's raw residual local(p, exp(z))."""
    return local(p, exp(z))


def sqrt_info(sigmas):
    """S of independent measurement axes of standard deviations ``sigmas``."""
    return torch.diag_embed(1.0 / torch.as_tensor(sigmas, dtype=F64))


@dataclass
class Problem:
    """A pose graph: Pose3Pose3 edges ``i`` -> ``j`` (m,) with means ``z``
    (m, 6) and whitening ``S`` (m, 6, 6), and a PriorPose3 on pose
    ``prior_pose`` with mean ``prior_z`` (6,) and whitening ``prior_S``."""

    n: int
    i: torch.Tensor
    j: torch.Tensor
    z: torch.Tensor
    S: torch.Tensor
    prior_z: torch.Tensor
    prior_S: torch.Tensor
    prior_pose: int = 0

    def rounded(self, rnd):
        return Problem(self.n, self.i, self.j, rnd(self.z), rnd(self.S), rnd(self.prior_z),
                       rnd(self.prior_S), self.prior_pose)


def residuals(prob: Problem, x):
    """Whitened residuals, (m + 1, 6): the edges', then the prior's."""
    r = torch.einsum("mab,mb->ma", prob.S, between_residual(prob.z, x[prob.i], x[prob.j]))
    rp = prob.prior_S @ prior_residual(prob.prior_z, x[prob.prior_pose])
    return torch.cat([r, rp[None]], dim=0)


def cost(prob: Problem, x):
    """0.5 * the sum of squared whitened residuals."""
    r = residuals(prob, torch.as_tensor(x, dtype=F64))
    return 0.5 * float(torch.sum(r * r))


def _between_jacobians(z, p, q):
    """(raw residual, d r / d p, d r / d q), each Jacobian (m, 6, 6)."""
    r = between_residual(z, p, q)
    Rp, Rq, Rz = qmatrix(p[:, 3:]), qmatrix(q[:, 3:]), qmatrix(qexp(z[:, 3:]))
    RqtRp = Rq.transpose(-1, -2) @ Rp
    Jr = jr_inv(r[:, 3:])
    m = r.shape[0]
    Jp = torch.zeros((m, 6, 6), dtype=F64)
    Jq = torch.zeros((m, 6, 6), dtype=F64)
    Jp[:, :3, :3] = RqtRp
    Jp[:, :3, 3:] = -RqtRp @ hat(z[:, :3])
    Jp[:, 3:, 3:] = Jr @ Rz.transpose(-1, -2)
    Jq[:, :3, :3] = -torch.eye(3, dtype=F64)
    Jq[:, :3, 3:] = hat(r[:, :3])
    Jq[:, 3:, 3:] = -Jr.transpose(-1, -2)
    return r, Jp, Jq


def _prior_jacobian(z, p):
    r = prior_residual(z, p)
    J = torch.zeros((6, 6), dtype=F64)
    J[:3, :3] = -torch.eye(3, dtype=F64)
    J[:3, 3:] = hat(r[:3])
    J[3:, 3:] = -jr_inv(r[3:]).T
    return r, J


def linearize(prob: Problem, x):
    """(whitened residual vector, sparse whitened Jacobian) at ``x`` (n, 7)."""
    r, Jp, Jq = _between_jacobians(prob.z, x[prob.i], x[prob.j])
    rp0, Jp0 = _prior_jacobian(prob.prior_z, x[prob.prior_pose])
    r = torch.einsum("mab,mb->ma", prob.S, r)
    Jp, Jq = prob.S @ Jp, prob.S @ Jq
    m = r.shape[0]
    a = torch.arange(6)
    rows = (6 * torch.arange(m)[:, None, None] + a[None, :, None]).expand(m, 6, 6)
    cols_p = (6 * prob.i[:, None, None] + a[None, None, :]).expand(m, 6, 6)
    cols_q = (6 * prob.j[:, None, None] + a[None, None, :]).expand(m, 6, 6)
    rows0 = (6 * m + a[:, None]).expand(6, 6)
    cols0 = (6 * prob.prior_pose + a[None, :]).expand(6, 6)
    vals = torch.cat([Jp.reshape(-1), Jq.reshape(-1), (prob.prior_S @ Jp0).reshape(-1)])
    J = sp.coo_matrix(
        (vals.numpy(), (torch.cat([rows.reshape(-1), rows.reshape(-1), rows0.reshape(-1)]).numpy(),
                        torch.cat([cols_p.reshape(-1), cols_q.reshape(-1),
                                   cols0.reshape(-1)]).numpy())),
        shape=(6 * (m + 1), 6 * prob.n)).tocsr()
    rvec = torch.cat([r.reshape(-1), prob.prior_S @ rp0]).numpy()
    return rvec, J


def _identity(a):
    return a


def solve(prob: Problem, x0, round_to=None, max_iters=200, ftol=1e-12, gtol=1e-8):
    """Levenberg-Marquardt from ``x0`` (n, 7). ``round_to`` (a function of a
    tensor) is applied to the inputs, the start and every iterate: the
    control. Returns (poses (n, 7) numpy, cost, iterations, converged)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rnd = round_to or _identity
    if round_to is not None:
        prob = prob.rounded(rnd)
    x = rnd(torch.as_tensor(np.asarray(x0), dtype=F64).clone())
    lam, cost_prev, n_rej, converged, it = 1e-6, np.inf, 0, False, 0
    lins = None
    for it in range(1, max_iters + 1):
        if lins is None:
            r, J = linearize(prob, x)
            lins = (0.5 * float(r @ r), J.T @ r, (J.T @ J).tocsc())
        cost0, g, H = lins
        if np.linalg.norm(g) < gtol:
            converged = True
            break
        Hd = (H + sp.diags(lam * np.maximum(H.diagonal(), 1e-8))).tocsc()
        try:
            d = spla.splu(Hd).solve(-g)
        except RuntimeError:
            lam = min(lam * 8.0, 1e12)
            continue
        xt = rnd(retract(x, torch.as_tensor(d, dtype=F64).reshape(-1, DOF)))
        cost1 = cost(prob, xt)
        if np.isfinite(cost1) and cost1 < cost0:
            x, lins, n_rej = xt, None, 0
            lam = max(lam * 0.25, 1e-12)
            if np.isfinite(cost_prev) and abs(cost_prev - cost1) <= ftol * max(1.0, abs(cost_prev)):
                converged = True
                break
            cost_prev = cost1
        else:
            lam = min(lam * 8.0, 1e12)
            n_rej += 1
            if n_rej >= 20:
                converged = True
                break
    return x.numpy(), cost(prob, x), it, converged


def bf16(a):
    """``a`` rounded to bfloat16 (to nearest even), as float64."""
    return torch.as_tensor(a, dtype=F64).to(torch.bfloat16).to(F64)


def ate(poses, ref):
    """RMSE of the positions of ``poses`` (n, >= 3) after the rigid motion
    (Kabsch, no scale) that best aligns them to ``ref``'s."""
    E, G = np.asarray(poses, float)[:, :3], np.asarray(ref, float)[:, :3]
    Ec, Gc = E - E.mean(0), G - G.mean(0)
    U, _s, Vt = np.linalg.svd(Gc.T @ Ec)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return float(np.sqrt(np.mean(np.sum((Ec @ (U @ D @ Vt).T - Gc) ** 2, axis=1))))
