"""What decides ``correct`` for a nonparametric solve: the beliefs a solve
wrote back, held variable by variable to the pooled beliefs of M solves of
the float64 reference (``benchmark.nonparametric_reference``) with seeds of
their own. A particle solve is random, so it is judged as a sample of the
reference's distribution, never value by value.

Per solvable variable, in the tangent at the pooled reference particles'
mean mu_ref, whitened by the inverse Cholesky factor W of their covariance
(W^T W = Sigma_ref^-1):

- ``z`` = n * |W (mean of the answer's particles - mean of the reference's)|^2
  / (2 * dof), n the answer's particle count: 1/2 on average for n particles
  drawn independently from the reference's distribution, more for a solve's
  (its particles share the solve's draws, so its mean wanders further), and
  n * the squared offset in units of the reference's spread more for an
  answer whose mean is off;
- ``kl``: the symmetric k-nearest-neighbour estimate of the Kullback-Leibler
  divergence between the answer's particles and the pooled reference's,
  0.5 * (KL(P || Q) + KL(Q || P)), each by Wang, Kulkarni and Verdu (IEEE
  Trans. Inf. Theory 55(5), 2009): KL(P || Q) ~ (d / n) * sum_i log(nu_k(i)
  / rho_k(i)) + log(m / (n - 1)), with rho_k(i) the k-th neighbour of
  sample i of P among P's others and nu_k(i) among Q's m samples. Distances
  are floored at 1e-12, so equal particles read as a large divergence, not
  an infinite one.

Readings over the variables: ``belief_mean_z`` (the mean of z),
``belief_mean_z_max`` (the largest z: one variable far off),
``belief_knn_kl`` (the mean of kl), and ``nonfinite_particles`` (particles
with a non-finite coordinate, or of the wrong shape, limit 0). The answers
judged (the last requests of a run, each a solve of its own seed) are
pooled per variable, as the reference's solves are: z and kl then compare
two mixtures of solves, and an offset common to the answers counts once
for every particle of theirs.

Plain numpy (and scipy's k-d tree for the neighbours); the tangent maps
are SE(2)'s and T(2)'s, written here.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.spatial import cKDTree

DOF = {"Pose2": 3, "Point2": 2}
DIST_FLOOR = 1e-12


def _wrap(a):
    return np.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def local(kind, p, q):
    """Tangent coordinates of points q relative to p (SE(2): body frame,
    angle wrapped; T(2): the difference)."""
    if kind == "Point2":
        return q - p
    c, s = np.cos(p[..., 2]), np.sin(p[..., 2])
    dx, dy = q[..., 0] - p[..., 0], q[..., 1] - p[..., 1]
    return np.stack([c * dx + s * dy, c * dy - s * dx, _wrap(q[..., 2] - p[..., 2])], axis=-1)


def boxplus(kind, p, xi):
    if kind == "Point2":
        return p + xi
    c, s = np.cos(p[..., 2]), np.sin(p[..., 2])
    return np.stack([p[..., 0] + c * xi[..., 0] - s * xi[..., 1],
                     p[..., 1] + s * xi[..., 0] + c * xi[..., 1],
                     _wrap(p[..., 2] + xi[..., 2])], axis=-1)


def mean_point(kind, pts, iters=10):
    """Mean of points (n, point_dim): from the first, ``iters`` steps of
    mu <- mu ⊞ mean(local(mu, p))."""
    mu = pts[0]
    for _ in range(iters):
        mu = boxplus(kind, mu, local(kind, mu, pts).mean(axis=0))
    return mu


def knn_kl(P, Q, k=1):
    """KL(P || Q) from samples P (n, d), Q (m, d), Wang-Kulkarni-Verdu
    (neighbour distances by k-d trees)."""
    n, m, dim = P.shape[0], Q.shape[0], P.shape[1]
    rho = cKDTree(P).query(P, k=[k + 1])[0][:, 0]     # the first is the point itself
    nu = cKDTree(Q).query(P, k=[k])[0][:, 0]
    rho, nu = np.maximum(rho, DIST_FLOOR), np.maximum(nu, DIST_FLOOR)
    return dim / n * float(np.sum(np.log(nu / rho))) + math.log(m / (n - 1.0))


def variable_stats(kind, answer, pooled, k=1):
    """(z, kl) of one variable: ``answer`` (n, point_dim) particles,
    ``pooled`` (m, point_dim) reference particles."""
    mu = mean_point(kind, pooled)
    Xr, Xa = local(kind, mu, pooled), local(kind, mu, answer)
    W = np.linalg.inv(np.linalg.cholesky(np.cov(Xr, rowvar=False, bias=True)))
    Yr, Ya = Xr @ W.T, Xa @ W.T
    dof = Xr.shape[1]
    z = answer.shape[0] * float(np.sum((Ya.mean(0) - Yr.mean(0)) ** 2)) / (2.0 * dof)
    kl = 0.5 * (knn_kl(Ya, Yr, k) + knn_kl(Yr, Ya, k))
    return z, kl


def answer_readings(answers, pooled, kinds, N, k=1):
    """Readings of ``answers`` (a list of {label: (N, point_dim)}), their
    particles pooled per variable, against ``pooled`` ({label: (M * N,
    point_dim)}): belief_mean_z, belief_mean_z_max, belief_knn_kl,
    nonfinite_particles."""
    zs, kls, bad = [], [], 0
    for label, ref in pooled.items():
        kind = kinds[label]
        parts = [np.asarray(a.get(label, np.zeros((0, 0))), dtype=np.float64) for a in answers]
        shaped = [p for p in parts if p.shape == (N, DOF[kind])]
        bad += N * (len(parts) - len(shaped))
        if not shaped:
            continue
        a = np.concatenate(shaped)
        finite = np.isfinite(a).all(axis=1)
        bad += int(np.sum(~finite))
        if not finite.all():
            continue
        z, kl = variable_stats(kind, a, np.asarray(ref, dtype=np.float64), k)
        zs.append(z)
        kls.append(kl)
    nan = float("nan")
    ok = bool(zs) and bad == 0
    return {"belief_mean_z": float(np.mean(zs)) if ok else nan,
            "belief_mean_z_max": float(np.max(zs)) if ok else nan,
            "belief_knn_kl": float(np.mean(kls)) if ok else nan,
            "nonfinite_particles": float(bad)}


def readings(answers, pooled, kinds, N, gates, k=1):
    """Readings ``{name: (value, limit)}`` of ``answers`` (a list of {label:
    (N, point_dim)}) pooled, against the pooled reference; ``gates`` maps
    each reading's name to {"limit": ...}."""
    return {name: (v, float(gates[name]["limit"]))
            for name, v in answer_readings(answers, pooled, kinds, N, k).items()}


def pool(reference):
    """{label: (M, N, point_dim)} reference beliefs -> {label: (M * N, point_dim)}."""
    return {label: np.asarray(b, dtype=np.float64).reshape(-1, np.shape(b)[-1])
            for label, b in reference.items()}
