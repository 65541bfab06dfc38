"""The sphere world: a frozen copy of chip_smoke.py's ``sphere_truth``,
``sphere_edges`` and ``write_sphere_g2o``, the layout of g2o's
``create_sphere`` example (the Sphere2500 dataset of Kuemmerle et al., g2o,
ICRA 2011): ``laps`` laps of ``per_lap`` poses on a sphere, climbing from
pole to pole, odometry between consecutive poses and a closure from each
pose to the one a lap below.

One departure, for the benchmark: the structure and the noise are apart.
``structure`` gives the true poses and the edges (fixed by the layout);
``measurements(world, noise_seed)`` draws the edges' noise from
``numpy.random.default_rng(noise_seed)`` in chip_smoke's order (every
edge's translation, then every edge's rotation), so ``noise_seed=0`` gives
the measurements of chip_smoke's ``write_sphere_g2o(seed=0)``.
``dead_reckon`` chains the odometry from the true first pose (the initial
values the g2o file carries) and ``write_g2o`` writes the graph as g2o text.

Imports numpy and the plain reference's SE(3) functions
(``benchmark.se3_reference``): nothing of the solver under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark import se3_reference as R

LAPS, PER_LAP, RADIUS_M = 50, 50, 100.0
SIGMA_T, SIGMA_R = 0.05, 0.005


@dataclass
class World:
    """True poses (n, 7) as (t, w, x, y, z), edges ``i`` -> ``j`` (m,):
    odometry (k - 1, k) first, then closures (k - per_lap, k), and the
    measurement noise's standard deviations (per axis)."""

    poses: np.ndarray
    i: np.ndarray
    j: np.ndarray
    sigma_t: float = SIGMA_T
    sigma_r: float = SIGMA_R

    @property
    def n(self):
        return self.poses.shape[0]

    @property
    def sigmas(self):
        return [self.sigma_t] * 3 + [self.sigma_r] * 3


def truth(laps=LAPS, per_lap=PER_LAP, radius=RADIUS_M):
    """(laps * per_lap, 7) true poses: azimuth -pi + 2 pi n / per_lap and
    elevation -pi/2 + (i + 1) pi / N of pose i = lap * per_lap + n; each
    pose's x-axis along the direction of travel, its z-axis out of the
    sphere."""
    n_poses = laps * per_lap
    pos = np.empty((n_poses, 3))
    for i in range(n_poses):
        az = -np.pi + 2 * np.pi * (i % per_lap) / per_lap
        el = -0.5 * np.pi + (i + 1) * np.pi / n_poses
        pos[i] = radius * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el),
                                    -np.sin(el)])
    travel = np.empty_like(pos)
    travel[:-1] = pos[1:] - pos[:-1]
    travel[-1] = travel[-2]
    up = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    x = travel - np.sum(travel * up, axis=1, keepdims=True) * up
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(up, x)
    rot = np.stack([x, y, up], axis=-1)  # columns: x (travel), y, z (out)
    q = R.qfrom_matrix(torch.as_tensor(rot, dtype=R.F64)).numpy()
    return np.concatenate([pos, q], axis=1)


def edges(laps=LAPS, per_lap=PER_LAP):
    """Odometry (k - 1, k) for k >= 1, then closures (k - per_lap, k) for
    k >= per_lap: 2,499 + 2,450 = 4,949 edges at 50 x 50."""
    n = laps * per_lap
    return [(k - 1, k) for k in range(1, n)] + [(k - per_lap, k) for k in range(per_lap, n)]


def structure(laps=LAPS, per_lap=PER_LAP, radius_m=RADIUS_M, sigma_t=SIGMA_T,
              sigma_r=SIGMA_R):
    e = np.asarray(edges(laps, per_lap), dtype=np.int64)
    return World(truth(laps, per_lap, radius_m), e[:, 0].copy(), e[:, 1].copy(),
                 sigma_t, sigma_r)


def measurements(world: World, noise_seed):
    """(m, 7) edge means: the true relative pose, its translation moved by
    N(0, sigma_t^2) per axis and its rotation by Exp of N(0, sigma_r^2) per
    axis, the quaternion's w made non-negative and renormalised."""
    rng = np.random.default_rng(noise_seed)
    m = len(world.i)
    a = torch.as_tensor(world.poses[world.i])
    b = torch.as_tensor(world.poses[world.j])
    rel = R.compose(R.inverse(a), b)
    t = rel[:, :3] + torch.as_tensor(rng.normal(0, world.sigma_t, (m, 3)))
    q = R.qmul(rel[:, 3:], R.qexp(torch.as_tensor(rng.normal(0, world.sigma_r, (m, 3)))))
    q = torch.where(q[:, :1] < 0, -q, q)
    return torch.cat([t, R.qnormalize(q)], dim=1).numpy()


def dead_reckon(world: World, meas):
    """(n, 7): the true first pose, then each pose its predecessor composed
    with its odometry edge's mean (row k - 1 for pose k)."""
    out = [torch.as_tensor(world.poses[0])]
    for m in torch.as_tensor(meas[: world.n - 1]):
        out.append(R.compose(out[-1], m))
    return torch.stack(out).numpy()


def write_g2o(path, world: World, meas, init):
    """The graph as g2o text: a VERTEX_SE3:QUAT line per pose at ``init``,
    then an EDGE_SE3:QUAT line per edge (mean ``meas``, information
    diag(1/sigma_t^2 x 3, 1/sigma_r^2 x 3)); quaternions in the file's
    (qx, qy, qz, qw) order, every number written exactly (``repr``)."""
    info = np.diag([world.sigma_t ** -2] * 3 + [world.sigma_r ** -2] * 3)
    info_s = " ".join(repr(float(info[a, b])) for a in range(6) for b in range(a, 6))

    def qline(v):
        return " ".join(repr(float(x)) for x in (*v[:3], v[4], v[5], v[6], v[3]))

    with open(path, "w") as fh:
        for k, v in enumerate(np.asarray(init)):
            fh.write(f"VERTEX_SE3:QUAT {k} {qline(v)}\n")
        for a, b, m in zip(world.i, world.j, np.asarray(meas)):
            fh.write(f"EDGE_SE3:QUAT {a} {b} {qline(m)} {info_s}\n")


def problem(world: World, meas, prior_sigmas):
    """The reference's problem of the graph the program loads: every edge
    (mean (t, Log q) of ``meas``) and the PriorPose3 on x0 at the first
    pose's value."""
    m = torch.as_tensor(np.asarray(meas), dtype=R.F64)
    S = R.sqrt_info(world.sigmas).expand(len(world.i), 6, 6).clone()
    return R.Problem(n=world.n, i=torch.as_tensor(world.i), j=torch.as_tensor(world.j),
                     z=R.log(torch.cat([m[:, :3], R.qnormalize(m[:, 3:])], dim=1)), S=S,
                     prior_z=R.log(torch.as_tensor(world.poses[0], dtype=R.F64)),
                     prior_S=R.sqrt_info(prior_sigmas))
