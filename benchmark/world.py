"""The citygrid world: a frozen copy of tools/gen_citygrid.py's generator.

A Manhattan-world pose graph in the manner of Olson et al. (ICRA 2006) at
10x metric scale: a grid random walk of 10 m blocks (straight 1-4 blocks,
then a turn of +-90 deg), one odometry edge per step and loop closures on
true-position revisits. The constants and the draws are the generator's.

One departure, for the benchmark: the random streams are split.
``structure(n, seed)`` consumes the generator's stream exactly as
``tools.gen_citygrid.generate(n, seed)`` does (trajectory, odometry noise,
closure acceptance, closure noise) and keeps the noise it drew as the base
noise. ``measurements(world, noise_seed)`` then gives the edges' means:
with ``noise_seed=None`` the base noise (so the edges equal ``generate``'s
exactly), otherwise a fresh draw from ``numpy.random.default_rng(noise_seed)``
(odometry edges first, then closures in their order). So graphs of one
structure seed share one connectivity and differ in their measurement noise.

Imports numpy only: the benchmark's reference reads this module.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

BLOCK = 10.0           # grid block length (m)
SIGMA_T = 0.15         # odometry translation noise (m)
SIGMA_R = 0.008        # odometry rotation noise (rad)
LC_SIGMA_T = 0.10      # loop-closure translation noise (m)
LC_SIGMA_R = 0.005
LC_RADIUS = 3.0        # true-position re-visit radius (m)
LC_MIN_SEP = 30        # minimum pose-index separation for a closure
LC_PROB = 0.85         # probability of adding an available closure
PRIOR_SIGMAS = (0.1, 0.1, 0.05)   # the PriorPose2 on x0 (bench.py:83-92)


def wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def se2_between(a, b):
    """Relative poses a^-1 * b as (..., 3) (dx, dy, dth) in a's frame."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy, wrap(b[..., 2] - a[..., 2])], axis=-1)


def se2_compose(a, b):
    """a o b of (..., 3) poses, the heading wrapped."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                     a[..., 1] + s * b[..., 0] + c * b[..., 1],
                     wrap(a[..., 2] + b[..., 2])], axis=-1)


@dataclass
class World:
    """A citygrid structure: true poses (n, 3), edges as index pairs
    ``i`` -> ``j`` (m,) with odometry edges first (``j = i + 1``, in order)
    then closures, ``closure`` (m,) bool, the noise the generator's own
    stream drew for them, ``base_noise`` (m, 3), the standard deviations of
    odometry and closure measurements and of the prior on x0."""

    poses: np.ndarray
    i: np.ndarray
    j: np.ndarray
    closure: np.ndarray
    base_noise: np.ndarray
    odo_sigmas: tuple = (SIGMA_T, SIGMA_T, SIGMA_R)
    lc_sigmas: tuple = (LC_SIGMA_T, LC_SIGMA_T, LC_SIGMA_R)
    prior_sigmas: tuple = PRIOR_SIGMAS

    @property
    def n(self):
        return self.poses.shape[0]

    @property
    def sigmas(self):
        """(m, 3) standard deviations of each edge's measurement."""
        return np.where(self.closure[:, None], self.lc_sigmas, self.odo_sigmas)

    def truncated(self, n):
        """The first ``n`` poses and the edges between them (the world a
        stream of ``n`` poses sees), in the same edge order."""
        keep = (self.i < n) & (self.j < n)
        return dataclasses.replace(self, poses=self.poses[:n].copy(), i=self.i[keep],
                                   j=self.j[keep], closure=self.closure[keep],
                                   base_noise=self.base_noise[keep])


def structure(n_poses=10_000, seed=7, block=BLOCK, sigma_t=SIGMA_T, sigma_r=SIGMA_R,
              lc_sigma_t=LC_SIGMA_T, lc_sigma_r=LC_SIGMA_R, lc_radius=LC_RADIUS,
              lc_min_sep=LC_MIN_SEP, lc_prob=LC_PROB, prior_sigmas=PRIOR_SIGMAS):
    """The generator's world for ``seed`` (tools/gen_citygrid.py's
    ``generate``, draw for draw, at its constants by default)."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_poses, 3))
    th = 0.0
    p = np.zeros(2)
    i = 1
    while i < n_poses:
        run = int(rng.integers(1, 5))
        for _ in range(run):
            if i >= n_poses:
                break
            p = p + block * np.array([np.cos(th), np.sin(th)])
            poses[i] = [p[0], p[1], th]
            i += 1
        th = wrap(th + rng.choice([-1.0, 1.0]) * np.pi / 2)

    # one draw of 3 per odometry edge, as the generator's loop makes them
    odo_sigmas = (sigma_t, sigma_t, sigma_r)
    lc_sigmas = (lc_sigma_t, lc_sigma_t, lc_sigma_r)
    odo_noise = rng.normal(0, odo_sigmas, size=(n_poses - 1, 3))
    ci, cj, c_noise = [], [], []
    cell = {}
    for j in range(n_poses):
        key = (round(poses[j, 0] / block), round(poses[j, 1] / block))
        for k in cell.get(key, []):
            if (
                j - k >= lc_min_sep
                and np.linalg.norm(poses[j, :2] - poses[k, :2]) < lc_radius
                and rng.random() < lc_prob
            ):
                ci.append(k)
                cj.append(j)
                c_noise.append(rng.normal(0, lc_sigmas))
        cell.setdefault(key, []).append(j)
    m_lc = len(ci)
    return World(
        poses=poses,
        i=np.concatenate([np.arange(n_poses - 1), np.asarray(ci, dtype=np.int64)]).astype(np.int64),
        j=np.concatenate([np.arange(1, n_poses), np.asarray(cj, dtype=np.int64)]).astype(np.int64),
        closure=np.concatenate([np.zeros(n_poses - 1, bool), np.ones(m_lc, bool)]),
        base_noise=np.concatenate([odo_noise, np.asarray(c_noise).reshape(m_lc, 3)]),
        odo_sigmas=odo_sigmas, lc_sigmas=lc_sigmas, prior_sigmas=tuple(prior_sigmas),
    )


def measurements(world: World, noise_seed=None):
    """(m, 3) edge means: the truth's relative poses plus the base noise
    (``noise_seed=None``) or a fresh draw from ``default_rng(noise_seed)``."""
    rel = se2_between(world.poses[world.i], world.poses[world.j])
    if noise_seed is None:
        noise = world.base_noise
    else:
        noise = np.random.default_rng(noise_seed).standard_normal(rel.shape) * world.sigmas
    return rel + noise


def dead_reckon(world: World, z, n=None):
    """Poses 0..n-1 chained from the origin along the odometry edges' means
    ``z``: a front end's initial values."""
    n = world.n if n is None else n
    out = np.zeros((n, 3))
    cur = np.zeros(3)
    odo = z[: world.n - 1]
    for k in range(1, n):
        cur = se2_compose(cur, odo[k - 1])
        out[k] = cur
    return out


def noise_seed(seed, *stream):
    """The seed of one graph's noise draw: the run's ``seed`` (any integer)
    and the stream's numbers, as a numpy SeedSequence entropy list."""
    return [int(seed) % 2**64, *(int(s) for s in stream)]
