"""Pose graphs of the citygrid world for the solver under test, built
through its public graph API (the program's side of the harness)."""

from __future__ import annotations

import numpy as np

from benchmark.world import World, se2_compose, wrap
from rome_tpu_torch import FactorGraph, MvNormal, Pose2, PriorPose2
from rome_tpu_torch.factors.pose2 import Pose2Pose2


def new_graph(dtype: str) -> FactorGraph:
    """An empty graph of float ``dtype`` with factor-graph initialisation
    off (every pose gets its value from the caller)."""
    fg = FactorGraph()
    fg.params.graphinit = False
    fg.params.dtype = dtype
    return fg


def add_poses(fg: FactorGraph, first: int, values):
    """Poses x{first}, x{first+1}, ... at ``values`` (k, 3)."""
    for k, v in enumerate(np.asarray(values, float)):
        label = f"x{first + k}"
        fg.add_variable(label, Pose2)
        fg.set_point(label, [v[0], v[1], wrap(v[2])])


def add_edges(fg: FactorGraph, world: World, z, rows):
    """The world's edges ``rows`` as Pose2Pose2 factors with means ``z``."""
    sig = world.sigmas
    for e in rows:
        fg.add_factor([f"x{world.i[e]}", f"x{world.j[e]}"],
                      Pose2Pose2(MvNormal(z[e], sig[e])), graphinit=False)


def add_prior(fg: FactorGraph, sigmas):
    """The PriorPose2 on x0 at the origin (bench.py:83-92)."""
    fg.add_factor(["x0"], PriorPose2(MvNormal([0.0, 0.0, 0.0], list(sigmas))), graphinit=False)


def build(world: World, z, n: int, values, dtype: str) -> FactorGraph:
    """The first ``n`` poses at ``values`` with every edge between them and
    the x0 prior."""
    fg = new_graph(dtype)
    add_poses(fg, 0, values[:n])
    add_prior(fg, world.prior_sigmas)
    add_edges(fg, world, z, np.flatnonzero(np.maximum(world.i, world.j) < n))
    return fg


def extend(fg: FactorGraph, world: World, z, first: int, stop: int):
    """Poses x{first}..x{stop-1} as a front end hands them over: each
    starts at its predecessor's current estimate composed with its odometry
    edge's mean (row p - 1), then its edges come in (the odometry edge,
    then the closures that end at it)."""
    later = np.maximum(world.i, world.j)
    for p in range(first, stop):
        prev = fg.variables[f"x{p - 1}"].points["parametric"]
        add_poses(fg, p, [se2_compose(prev, z[p - 1])])
        add_edges(fg, world, z, np.flatnonzero(later == p))


def points(fg: FactorGraph, first: int, stop: int):
    """References to the point arrays of x{first}..x{stop-1} (the solver
    writes new arrays, so the references keep this answer)."""
    return [fg.variables[f"x{k}"].points["parametric"] for k in range(first, stop)]
