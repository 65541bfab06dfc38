"""Graph builders that take the package module (``rome_tpu`` or
``rome_tpu_torch``), so both sides build the same graph from the same numpy
seed. The module imports neither jax nor the JAX package: jax-free test
files (run on the card with ``pytest --noconftest``) use it too."""

import copy

import numpy as np


def grid_graph(mod, rows=6, cols=6, seed=0, frozen=()):
    """A 2D grid pose graph (odometry chain + cross links + x0 prior), as
    tests/test_ndchol.py builds it; ``mod`` is either package."""
    rng = np.random.default_rng(seed)
    fg = mod.FactorGraph()
    n = rows * cols
    for i in range(n):
        fg.add_variable(f"x{i}", mod.Pose2)
    fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))

    def noisy(dx, dy, dth):
        return mod.MvNormal(
            [dx + rng.normal(0, 0.02), dy + rng.normal(0, 0.02),
             dth + rng.normal(0, 0.01)],
            [0.1, 0.1, 0.05],
        )

    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                fg.add_factor([f"x{i}", f"x{i+1}"], mod.Pose2Pose2(noisy(1, 0, 0)))
            if r + 1 < rows:
                fg.add_factor([f"x{i}", f"x{i+cols}"], mod.Pose2Pose2(noisy(0, 1, 0)))
    fg.init_all()
    for lbl in frozen:
        fg.variables[lbl].solvable = 0
    return fg


def reordered_graph(mod, src, order):
    """The graph ``src`` with its variables created in ``order`` (indices
    into src's variable order) and the same factors: other slots, so another
    connectivity of the same structure."""
    fg = mod.FactorGraph()
    labels = src._var_order
    for i in order:
        fg.add_variable(labels[i], src.variables[labels[i]].vtype)
    for fl in src._fct_order:
        f = src.factors[fl]
        fg.add_factor(list(f.variables), copy.copy(f), label=fl, graphinit=False)
    fg.init_all()
    return fg
