"""Nonparametric multimodal solve (counterpart of
``rome_tpu/solvers/multimodal/solve.py``): the batched engine with the
points init."""

from __future__ import annotations

from typing import Optional

from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.solvers.multimodal.batched import (
    BatchedNonparametricSolver,
    _not_ported,
)


def init_all_beliefs(*args, **kwargs):
    """initAll! for particle beliefs (per-factor convolution chain)."""
    _not_ported("init_all_beliefs (the particle graph init)")


def predict_belief(*args, **kwargs):
    """predictbelief: the product of one variable's convolution messages."""
    _not_ported("predict_belief")


def solve_graph_nonparametric(
    fg: FactorGraph,
    solve_key: str = "default",
    sweeps: int = 3,
    N: Optional[int] = None,
    seed: int = 2024,
    init=True,
    engine: str = "batched",
    device="cpu",
):
    """Batch nonparametric solve on ``device``: belief init + ``sweeps``
    Jacobi sweeps of batched messages and Gibbs belief products.

    ``init="points"`` seeds every belief from the closed-form graph init
    plus kernel noise (the production configuration); ``init=False`` starts
    from the beliefs on the records. ``seed`` seeds the solve's
    ``torch.Generator``. Beliefs land in ``rec.beliefs[solve_key]`` and their
    means in ``rec.points[solve_key]``.
    """
    if fg.params.treeinit:
        _not_ported("the Bayes-tree solve (SolverParams.treeinit, solve_tree)")
    if engine == "loop":
        _not_ported('engine="loop"')
    if engine != "batched":
        raise ValueError(f"unknown engine {engine!r}")
    solver = BatchedNonparametricSolver(fg, solve_key, N=N, device=device)
    return solver.solve(sweeps=sweeps, seed=seed, init=init)


# reference-style aliases
solveTree = solve_graph_nonparametric
solveGraph = solve_graph_nonparametric
predictbelief = predict_belief
initAll = init_all_beliefs
