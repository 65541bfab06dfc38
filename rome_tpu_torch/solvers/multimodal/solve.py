"""Nonparametric multimodal solve (counterpart of
``rome_tpu/solvers/multimodal/solve.py``): the particle graph init, the
per-variable belief prediction, the per-factor ``engine="loop"`` and the
entry point that routes to the batched engine or the Bayes tree.

Beliefs on the records are float32 numpy ``(N, point_dim)`` arrays; the
work runs on the ``device`` the caller names, with draws from one
``torch.Generator`` seeded by ``seed``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.solvers.multimodal.batched import (
    BatchedNonparametricSolver,
    set_points_from_beliefs,
)
from rome_tpu_torch.solvers.multimodal.convolve import DTYPE, approx_conv
from rome_tpu_torch.solvers.multimodal.kde import ManifoldKernelDensity, gibbs_product
from rome_tpu_torch.utils.device import entry_device
from rome_tpu_torch.utils.profiling import annotate


def _generator(gen, device, seed):
    return gen if gen is not None else torch.Generator(device=device).manual_seed(int(seed))


def init_variable_belief(fg: FactorGraph, label: str, particles, solve_key: str = "default"):
    """Store (N, point_dim) particles (a tensor or an array) as the belief."""
    rec = fg.variables[str(label)]
    if isinstance(particles, torch.Tensor):
        particles = particles.detach().to(DTYPE).cpu().numpy()
    rec.beliefs[solve_key] = np.asarray(particles)
    rec.initialized[solve_key] = True
    return rec


def init_all_beliefs(
    fg: FactorGraph,
    solve_key: str = "default",
    N: Optional[int] = None,
    gen: Optional[torch.Generator] = None,
    force: bool = False,
    device="cuda",
    seed: int = 42,
):
    """initAll! for particle beliefs: priors sample directly; relatives
    propagate through ``approx_conv`` once their neighbors are initialized
    (the graphinit ordering); leftovers seed at identity + noise."""
    entry_device(device)
    N = N or fg.params.N
    gen = _generator(gen, device, seed)
    if force:
        for rec in fg.variables.values():
            rec.beliefs.pop(solve_key, None)
            rec.initialized[solve_key] = False

    def ready(lbl):
        return solve_key in fg.variables[lbl].beliefs

    for _sweep in range(max(4, fg.num_factors)):
        progress = False
        for flabel in fg._fct_order:
            f = fg.factors[flabel]
            if f.solvable <= 0:
                continue
            for k, v in enumerate(f.variables):
                if ready(v):
                    continue
                others = [u for j, u in enumerate(f.variables) if j != k]
                if others and not all(ready(u) for u in others):
                    continue
                pts = approx_conv(fg, flabel, v, solve_key, gen=gen, N=N,
                                  skip_hypo=True, device=device)
                init_variable_belief(fg, v, pts, solve_key)
                progress = True
        if not progress:
            break

    for label, rec in fg.variables.items():
        if solve_key not in rec.beliefs:
            man = rec.manifold
            eps = torch.randn((N, man.dof), generator=gen, dtype=DTYPE, device=device)
            ident = man.identity(DTYPE, device).expand(N, man.point_dim)
            init_variable_belief(fg, label, man.normalize(man.boxplus(ident, eps)), solve_key)
    return fg


def predict_belief(
    fg: FactorGraph,
    label: str,
    factor_labels=None,
    solve_key: str = "default",
    gen: Optional[torch.Generator] = None,
    N: Optional[int] = None,
    device="cuda",
    seed: int = 0,
):
    """predictbelief: the Gibbs product of the ``approx_conv`` messages from
    the given (default: all) adjacent factors, as an (N, point_dim) tensor on
    ``device``; the current belief when no factor sends one (None when there
    is none)."""
    entry_device(device)
    label = str(label)
    N = N or fg.params.N
    gen = _generator(gen, device, seed)
    rec = fg.variables[label]
    flabels = [
        fl for fl in (factor_labels or fg._adj[label]) if fg.factors[fl].solvable > 0
    ]
    msgs = [approx_conv(fg, fl, label, solve_key, gen=gen, N=N, device=device)
            for fl in flabels]
    if not msgs:
        bel = rec.beliefs.get(solve_key)
        return None if bel is None else torch.as_tensor(np.asarray(bel), device=device)
    if len(msgs) == 1:
        return msgs[0]
    densities = [ManifoldKernelDensity.from_points(rec.manifold, m) for m in msgs]
    return gibbs_product(gen, densities, n_out=N)


def solve_graph_nonparametric(
    fg: FactorGraph,
    solve_key: str = "default",
    sweeps: int = 3,
    N: Optional[int] = None,
    seed: int = 2024,
    init=True,
    engine: str = "batched",
    device="cuda",
):
    """Batch nonparametric solve on ``device`` (the card unless the caller
    passes ``device="cpu"``); beliefs land in
    ``rec.beliefs[solve_key]`` and their means in ``rec.points[solve_key]``.

    ``engine="batched"`` (default): the batched engine. ``init=True`` runs
    the particle graph init, three Gauss-Seidel passes and ``sweeps`` Jacobi
    sweeps; ``init="points"`` seeds every belief from the closed-form graph
    init plus kernel noise; ``init=False`` starts from the beliefs on the
    records. ``engine="loop"``: the per-variable host loop of
    ``predict_belief`` (the reference-shaped cross-check).
    ``SolverParams.treeinit`` routes the solve through the Bayes tree.
    ``seed`` seeds the solve's ``torch.Generator``. The call is one
    ``np.solve`` span (``utils/profiling``).
    """
    if engine not in ("batched", "loop"):
        raise ValueError(f"unknown engine {engine!r}")
    if init not in (True, False, "points"):
        raise ValueError(f"unknown init {init!r}")
    entry_device(device)
    with annotate("np.solve"):
        return _solve(fg, solve_key, sweeps, N, seed, init, engine, device)


def _solve(fg, solve_key, sweeps, N, seed, init, engine, device):
    if fg.params.treeinit:
        from rome_tpu_torch.solvers.multimodal.tree import solve_tree

        solve_tree(fg, solve_key=solve_key, N=N, seed=seed, init=init, device=device)
        return fg
    if engine == "batched":
        with annotate("np.lower"):
            solver = BatchedNonparametricSolver(fg, solve_key, N=N, device=device)
        return solver.solve(sweeps=sweeps, seed=seed, init=init)

    N = N or fg.params.N
    gen = _generator(None, device, seed)
    if init:
        init_all_beliefs(fg, solve_key, N=N, gen=gen, device=device)
    for _ in range(sweeps):
        for label in fg._var_order:
            rec = fg.variables[label]
            if rec.solvable <= 0 or rec.marginalized:
                continue
            pts = predict_belief(fg, label, solve_key=solve_key, gen=gen, N=N, device=device)
            if pts is not None:
                init_variable_belief(fg, label, pts, solve_key)
    set_points_from_beliefs(
        fg, [l for l, r in fg.variables.items() if solve_key in r.beliefs], solve_key, device
    )
    return fg


# reference-style aliases
solveTree = solve_graph_nonparametric
solveGraph = solve_graph_nonparametric
predictbelief = predict_belief
initAll = init_all_beliefs
