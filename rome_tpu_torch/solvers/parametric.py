"""High-level parametric solve API (counterpart of
``rome_tpu/solvers/parametric.py``)."""

from __future__ import annotations

import logging
import time
from typing import Optional

import torch
import torch.distributed as dist

from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.graph.lower import lower, write_back
from rome_tpu_torch.solvers.gauss_newton import (
    GNOptions,
    ParametricSolver,
    marginal_covariances,
)
from rome_tpu_torch.solvers.linearize import runtime_state
from rome_tpu_torch.utils.device import entry_device
from rome_tpu_torch.utils.profiling import annotate

logger = logging.getLogger("rome_tpu_torch")


@annotate("solve")
def solve_graph_parametric(
    fg: FactorGraph,
    solve_key: str = "parametric",
    init: bool = True,
    options: Optional[GNOptions] = None,
    compute_covariances: bool = False,
    dtype=None,
    chordal_init: bool = True,
    pad: bool = False,
    schedule: str = "fused",
    device="cuda",
):
    """Batch nonlinear least-squares solve of the whole graph on ``device``
    (the card unless the caller passes ``device="cpu"``).

    Stacks every factor's (mean, sqrt-info) measurement, minimizes the
    whitened residual sum over the product manifold, writes the results to
    ``solve_key``, and with ``compute_covariances`` recovers per-variable
    marginal covariances (``result["covariances"]``, keyed by label). A
    graph with no unary factor gets its first variable frozen as the gauge
    anchor.

    ``schedule="fused"`` runs ``ParametricSolver.solve`` (for ndchol the
    speculative-accept loop as one device program, captured on the card),
    ``"host"`` runs ``solve_host``. With ``chordal_init`` a Pose2 graph of
    more than two poses is initialized by ``chordal_init_pose2`` first,
    unless ``schedule="fused"`` and the solver runs the chordal stages
    inside its program (``GNOptions.fused_chordal``, as the JAX package's
    fused_chordal); ``solve_time_s`` covers both. The solver comes from the
    structure cache
    (``ParametricSolver.cached``). With ``fg.params.multiproc`` set inside
    an initialized process group of more than one rank, every rank takes the
    factor-sharded distributed solve (``solve_graph_distributed``); otherwise
    the graph solves on its one device.

    Returns a result dict with stats, and covariances when requested.

    Recorded (``utils/profiling``) as a span ``solve`` with the children
    ``solve.lower``, ``solve.cache`` (the structure cache; a miss holds
    ``solver.build``), ``solve.plan`` (the connectivity's plans; a new one
    holds ``symbolic.build``), ``solve.run`` (the program's copy-in, replays
    and read, or the host loop) and ``solve.write_back``.
    """
    entry_device(device)
    if schedule not in ("fused", "host"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if dtype is None:
        dtype = torch.float64 if fg.params.dtype == "float64" else torch.float32
    if init:
        fg.init_all(solve_key)
    if fg.params.multiproc and dist.is_initialized() and dist.get_world_size() > 1:
        # SolverParams.multiproc: the factor-sharded solve over every rank
        from rome_tpu_torch.parallel.distributed import solve_graph_distributed

        return solve_graph_distributed(fg, solve_key=solve_key, device=device)

    with annotate("solve.lower"):
        ga = lower(fg, solve_key, dtype=dtype, pad=pad, device=device)

    # gauge: with no unary factor, freeze the first variable
    has_unary = any(b.ftype.arity == 1 for b in ga.batches)
    frozen_gauge = None
    if not has_unary:
        t0 = ga.type_names[0]
        ga.free[t0] = ga.free[t0].clone()
        ga.free[t0][0] = 0.0
        frozen_gauge = ga.var_labels[t0][0]
        logger.warning(
            "graph has no prior factor; freezing %s as gauge anchor", frozen_gauge
        )

    opts = options or GNOptions(
        max_iters=fg.params.max_iters,
        lam0=fg.params.lm_lambda0,
    )
    t0 = time.time()
    values0 = ga.values0
    # structure-cached solver; the graph's data rides in as its runtime_state
    with annotate("solve.cache"):
        solver = ParametricSolver.cached(ga, opts)
    fused = schedule == "fused"
    with annotate("solve.plan"):
        rt = solver.plans(runtime_state(ga), host=not fused)
    with annotate("solve.run"):
        if (chordal_init and "Pose2" in ga.counts and ga.counts["Pose2"] > 2
                and not (fused and solver.fuses_chordal)):
            from rome_tpu_torch.solvers.init2d import chordal_init_pose2

            values0 = chordal_init_pose2(ga, values0)
        run = solver.solve if fused else solver.solve_host
        values, stats = run(values0, rt=rt)
    dt = time.time() - t0

    with annotate("solve.write_back"):
        write_back(fg, ga, values, solve_key)

    result = {
        "stats": stats,
        "solve_time_s": dt,
        "num_variables": fg.num_variables,
        "num_factors": fg.num_factors,
        "linear_solver": solver.linear,
        "gauge_frozen": frozen_gauge,
    }
    if compute_covariances:
        covs = marginal_covariances(ga, values)
        out = {}
        for t in ga.type_names:
            arr = covs[t].to(torch.float64).cpu().numpy()
            for slot, label in enumerate(ga.var_labels[t]):
                out[label] = arr[slot]
        result["covariances"] = out
    return result


# reference-style alias
solveGraphParametric = solve_graph_parametric
