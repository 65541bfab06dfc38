"""Rank functions of the port's distributed tests
(tests/test_torch_{sharding,varpart,multimodal_sharded,distributed}.py).

Spawned ranks import this module by name, so it imports neither jax nor
rome_tpu: graphs cross as numpy arrays (``graph_arrays_to_numpy`` of either
package's lowered graph) and each rank builds the port's GraphArrays from
them on the CPU. Every rank function takes the rank's mesh first and returns
what the test compares, as numpy arrays and Python numbers.
"""

import numpy as np
import torch


def port_ga(spec, dtype=torch.float64):
    from rome_tpu_torch.graph.convert import graph_arrays_from_numpy

    return graph_arrays_from_numpy(**spec, dtype=dtype, device="cpu")


def _np(values):
    return {t: v.cpu().numpy() for t, v in values.items()}


def _launches():
    from rome_tpu_torch.ops import linearize_cuda as K
    from rome_tpu_torch.ops import pairwise_cuda as P

    return dict(P.LAUNCHES, **{f"k1_{k}": v for k, v in K.LAUNCHES.items()})


def sharding_rank(mesh, circle, chain):
    """One factor-sharded step on ``circle`` (lam 1e-6, PCG tol 1e-10) and
    the LM solve of ``chain`` (100 iterations at most), both in float64."""
    from rome_tpu_torch.parallel.sharding import make_sharded_gn_step, solve_distributed

    step, ga_p = make_sharded_gn_step(port_ga(circle), mesh, pcg_iters=100, pcg_tol=1e-10,
                                      device="cpu")
    v1, c0, c1, gn, ok = step(ga_p.values0, 1e-6)
    values, stats = solve_distributed(port_ga(chain), mesh, max_iters=100, pcg_iters=100,
                                      device="cpu")
    return dict(step=dict(values=_np(v1), c0=c0, c1=c1, gnorm=gn, ok=ok),
                solve=dict(stats, values=_np(values)), max_iters_1=solve_distributed(
                    port_ga(circle), mesh, max_iters=1, device="cpu")[1]["iterations"])


def varpart_rank(mesh, chain, cases):
    """Per (dtype name, ftol) of ``cases``: the owner-computes LM solve of
    ``chain`` (60 iterations at most) and the probes (this rank's gradient
    blocks, the start cost, one Schur step's gradient norm)."""
    from rome_tpu_torch.parallel.varpart import make_varpart_solver

    out = []
    for dtype, ftol in cases:
        solve, plan = make_varpart_solver(port_ga(chain, getattr(torch, dtype)), mesh,
                                          max_iters=60, ftol=ftol, device="cpu")
        probes = dict(lin_cost=float(solve.probe("lin_cost")[0]), grad=_np(solve.probe("grad")),
                      schur_full=float(solve.probe("schur_full")[0]))
        values, stats = solve(lam0=1e-4)
        out.append(dict(stats, values=_np(values), probes=probes,
                        bounds={t: plan.bounds[t].tolist() for t in plan.bounds}))
    return out


def multimodal_rank(mesh, N, seed, init):
    """The sharded nonparametric solve of the hexagonal graph; returns every
    belief and this rank's kernel launches."""
    from rome_tpu_torch.canonical.generators import generate_graph_hexagonal
    from rome_tpu_torch.parallel.multimodal import ShardedNonparametricSolver

    fg = generate_graph_hexagonal(N=N)
    before = _launches()
    ShardedNonparametricSolver(fg, mesh, N=N, device=mesh.device.type).solve(
        sweeps=3, seed=seed, init=init)
    after = _launches()
    return dict(beliefs={l: np.asarray(fg.variables[l].beliefs["default"]) for l in fg._var_order},
                launches={k: after[k] - before[k] for k in after})


def distributed_rank(mesh, dryrun):
    """``solve_graph_parametric`` with ``multiproc`` against
    ``solve_graph_distributed`` on the hexagonal graph; with ``dryrun``,
    also ``graft_entry.dryrun_multichip`` at this world size."""
    from rome_tpu_torch import generate_graph_hexagonal, solve_graph_parametric
    from rome_tpu_torch.graft_entry import dryrun_multichip
    from rome_tpu_torch.parallel.distributed import solve_graph_distributed

    fg1 = generate_graph_hexagonal()
    fg1.params.multiproc = True
    r1 = solve_graph_parametric(fg1, device="cpu")
    fg2 = generate_graph_hexagonal()
    fg2.init_all("parametric")
    r2 = solve_graph_distributed(fg2, device="cpu")
    pts = [{l: np.asarray(fg.variables[l].points["parametric"]) for l in fg._var_order}
           for fg in (fg1, fg2)]
    return dict(points=pts, stats=[r1["stats"], r2["stats"]], mesh=[r1.get("mesh"), r2["mesh"]],
                dryrun=dryrun_multichip(mesh.world, device="cpu") if dryrun else None)


def failing_rank(mesh):
    """Rank 1 raises before the collective every rank enters."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed")
    x = torch.ones(1)
    mesh.all_reduce(x)
    return float(x[0])
