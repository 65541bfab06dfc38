"""Nonparametric (multimodal) engine bench of the PyTorch port, every row
gated on accuracy: the port of tools/bench_multimodal.py.

Rows, at the JAX script's sizes unless the caller passes others:

- ``hexagonal_7pose``: the batched engine (first and steady solves) against
  the loop engine on the hexagonal graph (N = 100, ``init=True``), gated on
  the mean symmetric k-NN KL between the two engines' pose beliefs < 1.0;
- ``honeycomb_grow_default``: the default engine (graph init, Gauss-Seidel
  passes, Jacobi sweeps) re-solving the honeycomb grown 7 -> 14 -> 21 poses,
  mean landmark and pose errors against the parametric optimum < 4.0 m
  (testBeehiveGrow.jl:44-46);
- ``beehive_100pose``: ``init="points"`` on beehive-100 (seed 0), first and
  steady solves, mean pose error against the parametric optimum < 0.5 m;
- ``bayes_tree_grow``: ``solve_tree`` with clique recycling over the
  honeycomb grown 7 -> 14, at least one clique recycled at the regrow (its
  frontal beliefs and points bit-identical across the re-solve, reported)
  and the mean landmark error < 4.0 m;
- ``multihypo_range_bearing``: ``approx_conv`` toward x0 of the N = 400
  multihypo=[1, .5, .5] range-bearing graph, both modes' masses balanced;
- ``pose3_nullhypo``: ``approx_conv`` of the Pose3 nullhypo = 0.5 fixture,
  mass at the measurement in (0.25, 0.75) and spread mass > 0.15.

Each row also carries the launches it made of every kernel (K2 and K3 by
epilogue, K1 as ``k1_lin`` / ``k1_normal``), read from the wrappers'
counters before and after it; on the CPU the wrappers launch nothing and
every count is 0. The random draws are the port's own (torch generators),
so the rows match the JAX script's in distribution, not in value. The gates
roll up into ``gates`` and ``all_gates_pass``; the summary prints last.

    python tools/torch/bench_multimodal.py [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rome_tpu_torch import (  # noqa: E402
    FactorGraph, MvNormal, Normal, Point2, Pose2, Pose2Point2BearingRange, Pose3, Pose3Pose3,
    PriorPoint2, PriorPose2, PriorPose3, approx_conv, calc_cliques_recycled,
    generate_graph_beehive, generate_graph_hexagonal, generate_graph_honeycomb,
    init_all_beliefs, solve_graph_nonparametric, solve_graph_parametric, solve_tree,
)
from rome_tpu_torch.manifolds.base import SE2_  # noqa: E402
from rome_tpu_torch.solvers.multimodal.metrics import symmetric_kl_knn  # noqa: E402
from tools.torch.bench_kernels import device_label, launched_since, launches, require_device  # noqa: E402

N_PARTICLES, SWEEPS, CONV_N = 100, 3, 400
KL_GATE, BEEHIVE_GATE_M, GROW_GATE_M = 1.0, 0.5, 4.0
ROWS = ("hexagonal_7pose", "honeycomb_grow_default", "beehive_100pose", "bayes_tree_grow",
        "multihypo_range_bearing", "pose3_nullhypo")


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _solve(fg, engine, init=True, N=N_PARTICLES, device="cuda"):
    _sync(device)
    t0 = time.time()
    solve_graph_nonparametric(fg, sweeps=SWEEPS, N=N, engine=engine, init=init, device=device)
    _sync(device)
    return time.time() - t0


def _truth(fg, device):
    """The parametric optimum of a copy of ``fg`` (the accuracy anchor) and
    the launches its solve made."""
    fgp = copy.deepcopy(fg)
    fgp.init_all()
    before = launches()
    solve_graph_parametric(fgp, init=False, device=device)
    return fgp, launched_since(before)


def _mean_err(fg, fgp, pattern):
    """Per variable matching ``pattern`` with a default belief: the 2-D
    distance of its belief mean to the optimum. Returns the list."""
    errs = []
    for lbl in fg.ls(pattern):
        bel = fg.variables[lbl].beliefs.get("default")
        if bel is None:
            continue
        t = fgp.get_coords(lbl, "parametric")
        errs.append(float(np.linalg.norm(np.asarray(bel)[:, :2].mean(0) - t[:2])))
    return errs


def bench_hexagonal(device="cuda", N=N_PARTICLES, on_solve=None):
    """Batched (first, steady) against loop engine on the hexagonal graph.
    ``on_solve(engine, fg)`` sees each solved graph."""
    before = launches()
    times, graphs = {}, {}
    for tag, engine in (("batched_first", "batched"), ("batched_steady", "batched"),
                        ("loop", "loop")):
        fg = generate_graph_hexagonal(N=N)
        times[tag] = _solve(fg, engine, N=N, device=device)
        graphs[engine] = fg
        if on_solve is not None:
            on_solve(engine, fg)
    labels = graphs["batched"].ls(r"^x\d+$")
    kl = float(np.mean([
        symmetric_kl_knn(SE2_, torch.as_tensor(graphs["batched"].variables[l].beliefs["default"]),
                         torch.as_tensor(graphs["loop"].variables[l].beliefs["default"]))
        for l in labels]))
    return dict(
        batched_first_s=times["batched_first"],
        batched_steady_s=times["batched_steady"],
        loop_engine_s=times["loop"],
        speedup_steady_vs_loop=times["loop"] / max(times["batched_steady"], 1e-9),
        poses_per_sec=len(labels) / max(times["batched_steady"], 1e-9),
        mean_sym_kl_vs_loop=kl,
        accuracy_ok=bool(kl < KL_GATE),
        launches=launched_since(before),
    )


def bench_beehive(device="cuda", poses=100, N=N_PARTICLES, warm=1, on_solve=None, keep=None):
    """``init="points"`` on beehive-``poses``: a first solve and ``warm``
    steady ones, each of a fresh graph and each gated against the
    parametric optimum. ``on_solve(label, fg)`` sees each solved graph;
    ``keep``, a list, gets the last solved graph and the optimum's."""
    before = launches()
    fp = generate_graph_beehive(pose_count_target=poses, graphinit=False)
    fp.init_all()
    solve_graph_parametric(fp, init=False, device=device)
    truth_launches = launched_since(before)
    truth = {l: fp.get_coords(l, "parametric") for l in fp.ls(r"^x\d+$")}
    secs, errs = [], []
    for label in ["first"] + ["steady"] * warm:
        fg = generate_graph_beehive(pose_count_target=poses, graphinit=False)
        secs.append(_solve(fg, "batched", init="points", N=N, device=device))
        e = [float(np.linalg.norm(np.asarray(fg.variables[l].beliefs["default"])[:, :2].mean(0)
                                  - truth[l][:2])) for l in fg.ls(r"^x\d+$")]
        errs.append(float(np.mean(e)))
        if on_solve is not None:
            on_solve(label, fg)
    if keep is not None:
        keep[:] = [fg, fp]
    steady = min(secs[1:]) if warm else secs[0]
    return {
        "points_init": dict(
            batched_first_s=secs[0],
            batched_steady_s=steady,
            poses_per_sec=len(e) / max(steady, 1e-9),
            mean_pos_err_vs_parametric_m=errs[-1],
            err_by_run_m=errs,
            solve_s_by_run=secs,
            accuracy_ok=bool(max(errs) < BEEHIVE_GATE_M),
        ),
        "note": ("a single-shot solve from the closed-form point seeds (the production "
                 "configuration the incremental front end uses); the default engine's row is "
                 "honeycomb_grow_default"),
        "launches": launched_since(before),
        "truth_launches": truth_launches,
    }


def bench_honeycomb_grow(device="cuda", steps=(7, 14, 21), N=N_PARTICLES, on_step=None):
    """The default engine re-solving the honeycomb after each growth; the
    final graph's landmark and pose errors against the parametric optimum.
    ``on_step(poses, fg)`` sees the graph after each step's solve."""
    before = launches()
    fg, secs, by_step = None, [], []
    for target in steps:
        fg = generate_graph_honeycomb(pose_count_target=target, fg=fg, graphinit=True)
        b = launches()
        secs.append(_solve(fg, "batched", init=True, N=N, device=device))
        by_step.append(launched_since(b))
        if on_step is not None:
            on_step(target, fg)
    fgp, truth_launches = _truth(fg, device)
    el, ex = _mean_err(fg, fgp, r"^l\d+$"), _mean_err(fg, fgp, r"^x\d+$")
    lmean, xmean = float(np.mean(el)), float(np.mean(ex))
    return dict(
        workload=f"honeycomb grow {' -> '.join(map(str, steps))}, default engine each step",
        solve_s=secs,
        landmark_err_m=dict(mean=lmean, max=float(np.max(el)), n=len(el)),
        pose_err_m=dict(mean=xmean, max=float(np.max(ex)), n=len(ex)),
        reference_gate="testBeehiveGrow.jl:44-46 landmark atol 4-6 m",
        accuracy_ok=bool(lmean < GROW_GATE_M and xmean < GROW_GATE_M),
        launches=launched_since(before),
        launches_by_step=by_step,
        truth_launches=truth_launches,
    )


def bench_tree_grow(device="cuda", steps=(7, 14), N=N_PARTICLES, on_step=None):
    """``solve_tree`` with clique recycling over the honeycomb grow. Each
    step reports its cliques, the recycled ones, and whether every recycled
    clique's frontal beliefs and points kept their bits across the re-solve.
    ``on_step(poses, fg)`` sees the graph after each step's solve."""
    before = launches()
    fg, tree, rows = None, None, []
    for target in steps:
        fg = generate_graph_honeycomb(pose_count_target=target, fg=fg, graphinit=True)
        prior = {l: (np.array(r.beliefs["default"]), np.array(r.points["default"]))
                 for l, r in fg.variables.items()
                 if "default" in r.beliefs and "default" in r.points}
        _sync(device)
        t0 = time.time()
        tree = solve_tree(fg, old_tree=tree, N=N, device=device)
        _sync(device)
        total, recycled = calc_cliques_recycled(tree)
        kept = [v for c in tree.cliques if c.index not in tree.dirty for v in c.frontals
                if v in prior]
        same = all(np.array_equal(fg.variables[v].beliefs["default"], prior[v][0])
                   and np.array_equal(fg.variables[v].points["default"], prior[v][1])
                   for v in kept)
        rows.append(dict(poses=target, solve_s=time.time() - t0, cliques=total,
                         recycled=recycled, recycled_variables=len(kept),
                         recycled_bit_identical=bool(same), levels=len(tree.levels)))
        if on_step is not None:
            on_step(target, fg)
    fgp, truth_launches = _truth(fg, device)
    errs = _mean_err(fg, fgp, r"^l\d+$")
    mean_err = float(np.mean(errs)) if errs else float("nan")
    return dict(
        workload=f"honeycomb grow {' -> '.join(map(str, steps))}, solve_tree with recycling",
        steps=rows,
        recycled_at_regrow=rows[-1]["recycled"],
        landmark_err_mean_m=mean_err,
        landmark_err_max_m=float(np.max(errs)) if errs else float("nan"),
        accuracy_ok=bool(mean_err < GROW_GATE_M and rows[-1]["recycled"] >= 1),
        launches=launched_since(before),
        truth_launches=truth_launches,
    )


def multihypo_graph():
    """testMultimodalRangeBearing.jl:53-135's configuration
    (tools/bench_multimodal.py:254-271). Returns (graph, factor label)."""
    fg = FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", Pose2)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [4.0, 4.0, 4.0])), graphinit=True)
    fg.add_variable("l1", Point2)
    fg.add_variable("l2", Point2)
    fg.add_factor(["l1"], PriorPoint2(MvNormal([20.0, 5.0], [0.01, 0.01])))
    fg.add_factor(["l2"], PriorPoint2(MvNormal([20.0, -5.0], [0.01, 0.01])))
    f = fg.add_factor(["x0", "l1", "l2"],
                      Pose2Point2BearingRange(Normal(0.0, 0.01), Normal(20.0, 0.05)),
                      multihypo=[1.0, 0.5, 0.5])
    return fg, f.label


def _conv_twice(fg, flabel, target, N, device, seeds):
    """approx_conv toward ``target`` with each seed: (seconds, points) each."""
    out = []
    for seed in seeds:
        _sync(device)
        t0 = time.time()
        pts = approx_conv(fg, flabel, target, N=N, device=device, seed=seed).cpu().numpy()
        out.append((time.time() - t0, pts))
    return out


def bench_multihypo(device="cuda", N=CONV_N):
    """Mode masses of approx_conv toward x0 (first and steady calls)."""
    before = launches()
    fg, flabel = multihypo_graph()
    init_all_beliefs(fg, N=N, device=device)
    (t_first, _), (t_steady, pts) = _conv_twice(fg, flabel, "x0", N, device, (0, 3))
    r1 = np.abs(np.linalg.norm(pts[:, :2] - np.array([20.0, 5.0]), axis=1) - 20.0)
    r2 = np.abs(np.linalg.norm(pts[:, :2] - np.array([20.0, -5.0]), axis=1) - 20.0)
    m1 = float(np.mean((r1 < 1.0) & (r2 >= 1.0)))
    m2 = float(np.mean((r2 < 1.0) & (r1 >= 1.0)))
    balanced = m1 > 0.15 and m2 > 0.15 and 0.25 < m1 / (m1 + m2 + 1e-12) < 0.75
    return dict(
        config=f"MultimodalRangeBearing multihypo=[1,.5,.5], N={N}",
        first_s=t_first,
        steady_s=t_steady,
        mode_mass=[m1, m2],
        finite=bool(pts.shape == (N, 3) and np.isfinite(pts).all()),
        accuracy_ok=bool(balanced and np.isfinite(pts).all()),
        launches=launched_since(before),
    )


def nullhypo_graph(N=CONV_N):
    """testPose3Pose3NH.jl:118's fixture (tools/bench_multimodal.py:297-345):
    x0 anchored, a 10 m Pose3Pose3 to x1 with nullhypo = 0.5, and a wide
    belief of ``N`` particles on x1. Returns (graph, factor label)."""
    fg = FactorGraph()
    fg.add_variable("x0", Pose3)
    fg.add_factor(["x0"], PriorPose3(MvNormal(np.zeros(6), np.full(6, 1e-4))))
    fg.add_variable("x1", Pose3)
    f = fg.add_factor(["x0", "x1"], Pose3Pose3(MvNormal([10.0, 0, 0, 0, 0, 0], np.full(6, 1e-3))),
                      nullhypo=0.5, graphinit=False)
    rng = np.random.default_rng(5)
    wide = np.concatenate([rng.normal(0, 8.0, size=(N, 3)), np.tile([1.0, 0, 0, 0], (N, 1))],
                          axis=1)
    fg.variables["x1"].beliefs["default"] = wide.astype(np.float32)
    fg.variables["x1"].initialized["default"] = True
    return fg, f.label


def nullhypo_masses(pts):
    """(mass within 1 m of the measurement, mass beyond 3 m of it)."""
    d = np.linalg.norm(np.asarray(pts)[:, :3] - np.array([10.0, 0, 0]), axis=1)
    return float(np.mean(d < 1.0)), float(np.mean(d > 3.0))


def bench_nullhypo(device="cuda", N=CONV_N):
    """Null-hypothesis mass of approx_conv toward x1 (first and steady
    calls), each call gated."""
    before = launches()
    fg, flabel = nullhypo_graph(N)
    init_all_beliefs(fg, N=N, device=device)
    convs = _conv_twice(fg, flabel, "x1", N, device, (0, 4))
    at_meas, far = (list(m) for m in zip(*(nullhypo_masses(pts) for _t, pts in convs)))
    finite = all(pts.shape == (N, 7) and np.isfinite(pts).all() for _t, pts in convs)
    return dict(
        config=f"Pose3Pose3 nullhypo=0.5, N={N}",
        first_s=convs[0][0],
        steady_s=convs[1][0],
        mass_at_measurement=at_meas[-1],
        mass_spread=far[-1],
        mass_at_measurement_by_call=at_meas,
        mass_spread_by_call=far,
        finite=bool(finite),
        accuracy_ok=bool(finite and all(0.25 < a < 0.75 and f > 0.15
                                        for a, f in zip(at_meas, far))),
        launches=launched_since(before),
    )


def summarize(rows, card, N=N_PARTICLES):
    """tools/bench_multimodal.py:369-380: every row's gate, and their
    conjunction."""
    gates = {k: v["accuracy_ok"] if "accuracy_ok" in v else v["points_init"]["accuracy_ok"]
             for k, v in rows.items()}
    return dict(device=card, N=N, sweeps=SWEEPS, rows=rows, gates=gates,
                all_gates_pass=bool(all(gates.values())))


def run(device="cuda", card=None, sizes=None, echo=print):
    """Every row in the JAX script's order; ``sizes`` maps a row name to the
    keyword arguments of its function (the JAX sizes by default). Each row
    goes to ``echo`` as a JSON line when done. Returns the summary."""
    card = card or device_label(device)
    sizes = sizes or {}
    fns = dict(zip(ROWS, (bench_hexagonal, bench_honeycomb_grow, bench_beehive, bench_tree_grow,
                          bench_multihypo, bench_nullhypo)))
    rows = {}
    for name in ROWS:
        rows[name] = fns[name](device=device, **sizes.get(name, {}))
        echo(json.dumps(dict(rows[name], row=name, device=card)))
    return summarize(rows, card)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="also write the summary to this JSON file")
    args = ap.parse_args(argv)
    require_device(args.device, "bench_multimodal")
    doc = run(args.device, echo=lambda line: print(line, flush=True))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
