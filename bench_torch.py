"""Benchmark of the PyTorch port on one NVIDIA GPU: the port of bench.py.

    python bench_torch.py [--device cuda|cpu] [--out FILE]

Rows (stderr, one JSON object ``{"detail": ...}``), as bench.py's:

- ``manhattan3500`` and ``mit`` (ATE gate 0.1 m) and ``octagon`` (the
  ``small`` options): the reference datasets bench.py names, each solved
  only when its file exists, else ``{"absent": path}``;
- ``citygrid_10k``: data/citygrid.g2o (10,000 poses, 13,085 EDGE_SE2), ATE
  gate 1.0 m (10 % of its 10 m blocks, bench.py:292-303);
- ``covariance_recovery``: Takahashi selected inversion on the headline
  dataset at its g2o values, 32 sampled poses against an exact float64
  scipy ``splu`` solve of the same scaled, ridged system (bench.py:178-255);
- ``kernel_speed_of_light``: tools/torch/bench_kernels.py's K1 rows, in
  this process.

Each solved row: the g2o file into a FactorGraph with bench.py's x0
PriorPose2, chordal init, then Levenberg-Marquardt with the ``big`` options
(ndchol), once cold and three times warm, each on a freshly built graph;
``solve_time_s`` is the least warm ``solve_time_s`` (chordal init + LM, as
bench.py times it), every run's seconds and LM iterations are recorded. The
row's gate (``matched_ate``) is bench.py's: converged, SE(2)-aligned ATE <=
the gate against the float64 optimum in data/*_gt.npz, final cost <= 1.002 *
the optimum + 1e-3.

The last line (stdout) is bench.py's ``{"metric", "value", "unit",
"vs_baseline"}``. The headline is manhattan3500 when its file exists, else
citygrid_10k, and the metric's name says which. ``value`` is the headline's
poses/s, 0 unless ``matched_ate``. ``vs_baseline`` divides it by the poses/s
of tools/cpu_reference.py's float64 scipy LM (``chordal_init`` + ``solve_lm``,
timed as its ``main`` times them) run on this host's CPU in the same run;
the CPU's model is printed beside that time.

Every entry point runs on ``--device`` (the card by default); without a
CUDA device the script exits with code 2 unless ``--device cpu`` is given.
It writes a file only to ``--out``.
"""

from __future__ import annotations

import argparse
import ast
import copy
import json
import os
import platform
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from rome_tpu_torch import GNOptions, MvNormal, PriorPose2, load_g2o, solve_graph_parametric  # noqa: E402
from tools.torch import bench_kernels  # noqa: E402

CITYGRID = os.path.join(HERE, "data", "citygrid.g2o")
ATE_GATE_M = 0.1
CITYGRID_ATE_GATE_M = 1.0
# bench.py:72-77 and :78 (the octagon's)
BIG = dict(
    max_iters=40, linear="ndchol", polish_tol=5e-2, nd_leaf=32,
    polish_iters=60, lam0=1e-6, lam_down=0.1, lam_min=1e-12,
    chol_jitter=1e-7, dtol=0.0025, dtol_auto=True, ftol=1e-9,
    gtol=1e-8, fused_chordal=True,
)
SMALL = dict(max_iters=50, linear="dense", lam0=1e-4, ftol=1e-10)
WARM_RUNS = 3
COV_SAMPLES, COV_SEED, COV_REL_TOL = 32, 11, 1e-4


def reference_paths(bench=os.path.join(HERE, "bench.py")):
    """The reference datasets bench.py reads (its MANHATTAN, MIT and
    OCTAGON), from its source: {name: path}."""
    tree = ast.parse(open(bench).read())
    return {n.targets[0].id: n.value.value for n in tree.body
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
            and n.targets[0].id in ("MANHATTAN", "MIT", "OCTAGON")}


def datasets():
    """(row name, g2o path, ground-truth npz, options, ATE gate) in
    bench.py's order."""
    ref = reference_paths()
    data = os.path.join(HERE, "data")
    return [
        ("manhattan3500", ref["MANHATTAN"], os.path.join(data, "manhattan_gt.npz"), BIG,
         ATE_GATE_M),
        ("mit", ref["MIT"], os.path.join(data, "mit_gt.npz"), BIG, ATE_GATE_M),
        ("octagon", ref["OCTAGON"], os.path.join(data, "octagon_gt.npz"), SMALL, ATE_GATE_M),
        ("citygrid_10k", CITYGRID, os.path.join(data, "citygrid_gt.npz"), BIG,
         CITYGRID_ATE_GATE_M),
    ]


def build_graph(path):
    """bench.py:83-92: the g2o file with a PriorPose2 on x0, initialized."""
    fg = load_g2o(None, path)
    fg.add_factor(
        ["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])), graphinit=False
    )
    fg.init_all()
    return fg


def ate_values(poses, gt_poses):
    """ATE RMSE of (n, >= 2) positions after SE(2) alignment (Kabsch on the
    2-D positions) to the truth's."""
    E, G = np.asarray(poses)[:, :2], np.asarray(gt_poses)[:, :2]
    Ec, Gc = E - E.mean(0), G - G.mean(0)
    U, _s, Vt = np.linalg.svd(Gc.T @ Ec)
    R = U @ np.diag([1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    return float(np.sqrt(np.mean(np.sum((Ec @ R.T + G.mean(0) - G) ** 2, axis=1))))


def ate_rmse(fg, gt_poses):
    """bench.py's ``_ate_rmse``: the ATE RMSE of the poses x<i> after SE(2)
    alignment, and without it. Returns (aligned, raw)."""
    E, G = [], []
    for lbl in fg.ls(r"^x\d+$"):
        E.append(fg.get_coords(lbl, "parametric")[:2])
        G.append(gt_poses[int(lbl[1:])][:2])
    E, G = np.asarray(E), np.asarray(G)
    return ate_values(E, G), float(np.sqrt(np.mean(np.sum((E - G) ** 2, axis=1))))


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def solve_dataset(path, gt_file, opts, warm=True, ate_gate=ATE_GATE_M, device="cuda",
                  on_run=None):
    """bench.py's ``_solve_dataset`` on the port: one cold solve, then (with
    ``warm``) WARM_RUNS warm solves, each of a freshly built graph; the row
    reads the last solve's stats and graph, and records every solve's LM
    iterations and kernel launches. ``on_run(label, fg, res)`` sees every
    solve."""
    kw = dict(init=False, options=GNOptions(**opts), chordal_init=True, schedule="fused",
              device=device)
    runs, iterations, by_run = [], [], []
    for label in ["cold"] + ["warm"] * (WARM_RUNS if warm else 0):
        fg = build_graph(path)
        before = bench_kernels.launches()
        _sync(device)
        t0 = time.time()
        res = solve_graph_parametric(fg, **kw)
        _sync(device)
        if label == "cold":
            t_warm = time.time() - t0
        else:
            runs.append(res["solve_time_s"])
        iterations.append(res["stats"].iterations)
        by_run.append(bench_kernels.launched_since(before))
        if on_run is not None:
            on_run(label, fg, res)
    dt = min(runs) if runs else res["solve_time_s"]
    gt = np.load(gt_file)
    st = res["stats"]
    ate, ate_raw = ate_rmse(fg, gt["poses"])
    ref_cost = float(gt["final_cost"])
    matched = st.converged and ate <= ate_gate and st.final_cost <= ref_cost * 1.002 + 1e-3
    n_poses = len(fg.ls(r"^x\d+$"))
    return dict(
        n_poses=n_poses,
        n_factors=fg.num_factors,
        solve_time_s=dt,
        warm_runs_s=runs,
        warmup_time_s=t_warm,
        iterations=st.iterations,
        iterations_by_run=iterations,
        launches_by_run=by_run,
        converged=bool(st.converged),
        reason=st.reason,
        final_cost=float(st.final_cost),
        ref_cost=ref_cost,
        ate_rmse_m=ate,
        ate_raw_m=ate_raw,
        ate_gate_m=ate_gate,
        matched_ate=bool(matched),
        poses_per_sec=n_poses / dt,
    )


def cpu_model():
    """The host CPU's model (/proc/cpuinfo's model name, else its vendor,
    family and model numbers, else the machine type) and its logical core
    count."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                key, _, value = ln.partition(":")
                fields.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    model = fields.get("model name", "unknown")
    name = (model if model != "unknown" else "") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "stepping")
        if fields.get(k)) or platform.processor() or platform.machine()
    return f"{name}, {os.cpu_count()} logical cores"


def cpu_baseline(path):
    """tools/cpu_reference.py's float64 scipy LM on ``path``, timed as its
    ``main`` times it (chordal init + LM; parsing excluded), on this host."""
    from tools.cpu_reference import chordal_init, parse_g2o_se2, solve_lm

    edges, n = parse_g2o_se2(path)
    prior_sqrt_info = np.diag([10.0, 10.0, 20.0])  # cpu_reference.py's, bench.py's prior
    t0 = time.time()
    x0 = chordal_init(edges, n)
    _x, cost, iters, converged = solve_lm(x0, edges, prior_sqrt_info)
    dt = time.time() - t0
    return dict(solver="tools/cpu_reference.py: chordal init + scipy sparse LM (splu), float64",
                cpu=cpu_model(), n_poses=n, solve_s=dt, iterations=iters,
                converged=bool(converged), final_cost=float(cost), poses_per_sec=n / dt)


def _information_f64(ga):
    """(scipy CSC H = JᵀJ from an f64 linearize at ``ga.values0``, the free
    vector, the tangent base offsets, D): the system both covariance
    methods invert, assembled on the host."""
    import scipy.sparse as sp

    from rome_tpu_torch.solvers.linearize import (
        free_vector, linearize_all, runtime_state, tangent_offsets,
    )

    ga64 = copy.copy(ga)
    ga64.dtype = torch.float64
    rt = runtime_state(ga)
    v64 = {t: v.to(torch.float64) for t, v in ga.values0.items()}
    lins = linearize_all(ga64, v64, rt)
    base, nD = tangent_offsets(ga)
    fvec = free_vector(ga, rt).to(torch.float64).cpu().numpy()
    rows, cols, vals = [], [], []
    for b, _r0, Js, vs in lins:
        vs = vs.cpu().numpy()
        offs = [base[t] + vs[:, kk, None] * ga.manifolds[t].dof
                + np.arange(ga.manifolds[t].dof)[None, :] for kk, t in enumerate(b.vtypes)]
        Jh = [J.to(torch.float64).cpu().numpy() for J in Js]
        for a in range(len(Jh)):
            for c in range(len(Jh)):
                blk = np.einsum("nij,nik->njk", Jh[a], Jh[c])
                rows.append(np.broadcast_to(offs[a][:, :, None], blk.shape).ravel())
                cols.append(np.broadcast_to(offs[c][:, None, :], blk.shape).ravel())
                vals.append(blk.ravel())
    H = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(nD, nD)).tocsc()
    return H, fvec, base, nD


def covariance_crosscheck(ga, covs, system="takahashi", k=COV_SAMPLES, seed=COV_SEED):
    """bench.py:178-255 on the port: an f64 reference for ``k`` sampled
    per-pose covariances, solved exactly with scipy's ``splu`` in f64, and
    the largest deviation of a 3 x 3 block relative to its largest entry.
    Returns (poses sampled, that deviation).

    ``system``: "takahashi", the Jacobi-scaled, 1e-8-ridged system the
    Takahashi path factors (bench.py's check), or "dense", H + 1e-8 I, the
    dense path's."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    H, fvec, base, nD = _information_f64(ga)
    if system == "takahashi":
        dv = 1.0 / np.sqrt(np.maximum(H.diagonal() * fvec ** 2, 1e-12))
        Ddf = sp.diags(dv * fvec)
        A = Ddf @ H @ Ddf + sp.diags(fvec * 1e-8 + (1.0 - fvec))
    else:
        f = sp.diags(fvec)
        dv = np.ones(nD)
        A = f @ H @ f + sp.diags(1.0 - fvec) + 1e-8 * sp.identity(nD)
    lu = spla.splu(A.tocsc())
    sample = np.random.default_rng(seed).choice(ga.counts["Pose2"],
                                                size=min(k, ga.counts["Pose2"]), replace=False)
    got = covs["Pose2"].double().cpu().numpy()
    worst = 0.0
    for i in sample:
        sl = base["Pose2"] + 3 * int(i) + np.arange(3)
        e = np.zeros((nD, 3))
        e[sl, np.arange(3)] = 1.0
        ref = dv[sl][:, None] * lu.solve(e)[sl] * dv[sl][None, :]
        worst = max(worst, float(np.abs(got[i] - ref).max() / max(np.abs(ref).max(), 1e-12)))
    return len(sample), worst


def covariance_recovery(path, device="cuda"):
    """bench.py's ``covariance_recovery`` row: Takahashi selected inversion
    at the g2o values of ``path``, cold then warm (timed), checked on
    COV_SAMPLES poses against ``splu``."""
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.solvers.gauss_newton import marginal_covariances

    ga = lower(build_graph(path), device=device)
    covs = marginal_covariances(ga, ga.values0, method="takahashi")
    _sync(device)
    t0 = time.time()
    covs = marginal_covariances(ga, ga.values0, method="takahashi")
    _sync(device)
    dt = time.time() - t0
    n = int(ga.counts["Pose2"])
    sampled, max_rel = covariance_crosscheck(ga, covs)
    return dict(method="takahashi_selected_inverse", n_poses=n, warm_s=dt,
                per_pose_us=1e6 * dt / n,
                finite=bool(torch.isfinite(covs["Pose2"]).all()),
                sampled_poses=sampled, max_rel_err_sampled=max_rel, rel_tol=COV_REL_TOL,
                accuracy_ok=bool(max_rel <= COV_REL_TOL))


def _secondary(detail, name, fn):
    """A row that must not take the headline down (bench.py's try/except):
    its exception is recorded in the row and its traceback printed."""
    try:
        detail[name] = fn()
    except Exception as e:  # noqa: BLE001 - recorded, the headline still prints
        traceback.print_exc()
        detail[name] = {"error": repr(e)}


def run(device="cuda", card=None, on_run=None):
    """Every row of the benchmark; returns (detail, metric line).
    ``on_run(row name, label, fg, res)`` sees every solve."""
    card = card or bench_kernels.device_label(device)
    detail = {"device": card, "config": dict(BIG, chordal_init=True, schedule="fused")}
    rows = datasets()
    headline = rows[0] if os.path.exists(rows[0][1]) else rows[-1]
    for name, path, gt_file, opts, gate in rows:
        if not os.path.exists(path):
            detail[name] = {"absent": path}
            continue

        def solve(name=name, path=path, gt_file=gt_file, opts=opts, gate=gate):
            hook = None if on_run is None else (
                lambda label, fg, res: on_run(name, label, fg, res))
            return solve_dataset(path, gt_file, opts, ate_gate=gate, device=device, on_run=hook)

        if name == headline[0]:
            detail[name] = solve()
        else:
            _secondary(detail, name, solve)
    head = detail[headline[0]]
    before = bench_kernels.launches()
    _secondary(detail, "covariance_recovery", lambda: covariance_recovery(headline[1], device))
    detail["covariance_recovery"]["launches"] = bench_kernels.launched_since(before)
    _secondary(detail, "kernel_speed_of_light",
               lambda: bench_kernels.run(device, bench_kernels.SIZES, card=card, verbose=False))
    base = cpu_baseline(headline[1])
    detail["cpu_baseline"] = base
    head.update(baseline_cpu_solve_s=base["solve_s"],
                baseline_cpu_poses_per_sec=base["poses_per_sec"], baseline_cpu=base["cpu"])
    pps = head["poses_per_sec"] if head["matched_ate"] else 0.0
    out = {
        "metric": f"{headline[0]}_parametric_poses_per_sec_at_matched_ate",
        "value": pps,
        "unit": "poses/s",
        "vs_baseline": pps / base["poses_per_sec"],
    }
    return detail, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="also write the detail and the metric line to this JSON file")
    args = ap.parse_args(argv)
    bench_kernels.require_device(args.device, "bench_torch")
    detail, out = run(args.device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"detail": detail, "metric": out}, fh, indent=1)
    # detail first (stderr), the metric line last (stdout), as bench.py
    print(json.dumps({"detail": detail}), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
