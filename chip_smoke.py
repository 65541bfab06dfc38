#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rome_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch / CUDA
   versions and the TF32 settings (both forced off: float32 products run in
   full float32).
2. Builds the hand-written CUDA kernel libraries with nvcc from the
   checkout's sources, one nvcc per source, all started together: K1
   (Pose2Pose2 linearize) and K2/K3 (Gibbs pairwise scores); prints the
   build seconds and the ptxas reports.
3. K1 phase: K1 against its plain PyTorch version on the card, on seeded
   random inputs at n in {1, 1000, 8192, 10000, 13085}, float32 (atol 2e-5,
   the JAX package's Pallas-kernel tolerance) and float64 (atol 1e-10);
   both timed with CUDA events at n = 13,085.
4. K2/K3 phase: both kernels against their plain versions, float32 at rtol
   = atol = 2e-5 (tests/test_ops_pairwise.py:43), at (V, N, Nj) = (1, 1, 1),
   (1, 37, 101), the beehive-100 shapes (101, 100, 100) and (74, 100, 100),
   the default engine's shapes (1, 100, 100) (one variable's product in a
   Gauss-Seidel pass or the loop engine), (22, 100, 100) and (14, 100, 100)
   (the honeycomb-21 Pose2 and Point2 sweeps), and (101, 512, 512); K3 at dof 1, 2, 3 and 8 with mixed circular masks
   and angles at and near +-pi. Kernels and plain versions timed with CUDA
   events at the beehive shapes.
5. Citygrid path: the batch SE(2) solve of data/citygrid.g2o (10,000 poses,
   13,085 odometry/loop-closure edges, x0 prior) through the port's public
   entry points on device "cuda" — g2o load, chordal init, Levenberg-
   Marquardt with the nested-dissection Cholesky (``linear="ndchol"``) and
   the benchmark's ``big`` options — once cold and three times warm. Each
   run must converge, reach an SE(2)-aligned ATE <= 1.0 m against the f64
   optimum in data/citygrid_gt.npz, and a cost <= 1.002 * optimum + 1e-3;
   K1's launch count over the runs must cover every LM iteration.
6. Beehive path: the nonparametric solve of the beehive-100 graph (101
   Pose2, 74 Point2, 202 factors; seed 0) through
   ``solve_graph_nonparametric(..., sweeps=3, N=100, engine="batched",
   init="points", device="cuda")``, once cold and twice warm, each on a
   fresh graph. Each run's mean 2-D pose error of the belief means against
   the port's own parametric optimum of the same graph must be below 0.5 m
   (tools/bench_multimodal.py:130's gate), and K2 and K3 must each launch
   3 sweeps x 3 Gibbs sweeps x K = 3 = 27 times per solve.
7. Honeycomb grow, the default engine: ``generate_graph_honeycomb`` grown
   7 -> 14 -> 21 poses (graphinit), after each step
   ``solve_graph_nonparametric(fg, sweeps=3, N=100, engine="batched",
   init=True, device="cuda")`` (tools/bench_multimodal.py:154-196). Prints
   each step's seconds and each Gauss-Seidel pass's; the mean landmark and
   mean pose errors of the final graph against the port's own parametric
   optimum must both be below 4.0 m, and K2 and K3 must each launch in every
   step.
8. Bayes-tree grow: ``solve_tree(fg, old_tree=tree, N=100, device="cuda")``
   over the honeycomb grown 7 -> 14 (bench_multimodal.py:199-240). The regrow
   must recycle at least one clique, every recycled clique's frontal beliefs
   and points must be bit-identical across the re-solve, and the mean
   landmark error must be below 4.0 m.
9. Hexagonal cross-check (bench_multimodal.py:74-95): ``engine="loop"`` and
   ``engine="batched"``, ``init=True``, N = 100. Both must pass the band
   check (>= 35 of 100 particles within +-3 m and +-0.3 rad per pose,
   tests/test_multimodal.py:117-136) and their mean symmetric k-NN KL over
   the poses must be below 1.0.
10. Multihypo range-bearing (bench_multimodal.py:243-295): ``approx_conv``
   toward x0 of the N = 400 multihypo=[1, .5, .5] graph must put balanced
   mass on both modes; then a batched ``init=True`` solve of the hexagonal
   graph plus one multihypo bearing-range factor, whose messages take the
   per-factor fallback, must leave every belief finite.
11. Prints the kernel table as one JSON line (K2/K3 launches summed over
   every nonparametric path, each path counted from 0), the card line, and
   as the last line {"ok": true, "device": {...}}; writes
   chiprun_out/chip_smoke.json.

Exits non-zero, printing no result, when there is no CUDA device, when the
package is missing, or when any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CITYGRID = os.path.join(HERE, "data", "citygrid.g2o")
CITYGRID_GT = os.path.join(HERE, "data", "citygrid_gt.npz")
ATE_GATE_M = 1.0
# the benchmark's "big" solve options (bench.py:72-77)
BIG = dict(
    max_iters=40, linear="ndchol", polish_tol=5e-2, nd_leaf=32,
    polish_iters=60, lam0=1e-6, lam_down=0.1, lam_min=1e-12,
    chol_jitter=1e-7, dtol=0.0025, dtol_auto=True, ftol=1e-9,
    gtol=1e-8, fused_chordal=True,
)
K1_SIZES = (1, 1000, 8192, 10000, 13085)
K1_TIMED_N = 13085
PAIRWISE_TOL = dict(rtol=2e-5, atol=2e-5)
# (V, N, Nj): one pair, off every tile, the beehive-100 shapes, one variable's
# product (the Gauss-Seidel passes, the loop engine), the honeycomb-21 Pose2
# and Point2 sweeps, a large batch
PAIRWISE_SHAPES = ((1, 1, 1), (1, 37, 101), (101, 100, 100), (74, 100, 100), (1, 100, 100),
                   (22, 100, 100), (14, 100, 100), (101, 512, 512))
K3_DOFS = (1, 2, 3, 8)
BEEHIVE_POSES, BEEHIVE_N, BEEHIVE_SWEEPS = 100, 100, 3
BEEHIVE_GATE_M = 0.5
GIBBS_SWEEPS = 3
NP_N = 100                    # particles of the default-engine phases
HONEYCOMB_STEPS = (7, 14, 21)
TREE_STEPS = (7, 14)
GROW_GATE_M = 4.0             # testBeehiveGrow.jl:44-46's landmark atol band
BAND_M, BAND_RAD, BAND_MIN = 3.0, 0.3, 35  # per 100 particles
KL_GATE = 1.0
MULTIHYPO_N = 400


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


class PhaseTimer:
    """CUDA-event spans around wrapped functions, summed per label."""

    def __init__(self, torch):
        self.torch = torch
        self.spans = defaultdict(list)
        self._restore = []

    def wrap(self, owner, name, label):
        fn = getattr(owner, name)
        torch, spans = self.torch, self.spans

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[label].append((start, end))
            return out

        setattr(owner, name, timed)
        self._restore.append((owner, name, fn))

    def take(self):
        """Seconds per label since the last take (call after a sync); the
        seconds of each call stay in ``self.each``."""
        self.each = {k: [s.elapsed_time(e) / 1e3 for s, e in v] for k, v in self.spans.items()}
        out = {k: sum(v) for k, v in self.each.items()}
        calls = {k: len(v) for k, v in self.spans.items()}
        self.spans.clear()
        return out, calls

    def unwrap(self):
        for owner, name, fn in reversed(self._restore):
            setattr(owner, name, fn)
        self._restore.clear()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def k1_inputs(n, dtype, device, seed=0):
    """Random Pose2Pose2 batch as tests/test_linearize_pallas.py makes it."""
    import torch

    rng = np.random.default_rng(seed)
    p = rng.normal(0, 2, (n, 3))
    q = rng.normal(0, 2, (n, 3))
    z = rng.normal(0, 1, (n, 3))
    S = rng.normal(0, 1, (n, 3, 3)) + 5 * np.eye(3)
    w = rng.uniform(0.5, 1, (n,))
    return [torch.as_tensor(a, dtype=dtype, device=device).contiguous() for a in (p, q, z, S, w)]


def cuda_ms(fn, reps=200):
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_phase(card):
    import torch

    from rome_tpu_torch.ops import linearize_cuda as K
    from rome_tpu_torch.ops.fused_linearize import pose2pose2_linearize_plain

    atol = {torch.float32: 2e-5, torch.float64: 1e-10}
    worst = {}
    for dt in (torch.float32, torch.float64):
        for n in K1_SIZES:
            args = k1_inputs(n, dt, "cuda")
            r, (J1, J2) = K.pose2pose2_linearize(*args)
            torch.cuda.synchronize()
            rp, (J1p, J2p) = pose2pose2_linearize_plain(*args)
            err = max(
                float((a - b).abs().max()) for a, b in ((r, rp), (J1, J1p), (J2, J2p))
            )
            finite = all(bool(torch.isfinite(a).all()) for a in (r, J1, J2))
            print(f"[{card}] K1 {str(dt)[6:]} n={n}: max_abs_err {err:.3e} "
                  f"(atol {atol[dt]:g}) finite={finite}")
            check(finite and err <= atol[dt], f"K1 disagrees at n={n} {dt}: {err}")
            worst[dt] = max(worst.get(dt, 0.0), err)
    args = k1_inputs(K1_TIMED_N, torch.float32, "cuda", seed=1)
    ms = cuda_ms(lambda: K.pose2pose2_linearize(*args))
    plain_ms = cuda_ms(lambda: pose2pose2_linearize_plain(*args))
    print(f"[{card}] K1 float32 n={K1_TIMED_N}: kernel {ms * 1e3:.2f} us, "
          f"plain PyTorch {plain_ms * 1e3:.2f} us (CUDA events, 200 calls)")
    return {"max_abs_err": worst[torch.float32], "max_abs_err_f64": worst[torch.float64],
            "ms": ms, "plain_ms": plain_ms}


def build_graph(path):
    from rome_tpu_torch import MvNormal, PriorPose2, load_g2o

    fg = load_g2o(None, path)
    fg.add_factor(
        ["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])), graphinit=False
    )
    fg.init_all()
    return fg


def ate_rmse(fg, gt_poses):
    """ATE RMSE after SE(2) alignment (Kabsch on the 2-D positions), as
    bench.py computes it. Returns (aligned, raw)."""
    E, G = [], []
    for lbl in fg.ls(r"^x\d+$"):
        E.append(fg.get_coords(lbl, "parametric")[:2])
        G.append(gt_poses[int(lbl[1:])][:2])
    E, G = np.asarray(E), np.asarray(G)
    raw = float(np.sqrt(np.mean(np.sum((E - G) ** 2, axis=1))))
    Ec, Gc = E - E.mean(0), G - G.mean(0)
    U, _s, Vt = np.linalg.svd(Gc.T @ Ec)
    R = U @ np.diag([1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    Ea = Ec @ R.T + G.mean(0)
    return float(np.sqrt(np.mean(np.sum((Ea - G) ** 2, axis=1)))), raw


def main_path(card, device="cuda", g2o=CITYGRID, gt_file=CITYGRID_GT):
    import torch

    from rome_tpu_torch import GNOptions, solve_graph_parametric
    from rome_tpu_torch.ops import linearize_cuda as K

    gt = np.load(gt_file)
    ref_cost = float(gt["final_cost"])
    runs = []
    total_iters = 0
    K.LAUNCHES = 0
    for label in ("cold", "warm", "warm", "warm"):
        t_load = time.time()
        fg = build_graph(g2o)
        t_load = time.time() - t_load
        before = K.LAUNCHES
        t0 = time.time()
        res = solve_graph_parametric(
            fg, init=False, options=GNOptions(**BIG), chordal_init=True, device=device,
        )
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        st = res["stats"]
        launches = K.LAUNCHES - before
        total_iters += st.iterations
        pts = np.stack([fg.get_point(l) for l in fg.ls(r"^x\d+$")])
        ate, ate_raw = ate_rmse(fg, gt["poses"])
        n_poses = pts.shape[0]
        row = dict(
            run=label, iterations=st.iterations, converged=st.converged,
            reason=st.reason, final_cost=st.final_cost, ref_cost=ref_cost,
            ate_rmse_m=ate, ate_raw_m=ate_raw, solve_time_s=res["solve_time_s"],
            wall_s=wall, load_s=t_load, poses_per_s=n_poses / res["solve_time_s"],
            k1_launches=launches, cg_iters=[h["cg"] for h in st.history],
        )
        runs.append(row)
        print(f"[{card}] citygrid_10k {label}: " + json.dumps(row))
        check(pts.shape == (len(gt["poses"]), 3) and np.isfinite(pts).all(),
              "poses missing or not finite")
        check(st.converged, f"{label} run did not converge ({st.reason})")
        check(ate <= ATE_GATE_M, f"{label} run ATE {ate} > {ATE_GATE_M}")
        check(st.final_cost <= ref_cost * 1.002 + 1e-3,
              f"{label} run cost {st.final_cost} > 1.002 * {ref_cost}")
        # (a CPU rehearsal takes the plain path and launches nothing)
        check(device != "cuda" or launches >= st.iterations,
              f"{label} run: {launches} K1 launches for {st.iterations} iterations")
    total_launches = K.LAUNCHES
    check(device != "cuda" or total_launches >= total_iters,
          "K1 launches do not cover the LM iterations")
    return runs, total_launches


def pairwise_inputs(V, N, Nj, d, device, seed=0):
    """Seeded Gibbs-score inputs (ref, mu, pts, inv_var) and a mixed circular
    mask; angles include values at and next to +-pi."""
    import torch

    rng = np.random.default_rng(seed)
    ref = rng.uniform(-np.pi, np.pi, (V, N, d))
    pts = rng.uniform(-np.pi, np.pi, (V, Nj, d))
    ref[..., :2] *= 3.0
    pts[..., :2] *= 3.0
    ref[:, :3, -1] = np.float32(np.pi) - np.float32(1e-6)
    pts[:, :4, -1] = -np.float32(np.pi)
    mu = rng.normal(size=(V, N, d)) * 0.5
    iv = rng.uniform(0.5, 4.0, (V, d))
    circ = (np.arange(d) % 2 == 0).astype(np.float32)
    arrs = [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in (ref, mu, pts, iv)]
    return arrs, torch.as_tensor(circ, device=device)


def pairwise_phase(card):
    import torch

    from rome_tpu_torch.ops import pairwise_cuda as P
    from rome_tpu_torch.ops.pairwise import (
        euclid_pairwise_logw_plain,
        se2_pairwise_logw_plain,
    )

    worst = {"K2": 0.0, "K3": 0.0}

    def compare(tag, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and bool(torch.allclose(got, want, **PAIRWISE_TOL))
        print(f"[{card}] {tag}: max_abs_err {err:.3e} max|logw| "
              f"{float(want.abs().max()):.3e} (rtol=atol=2e-5) ok={ok}")
        check(ok and got.shape == want.shape, f"{tag} disagrees with its plain version")
        worst[tag[:2]] = max(worst[tag[:2]], err)

    for V, N, Nj in PAIRWISE_SHAPES:
        arrs, _ = pairwise_inputs(V, N, Nj, 3, "cuda", seed=V + N)
        compare(f"K2 V={V} N={N} Nj={Nj}", P.se2_pairwise_logw(*arrs),
                se2_pairwise_logw_plain(*arrs))
        for d in K3_DOFS:
            arrs, circ = pairwise_inputs(V, N, Nj, d, "cuda", seed=V + N + d)
            compare(f"K3 dof={d} V={V} N={N} Nj={Nj}", P.euclid_pairwise_logw(*arrs, circ),
                    euclid_pairwise_logw_plain(*arrs, circ))

    times = {}
    for name, V, d in (("K2", 101, 3), ("K3", 74, 2)):
        arrs, circ = pairwise_inputs(V, BEEHIVE_N, BEEHIVE_N, d, "cuda", seed=5)
        if name == "K2":
            fns = (lambda: P.se2_pairwise_logw(*arrs), lambda: se2_pairwise_logw_plain(*arrs))
        else:
            fns = (lambda: P.euclid_pairwise_logw(*arrs, circ),
                   lambda: euclid_pairwise_logw_plain(*arrs, circ))
        # in turns: plain, kernel, kernel, plain
        plain_a, ms_a, ms_b, plain_b = (cuda_ms(f) for f in (fns[1], fns[0], fns[0], fns[1]))
        times[name] = dict(ms=min(ms_a, ms_b), plain_ms=min(plain_a, plain_b),
                           ms_runs=[ms_a, ms_b], plain_ms_runs=[plain_a, plain_b])
        print(f"[{card}] {name} V={V} N=Nj={BEEHIVE_N} dof={d}: kernel "
              f"{ms_a * 1e3:.2f}/{ms_b * 1e3:.2f} us, plain PyTorch "
              f"{plain_a * 1e3:.2f}/{plain_b * 1e3:.2f} us (CUDA events, 200 calls)")
    return {k: dict(max_abs_err=worst[k], **times[k]) for k in worst}


def beehive_graph(poses=BEEHIVE_POSES):
    from rome_tpu_torch import generate_graph_beehive

    return generate_graph_beehive(pose_count_target=poses, graphinit=False, seed=0)


def beehive_path(card, device="cuda", poses=BEEHIVE_POSES, N=BEEHIVE_N):
    """Three nonparametric solves (cold, warm, warm) of fresh beehive graphs,
    each gated against the parametric optimum; returns the run rows and the
    K2/K3 launch counts of the path."""
    import torch

    from rome_tpu_torch import solve_graph_nonparametric, solve_graph_parametric
    from rome_tpu_torch.ops import pairwise_cuda as P

    fp = beehive_graph(poses)
    fp.init_all()
    solve_graph_parametric(fp, init=False, device=device)
    truth = {l: fp.get_coords(l, "parametric") for l in fp.ls(r"^x\d+$")}
    per_solve = BEEHIVE_SWEEPS * GIBBS_SWEEPS * 3  # K = 3 messages per variable
    runs = []
    for k in P.LAUNCHES:
        P.LAUNCHES[k] = 0
    for label in ("cold", "warm", "warm"):
        fg = beehive_graph(poses)
        before = dict(P.LAUNCHES)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        solve_graph_nonparametric(fg, sweeps=BEEHIVE_SWEEPS, N=N, engine="batched",
                                  init="points", device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: P.LAUNCHES[k] - before[k] for k in P.LAUNCHES}
        errs = []
        for l in fg._var_order:
            bel = np.asarray(fg.variables[l].beliefs["default"])
            check(bel.shape == (N, fg.variables[l].vtype.point_dim) and np.isfinite(bel).all(),
                  f"belief of {l} missing, misshapen or not finite")
            if l in truth:
                errs.append(float(np.linalg.norm(bel[:, :2].mean(0) - truth[l][:2])))
        err = float(np.mean(errs))
        row = dict(run=label, solve_time_s=wall, mean_pose_err_m=err, max_pose_err_m=max(errs),
                   poses=len(errs), landmarks=len(fg.ls(r"^l\d+$")), launches=launches)
        runs.append(row)
        print(f"[{card}] beehive_{poses} {label}: " + json.dumps(row))
        check(err < BEEHIVE_GATE_M, f"{label} run: mean pose error {err} >= {BEEHIVE_GATE_M} m")
        check(device != "cuda" or all(v == per_solve for v in launches.values()),
              f"{label} run: K2/K3 launches {launches}, expected {per_solve} each")
    return runs, dict(P.LAUNCHES)


def _sync(device):
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def _reset_launches():
    from rome_tpu_torch.ops import pairwise_cuda as P

    for k in P.LAUNCHES:
        P.LAUNCHES[k] = 0


def _launches():
    from rome_tpu_torch.ops import pairwise_cuda as P

    return dict(P.LAUNCHES)


def _parametric_truth(fg, device):
    """The port's parametric optimum of a copy of ``fg``: {label: coords}."""
    import copy

    from rome_tpu_torch import solve_graph_parametric

    fp = copy.deepcopy(fg)
    fp.init_all()
    solve_graph_parametric(fp, init=False, device=device)
    return {l: fp.get_coords(l, "parametric") for l in fp._var_order}


def _mean_err(fg, truth, pattern):
    errs = [float(np.linalg.norm(np.asarray(fg.variables[l].beliefs["default"])[:, :2].mean(0)
                                 - truth[l][:2])) for l in fg.ls(pattern)]
    return float(np.mean(errs)), float(np.max(errs))


def _check_beliefs(fg, N):
    for l in fg._var_order:
        bel = np.asarray(fg.variables[l].beliefs["default"])
        check(bel.shape == (N, fg.variables[l].vtype.point_dim) and np.isfinite(bel).all(),
              f"belief of {l} missing, misshapen or not finite")


def _check_launched(device, launches, what):
    check(device != "cuda" or all(v > 0 for v in launches.values()),
          f"{what}: K2/K3 launches {launches}, expected both > 0")


def honeycomb_path(card, steps=HONEYCOMB_STEPS, N=NP_N):
    """The default engine over the honeycomb grow; returns the step rows and
    the path's K2/K3 launch counts. Each Gauss-Seidel pass is timed with CUDA
    events (``PhaseTimer``)."""
    import torch

    from rome_tpu_torch import generate_graph_honeycomb, solve_graph_nonparametric
    from rome_tpu_torch.solvers.multimodal.batched import BatchedNonparametricSolver

    rows, fg = [], None
    timer = PhaseTimer(torch)
    _reset_launches()
    timer.wrap(BatchedNonparametricSolver, "gs_pass", "gs_pass")
    try:
        for target in steps:
            fg = generate_graph_honeycomb(pose_count_target=target, fg=fg, graphinit=True)
            before = _launches()
            _sync("cuda")
            t0 = time.time()
            solve_graph_nonparametric(fg, sweeps=3, N=N, engine="batched", init=True,
                                      device="cuda")
            _sync("cuda")
            wall = time.time() - t0
            timer.take()
            gs_seconds = timer.each.get("gs_pass", [])
            launches = {k: v - before[k] for k, v in _launches().items()}
            row = dict(poses=target, variables=fg.num_variables, factors=fg.num_factors,
                       solve_time_s=wall, gs_pass_s=gs_seconds, launches=launches)
            rows.append(row)
            print(f"[{card}] honeycomb_grow_default {target} poses: " + json.dumps(row))
            check(len(gs_seconds) == 3, f"{len(gs_seconds)} Gauss-Seidel passes, expected 3")
            _check_launched("cuda", launches, f"honeycomb step {target}")
    finally:
        timer.unwrap()
    _check_beliefs(fg, N)
    truth = _parametric_truth(fg, "cuda")
    (l_mean, l_max), (x_mean, x_max) = (_mean_err(fg, truth, r"^l\d+$"),
                                        _mean_err(fg, truth, r"^x\d+$"))
    res = dict(steps=rows, landmark_err_m=dict(mean=l_mean, max=l_max),
               pose_err_m=dict(mean=x_mean, max=x_max))
    print(f"[{card}] honeycomb_grow_default errors vs the parametric optimum: landmarks "
          f"{l_mean:.4f} m (max {l_max:.4f}), poses {x_mean:.4f} m (max {x_max:.4f})")
    check(l_mean < GROW_GATE_M and x_mean < GROW_GATE_M,
          f"honeycomb grow errors {l_mean}, {x_mean} not below {GROW_GATE_M} m")
    return res, _launches()


def bayes_tree_path(card, device="cuda", steps=TREE_STEPS, N=NP_N):
    """solve_tree with clique recycling over the honeycomb grow."""
    from rome_tpu_torch import calc_cliques_recycled, generate_graph_honeycomb, solve_tree

    rows, fg, tree = [], None, None
    _reset_launches()
    for target in steps:
        fg = generate_graph_honeycomb(pose_count_target=target, fg=fg, graphinit=True)
        before = {l: (np.array(r.beliefs["default"]), np.array(r.points["default"]))
                  for l, r in fg.variables.items()
                  if "default" in r.beliefs and "default" in r.points}
        _sync(device)
        t0 = time.time()
        tree = solve_tree(fg, old_tree=tree, N=N, device=device)
        _sync(device)
        total, recycled = calc_cliques_recycled(tree)
        kept = [v for c in tree.cliques if c.index not in tree.dirty for v in c.frontals
                if v in before]
        for v in kept:
            check(np.array_equal(fg.variables[v].beliefs["default"], before[v][0])
                  and np.array_equal(fg.variables[v].points["default"], before[v][1]),
                  f"recycled clique variable {v} changed across the re-solve")
        row = dict(poses=target, solve_time_s=time.time() - t0, cliques=total,
                   recycled=recycled, recycled_variables=len(kept), levels=len(tree.levels))
        rows.append(row)
        print(f"[{card}] bayes_tree_grow {target} poses: " + json.dumps(row))
    check(rows[-1]["recycled"] >= 1 and rows[-1]["recycled_variables"] >= 1,
          "the regrow recycled no clique")
    _check_beliefs(fg, N)
    l_mean, l_max = _mean_err(fg, _parametric_truth(fg, device), r"^l\d+$")
    print(f"[{card}] bayes_tree_grow landmark error vs the parametric optimum: "
          f"{l_mean:.4f} m (max {l_max:.4f})")
    check(l_mean < GROW_GATE_M, f"tree landmark error {l_mean} not below {GROW_GATE_M} m")
    launches = _launches()
    _check_launched(device, launches, "bayes_tree_grow")
    return dict(steps=rows, landmark_err_m=dict(mean=l_mean, max=l_max)), launches


def _in_band(fg, N):
    """Per pose, the fewest particles within the x, y and heading bands."""
    from rome_tpu_torch.utils.math import sym_rem_np

    worst = []
    for l in fg.ls(r"^x\d+$"):
        sim, pts = fg.get_ppe(l), np.asarray(fg.variables[l].beliefs["default"])
        worst.append(int(min(np.sum(np.abs(pts[:, 0] - sim[0]) < BAND_M),
                             np.sum(np.abs(pts[:, 1] - sim[1]) < BAND_M),
                             np.sum(np.abs(sym_rem_np(pts[:, 2] - sim[2])) < BAND_RAD))))
    return worst


def hexagonal_path(card, device="cuda", N=NP_N):
    """engine="loop" against engine="batched" on the hexagonal graph."""
    import torch

    from rome_tpu_torch import generate_graph_hexagonal, solve_graph_nonparametric
    from rome_tpu_torch.manifolds.base import SE2_
    from rome_tpu_torch.solvers.multimodal.metrics import symmetric_kl_knn

    graphs, rows = {}, {}
    _reset_launches()
    for engine in ("batched", "loop"):
        fg = generate_graph_hexagonal(N=N)
        before = _launches()
        _sync(device)
        t0 = time.time()
        solve_graph_nonparametric(fg, sweeps=3, N=N, engine=engine, init=True, device=device)
        _sync(device)
        launches = {k: v - before[k] for k, v in _launches().items()}
        _check_beliefs(fg, N)
        band = _in_band(fg, N)
        rows[engine] = dict(solve_time_s=time.time() - t0, min_in_band=band, launches=launches)
        graphs[engine] = fg
        print(f"[{card}] hexagonal_7pose {engine}: " + json.dumps(rows[engine]))
        check(min(band) >= BAND_MIN * N // 100, f"{engine} engine misses the band: {band}")
        _check_launched(device, launches, f"hexagonal {engine}")
    kl = float(np.mean([
        symmetric_kl_knn(SE2_, torch.as_tensor(graphs["loop"].variables[l].beliefs["default"]),
                         torch.as_tensor(graphs["batched"].variables[l].beliefs["default"]))
        for l in graphs["loop"].ls(r"^x\d+$")
    ]))
    rows["mean_sym_kl_loop_vs_batched"] = kl
    print(f"[{card}] hexagonal_7pose mean symmetric KL loop vs batched: {kl:.4f}")
    check(kl < KL_GATE, f"loop and batched engines disagree: KL {kl}")
    return rows, _launches()


def multihypo_graph():
    """testMultimodalRangeBearing.jl's configuration (bench_multimodal.py:254-271)."""
    from rome_tpu_torch import (FactorGraph, MvNormal, Normal, Point2, Pose2,
                                Pose2Point2BearingRange, PriorPoint2, PriorPose2)

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


def multihypo_path(card, device="cuda", N=MULTIHYPO_N, solve_N=NP_N):
    """approx_conv's mode masses, then a default solve through the fallback."""
    from rome_tpu_torch import (MvNormal, Normal, Point2, Pose2Point2BearingRange, PriorPoint2,
                                approx_conv, generate_graph_hexagonal, init_all_beliefs,
                                solve_graph_nonparametric)
    from rome_tpu_torch.solvers.multimodal.batched import BatchedNonparametricSolver

    _reset_launches()
    fg, flabel = multihypo_graph()
    init_all_beliefs(fg, N=N, device=device)
    times = []
    for seed in (0, 3):
        _sync(device)
        t0 = time.time()
        pts = approx_conv(fg, flabel, "x0", N=N, device=device, seed=seed).cpu().numpy()
        times.append(time.time() - t0)
    r1 = np.abs(np.linalg.norm(pts[:, :2] - np.array([20.0, 5.0]), axis=1) - 20.0)
    r2 = np.abs(np.linalg.norm(pts[:, :2] - np.array([20.0, -5.0]), axis=1) - 20.0)
    m1 = float(np.mean((r1 < 1.0) & (r2 >= 1.0)))
    m2 = float(np.mean((r2 < 1.0) & (r1 >= 1.0)))
    res = dict(conv_s=times, mode_mass=[m1, m2])
    check(pts.shape == (N, 3) and np.isfinite(pts).all(), "multihypo conv not finite")
    check(m1 > 0.15 and m2 > 0.15 and 0.25 < m1 / (m1 + m2 + 1e-12) < 0.75,
          f"multihypo mode masses unbalanced: {m1}, {m2}")

    fh = generate_graph_hexagonal(N=solve_N)
    fh.add_variable("l2", Point2)
    fh.add_factor(["l2"], PriorPoint2(MvNormal([20.0, 4.0], [0.5, 0.5])))
    fh.add_factor(["x3", "l1", "l2"],
                  Pose2Point2BearingRange(Normal(np.pi, 0.05), Normal(20.0, 0.5)),
                  multihypo=[1.0, 0.5, 0.5])
    fallback = BatchedNonparametricSolver(fh, "default", N=solve_N, device=device).bp.fallback
    check(len(fallback) > 0, "the multihypo factor took no fallback message")
    _sync(device)
    t0 = time.time()
    solve_graph_nonparametric(fh, sweeps=3, N=solve_N, init=True, device=device)
    _sync(device)
    res.update(solve_time_s=time.time() - t0, fallback_messages=len(fallback))
    _check_beliefs(fh, solve_N)
    launches = _launches()
    res["launches"] = launches
    print(f"[{card}] multihypo_range_bearing: " + json.dumps(res))
    _check_launched(device, launches, "multihypo")
    return res, launches


def build_all(card):
    """One nvcc per kernel source, all started together."""
    from rome_tpu_torch.ops import linearize_cuda, nvcc_build, pairwise_cuda

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(lambda m: m.build(), (linearize_cuda, pairwise_cuda)))
    build_s = time.time() - t0
    for lib in libs:
        print(f"[{card}] built {os.path.relpath(lib, HERE)}")
    print(f"[{card}] kernel build {build_s:.2f} s")
    for src, log in nvcc_build.BUILD_LOGS.items():
        print(f"--- ptxas {src}\n{log}")
    return build_s


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    t_start = time.time()
    build_s = build_all(card)
    k1 = kernel_phase(card)
    k23 = pairwise_phase(card)
    runs, launches = main_path(card)
    warm = [r["solve_time_s"] for r in runs[1:]]
    print(f"[{card}] citygrid_10k: cold {runs[0]['solve_time_s']:.3f} s, warm "
          f"{', '.join(f'{w:.3f}' for w in warm)} s, best {10000 / min(warm):.1f} poses/s, "
          f"{runs[-1]['iterations']} LM iterations, K1 launches {launches}")
    bee, bee_launches = beehive_path(card)
    secs = ", ".join(f"{r['solve_time_s']:.3f}" for r in bee)
    errs = ", ".join(f"{r['mean_pose_err_m']:.4f}" for r in bee)
    print(f"[{card}] beehive_{BEEHIVE_POSES} N={BEEHIVE_N}: solves (cold, warm, warm) "
          f"{secs} s, mean pose error {errs} m, K2/K3 launches {bee_launches}")
    np_paths = {"beehive_points": (bee, bee_launches)}
    for name, path in (("honeycomb_grow_default", honeycomb_path),
                       ("bayes_tree_grow", bayes_tree_path),
                       ("hexagonal_7pose", hexagonal_path),
                       ("multihypo_range_bearing", multihypo_path)):
        t0 = time.time()
        np_paths[name] = path(card)
        print(f"[{card}] {name}: {time.time() - t0:.1f} s, K2/K3 launches {np_paths[name][1]}")
    np_launches = {k: sum(l[k] for _r, l in np_paths.values()) for k in bee_launches}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "build_s": build_s, "k1": k1, "k2_k3": k23, "runs": runs,
                   "nonparametric": {k: {"result": r, "launches": l}
                                     for k, (r, l) in np_paths.items()},
                   "seconds": time.time() - t_start}, fh, indent=1)

    rows = [("pose2pose2_linearize", "pose2pose2_linearize.cu",
             "rome_tpu/ops/linearize_pallas.py:54", launches, k1),
            ("se2_pairwise_logw", "pairwise_logw.cu", "rome_tpu/ops/pairwise.py:75",
             np_launches["se2_pairwise_logw"], k23["K2"]),
            ("euclid_pairwise_logw", "pairwise_logw.cu", "rome_tpu/ops/pairwise.py:126",
             np_launches["euclid_pairwise_logw"], k23["K3"])]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"rome_tpu_torch/csrc/{src}",
        "replaces": tpu,
        "launches": n,
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
    } for name, src, tpu, n, m in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
