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
   and (101, 512, 512); K3 at dof 1, 2, 3 and 8 with mixed circular masks
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
7. Prints the kernel table as one JSON line, the card line, and as the last
   line {"ok": true, "device": {...}}; writes chiprun_out/chip_smoke.json.

Exits non-zero, printing no result, when there is no CUDA device, when the
package is missing, or when any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
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
# (V, N, Nj): one pair, off every tile, the beehive-100 shapes, a large batch
PAIRWISE_SHAPES = ((1, 1, 1), (1, 37, 101), (101, 100, 100), (74, 100, 100), (101, 512, 512))
K3_DOFS = (1, 2, 3, 8)
BEEHIVE_POSES, BEEHIVE_N, BEEHIVE_SWEEPS = 100, 100, 3
BEEHIVE_GATE_M = 0.5
GIBBS_SWEEPS = 3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


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
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "build_s": build_s, "k1": k1, "k2_k3": k23, "runs": runs,
                   "beehive_runs": bee, "seconds": time.time() - t_start}, fh, indent=1)

    rows = [("pose2pose2_linearize", "pose2pose2_linearize.cu",
             "rome_tpu/ops/linearize_pallas.py:54", launches, k1),
            ("se2_pairwise_logw", "pairwise_logw.cu", "rome_tpu/ops/pairwise.py:75",
             bee_launches["se2_pairwise_logw"], k23["K2"]),
            ("euclid_pairwise_logw", "pairwise_logw.cu", "rome_tpu/ops/pairwise.py:126",
             bee_launches["euclid_pairwise_logw"], k23["K3"])]
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
