#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rome_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch / CUDA
   versions and the TF32 settings (both forced off: float32 products run in
   full float32).
2. Builds the hand-written CUDA kernel K1 (Pose2Pose2 linearize) with nvcc
   from the checkout's sources and prints the build seconds.
3. Kernel phase: K1 against its plain PyTorch version on the card, on
   seeded random inputs at n in {1, 1000, 8192, 10000, 13085}, float32
   (atol 2e-5, the JAX package's Pallas-kernel tolerance) and float64
   (atol 1e-10); both timed with CUDA events at n = 13,085.
4. Main path: the batch SE(2) solve of data/citygrid.g2o (10,000 poses,
   13,085 odometry/loop-closure edges, x0 prior) through the port's public
   entry points on device "cuda" — g2o load, chordal init, Levenberg-
   Marquardt with the nested-dissection Cholesky (``linear="ndchol"``) and
   the benchmark's ``big`` options — once cold and three times warm. Each
   run must converge, reach an SE(2)-aligned ATE <= 1.0 m against the f64
   optimum in data/citygrid_gt.npz, and a cost <= 1.002 * optimum + 1e-3;
   K1's launch count over the runs must cover every LM iteration.
5. Prints the kernel table as one JSON line, the card line, and as the last
   line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when there is no CUDA device, when the
package is missing, or when any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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

    from rome_tpu_torch.ops import linearize_cuda as K

    t0 = time.time()
    lib = K.build()
    build_s = time.time() - t0
    print(f"[{card}] built {os.path.relpath(lib, HERE)} in {build_s:.2f} s")
    if K.BUILD_LOG:
        print(K.BUILD_LOG)

    k1 = kernel_phase(card)
    runs, launches = main_path(card)
    warm = [r["solve_time_s"] for r in runs[1:]]
    print(f"[{card}] citygrid_10k: cold {runs[0]['solve_time_s']:.3f} s, warm "
          f"{', '.join(f'{w:.3f}' for w in warm)} s, best {10000 / min(warm):.1f} poses/s, "
          f"{runs[-1]['iterations']} LM iterations, K1 launches {launches}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "build_s": build_s, "k1": k1, "runs": runs}, fh, indent=1)

    print(json.dumps({"kernels": [{
        "name": "pose2pose2_linearize",
        "route": "cuda",
        "source": "rome_tpu_torch/csrc/pose2pose2_linearize.cu",
        "replaces": "rome_tpu/ops/linearize_pallas.py:54",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
