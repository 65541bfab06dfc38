#!/usr/bin/env python3
"""Profile the PyTorch port's citygrid_10k solve on one NVIDIA GPU.

    python3 profile_torch.py [--solves 6] [--out chiprun_out]

Every solve goes through the same entry points and options as chip_smoke.py
(g2o load, x0 prior, ``solve_graph_parametric(..., device="cuda")`` with the
benchmark's ``big`` options). The phases:

1. Repeatability: ``--solves`` solves in PyTorch's default mode (the first is
   the process's cold solve), then ``--solves`` more with
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (fixed-order
   ``index_add_`` scatters among others). Each solve's LM and CG iteration
   counts, final cost, aligned ATE and seconds are recorded, with any
   warning of an op that has no deterministic implementation.
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` is set for the whole process, so the
   two modes differ only in the deterministic flag.
2. Phase breakdown of three more solves, timed with CUDA events recorded
   around each phase on the current stream (no added synchronization): the
   chordal init, the symbolic-plan lookup, the LM loop and, inside it, the
   linearize, the linear solve (normal-equation entries, ND assembly,
   factorization, CG polish) and the cost evaluations.
3. torch.profiler over one more solve: kernel count, device time, and the
   device busy share (union of kernel intervals over the span from the first
   kernel's start to the last one's end); the op table goes to
   ``<out>/profile_ops.txt``.
4. K1 alone at n = 13,085 (float32): device time per launch from the
   profiler, against the plain PyTorch version's device time per call.

Prints one line per result, each tagged with the card's nvidia-smi name and
power limit, and writes everything to ``<out>/profile_torch.json``. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from collections import defaultdict

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as C  # noqa: E402


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
        """Seconds per label since the last take (call after a sync)."""
        out = {k: sum(s.elapsed_time(e) for s, e in v) / 1e3 for k, v in self.spans.items()}
        calls = {k: len(v) for k, v in self.spans.items()}
        self.spans.clear()
        return out, calls

    def unwrap(self):
        for owner, name, fn in reversed(self._restore):
            setattr(owner, name, fn)
        self._restore.clear()


def solve_once(torch, gt):
    from rome_tpu_torch import GNOptions, solve_graph_parametric

    fg = C.build_graph(C.CITYGRID)
    res = solve_graph_parametric(
        fg, init=False, options=GNOptions(**C.BIG), chordal_init=True, device="cuda",
    )
    torch.cuda.synchronize()
    st = res["stats"]
    ate, _raw = C.ate_rmse(fg, gt["poses"])
    return dict(
        iterations=st.iterations, reason=st.reason, converged=st.converged,
        final_cost=st.final_cost, ate_rmse_m=ate, solve_time_s=res["solve_time_s"],
        cg_iters=[h["cg"] for h in st.history],
    )


def repeatability(torch, gt, card, n):
    runs = {}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rows = [solve_once(torch, gt) for _ in range(n)]
        nondet = sorted({str(w.message).splitlines()[0][:160] for w in caught
                         if "deterministic" in str(w.message)})
        for k, r in enumerate(rows):
            print(f"[{card}] {mode} solve {k}: " + json.dumps(r))
        iters = [r["iterations"] for r in rows]
        print(f"[{card}] {mode}: LM iterations {iters}, aligned ATE "
              f"{min(r['ate_rmse_m'] for r in rows):.4f}-{max(r['ate_rmse_m'] for r in rows):.4f} m, "
              f"ops without a deterministic implementation: {nondet or 'none'}")
        runs[mode] = {"solves": rows, "nondeterministic_ops": nondet}
    torch.use_deterministic_algorithms(False)
    return runs


def phases(torch, gt, card, n=3):
    from rome_tpu_torch.solvers import gauss_newton as GN
    from rome_tpu_torch.solvers import init2d as I2

    timer = PhaseTimer(torch)
    timer.wrap(I2, "chordal_init_pose2", "chordal_init")
    timer.wrap(GN, "_symbolic_plan", "symbolic_plan")
    timer.wrap(GN.ParametricSolver, "solve", "lm_loop")
    timer.wrap(GN.ParametricSolver, "_linearize", "lm.linearize")
    timer.wrap(GN.ParametricSolver, "_solve_ndchol", "lm.linear_solve")
    timer.wrap(GN, "cost_at", "lm.cost_at")
    rows = []
    try:
        for _ in range(n):
            row = solve_once(torch, gt)
            row["phases_s"], row["phase_calls"] = timer.take()
            rows.append(row)
            print(f"[{card}] phases (CUDA events): " + json.dumps(row))
    finally:
        timer.unwrap()
    return rows


def busy_share(events):
    """(summed kernel time, busy time, span) in µs of kernel events."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (cur_s, cur_e) = 0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return sum(e - s for s, e in spans), busy, spans[-1][1] - spans[0][0]


def profiled(torch, gt, card, out_dir):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        row = solve_once(torch, gt)
    ka = prof.key_averages()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    total, busy, span = busy_share(kernels) if kernels else (0, 0, 0)
    res = dict(solve=row, kernels=len(kernels), kernel_time_ms=total / 1e3,
               device_busy_ms=busy / 1e3, device_span_ms=span / 1e3,
               busy_share=busy / span if span else None)
    print(f"[{card}] profiled solve: " + json.dumps(res))
    with open(os.path.join(out_dir, "profile_ops.txt"), "w") as fh:
        fh.write(ka.table(sort_by="self_cuda_time_total", row_limit=30))
        fh.write("\n\n" + ka.table(sort_by="cpu_time_total", row_limit=40))
    return res


def k1_device_time(torch, card, reps=100):
    from torch.profiler import ProfilerActivity, profile

    from rome_tpu_torch.ops import linearize_cuda as K
    from rome_tpu_torch.ops.fused_linearize import pose2pose2_linearize_plain

    args = C.k1_inputs(C.K1_TIMED_N, torch.float32, "cuda", seed=1)
    res = {}
    for label, fn in (("k1", K.pose2pose2_linearize), ("plain", pose2pose2_linearize_plain)):
        for _ in range(10):
            fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        res[label] = dict(
            device_us_per_call=sum(e.self_device_time_total for e in ka) / reps,
            kernels_per_call=sum(e.count for e in ka) / reps,
        )
    print(f"[{card}] K1 float32 n={C.K1_TIMED_N} device time per call: " + json.dumps(res))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solves", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.card_line()
    print(card)
    os.makedirs(args.out, exist_ok=True)
    from rome_tpu_torch.ops import linearize_cuda as K

    t0 = time.time()
    K.build()
    print(f"[{card}] K1 built in {time.time() - t0:.2f} s")
    gt = np.load(C.CITYGRID_GT)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    report["repeatability"] = repeatability(torch, gt, card, args.solves)
    report["phases"] = phases(torch, gt, card)
    report["profile"] = profiled(torch, gt, card, args.out)
    report["k1"] = k1_device_time(torch, card)
    with open(os.path.join(args.out, "profile_torch.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
