#!/usr/bin/env python3
"""Profile the PyTorch port's solves on one NVIDIA GPU.

    python3 profile_torch.py [--solves 6] [--out chiprun_out]
    python3 profile_torch.py --path beehive [--out chiprun_out]
    python3 profile_torch.py --path default [--out chiprun_out]

``--path citygrid`` (the default) profiles the parametric citygrid_10k
solve; ``--path beehive`` the nonparametric beehive-100 solve with the
points init, ``--path default`` the default nonparametric engine (see the
end of this note).

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
2. The recorder's summary of those captured solves
   (``rome_tpu_torch.utils.profiling.summary`` of their ``solve`` spans):
   per span (``solve.lower``, ``solve.cache``, ``solve.plan``,
   ``solve.run``, ``solve.write_back``, any ``program.capture``) its count,
   total and mean milliseconds on the host clock; per device phase of the
   captured LM program (``lm.chordal``, ``lm.start_linearize``,
   ``lm.assemble``, ``lm.factorize``, ``lm.cg``, ``lm.linearize``,
   ``lm.update``) its calls and device milliseconds from the program's
   %globaltimer stamps; the programs' device milliseconds; the structure
   cache's counters.
3. torch.profiler over one more solve: kernel count, device time, and the
   device busy share (union of kernel intervals over the span from the first
   kernel's start to the last one's end); the op table goes to
   ``<out>/profile_ops.txt``.
4. K1's lin epilogue alone at n = 13,085 (float32): device time per launch
   from the profiler, against the plain PyTorch version's device time per
   call.
Every solve runs the captured program users run.

``--path beehive``: the solve of chip_smoke.py's beehive path
(``solve_graph_nonparametric(..., sweeps=3, N=100, engine="batched",
init="points", device="cuda")`` of beehive-100, seed 0), once cold, then:

1. Phase breakdown of three warm solves with CUDA events: the points init,
   the belief gather/scatter, and per sweep the messages (inside them the
   per-particle Gauss-Newton), the padding scatter and the Gibbs products
   (inside them the K2/K3 draw launches: score and Gumbel-max label draw).
2. torch.profiler over one more solve: kernel count, device time, busy
   share; the op table goes to ``<out>/profile_beehive_ops.txt``.
3. K2 and K3 alone at the beehive shapes, both epilogues (logw and draw):
   device time per launch against the plain versions'.

``--path default``: the default engine, ``solve_graph_nonparametric(fg,
sweeps=3, N=100, engine="batched", init=True, device="cuda")``, on a fresh
honeycomb-21 graph (22 Pose2, 14 Point2, 44 factors; graphinit):

1. Phase breakdown of two solves (the first is the process's cold one) with
   CUDA events: the particle init (``init_all_beliefs``, inside it the
   per-factor ``approx_conv``), each Gauss-Seidel pass, the Jacobi sweeps
   and the write-back; across them the batched messages, the per-particle
   Gauss-Newton, the Gibbs products and the K2/K3 draw launches.
2. torch.profiler (device activity only) over one more solve: kernel count,
   device time, busy share, K2/K3 launches.
3. One cold ``init=True`` solve of beehive-100 (seed 0) with its phases and
   its mean pose error against the port's parametric optimum (reported, not
   gated).

Prints one line per result, each tagged with the card's nvidia-smi name and
power limit, and writes everything to ``<out>/profile_torch.json`` (or
``<out>/profile_beehive.json``, ``<out>/profile_default.json``). Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as C  # noqa: E402


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


def span_summary(card, since):
    """The recorder's summary of the ``solve`` spans that began after the
    host-clock mark ``since`` (``time.perf_counter_ns``)."""
    from rome_tpu_torch.utils import profiling

    roots = [r for r in profiling.roots() if r.name == "solve" and r.start >= since]
    res = dict(solves=len(roots), **profiling.summary(roots))
    print(f"[{card}] span summary of {len(roots)} captured solves: " + json.dumps(res))
    return res


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


def profiled(torch, card, out_path, solve):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        row = solve()
    ka = prof.key_averages()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    total, busy, span = busy_share(kernels) if kernels else (0, 0, 0)
    res = dict(solve=row, kernels=len(kernels), kernel_time_ms=total / 1e3,
               device_busy_ms=busy / 1e3, device_span_ms=span / 1e3,
               busy_share=busy / span if span else None)
    print(f"[{card}] profiled solve: " + json.dumps(res))
    with open(out_path, "w") as fh:
        fh.write(ka.table(sort_by="self_cuda_time_total", row_limit=30))
        fh.write("\n\n" + ka.table(sort_by="cpu_time_total", row_limit=40))
    return res


def device_time(torch, card, tag, fns, reps=100):
    """Device time per call of each labelled function, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    res = {}
    for label, fn in fns:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        res[label] = dict(
            device_us_per_call=sum(e.self_device_time_total for e in ka) / reps,
            kernels_per_call=sum(e.count for e in ka) / reps,
        )
    print(f"[{card}] {tag} device time per call: " + json.dumps(res))
    return res


def k1_device_time(torch, card):
    from rome_tpu_torch.ops import linearize_cuda as K
    from rome_tpu_torch.ops.fused_linearize import pose2pose2_linearize_plain

    args = C.k1_inputs(C.K1_TIMED_N, torch.float32, "cuda", seed=1)
    return device_time(torch, card, f"K1 float32 n={C.K1_TIMED_N}", (
        ("k1", lambda: K.pose2pose2_linearize(*args)),
        ("plain", lambda: pose2pose2_linearize_plain(*args)),
    ))


def beehive_solve(torch, poses=C.BEEHIVE_POSES, N=C.BEEHIVE_N):
    from rome_tpu_torch import solve_graph_nonparametric

    fg = C.beehive_graph(poses)
    torch.cuda.synchronize()
    t0 = time.time()
    solve_graph_nonparametric(fg, sweeps=C.BEEHIVE_SWEEPS, N=N, engine="batched",
                              init="points", device="cuda")
    torch.cuda.synchronize()
    return dict(solve_time_s=time.time() - t0)


def beehive_phases(torch, card, n=3):
    from rome_tpu_torch.ops import pairwise_cuda as P
    from rome_tpu_torch.solvers.multimodal import batched as B

    timer = C.PhaseTimer(torch)
    timer.wrap(B.BatchedNonparametricSolver, "init_beliefs_from_points", "points_init")
    timer.wrap(B.BatchedNonparametricSolver, "gather_beliefs", "gather_beliefs")
    timer.wrap(B.BatchedNonparametricSolver, "scatter_beliefs", "scatter_beliefs")
    timer.wrap(B, "_messages", "messages")
    # one call per message, its program replayed (or captured) inside
    timer.wrap(B, "conv_particles", "messages.gauss_newton")
    timer.wrap(B, "_pad_messages", "pad_messages")
    timer.wrap(B, "_products", "products")
    timer.wrap(P, "se2_gibbs_draw", "products.k2_draw")
    timer.wrap(P, "euclid_gibbs_draw", "products.k3_draw")
    rows = []
    try:
        for _ in range(n):
            row = beehive_solve(torch)
            row["phases_s"], row["phase_calls"] = timer.take()
            rows.append(row)
            print(f"[{card}] beehive phases (CUDA events): " + json.dumps(row))
    finally:
        timer.unwrap()
    return rows


def k23_device_time(torch, card):
    from rome_tpu_torch.ops import pairwise_cuda as P
    from rome_tpu_torch.ops.pairwise import (
        euclid_gibbs_draw_plain,
        euclid_pairwise_logw_plain,
        se2_gibbs_draw_plain,
        se2_pairwise_logw_plain,
    )

    n = C.BEEHIVE_N
    a2, _ = C.pairwise_inputs(101, n, n, 3, "cuda", seed=5)
    a3, circ = C.pairwise_inputs(74, n, n, 2, "cuda", seed=5, circ=[0.0, 0.0])
    u2, u3 = torch.rand((101, n, n), device="cuda"), torch.rand((74, n, n), device="cuda")
    return device_time(torch, card, "K2 (V=101) / K3 (V=74, dof 2) at N=Nj=100", (
        ("k2", lambda: P.se2_pairwise_logw(*a2)),
        ("k2_plain", lambda: se2_pairwise_logw_plain(*a2)),
        ("k2_draw", lambda: P.se2_gibbs_draw(*a2, u2)),
        ("k2_draw_plain", lambda: se2_gibbs_draw_plain(*a2, u2)),
        ("k3", lambda: P.euclid_pairwise_logw(*a3, circ)),
        ("k3_plain", lambda: euclid_pairwise_logw_plain(*a3, circ)),
        ("k3_draw", lambda: P.euclid_gibbs_draw(*a3, circ, u3)),
        ("k3_draw_plain", lambda: euclid_gibbs_draw_plain(*a3, circ, u3)),
    ))


def profile_beehive(torch, card, out_dir):
    from rome_tpu_torch.ops import pairwise_cuda as P

    t0 = time.time()
    P.build()
    print(f"[{card}] K2/K3 built in {time.time() - t0:.2f} s")
    report = {"cold": beehive_solve(torch)}
    print(f"[{card}] beehive cold solve: " + json.dumps(report["cold"]))
    report["phases"] = beehive_phases(torch, card)
    report["profile"] = profiled(
        torch, card, os.path.join(out_dir, "profile_beehive_ops.txt"),
        lambda: beehive_solve(torch),
    )
    report["k2_k3"] = k23_device_time(torch, card)
    return report


def default_solve(torch, fg):
    from rome_tpu_torch import solve_graph_nonparametric
    from rome_tpu_torch.ops import pairwise_cuda as P

    C._reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    solve_graph_nonparametric(fg, sweeps=3, N=C.NP_N, engine="batched", init=True,
                              device="cuda")
    torch.cuda.synchronize()
    return dict(solve_time_s=time.time() - t0, launches=dict(P.LAUNCHES))


def _default_timer(torch):
    from rome_tpu_torch.ops import pairwise_cuda as P
    from rome_tpu_torch.solvers.multimodal import batched as B
    from rome_tpu_torch.solvers.multimodal import convolve as V
    from rome_tpu_torch.solvers.multimodal import solve as S

    timer = C.PhaseTimer(torch)
    timer.wrap(S, "init_all_beliefs", "init_all_beliefs")
    timer.wrap(S, "approx_conv", "init_all_beliefs.approx_conv")
    timer.wrap(B.BatchedNonparametricSolver, "gs_pass", "gs_pass")
    timer.wrap(B.BatchedNonparametricSolver, "sweep", "jacobi_sweep")
    timer.wrap(B.BatchedNonparametricSolver, "write_back", "write_back")
    timer.wrap(B, "_source_messages", "messages")
    timer.wrap(B, "conv_particles", "gauss_newton")
    timer.wrap(V, "conv_particles", "gauss_newton")
    timer.wrap(B, "_masked_gibbs", "gibbs_products")
    timer.wrap(P, "se2_gibbs_draw", "k2_draw")
    timer.wrap(P, "euclid_gibbs_draw", "k3_draw")
    return timer


def default_phases(torch, card, make_graph, tag, n):
    timer = _default_timer(torch)
    rows = []
    try:
        for _ in range(n):
            row = default_solve(torch, make_graph())
            row["phases_s"], row["phase_calls"] = timer.take()
            row["gs_pass_each_s"] = timer.each.get("gs_pass", [])
            row["jacobi_sweep_each_s"] = timer.each.get("jacobi_sweep", [])
            rows.append(row)
            print(f"[{card}] {tag} phases (CUDA events): " + json.dumps(row))
    finally:
        timer.unwrap()
    return rows


def device_profiled(torch, card, solve):
    """torch.profiler with device activity only over one solve."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        row = solve()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    total, busy, span = busy_share(kernels) if kernels else (0, 0, 0)
    res = dict(solve=row, kernels=len(kernels), kernel_time_ms=total / 1e3,
               device_busy_ms=busy / 1e3, device_span_ms=span / 1e3,
               busy_share=busy / span if span else None)
    print(f"[{card}] profiled solve (device activity): " + json.dumps(res))
    return res


def profile_default(torch, card):
    from rome_tpu_torch import generate_graph_honeycomb
    from rome_tpu_torch.ops import pairwise_cuda as P

    t0 = time.time()
    P.build()
    print(f"[{card}] K2/K3 built in {time.time() - t0:.2f} s")

    def honeycomb():
        return generate_graph_honeycomb(pose_count_target=21, graphinit=True)

    report = {"honeycomb21": default_phases(torch, card, honeycomb, "honeycomb-21", 2)}
    report["profile"] = device_profiled(torch, card, lambda: default_solve(torch, honeycomb()))
    fg = C.beehive_graph(C.BEEHIVE_POSES)
    row = default_phases(torch, card, lambda: fg, f"beehive-{C.BEEHIVE_POSES} init=True", 1)[0]
    truth = C._parametric_truth(C.beehive_graph(C.BEEHIVE_POSES), "cuda")
    row["mean_pose_err_m"], row["max_pose_err_m"] = C._mean_err(fg, truth, r"^x\d+$")
    print(f"[{card}] beehive-{C.BEEHIVE_POSES} cold init=True solve: "
          f"{row['solve_time_s']:.3f} s, mean pose error {row['mean_pose_err_m']:.4f} m "
          f"(max {row['max_pose_err_m']:.4f}) against the parametric optimum")
    report["beehive_default"] = row
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solves", type=int, default=6)
    ap.add_argument("--path", choices=("citygrid", "beehive", "default"), default="citygrid")
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
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    if args.path in ("beehive", "default"):
        report.update(profile_beehive(torch, card, args.out) if args.path == "beehive"
                      else profile_default(torch, card))
        with open(os.path.join(args.out, f"profile_{args.path}.json"), "w") as fh:
            json.dump(report, fh, indent=1)
        print(card)
        return 0
    from rome_tpu_torch.ops import linearize_cuda as K

    t0 = time.time()
    K.build()
    print(f"[{card}] K1 built in {time.time() - t0:.2f} s")
    gt = np.load(C.CITYGRID_GT)
    since = time.perf_counter_ns()
    report["repeatability"] = repeatability(torch, gt, card, args.solves)
    report["summary"] = span_summary(card, since)
    report["profile"] = profiled(
        torch, card, os.path.join(args.out, "profile_ops.txt"), lambda: solve_once(torch, gt)
    )
    report["k1"] = k1_device_time(torch, card)
    with open(os.path.join(args.out, "profile_torch.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
