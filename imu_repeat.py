"""Repeat chip_smoke.py's phase-14 ndchol solve (imu_euroc_mh01, IMU_BIG) and
phase 5's citygrid ndchol solve (BIG) on the card and print each solve: LM
iterations, reason, final cost (repr), wall seconds, the LM loop's seconds
(``ParametricSolver.solve`` between two syncs: under BIG's fused_chordal
the citygrid chordal stages are inside it, as the program runs them) and
ms per LM iteration; for the IMU solves also the accepted (a) / rejected (r)
steps and each step's CG polish iterations. IMU_SOLVES in PyTorch's default
mode, then DET_SOLVES under ``torch.use_deterministic_algorithms(True)``,
then CITY_SOLVES citygrid solves, each with its own chordal initialization
(its SHA-256 printed), then CITY_LM_SOLVES LM solves of citygrid from one
chordal start computed once (``chordal_init=False`` and BIG less
``fused_chordal`` from that start: the LM stage alone); all share one graph
and the structure cache, as the smoke
run's warm solves do. Then CHORDAL_REPS chordal stages on citygrid's
lowered graph, each timed alone with CUDA events (after one untimed call),
and the CUDA kernels one of them launches (torch.profiler). Then the
fixed-lag stream of chip_smoke.py's phase 16 through FIXEDLAG_POSES poses
(stride 10, window 25): each step's wall seconds (host clock, ending in a
sync), the steady median and p90, and where the checkout has one, the
seconds spent building the dense solvers' sum plans (``DenseScatter.of``,
between syncs) per step. Then PHASE5 calls of the checkout's phase 5,
``chip_smoke.main_path`` (its four citygrid solves; bench_torch.py's
``run`` where the checkout has it), each solve's ``solve_time_s`` (the
solver's own timer: chordal init + LM) beside its LM loop's seconds. The
last line is a JSON summary: per path the iteration counts, whether the
final costs are bit-identical, the solves' seconds and the median ms per
LM iteration; the chordal stage's ms and kernels; the fixed-lag summary.

    python3 imu_repeat.py [IMU_SOLVES] [DET_SOLVES] [CITY_SOLVES] [CITY_LM_SOLVES]
                          [CHORDAL_REPS] [FIXEDLAG_POSES] [PHASE5]
                          (defaults 6, 0, 6, 0, 0, 0, 0)

Run it from the root of a checkout: it reads that checkout's chip_smoke.py
and package (a copy of this file in an older checkout times that one).
"""
import copy
import json
import os
import sys
import time

# deterministic cuBLAS needs its workspace fixed before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    import rome_tpu_torch
    from rome_tpu_torch.solvers import gauss_newton as GN

    args = [int(a) for a in sys.argv[1:]] + [6, 0, 6, 0, 0, 0, 0][len(sys.argv) - 1:]
    solves, det, city, city_lm, chordal_reps, fixedlag_poses, phase5 = args[:7]
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    cs.build_all(card)
    lm = []
    solve = GN.ParametricSolver.solve

    def timed_solve(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = solve(self, *a, **kw)
        torch.cuda.synchronize()
        lm.append(time.time() - t0)
        return out

    GN.ParametricSolver.solve = timed_solve
    rows = {"imu": [], "imu_deterministic": [], "citygrid": [], "citygrid_lm_one_start": [],
            "phase5": []}
    try:
        if solves or det:
            fg0, _build_s = cs.imu_graph(rome_tpu_torch, cs.IMU_KEYFRAMES, cs.IMU_WINDOW)
        for mode in ["imu"] * solves + ["imu_deterministic"] * det:
            torch.use_deterministic_algorithms(mode == "imu_deterministic", warn_only=True)
            fg = copy.deepcopy(fg0)
            res, wall, _peak = cs._solve_timed(fg, rome_tpu_torch.GNOptions(**cs.IMU_BIG),
                                               "cuda")
            st, h = res["stats"], res["stats"].history
            rows[mode].append(dict(iterations=st.iterations, cost=st.final_cost, wall_s=wall,
                                   lm_s=lm[-1], ms_per_iter=1e3 * lm[-1] / st.iterations))
            steps = "".join("a" if r["accepted"] else "r" for r in h)
            print(f"[{card}] {mode}: {st.iterations} iterations, {st.reason}, cost "
                  f"{st.final_cost!r}, {wall:.2f} s, LM {lm[-1]:.3f} s = "
                  f"{rows[mode][-1]['ms_per_iter']:.2f} ms per iteration; steps {steps}; "
                  f"CG {[r['cg'] for r in h]}", flush=True)
        torch.use_deterministic_algorithms(False)
        with cs.ChordalStarts() as recorded:
            starts = recorded.digests
            for _ in range(city):
                fg = cs.build_graph(cs.CITYGRID)
                res, wall, _peak = cs._solve_timed(fg, rome_tpu_torch.GNOptions(**cs.BIG),
                                                   "cuda")
                st = res["stats"]
                rows["citygrid"].append(dict(iterations=st.iterations, cost=st.final_cost,
                                             wall_s=wall, lm_s=lm[-1],
                                             ms_per_iter=1e3 * lm[-1] / st.iterations,
                                             chordal_start_sha256=starts[-1]))
                print(f"[{card}] citygrid: {st.iterations} iterations, {st.reason}, cost "
                      f"{st.final_cost!r}, {wall:.2f} s, LM {lm[-1]:.3f} s = "
                      f"{rows['citygrid'][-1]['ms_per_iter']:.2f} ms per iteration; chordal "
                      f"start {starts[-1][:16]}", flush=True)
        if city_lm:
            from rome_tpu_torch.graph.lower import lower, write_back
            from rome_tpu_torch.solvers.init2d import chordal_init_pose2

            start = cs.build_graph(cs.CITYGRID)
            ga = lower(start, device="cuda")
            write_back(start, ga, chordal_init_pose2(ga, ga.values0))
        for _ in range(city_lm):
            fg = copy.deepcopy(start)
            res = rome_tpu_torch.solve_graph_parametric(
                fg, init=False, options=rome_tpu_torch.GNOptions(**dict(cs.BIG, fused_chordal=False)),
                chordal_init=False, device="cuda")
            st = res["stats"]
            rows["citygrid_lm_one_start"].append(dict(
                iterations=st.iterations, cost=st.final_cost, wall_s=res["solve_time_s"],
                lm_s=lm[-1], ms_per_iter=1e3 * lm[-1] / st.iterations))
            print(f"[{card}] citygrid LM from one chordal start: {st.iterations} iterations, "
                  f"{st.reason}, cost {st.final_cost!r}, LM {lm[-1]:.3f} s", flush=True)
        for _ in range(phase5):
            n0 = len(lm)
            runs = cs.main_path(card)[0]
            for r, lm_s in zip(runs, lm[n0:n0 + len(runs)]):
                rows["phase5"].append(dict(run=r["run"], iterations=r["iterations"],
                                           cost=r["final_cost"], wall_s=r["solve_time_s"],
                                           lm_s=lm_s, ms_per_iter=1e3 * lm_s / r["iterations"]))
                print(f"[{card}] phase 5 citygrid {r['run']}: {r['iterations']} iterations, "
                      f"solve_time_s {r['solve_time_s']:.4f}, LM {lm_s:.4f} s", flush=True)
    finally:
        GN.ParametricSolver.solve = solve
    summary = {k: dict(iterations=[r["iterations"] for r in v],
                       costs_bit_identical=len({r["cost"] for r in v}) == 1,
                       solve_s=[round(r["wall_s"], 4) for r in v],
                       ms_per_iter_median=float(np.median([r["ms_per_iter"] for r in v])),
                       ms_per_iter=[round(r["ms_per_iter"], 3) for r in v])
               for k, v in rows.items() if v}
    if rows["citygrid"]:
        summary["citygrid"]["chordal_starts"] = len(
            {r["chordal_start_sha256"] for r in rows["citygrid"]})
    if chordal_reps:
        summary["chordal_stage"] = chordal_stage(card, chordal_reps)
    if fixedlag_poses:
        summary["fixedlag"] = fixedlag(card, fixedlag_poses)
    print(card)
    print(json.dumps({"checkout": os.getcwd(), "summary": summary}))


def chordal_stage(card, reps):
    """``reps`` chordal stages on citygrid's lowered graph (CUDA events each,
    after one untimed call) and the CUDA kernels of one (torch.profiler)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from rome_tpu_torch.graph.lower import lower
    from rome_tpu_torch.solvers.init2d import chordal_init_pose2

    ga = lower(cs.build_graph(cs.CITYGRID), device="cuda")
    chordal_init_pose2(ga, ga.values0)
    ms = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        chordal_init_pose2(ga, ga.values0)
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chordal_init_pose2(ga, ga.values0)
        torch.cuda.synchronize()
    kernels = sum(1 for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and not ev.name.startswith("Memcpy") and not ev.name.startswith("Memset"))
    out = dict(ms=[round(m, 3) for m in ms], ms_median=float(np.median(ms)), kernels=kernels,
               host_waits=_host_waits(prof),
               top_ops=_top_ops(prof), scatter_costs=scatter_costs(card, ga))
    print(f"[{card}] chordal stage: {json.dumps(out)}", flush=True)
    return out


def _host_waits(prof):
    """CUDA runtime calls in a trace that make the host wait for the card."""
    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
             "cudaMemcpyAsync", "cudaEventSynchronize")
    counts = {}
    for ev in prof.events():
        if ev.name in names:
            counts[ev.name] = counts.get(ev.name, 0) + 1
    return counts


def _top_ops(prof, k=12):
    """The ``k`` aten ops with the most host time (self, ms) and their calls."""
    rows = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                  key=lambda e: -e.self_cpu_time_total)[:k]
    return {e.key: [e.count, round(e.self_cpu_time_total / 1e3, 3)] for e in rows}


def scatter_costs(card, ga, reps=200):
    """One sum of the chordal stage's (n, 2) row contributions (26,171 on
    citygrid: every edge's tail and head, the prior) in its two forms: three
    ``index_add_`` (the atomic form) and one ``SegmentPlan.add_`` (the
    fixed-order form); per call, host microseconds (no sync) and the
    microseconds between two CUDA events around ``reps`` calls, and the
    host waits in a traced call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rome_tpu_torch.ops.segment_sum import SegmentPlan
    from rome_tpu_torch.solvers import init2d as I

    n = ga.counts["Pose2"]
    parts = [(i, j) for i, j, *_ in I._pose2_edges(ga)]
    idx = [p[0] for p in I._pose2_priors(ga)]
    slots = torch.cat([v for i, j in parts for v in (i, j)] + idx)
    vals = torch.randn(slots.numel(), 2, dtype=torch.float64, device="cuda")
    plan = SegmentPlan(slots.cpu().numpy(), device="cuda")
    bounds = [0]
    for v in [v for i, j in parts for v in (i, j)] + idx:
        bounds.append(bounds[-1] + v.numel())
    pieces = [(slots[a:b], a, b) for a, b in zip(bounds[:-1], bounds[1:])]

    def atomic():
        y = torch.zeros((n, 2), dtype=torch.float64, device="cuda")
        for s, a, b in pieces:
            y.index_add_(0, s, vals[a:b])
        return y

    def fixed():
        return plan.add_(torch.zeros((n, 2), dtype=torch.float64, device="cuda"), vals)

    out = {}
    for name, fn in (("index_add", atomic), ("segment_plan", fixed)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        e.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[name] = dict(host_us=round(host_us, 2),
                         event_us=round(s.elapsed_time(e) / reps * 1e3, 2),
                         host_waits=_host_waits(prof))
    return out


def fixedlag(card, poses):
    """chip_smoke.py's fixed-lag stream (tools/torch/incremental_bench.py's
    ``run_incremental``) through ``poses`` poses: the steady step and,
    where the checkout has ``DenseScatter``, the seconds its plans took to
    build."""
    import torch

    import chip_smoke as cs
    from rome_tpu_torch.solvers import linearize as L
    from tools.torch import incremental_bench as IB

    plan_s = []
    real = getattr(L, "DenseScatter", None)
    if real is not None:
        build = real.of.__func__

        def timed_of(cls, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = build(cls, *a, **kw)
            torch.cuda.synchronize()
            plan_s.append(time.perf_counter() - t0)
            return out

        real.of = classmethod(timed_of)
    t0 = time.time()
    try:
        _fg, rows, _drift = IB.run_incremental(IB.stream_instructions(poses), cs.FIXEDLAG_STRIDE,
                                               True, cs.FIXEDLAG_WINDOW, "cuda")
    finally:
        if real is not None:
            real.of = classmethod(build)
    s = IB._summary(rows)
    lat = s["steady_step_latency_s"]
    out = dict(solves=s["steps"], steady_median_ms=1e3 * lat["median"],
               steady_p90_ms=1e3 * lat["p90"], linear=s["linear"], iterations=s["iterations"],
               plan_builds=len(plan_s), plan_ms_per_step=1e3 * sum(plan_s) / max(1, s["steps"]),
               seconds=time.time() - t0)
    print(f"[{card}] fixedlag_citygrid_{poses}: {json.dumps(out)}", flush=True)
    return out


if __name__ == "__main__":
    main()
