"""Repeat chip_smoke.py's phase-14 ndchol solve (imu_euroc_mh01, IMU_BIG) and
phase 5's citygrid ndchol solve (BIG) on the card and print each solve: LM
iterations, reason, final cost (repr), wall seconds, the LM loop's seconds
(``ParametricSolver.solve`` between two syncs, the chordal init apart) and
ms per LM iteration; for the IMU solves also the accepted (a) / rejected (r)
steps and each step's CG polish iterations. IMU_SOLVES in PyTorch's default
mode, then DET_SOLVES under ``torch.use_deterministic_algorithms(True)``,
then CITY_SOLVES citygrid solves, each with its own chordal initialization,
then CITY_LM_SOLVES LM solves of citygrid from one chordal start computed
once (``chordal_init=False`` from that start: the LM stage alone); all share
one graph and the structure cache, as the smoke run's warm solves do. The
last line is a JSON summary: per path the iteration counts, whether the
final costs are bit-identical, and the median ms per LM iteration.

    python3 imu_repeat.py [IMU_SOLVES] [DET_SOLVES] [CITY_SOLVES] [CITY_LM_SOLVES]
                                                          (defaults 6, 0, 6, 0)

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

    args = [int(a) for a in sys.argv[1:]] + [6, 0, 6, 0][len(sys.argv) - 1:]
    solves, det, city, city_lm = args[:4]
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
    rows = {"imu": [], "imu_deterministic": [], "citygrid": [], "citygrid_lm_one_start": []}
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
        for _ in range(city):
            fg = cs.build_graph(cs.CITYGRID)
            res, wall, _peak = cs._solve_timed(fg, rome_tpu_torch.GNOptions(**cs.BIG), "cuda")
            st = res["stats"]
            rows["citygrid"].append(dict(iterations=st.iterations, cost=st.final_cost,
                                         wall_s=wall, lm_s=lm[-1],
                                         ms_per_iter=1e3 * lm[-1] / st.iterations))
            print(f"[{card}] citygrid: {st.iterations} iterations, {st.reason}, cost "
                  f"{st.final_cost!r}, {wall:.2f} s, LM {lm[-1]:.3f} s = "
                  f"{rows['citygrid'][-1]['ms_per_iter']:.2f} ms per iteration", flush=True)
        if city_lm:
            from rome_tpu_torch.graph.lower import lower, write_back
            from rome_tpu_torch.solvers.init2d import chordal_init_pose2

            start = cs.build_graph(cs.CITYGRID)
            ga = lower(start, device="cuda")
            write_back(start, ga, chordal_init_pose2(ga, ga.values0))
        for _ in range(city_lm):
            fg = copy.deepcopy(start)
            res = rome_tpu_torch.solve_graph_parametric(
                fg, init=False, options=rome_tpu_torch.GNOptions(**cs.BIG), chordal_init=False,
                device="cuda")
            st = res["stats"]
            rows["citygrid_lm_one_start"].append(dict(
                iterations=st.iterations, cost=st.final_cost, wall_s=res["solve_time_s"],
                lm_s=lm[-1], ms_per_iter=1e3 * lm[-1] / st.iterations))
            print(f"[{card}] citygrid LM from one chordal start: {st.iterations} iterations, "
                  f"{st.reason}, cost {st.final_cost!r}, LM {lm[-1]:.3f} s", flush=True)
    finally:
        GN.ParametricSolver.solve = solve
    summary = {k: dict(iterations=[r["iterations"] for r in v],
                       costs_bit_identical=len({r["cost"] for r in v}) == 1,
                       ms_per_iter_median=float(np.median([r["ms_per_iter"] for r in v])),
                       ms_per_iter=[round(r["ms_per_iter"], 3) for r in v])
               for k, v in rows.items() if v}
    print(card)
    print(json.dumps({"checkout": os.getcwd(), "summary": summary}))


if __name__ == "__main__":
    main()
