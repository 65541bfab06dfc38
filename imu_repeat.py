"""Repeat chip_smoke.py's phase-14 ndchol solve (imu_euroc_mh01, IMU_BIG) on
the card and print each solve's LM trace: iterations, reason, final cost,
the accepted (a) / rejected (r) steps, each step's relative cost decrease
and CG polish iterations. SOLVES solves in PyTorch's default mode, then
DET_SOLVES under ``torch.use_deterministic_algorithms(True)``; all share
one graph and the structure cache, as the phase's warm solves do.

    python3 imu_repeat.py [SOLVES] [DET_SOLVES]     (defaults 6 and 4)
"""
import copy
import os
import sys
import time

# deterministic cuBLAS needs its workspace fixed before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main():
    import torch

    import chip_smoke as cs
    import rome_tpu_torch

    solves = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    det = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    cs.build_all(card)
    fg0, _build_s = cs.imu_graph(rome_tpu_torch, cs.IMU_KEYFRAMES, cs.IMU_WINDOW)
    for mode in ["default"] * solves + ["deterministic"] * det:
        torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
        fg = copy.deepcopy(fg0)
        t0 = time.time()
        res, wall, _peak = cs._solve_timed(fg, rome_tpu_torch.GNOptions(**cs.IMU_BIG), "cuda")
        st, h = res["stats"], res["stats"].history
        steps = "".join("a" if r["accepted"] else "r" for r in h)
        print(f"[{card}] {mode}: {st.iterations} iterations, {st.reason}, cost "
              f"{st.final_cost!r}, {wall:.2f} s; steps {steps}; CG {[r['cg'] for r in h]}")
        print("   relative decrease " + " ".join(
            f"{(r['cost0'] - r['cost1']) / r['cost0']:.1e}" for r in h), flush=True)
    print(card)


if __name__ == "__main__":
    main()
