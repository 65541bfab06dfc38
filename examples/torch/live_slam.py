"""Live SLAM loop on the PyTorch port: the torch version of
examples/live_slam.py.

A producer adds poses and odometry at sensor rate while the solve manager
solves on ``--device`` (the card by default) in the background; between
solves the dead-reckon tether (MutablePose2Pose2Gaussian accumulation)
carries the high-rate state estimate.

    PYTHONPATH=. python examples/torch/live_slam.py [n_poses] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from rome_tpu_torch import MvNormal, Pose2, PriorPose2
from rome_tpu_torch.factors.pose2 import MutablePose2Pose2Gaussian
from rome_tpu_torch.frontend.odometry import (
    accumulate_discrete_local_frame,
    duplicate_to_standard_factor_variable,
    reset_factor,
)
from rome_tpu_torch.frontend.slam import (
    SLAMWrapperLocal,
    check_solve_stride_trigger,
    manage_solve_tree,
    stop_manage_solve_tree,
)


def main(n_poses=12, device="cuda"):
    slam = SLAMWrapperLocal()
    fg = slam.dfg
    fg.params.graphinit = False
    fg.add_variable("x0", Pose2, solvable=1)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.01, 0.01, 0.001])))
    fg.init_variable("x0", [0.0, 0.0, 0.0])

    thread = manage_solve_tree(slam, device=device)
    drt = MutablePose2Pose2Gaussian()
    reset_factor(drt)
    Qc = np.diag([1e-4, 1e-4, 1e-5])
    dx_hi_rate = np.array([0.1, 0.0, 0.02])  # 10 odometry ticks per pose
    for i in range(1, n_poses):
        for _ in range(10):
            accumulate_discrete_local_frame(drt, dx_hi_rate, Qc)
            time.sleep(0.002)  # sensor rate
        with slam.lock:  # the manager holds it over each cycle's graph work
            flbl = duplicate_to_standard_factor_variable(
                drt, fg, f"x{i - 1}", f"x{i}", solvable=0, graphinit=False)
        reset_factor(drt)
        slam.pose_count += 1
        slam.solve_settings.solvables.put([f"x{i}", flbl])
        if check_solve_stride_trigger(slam):
            print(f"pose x{i}: solve triggered")

    time.sleep(2.0)
    stop_manage_solve_tree(slam)
    thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("the solve manager did not stop within 60 s")
    for lbl in fg.ls(r"^x\d+$"):
        if fg.is_initialized(lbl):
            print(f"  {lbl}: {np.round(fg.get_coords(lbl), 3)}")
    print(f"solve cycles: {slam.solve_count}, timing log rows: {len(slam.timing_log)}")
    if slam.errors:
        raise RuntimeError(f"a solve failed: {slam.errors[0]}")
    return slam


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_poses", nargs="?", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.n_poses, a.device)
