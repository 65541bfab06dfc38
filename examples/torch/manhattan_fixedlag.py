"""Fixed-lag (sliding window) solve of a g2o stream on the PyTorch port: the
torch version of examples/manhattan_fixedlag.py.

Parses the g2o instructions one at a time; every 10, ``fifo_freeze`` freezes
the poses older than the window ``qfl`` and the graph is solved on
``--device`` (the card by default). Frozen poses keep their estimates bit
for bit through later solves: the script checks it and fails otherwise.

    PYTHONPATH=. python examples/torch/manhattan_fixedlag.py PATH [MAX_INSTRUCTIONS] [QFL] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from rome_tpu_torch import FactorGraph, GNOptions, MvNormal, Pose2, PriorPose2, solve_graph_parametric
from rome_tpu_torch.frontend.robot_utils import fifo_freeze
from rome_tpu_torch.io.g2o import import_g2o, parse_g2o_instruction


def main(path, max_instructions=300, qfl=25, device="cuda"):
    instructions = import_g2o(path)[:max_instructions]
    fg = FactorGraph()
    fg.params.graphinit = False
    fg.params.qfl = qfl
    fg.params.isfixedlag = True
    fg.add_variable("x0", Pose2)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    fg.init_variable("x0", [0.0, 0.0, 0.0])

    opts = GNOptions(max_iters=15)
    frozen = {}
    worst = 0.0
    for i, ins in enumerate(instructions):
        parse_g2o_instruction(fg, ins, initialize=True)
        if (i + 1) % 10 == 0:
            fifo_freeze(fg)
            t0 = time.time()
            solve_graph_parametric(fg, init=False, options=opts, chordal_init=False,
                                   device=device)
            dt = time.time() - t0
            drift = max((float(np.abs(fg.get_coords(l) - p).max()) for l, p in frozen.items()),
                        default=0.0)
            worst = max(worst, drift)
            for lbl in fg.ls(r"^x\d+$"):
                if fg.variables[lbl].solvable == 0:
                    frozen[lbl] = fg.get_coords(lbl).copy()
            print(f"step {i + 1}: {fg.num_variables} vars ({len(frozen)} frozen), "
                  f"solve {dt:.3f}s, frozen-drift={drift:.2e}")
    if worst != 0.0:
        raise RuntimeError(f"frozen poses moved by {worst}")
    return fg


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("max_instructions", nargs="?", type=int, default=300)
    ap.add_argument("qfl", nargs="?", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.path, a.max_instructions, a.qfl, a.device)
