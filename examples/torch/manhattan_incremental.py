"""Incremental solve of a g2o stream on the PyTorch port: the torch version
of examples/manhattan_incremental.py.

Parses the g2o instructions one at a time and re-solves every ``stride``
from the current estimates on ``--device`` (the card by default), with
padded shapes so a cached solver serves each shape bucket; saves the graph.

    PYTHONPATH=. python examples/torch/manhattan_incremental.py PATH [MAX_INSTRUCTIONS] [STRIDE] [OUT_DIR] [--device cuda|cpu]
"""

import argparse
import os
import tempfile
import time

from rome_tpu_torch import FactorGraph, GNOptions, MvNormal, Pose2, PriorPose2, solve_graph_parametric
from rome_tpu_torch.io.g2o import import_g2o, parse_g2o_instruction
from rome_tpu_torch.io.serialization import save_dfg


def main(path, max_instructions=300, stride=10, out_dir=None, device="cuda"):
    out_dir = out_dir or tempfile.gettempdir()
    instructions = import_g2o(path)[:max_instructions]
    fg = FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", Pose2)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    fg.init_variable("x0", [0.0, 0.0, 0.0])

    opts = GNOptions(max_iters=15)
    for i, ins in enumerate(instructions):
        parse_g2o_instruction(fg, ins, initialize=True)
        if (i + 1) % stride == 0:
            t0 = time.time()
            res = solve_graph_parametric(fg, init=False, options=opts, chordal_init=False,
                                         pad=True, device=device)
            st = res["stats"]
            print(f"step {i + 1}: {fg.num_variables} vars, solve {time.time() - t0:.3f}s, "
                  f"{st.iterations} iters, cost={st.final_cost:.3f}")
    path_out = save_dfg(fg, os.path.join(out_dir, "manhattan_incremental_final"))
    print(f"saved final graph to {path_out}")
    return fg


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("max_instructions", nargs="?", type=int, default=300)
    ap.add_argument("stride", nargs="?", type=int, default=10)
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.path, a.max_instructions, a.stride, a.out_dir, a.device)
