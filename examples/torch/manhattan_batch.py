"""Batch solve of a g2o pose graph on the PyTorch port: the torch version of
examples/manhattan_batch.py (the reference's Manhattan-3500 example).

Imports the g2o file, anchors x0 with a prior, solves it parametrically on
``--device`` (the card by default), saves the graph and the trajectory.
The Manhattan file is not in this repository; any EDGE_SE2 file works, such
as data/citygrid.g2o.

    PYTHONPATH=. python examples/torch/manhattan_batch.py PATH [OUT_DIR] [--device cuda|cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np

from rome_tpu_torch import GNOptions, MvNormal, PriorPose2, solve_graph_parametric
from rome_tpu_torch.io.g2o import load_g2o
from rome_tpu_torch.io.serialization import save_dfg


def main(path, out_dir=None, device="cuda"):
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "manhattan_out")
    fg = load_g2o(None, path)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])), graphinit=False)
    fg.init_all()
    n = len(fg.ls(r"^x\d+$"))
    print(f"loaded {n} poses, {fg.num_factors} factors")

    t0 = time.time()
    res = solve_graph_parametric(fg, init=False, options=GNOptions(max_iters=50),
                                 chordal_init=True, device=device)
    dt = time.time() - t0
    st = res["stats"]
    print(f"solved in {dt:.2f}s ({n / dt:.1f} poses/s): {st.iterations} iters, "
          f"cost={st.final_cost:.2f}, converged={st.converged}, linear={st.linear}")

    os.makedirs(out_dir, exist_ok=True)
    save_dfg(fg, os.path.join(out_dir, "manhattan_solved"))
    xy = np.stack([fg.get_coords(f"x{i}")[:2] for i in range(n)])
    np.savetxt(os.path.join(out_dir, "trajectory.csv"), xy, delimiter=",")
    print(f"saved graph + trajectory to {out_dir}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.path, a.out_dir, a.device)
