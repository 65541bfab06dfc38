"""Batch solve and figure of a g2o pose graph on the PyTorch port: the
torch version of examples/mit_batch.py (the reference's MIT-dataset example).

Imports the g2o file, anchors x0, solves on ``--device`` (the card by
default), saves the graph and writes the plotSLAM2D figure (where
matplotlib is installed). The MIT file is
not in this repository; any EDGE_SE2 file works, such as data/citygrid.g2o.

    PYTHONPATH=. python examples/torch/mit_batch.py PATH [OUT_DIR] [--device cuda|cpu]
"""

import argparse
import os
import tempfile
import time

from rome_tpu_torch import GNOptions, MvNormal, PriorPose2, solve_graph_parametric
from rome_tpu_torch.io.g2o import load_g2o
from rome_tpu_torch.io.serialization import save_dfg
from rome_tpu_torch.services.plotting import plot_slam2d


def main(path, out_dir=None, device="cuda"):
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "mit_out")
    fg = load_g2o(None, path)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])), graphinit=False)
    fg.init_all()
    n = len(fg.ls(r"^x\d+$"))
    print(f"loaded {n} poses, {fg.num_factors} factors")
    t0 = time.time()
    res = solve_graph_parametric(fg, init=False, options=GNOptions(max_iters=50),
                                 chordal_init=True, device=device)
    st = res["stats"]
    print(f"solved in {time.time() - t0:.2f}s: {st.iterations} iters, cost={st.final_cost:.2f}")
    os.makedirs(out_dir, exist_ok=True)
    save_dfg(fg, os.path.join(out_dir, "mit_solved"))
    png = os.path.join(out_dir, "mit_slam2d.png")
    try:
        plot_slam2d(fg, path=png, title="MIT batch solve")
        print(f"wrote {png}")
    except ImportError as e:  # matplotlib is optional at run time
        print("plot skipped:", e)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.path, a.out_dir, a.device)
