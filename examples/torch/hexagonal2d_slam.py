"""Hexagonal 2D SLAM on the PyTorch port: the torch version of
examples/hexagonal2d_slam.py.

Builds the hexagonal fixture (7 poses around a circle, odometry ring, a
landmark with two sightings), runs the parametric batch solve and the
nonparametric Bayes-tree solve on ``--device`` (the card by default), and
prints per-pose estimates against the simulated ground-truth PPEs.

    PYTHONPATH=. python examples/torch/hexagonal2d_slam.py [--device cuda|cpu] [--N 100]
"""

import argparse

import numpy as np

from rome_tpu_torch import GNOptions, solve_graph_parametric, solve_tree
from rome_tpu_torch.canonical import generate_graph_hexagonal


def main(device="cuda", N=100):
    fg = generate_graph_hexagonal(N=N)
    fg.init_all()

    res = solve_graph_parametric(fg, options=GNOptions(max_iters=50), device=device)
    print(f"parametric: {res['stats'].iterations} iters, cost={res['stats'].final_cost:.4f}")
    for lbl in fg.ls(r"^x\d+$") + fg.ls(r"^l\d+$"):
        est = fg.get_coords(lbl)
        line = f"  {lbl}: est={np.round(est, 3)}"
        if lbl.startswith("x"):
            gt = fg.get_ppe(lbl)
            line += f"  gt={np.round(gt, 3)}  err={np.linalg.norm(est[:2] - gt[:2]):.3f}"
        print(line)

    tree = solve_tree(fg, device=device)
    print(f"nonparametric: {tree.num_cliques} cliques")
    for lbl in fg.ls(r"^x\d+$"):
        pts = np.asarray(fg.variables[lbl].beliefs["default"])
        print(f"  {lbl}: belief mean={np.round(pts.mean(axis=0), 3)} "
              f"std={np.round(pts.std(axis=0), 3)}")
    return res, tree


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--N", type=int, default=100, help="particles per belief")
    a = ap.parse_args()
    main(a.device, a.N)
