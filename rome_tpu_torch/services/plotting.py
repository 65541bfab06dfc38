"""Trajectory, belief and tree figures, the RoMEPlotting analogue
(counterpart of ``rome_tpu/services/plotting.py``).

drawPoses / drawPosesLandms / plotSLAM2D / plotKDE / drawTree on matplotlib's
Agg backend (no display needed), reading the port's graph (float64 numpy
points) and Bayes tree; particle sets may be numpy arrays or torch tensors
on any device. Every function returns the Figure and optionally writes a
file.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(a):
    """A numpy float64 copy of ``a`` (numpy array, list or torch tensor)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _pose_xy_th(fg, solve_key):
    xs, ys, ths, labels = [], [], [], []
    for lbl in sorted(fg.ls(r"^x\d+$"), key=lambda s: int(s[1:])):
        rec = fg.variables[lbl]
        p = rec.points.get(solve_key)
        if p is None:
            continue
        p = np.asarray(p, dtype=np.float64)
        xs.append(p[0])
        ys.append(p[1])
        ths.append(p[2] if p.shape[-1] > 2 else 0.0)
        labels.append(lbl)
    return np.asarray(xs), np.asarray(ys), np.asarray(ths), labels


def draw_poses(fg, solve_key: str = "parametric", ax=None, heading_len=0.5,
               color="tab:blue", label=None):
    """drawPoses analogue: trajectory line + heading ticks."""
    plt = _mpl()
    if ax is None:
        _fig, ax = plt.subplots(figsize=(7, 7))
    xs, ys, ths, _ = _pose_xy_th(fg, solve_key)
    ax.plot(xs, ys, "-", lw=0.8, color=color, label=label or solve_key)
    ax.quiver(
        xs, ys, np.cos(ths) * heading_len, np.sin(ths) * heading_len,
        angles="xy", scale_units="xy", scale=1.0, width=0.002, color=color,
    )
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return ax.figure


def draw_poses_landms(fg, solve_key: str = "parametric", ax=None, **kw):
    """drawPosesLandms analogue: poses + landmark markers."""
    plt = _mpl()
    if ax is None:
        _fig, ax = plt.subplots(figsize=(7, 7))
    fig = draw_poses(fg, solve_key, ax=ax, **kw)
    lx, ly = [], []
    for lbl in fg.ls(r"^l\d+$"):
        p = fg.variables[lbl].points.get(solve_key)
        if p is not None:
            p = np.asarray(p, dtype=np.float64)
            lx.append(p[0])
            ly.append(p[1])
    if lx:
        ax.plot(lx, ly, "r*", ms=10, label="landmarks")
    return fig


def plot_slam2d(fg, solve_key: str = "parametric", path: str = None,
                title: str = None, gt=None):
    """plotSLAM2D analogue: the one-call result figure the examples save.

    ``gt``: optional (n, 2+) ground-truth pose array overlaid dashed."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    draw_poses_landms(fg, solve_key, ax=ax)
    if gt is not None:
        gt = np.asarray(gt, dtype=np.float64)
        ax.plot(gt[:, 0], gt[:, 1], "--", lw=0.8, color="gray",
                label="ground truth")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(title or f"SLAM 2D ({solve_key})")
    if path:
        fig.savefig(path, dpi=130, bbox_inches="tight")
    return fig


def plot_kde(belief_points, dims=(0, 1), ax=None, path: str = None,
             bins: int = 60):
    """plotKDE analogue: particle scatter + 2D histogram density shading
    over two selected dims (or a 1D histogram for a single dim)."""
    plt = _mpl()
    pts = _host(belief_points)
    if ax is None:
        _fig, ax = plt.subplots(figsize=(6, 5))
    if isinstance(dims, int) or len(dims) == 1:
        d = dims if isinstance(dims, int) else dims[0]
        ax.hist(pts[:, d], bins=bins, density=True, alpha=0.7)
        ax.set_xlabel(f"dim {d}")
    else:
        dx, dy = dims[0], dims[1]
        ax.hist2d(pts[:, dx], pts[:, dy], bins=bins, cmap="viridis")
        ax.plot(pts[:, dx], pts[:, dy], ".", ms=1.5, color="w", alpha=0.4)
        ax.set_xlabel(f"dim {dx}")
        ax.set_ylabel(f"dim {dy}")
    if path:
        ax.figure.savefig(path, dpi=130, bbox_inches="tight")
    return ax.figure


def draw_tree(tree, path: str = None):
    """drawTree analogue: clique tree layout by elimination level (frontal
    variables per clique box, separator on the edge label)."""
    plt = _mpl()
    cliques = getattr(tree, "cliques", None) or []
    parents = {
        i: getattr(c, "parent", None) for i, c in enumerate(cliques)
    }
    # depth from parent pointers
    depth = {}

    def _depth(i):
        if i in depth:
            return depth[i]
        p = parents.get(i)
        depth[i] = 0 if p is None else _depth(p) + 1
        return depth[i]

    for i in range(len(cliques)):
        _depth(i)
    by_level: dict = {}
    for i in range(len(cliques)):
        by_level.setdefault(depth[i], []).append(i)
    fig, ax = plt.subplots(
        figsize=(max(6, 1.6 * max((len(v) for v in by_level.values()),
                                  default=1)),
                 max(4, 1.2 * (len(by_level) or 1)))
    )
    pos = {}
    for lvl, nodes in sorted(by_level.items()):
        for k, i in enumerate(nodes):
            x = (k + 0.5) / len(nodes)
            y = 1.0 - (lvl + 0.5) / max(1, len(by_level))
            pos[i] = (x, y)
    for i, cl in enumerate(cliques):
        x, y = pos[i]
        frontals = ",".join(map(str, getattr(cl, "frontals", [])))[:24]
        ax.text(x, y, frontals or f"c{i}", ha="center", va="center",
                fontsize=7,
                bbox=dict(boxstyle="round", fc="lightyellow", ec="k"))
        p = parents.get(i)
        if p is not None:
            px, py = pos[p]
            ax.plot([x, px], [y, py], "k-", lw=0.6, zorder=0)
    ax.set_axis_off()
    ax.set_title("Bayes (clique) tree")
    if path:
        fig.savefig(path, dpi=130, bbox_inches="tight")
    return fig


# reference-style aliases
drawPoses = draw_poses
drawPosesLandms = draw_poses_landms
plotSLAM2D = plot_slam2d
plotKDE = plot_kde
drawTree = draw_tree
