"""The port's services/plotting on matplotlib's Agg backend:
tests/test_blob_plot.py's plotting case on the port, and the figures' data
(the trajectory line, the landmark markers, the tree's boxes) equal to the
JAX package's for the same graph (both draw float64 numpy points: exact)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")
import jax  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu.services.plotting as JPL  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
import rome_tpu_torch.services.plotting as TPL  # noqa: E402
from rome_tpu.solvers.multimodal import tree as JT  # noqa: E402
from rome_tpu_torch.solvers.multimodal import tree as TT  # noqa: E402


def _small_graph(mod, landmark=False):
    fg = mod.FactorGraph()
    fg.add_variable("x0", mod.Pose2)
    fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    for i in range(1, 6):
        fg.add_variable(f"x{i}", mod.Pose2)
        fg.add_factor([f"x{i-1}", f"x{i}"],
                      mod.Pose2Pose2(mod.MvNormal([1, 0, 0.2], [0.1, 0.1, 0.05])))
    if landmark:
        fg.add_variable("l1", mod.Point2)
        fg.add_factor(["x2", "l1"], mod.Pose2Point2BearingRange(mod.Normal(0.3, 0.05),
                                                                 mod.Normal(4.0, 0.1)))
    fg.init_all()
    return fg


def test_plotting_analogues(tmp_path):
    """tests/test_blob_plot.py::test_plotting_analogues on the port."""
    fg = _small_graph(T)
    T.solve_graph_parametric(fg, init=False, device="cpu")
    fig = TPL.plot_slam2d(fg, path=str(tmp_path / "slam2d.png"))
    assert os.path.getsize(tmp_path / "slam2d.png") > 0 and fig.axes
    assert TPL.draw_poses(fg).axes
    pts = np.random.default_rng(1).normal(size=(300, 3))
    TPL.plot_kde(pts, dims=(0, 1), path=str(tmp_path / "kde.png"))
    assert os.path.getsize(tmp_path / "kde.png") > 0
    tree = TT.build_tree_from_ordering(fg, TT.get_elimination_order(fg))
    TPL.draw_tree(tree, path=str(tmp_path / "tree.png"))
    assert os.path.getsize(tmp_path / "tree.png") > 0
    import matplotlib

    assert matplotlib.get_backend().lower() == "agg"


def test_figures_hold_the_same_data_as_jax():
    with jax.enable_x64():
        fj = _small_graph(R, landmark=True)
    ft = _small_graph(T, landmark=True)
    aj = JPL.plot_slam2d(fj, gt=np.ones((4, 3))).axes[0]
    at = TPL.plot_slam2d(ft, gt=np.ones((4, 3))).axes[0]
    assert len(at.lines) == len(aj.lines) == 3
    for lj, lt in zip(aj.lines, at.lines):
        np.testing.assert_array_equal(lt.get_xydata(), lj.get_xydata())
    assert at.get_title() == aj.get_title()
    tj = JPL.draw_tree(JT.build_tree_from_ordering(fj, JT.get_elimination_order(fj))).axes[0]
    tt = TPL.draw_tree(TT.build_tree_from_ordering(ft, TT.get_elimination_order(ft))).axes[0]
    assert [t.get_text() for t in tt.texts] == [t.get_text() for t in tj.texts]
    assert [t.get_position() for t in tt.texts] == [t.get_position() for t in tj.texts]


@pytest.mark.parametrize("dims", [(0, 1), (2,), 1])
def test_plot_kde_takes_tensors(dims):
    pts = np.random.default_rng(2).normal(size=(200, 3))
    a = TPL.plot_kde(torch.as_tensor(pts, dtype=torch.float32), dims=dims).axes[0]
    b = JPL.plot_kde(pts.astype(np.float32), dims=dims).axes[0]
    assert a.get_xlabel() == b.get_xlabel() and a.get_ylabel() == b.get_ylabel()


def test_aliases():
    for alias, fn in (("drawPoses", "draw_poses"), ("drawPosesLandms", "draw_poses_landms"),
                      ("plotSLAM2D", "plot_slam2d"), ("plotKDE", "plot_kde"),
                      ("drawTree", "draw_tree")):
        assert getattr(TPL, alias) is getattr(TPL, fn)
