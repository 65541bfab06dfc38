"""The port's services/analysis against the JAX package's, on
tests/test_services.py:92-160's cases run through both packages.

Deterministic helpers agree at atol 1e-12 (both are float64 numpy over the
same inputs; the homography converters within 1e-12 of each other too).
``predict_variable_by_factor`` draws particles from each package's own
random stream, so the two are held to the same band as the JAX test
(prediction mean within 1.0 of [10, 0]) and to each other's mean within 0.5
(200 particles of a 0.5 m range sigma: the means' spread is ~0.05).
``sim_odo`` is fed the same numpy generator, so both twins are the same.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu.services as JS  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
import rome_tpu_torch.services as TS  # noqa: E402
from rome_tpu.frontend.robot_utils import init_factor_graph as j_init  # noqa: E402
from rome_tpu_torch.frontend.robot_utils import init_factor_graph as t_init  # noqa: E402


def _both(fn):
    with jax.enable_x64():
        a = fn(R, JS)
    return a, fn(T, TS)


def test_predict_body_br_and_mala():
    def run(mod, S):
        fg = mod.FactorGraph()
        fg.add_variable("x0", mod.Pose2)
        fg.add_variable("l1", mod.Pose2)
        fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, np.pi / 2], np.eye(3) * 1e-6)))
        fg.add_factor(["l1"], mod.PriorPose2(mod.MvNormal([0, 5, 0], np.eye(3) * 1e-6)))
        fg.init_all()
        b, r = S.predict_body_br(fg, "x0", "l1")
        return b, r, S.malahanobis_br([0.1, 5.5], [b, r], np.diag([0.01, 0.25]))

    (bj, rj, mj), (bt, rt, mt) = _both(run)
    np.testing.assert_allclose([bt, rt, mt], [bj, rj, mj], rtol=0, atol=1e-12)
    np.testing.assert_allclose(rt, 5.0, atol=1e-3)
    np.testing.assert_allclose(bt, 0.0, atol=1e-3)
    np.testing.assert_allclose(mt, np.sqrt(0.1**2 / 0.01 + 0.5**2 / 0.25), atol=1e-6)
    assert TS.malahanobis_br is TS.mahalanobis_br


def test_predict_body_br_from_beliefs():
    """With particle beliefs both packages average the same coordinates."""
    rng = np.random.default_rng(4)
    pts = {"x0": rng.normal([1, 2, 0.3], 0.1, (50, 3)), "l1": rng.normal([4, 6, 0], 0.1, (50, 3))}

    def run(mod, S):
        fg = mod.FactorGraph()
        for k, v in pts.items():
            fg.add_variable(k, mod.Pose2)
            fg.variables[k].beliefs["default"] = v
        return S.predict_body_br(fg, "x0", "l1")

    a, b = _both(run)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


def test_calc_pose_point_bearing_range():
    the, rng = TS.calc_pose_point_bearing_range([0, 0, 0], [10, 10])
    np.testing.assert_allclose(the, np.pi / 4, atol=1e-9)
    np.testing.assert_allclose(rng, np.hypot(10, 10), atol=1e-9)
    for pose, pt in (([1, -2, 3.0], [-4, 5]), ([0, 0, -3.1], [-1, -0.01])):
        np.testing.assert_allclose(TS.calc_pose_point_bearing_range(pose, pt),
                                   JS.calc_pose_point_bearing_range(pose, pt), atol=1e-12)


def test_predict_variable_by_factor():
    def run(mod, S):
        fg = mod.FactorGraph()
        fg.params.N = 200
        fg.add_variable("x7", mod.Pose2)
        fg.add_variable("l3", mod.Point2)
        fg.add_factor(["x7"], mod.PriorPose2(mod.MvNormal([0, 0, 0], np.eye(3) * 1e-4)))
        fg.add_factor(["l3"], mod.PriorPoint2(mod.MvNormal([10, 0], np.eye(2) * 0.5)))
        fg.init_all()
        pp = mod.Pose2Point2BearingRange(mod.Normal(0, 0.05), mod.Normal(10.0, 0.5))
        kw = {} if mod is R else {"device": "cpu"}
        return S.predict_variable_by_factor(fg, "l3", pp, ["x7", "l3"], **kw)

    (cj, pj), (ct, pt) = _both(run)
    assert pt.shape == pj.shape and pt.shape[1] == 2
    assert ct.shape == cj.shape
    np.testing.assert_allclose(ct, cj, atol=1e-12)
    np.testing.assert_allclose(pt.mean(axis=0), [10, 0], atol=1.0)
    np.testing.assert_allclose(pt.mean(axis=0), np.asarray(pj).mean(axis=0), atol=0.5)


def test_sim_odo_and_range_comp():
    def run(mod, S, init):
        rng = np.random.default_rng(3)
        fg_gt, fg = mod.FactorGraph(), mod.FactorGraph()
        init(fg_gt)
        init(fg)
        for _ in range(3):
            lbl = S.sim_odo(fg_gt, fg, [1.0, 0, 0.1], rng=rng)
        fg_gt.init_all()
        fg.init_all()
        return lbl, S.range_comp_all_poses(fg_gt, fg), fg

    with jax.enable_x64():
        lj, ej, fj = run(R, JS, j_init)
    lt, et, ft = run(T, TS, t_init)
    assert lt == lj == "x3"
    assert et.shape[0] >= 3 and np.all(et < 1.5)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-12)
    for lbl in fj.lsf():
        np.testing.assert_allclose(ft.factors[lbl].params["z"], fj.factors[lbl].params["z"],
                                   rtol=0, atol=1e-12)
    assert TS.range_err_max_point2(ft, "x2", ft, "x2") == 0.0


def test_compare_density_and_homography():
    assert TS.compare_density(T.Normal(1, 2), T.Normal(1, 2))
    assert not TS.compare_density(T.Normal(1, 2), T.Normal(1.1, 2))
    a = T.MvNormal([1, 2], np.eye(2))
    assert TS.compare_density(a, T.MvNormal([1, 2], np.eye(2)))
    assert not TS.compare_density(a, T.Normal(0, 1))
    c = np.array([1.0, 2, 3, 0.1, -0.2, 0.3])
    H = TS.coordinates_to_homography(c)
    np.testing.assert_allclose(TS.homography_to_coordinates(H), c, atol=1e-6)
    np.testing.assert_allclose(H[3], [0, 0, 0, 1])
    with jax.enable_x64():
        Hj = JS.coordinates_to_homography(c)
        cj = JS.homography_to_coordinates(Hj)
    np.testing.assert_allclose(H, Hj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(TS.homography_to_coordinates(Hj), cj, rtol=0, atol=1e-12)


def test_aliases():
    import rome_tpu_torch.services.analysis as A

    for alias, fn in (("predictBodyBR", "predict_body_br"), ("malahanobisBR", "malahanobis_br"),
                      ("calcPosePointBearingRange", "calc_pose_point_bearing_range"),
                      ("predictVariableByFactor", "predict_variable_by_factor"),
                      ("simOdo", "sim_odo"), ("rangeErrMaxPoint2", "range_err_max_point2"),
                      ("rangeCompAllPoses", "range_comp_all_poses"),
                      ("compareDensity", "compare_density")):
        assert getattr(A, alias) is getattr(A, fn)
