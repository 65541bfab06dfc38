"""The sensor-model factors (rome_tpu_torch/factors/sensors.py) against the
JAX package: the LinearRangeBearingElevation (DIDSON sonar) and
MultipleFeatures2D residuals on seeded random points at 1e-10 in float64
(the JAX side under x64), the ctor params, the RangeAzimuthElevation
conversion (1e-6: the JAX helper rotates in float32), and the fixtures of
tests/test_sensors.py through the port (device="cpu") with their
assertions, their solutions within 1e-3 of the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402

TOL = 1e-10


def _unit_quat(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def _pose3(rng):
    return np.concatenate([rng.normal(0, 3, 3), _unit_quat(rng)])


def _pose2(rng):
    return np.array([*rng.normal(0, 3, 2), rng.uniform(-np.pi, np.pi)])


def _residuals(mod_factor_j, mod_factor_t, pts):
    with jax.enable_x64():
        jp = {k: jnp.asarray(v) for k, v in mod_factor_j.params.items()}
        want = np.asarray(mod_factor_j.ftype.residual(jp, *[jnp.asarray(p) for p in pts]))
    tp = {k: torch.as_tensor(v) for k, v in mod_factor_t.params.items()}
    got = mod_factor_t.ftype.residual(tp, *[torch.as_tensor(p) for p in pts]).numpy()
    return got, want


def test_lrbe_residual_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        args = ((rng.uniform(1, 10), 0.05), (rng.uniform(-1, 1), 0.01))
        fj, ft = R.LinearRangeBearingElevation(*args), T.LinearRangeBearingElevation(*args)
        assert ft.ftype.name == fj.ftype.name and ft.ftype.coord_types == fj.ftype.coord_types
        for k in fj.params:
            np.testing.assert_allclose(ft.params[k], fj.params[k], rtol=1e-12)
        got, want = _residuals(fj, ft, [_pose3(rng), rng.normal(0, 5, 3)])
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_multiplefeatures2d_residual_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(10):
        angles = [(rng.uniform(-3, 3), 0.01) for _ in range(6)]
        bTc = rng.normal(0, 0.3, 3)
        fj = R.MultipleFeatures2D(*angles, bTc=bTc)
        ft = T.MultipleFeatures2D(*angles, bTc=bTc)
        for k in fj.params:
            np.testing.assert_allclose(ft.params[k], fj.params[k], rtol=1e-12)
        pts = [_pose2(rng), _pose2(rng)] + [rng.normal(0, 5, 2) for _ in range(3)]
        got, want = _residuals(fj, ft, pts)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_range_azimuth_elevation_conversion_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(10):
        p, w = _pose3(rng), rng.normal(0, 5, 3)
        a, b = T.range_azimuth_elevation(p, w), R.range_azimuth_elevation(p, w)
        np.testing.assert_allclose([a.range, a.azimuth, a.elevation],
                                   [b.range, b.azimuth, b.elevation], atol=1e-5)
    # tests/test_sensors.py's conversion fixture
    rae = T.range_azimuth_elevation(np.array([0.0, 0, 0, 1, 0, 0, 0]), [3.0, 4.0, 0.0])
    np.testing.assert_allclose([rae.range, rae.azimuth, rae.elevation],
                               [5.0, np.arctan2(4, 3), 0.0], atol=1e-12)
    r = T.RangeAzimuthElevation.from_tuple((":rangeazimuth", [2.0, 0.5]))
    assert r.elevation is None and r.range == 2.0
    r = T.RangeAzimuthElevation.from_tuple((":rangeazimuthelevation", [2.0, 0.5, 0.1]))
    assert r.elevation == 0.1
    with pytest.raises(ValueError):
        T.RangeAzimuthElevation.from_tuple((":bearing", [1.0]))


def _lrbe_graph(mod):
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", mod.Pose3)
    fg.add_variable("l1", mod.Point3)
    fg.add_factor(["x0"], mod.PriorPose3(mod.MvNormal(np.zeros(6), np.eye(6) * 1e-6)))
    fg.add_factor(["x0", "l1"], mod.LinearRangeBearingElevation((5.0, 0.05), (np.pi / 6, 0.01)))
    fg.init_all()
    fg.set_point("l1", [1.0, 1.0, 0.0])  # rough init
    return fg


def test_lrbe_solve_landmark():
    fg = _lrbe_graph(T)
    res = T.solve_graph_parametric(fg, options=T.GNOptions(max_iters=200), device="cpu")
    assert res["stats"].converged
    l1 = fg.get_coords("l1")
    np.testing.assert_allclose(l1[:2], [5 * np.cos(np.pi / 6), 5 * np.sin(np.pi / 6)], atol=1e-2)
    np.testing.assert_allclose(l1[2], 0.0, atol=1e-2)
    fj = _lrbe_graph(R)
    R.solve_graph_parametric(fj, options=R.GNOptions(max_iters=200))
    np.testing.assert_allclose(l1, fj.get_coords("l1"), atol=1e-3)


def _mf2d_graph(mod):
    lms = {"l1": [5.0, 5.0], "l2": [10.0, 0.0], "l3": [5.0, -5.0]}
    xj_true = np.array([2.0, 1.0, 0.3])

    def ang(pose, lm):
        d = np.asarray(lm) - pose[:2]
        return np.arctan2(d[1], d[0]) - pose[2]

    meas = [ang(np.zeros(3), lms[k]) for k in ("l1", "l2", "l3")] + [
        ang(xj_true, lms[k]) for k in ("l1", "l2", "l3")]
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("xi", mod.Pose2)
    fg.add_variable("xj", mod.Pose2)
    for k, v in lms.items():
        fg.add_variable(k, mod.Point2)
        fg.add_factor([k], mod.PriorPoint2(mod.MvNormal(v, np.eye(2) * 1e-6)))
    fg.add_factor(["xi"], mod.PriorPose2(mod.MvNormal(np.zeros(3), np.eye(3) * 1e-6)))
    fg.add_factor(["xi", "xj", "l1", "l2", "l3"],
                  mod.MultipleFeatures2D(*[(m, 0.01) for m in meas]))
    fg.init_all()
    fg.set_point("xj", [1.0, 0.0, 0.0])
    return fg, xj_true


def test_multiplefeatures2d_pose_recovery():
    fg, xj_true = _mf2d_graph(T)
    res = T.solve_graph_parametric(fg, options=T.GNOptions(max_iters=300), device="cpu")
    assert res["stats"].converged
    np.testing.assert_allclose(fg.get_coords("xj"), xj_true, atol=0.05)
    fj, _ = _mf2d_graph(R)
    R.solve_graph_parametric(fj, options=R.GNOptions(max_iters=300))
    np.testing.assert_allclose(fg.get_coords("xj"), fj.get_coords("xj"), atol=1e-3)
