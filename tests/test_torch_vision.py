"""The port's vision module against the JAX package's.

- The GenericProjection residual on seeded poses and points, both packages
  fed the same arrays: atol 1e-10 in float64; rtol = atol = 2e-5 in float32
  (the linearize tolerance of tests/test_linearize_pallas.py:38, relative
  because a pixel coordinate is ~300, where float32 spacing is 3e-5).
- A 3-camera, 20-point bundle solved by both packages (default options,
  float64): poses and points within 1e-3.
- The batched restarts of ``solve_multiview_landmark`` fed the JAX
  package's own ``jax.random.normal`` inits: the winning point within 1e-4
  of the JAX result (both in float32).
- tests/test_vision.py's five cases on the port (their tolerances).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu.vision.camera as JC  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
import rome_tpu_torch.vision.camera as TC  # noqa: E402
from rome_tpu.manifolds import quat as JQ  # noqa: E402
from rome_tpu_torch.vision import (  # noqa: E402
    CameraCalibration, CameraModelFull, GenericProjection, camera_residual, project,
    solve_multiview_landmark)


def _quat(rng, n, spread=0.3):
    q = np.concatenate([np.ones((n, 1)), rng.normal(0, spread, (n, 3))], axis=1)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    pose = np.concatenate([rng.normal(0, 1, (n, 3)), _quat(rng, n)], axis=1)
    point = pose[:, :3] + rng.normal(0, 1, (n, 3)) + np.array([0, 0, 6.0])
    # some points behind the camera exercise the front-of-camera penalty
    point[::7, 2] = pose[::7, 2] - 3.0
    K = np.broadcast_to(CameraCalibration().K, (n, 3, 3)).copy()
    z = rng.normal(320, 50, (n, 2))
    return dict(K=K, z=z), pose, point


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_residual_matches_jax(dtype):
    params, pose, point = _inputs()
    tp = {k: torch.as_tensor(v.astype(dtype)) for k, v in params.items()}
    got = TC._generic_projection_res(tp, torch.as_tensor(pose.astype(dtype)),
                                     torch.as_tensor(point.astype(dtype))).numpy()
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax.vmap(JC._generic_projection_res)(
            {k: jnp.asarray(v.astype(dtype)) for k, v in params.items()},
            jnp.asarray(pose.astype(dtype)), jnp.asarray(point.astype(dtype))))
    assert got.dtype == np.dtype(dtype)
    tol = dict(rtol=0, atol=1e-10) if dtype == "float64" else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want, **tol)
    # the generic linearize route differentiates it (float64 Jacobians)
    if dtype == "float64":
        ga = _bundle_lowered()
        b = next(b for b in ga.batches if b.ftype.name == "GenericProjection")
        from rome_tpu_torch.solvers.linearize import batch_linearize

        r0, Js = batch_linearize(ga, b, ga.values0)
        assert r0.shape == (b.n, 2) and Js[0].shape == (b.n, 2, 6) and Js[1].shape == (b.n, 2, 3)
        assert all(torch.isfinite(J).all() for J in Js)


def _bundle(mod, n_points=20, seed=3):
    """Three cameras looking down +z, 20 points 5-8 m ahead, every point
    seen by every camera (pixel noise 0.5 px), tight priors on the
    cameras, points started 0.3 m off."""
    rng = np.random.default_rng(seed)
    cam = (JC if mod is R else TC).CameraCalibration()
    GP = (JC if mod is R else TC).GenericProjection
    cams = [np.r_[[-1.0, 0, 0], 1, 0, 0, 0], np.r_[[1.0, 0, 0], _quat(rng, 1, 0.05)[0]],
            np.r_[[0.0, 1.0, 0], _quat(rng, 1, 0.05)[0]]]
    pts = rng.uniform([-2, -2, 5], [2, 2, 8], (n_points, 3))
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    for i, c in enumerate(cams):
        fg.add_variable(f"x{i}", mod.Pose3)
        fg.add_factor([f"x{i}"], mod.PriorPose3(mod.MvNormal(
            np.r_[c[:3], 0, 0, 0] if i == 0 else _pose3_coords(c), np.eye(6) * 1e-4)))
    for j, p in enumerate(pts):
        fg.add_variable(f"l{j}", mod.Point3)
    for i, c in enumerate(cams):
        for j, p in enumerate(pts):
            z, _d = _project_np(cam, c, p)
            fg.add_factor([f"x{i}", f"l{j}"], GP(cam, mod.MvNormal(
                z + rng.normal(0, 0.5, 2), np.eye(2))))
    for i, c in enumerate(cams):
        fg.set_point(f"x{i}", c)
    for j, p in enumerate(pts):
        fg.set_point(f"l{j}", p + rng.normal(0, 0.3, 3))
    return fg


def _pose3_coords(c):
    """PriorPose3's mean in (t, rotation vector) coordinates."""
    w, v = c[3], c[4:7]
    s = np.linalg.norm(v)
    return np.r_[c[:3], (2 * np.arctan2(s, w) / s) * v if s > 0 else np.zeros(3)]


def _bundle_lowered():
    from rome_tpu_torch.graph.lower import lower

    return lower(_bundle(T), dtype=torch.float64, device="cpu")


def _project_np(cam, pose, point):
    R_ = np.asarray(JQ.qto_matrix(jnp.asarray(pose[3:7])))
    c = R_.T @ (np.asarray(point) - pose[:3])
    uvw = cam.K @ c
    return uvw[:2] / uvw[2], c[2]


def test_bundle_matches_jax():
    fj, ft = _bundle(R), _bundle(T)
    opts = dict(max_iters=100)
    with jax.enable_x64():
        rj = R.solve_graph_parametric(fj, options=R.GNOptions(**opts), dtype=jnp.float64)
    rt = T.solve_graph_parametric(ft, options=T.GNOptions(**opts), dtype=torch.float64,
                                  device="cpu")
    assert rj["stats"].converged and rt["stats"].converged
    for lbl in fj._var_order:
        a, b = np.asarray(fj.get_coords(lbl)), ft.get_coords(lbl)
        np.testing.assert_allclose(b, a, atol=1e-3, err_msg=lbl)


def _multiview_graph(mod, cam, truth, seed=2):
    GP = (JC if mod is R else TC).GenericProjection
    rng = np.random.default_rng(seed)
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("l7", mod.Point3)
    for i in range(4):
        p = np.r_[rng.uniform(-2, 2, 2), 0.0, _quat(rng, 1, 0.05)[0]]
        fg.add_variable(f"x{i}", mod.Pose3)
        fg.set_point(f"x{i}", p)
        z, d = _project_np(cam, p, truth)
        assert d > 0
        fg.add_factor([f"x{i}", "l7"], GP(cam, mod.MvNormal(z + rng.normal(0, 0.5, 2),
                                                             np.eye(2))))
    fg.set_point("l7", truth + np.array([1.5, -1.0, 1.0]))
    return fg


def test_restarts_from_the_jax_inits_match_jax():
    truth = np.array([0.5, -0.3, 7.0])
    retry, iters, seed = 48, 50, 4
    fj = _multiview_graph(R, JC.CameraCalibration(), truth)
    ft = _multiview_graph(T, TC.CameraCalibration(), truth)
    base = jnp.asarray(np.asarray(fj.get_coords("l7"), np.float32))
    inits = np.array(base + float(retry) * jax.random.normal(jax.random.PRNGKey(seed),
                                                               (retry, 3)))
    want = JC.solve_multiview_landmark(fj, "l7", retry=retry, iters=iters, seed=seed)
    cam = TC.CameraCalibration()
    poses, pixels = [], []
    for flb in ft.neighbors("l7"):
        f = ft.factors[flb]
        poses.append(ft.variables[f.variables[0]].points["parametric"])
        pixels.append(cam.undistort_point(f.params["z"]))
    f32 = dict(dtype=torch.float32)
    xs, costs, mind = TC.multiview_restarts(
        torch.as_tensor(cam.K, **f32), torch.as_tensor(np.stack(poses), **f32),
        torch.as_tensor(np.stack(pixels), **f32), torch.as_tensor(inits, **f32), iters)
    costs = torch.where(mind > 0, costs, torch.full_like(costs, np.inf))
    got = xs[int(torch.argmin(costs))].double().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, truth, atol=0.05)
    # the entry point on the CPU draws its own inits and finds the same point
    np.testing.assert_allclose(solve_multiview_landmark(ft, "l7", retry=retry, seed=seed,
                                                        device="cpu"), want, atol=1e-4)


# tests/test_vision.py's five cases, on the port

def _pose3(t, q=(1.0, 0, 0, 0)):
    return np.concatenate([np.asarray(t, np.float64), np.asarray(q, np.float64)])


def test_legacy_pinhole_project():
    cm = CameraModelFull()
    np.testing.assert_allclose(project(cm, [0, 0, 2.0]), [320, 240])
    r = camera_residual([330.0, 240.0], cm.ci, cm.ce, [0, 0, 2.0])
    np.testing.assert_allclose(r, [10.0, 0.0])


def test_generic_projection_factor_solve():
    cam = CameraCalibration()
    truth = np.array([1.0, 0.5, 5.0])
    p0, p1 = _pose3([0, 0, 0]), _pose3([2.0, 0, 0])
    z0, d0 = _project_np(cam, p0, truth)
    z1, d1 = _project_np(cam, p1, truth)
    assert d0 > 0 and d1 > 0
    fg = T.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", T.Pose3)
    fg.add_variable("x1", T.Pose3)
    fg.add_variable("l1", T.Point3)
    fg.add_factor(["x0"], T.PriorPose3(T.MvNormal(np.zeros(6), np.eye(6) * 1e-6)))
    fg.add_factor(["x1"], T.PriorPose3(T.MvNormal([2, 0, 0, 0, 0, 0], np.eye(6) * 1e-6)))
    fg.add_factor(["x0", "l1"], GenericProjection(cam, T.MvNormal(z0, np.eye(2) * 1.0)))
    fg.add_factor(["x1", "l1"], GenericProjection(cam, T.MvNormal(z1, np.eye(2) * 1.0)))
    fg.init_all()
    fg.set_point("l1", [0.5, 0.2, 3.0])
    res = T.solve_graph_parametric(fg, options=T.GNOptions(max_iters=200), device="cpu")
    assert res["stats"].converged
    np.testing.assert_allclose(fg.get_coords("l1"), truth, atol=1e-2)


def test_solve_multiview_landmark():
    cam = CameraCalibration()
    truth = np.array([1.0, -0.5, 6.0])
    fg = T.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("l7", T.Point3)
    for i, p in enumerate([_pose3([0, 0, 0]), _pose3([2, 0, 0]), _pose3([0, 2, 0])]):
        fg.add_variable(f"x{i}", T.Pose3)
        fg.set_point(f"x{i}", p)
        z, d = _project_np(cam, p, truth)
        assert d > 0
        fg.add_factor([f"x{i}", "l7"], GenericProjection(cam, T.MvNormal(z, np.eye(2))))
    fg.set_point("l7", [0.0, 0.0, 1.0])
    w_P3 = solve_multiview_landmark(fg, "l7", cam=cam, retry=32, seed=1, device="cpu")
    np.testing.assert_allclose(w_P3, truth, atol=1e-2)
    np.testing.assert_allclose(fg.get_coords("l7"), truth, atol=1e-2)


def test_solve_multiview_no_factors():
    fg = T.FactorGraph()
    fg.add_variable("l1", T.Point3)
    with pytest.raises(ValueError, match="GenericProjection"):
        solve_multiview_landmark(fg, "l1", device="cpu")


def test_calibration_from_dict_and_undistort():
    d = {"height": 480, "width": 640, "K": np.eye(3).ravel().tolist(), "kc": [0] * 5}
    c = CameraCalibration.from_dict(d)
    assert c.fx == 1.0 and c.cx == 0.0
    np.testing.assert_allclose(CameraCalibration().undistort_point([100.0, 200.0]), [100, 200])
    # with distortion both packages undo it the same way
    kc = (0.1, -0.05, 0.001, 0.002, 0.01)
    np.testing.assert_allclose(CameraCalibration(kc=kc).undistort_point([500.0, 60.0]),
                               JC.CameraCalibration(kc=kc).undistort_point([500.0, 60.0]),
                               rtol=0, atol=1e-12)
