"""The extension factors against the JAX package: the RK4 ODE factor
(rome_tpu_torch/factors/ode.py), the NN mixture odometry
(factors/fluxmix.py) and the legacy InertialPose3 (factors/legacy_inertial.py).

- InertialDynamic: the residual and both initializers (the forward and the
  backward flow) against the JAX package's in float64 at 1e-8 (JAX under
  x64; its initializers cast to float32, so they are held to
  ``_integrate_rvp``, the flow they wrap, and to themselves at 1e-5); the
  initializer and the ODE-vs-preintegration fixtures of
  tests/test_ext_factors.py. The JAX suite marks the latter ``slow``; here
  it runs unmarked at the same size.
- The Pose2OdoNN_01 forward pass against ``pose2_odo_nn_forward`` at 1e-6
  with the same weights carried across (the JAX side in float32), the
  tensorflow weight layout, NNOdoPredictor's mean, covariance and samples,
  ``calc_velocity_inter_pose2``, the mixture factor's params and its solve.
- InertialPose3: the residual and the prior's at 1e-10 in float64, the ctor
  params (1e-6: the JAX package logs rRp in float32), the free-fall fixture
  and its graph solve, and a 10-state free-fall chain against the JAX
  package's solution at 1e-3.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.factors import legacy_inertial as JL  # noqa: E402
from rome_tpu.factors import ode as JO  # noqa: E402
from rome_tpu_torch.canonical import generate_field_inertial_measurement_noise  # noqa: E402
from rome_tpu_torch.factors import legacy_inertial as TL  # noqa: E402
from rome_tpu_torch.factors import ode as TO  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke as C  # noqa: E402


def _unit_quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def _rvp(rng):
    return np.concatenate([_unit_quat(rng), rng.normal(0, 2, 6)])


# ----------------------------- InertialDynamic ------------------------------

def _ode_factor(mod, rng, n=8):
    return mod.InertialDynamic((rng.uniform(0, 5), 0.0), rng.uniform(0.01, 0.1),
                               rng.normal(0, 0.3, (n, 3)), rng.normal(0, 1, (n, 3)) + [0, 0, 9.81],
                               mod.MvNormal(rng.normal(0, 0.1, 9), np.eye(9) * 1e-2))


def test_inertial_dynamic_residual_and_flows_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(4):
        f = _ode_factor(T, rng)
        xi, xj = _rvp(rng), _rvp(rng)
        with jax.enable_x64():
            jp = {k: jnp.asarray(v) for k, v in f.params.items()}
            want = np.asarray(JO.INERTIAL_DYNAMIC.residual(jp, jnp.asarray(xi), jnp.asarray(xj)))
            fwd = np.asarray(JO._integrate_rvp(jp, jnp.asarray(xi), 1.0))
            bwd = np.asarray(JO._integrate_rvp(jp, jnp.asarray(xj), -1.0))
        tp = {k: torch.as_tensor(v) for k, v in f.params.items()}
        got = f.ftype.residual(tp, torch.as_tensor(xi), torch.as_tensor(xj)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)
        init1 = f.ftype.initializers[1](tp, [torch.as_tensor(xi), None]).numpy()
        init0 = f.ftype.initializers[0](tp, [None, torch.as_tensor(xj)]).numpy()
        np.testing.assert_allclose(init1, fwd, atol=1e-8, rtol=0)
        np.testing.assert_allclose(init0, bwd, atol=1e-8, rtol=0)
        # the JAX package's own (float32) initializers
        np.testing.assert_allclose(init1, np.asarray(JO._inertial_dynamic_init1(f.params, [xi, None])),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(init0, np.asarray(JO._inertial_dynamic_init0(f.params, [None, xj])),
                                   atol=1e-4, rtol=1e-5)
        # batched over particles, as the nonparametric convolution calls it
        M = 3
        bp = {k: v.expand(M, *v.shape) for k, v in tp.items()}
        out = f.ftype.initializers[1](bp, [torch.as_tensor(xi).expand(M, 10), None]).numpy()
        np.testing.assert_allclose(out, np.broadcast_to(init1, out.shape), atol=1e-12)


def test_inertial_dynamic_initializer():
    """tests/test_ext_factors.py:76-86: hovering, the forward flow stays put."""
    dt, N = 0.05, 8
    fac = T.InertialDynamic((0.0, dt * N), dt, np.zeros((N, 3)), np.tile([0, 0, 9.81], (N, 1)))
    x0 = np.concatenate([[1, 0, 0, 0], [0, 0, 0], [0, 0, 0.0]])
    p = {k: torch.as_tensor(v) for k, v in fac.params.items()}
    x1 = fac.ftype.initializers[1](p, [torch.as_tensor(x0), None]).numpy()
    np.testing.assert_allclose(x1[4:7], [0, 0, 0], atol=1e-5)
    np.testing.assert_allclose(x1[7:10], [0, 0, 0], atol=1e-5)


def test_inertial_dynamic_matches_imudelta():
    """tests/test_ext_factors.py:36-73 (``slow`` in the JAX suite): the ODE
    and preintegration formulations land x1 at the same state."""
    dt, N = 0.1, 10
    imu = generate_field_inertial_measurement_noise(
        dt=dt, N=N, rate=(0, 0, 0.001), accel0=(0, 0, 9.81 - 1),
        sigma_a=1e-4, sigma_w=np.deg2rad(0.0001))

    def solve_with(fac):
        fg = T.FactorGraph()
        fg.params.graphinit = False
        fg.add_variable("x0", T.RotVelPos)
        fg.add_variable("x1", T.RotVelPos)
        z0 = np.zeros(9)
        z0[3:6] = [10, 0, 0]
        fg.add_factor(["x0"], T.PriorRotVelPos(T.MvNormal(z0, np.eye(9) * 1e-3)))
        fg.add_factor(["x0", "x1"], fac)
        fg.init_all()
        res = T.solve_graph_parametric(fg, options=T.GNOptions(max_iters=150), device="cpu")
        assert res["stats"].converged
        return fg.variables["x1"].points["parametric"]

    x1_ode = solve_with(T.InertialDynamic((0.0, dt * N), dt, imu.gyros, imu.accels))
    x1_pre = solve_with(T.IMUDeltaFactor(imu.accels, imu.gyros, np.ones(N) * dt, imu.Sigma_y))
    np.testing.assert_allclose(x1_ode[4:7], x1_pre[4:7], atol=0.02)
    np.testing.assert_allclose(x1_ode[7:10], x1_pre[7:10], atol=0.02)
    np.testing.assert_allclose(x1_ode[:4], x1_pre[:4], atol=1e-3)
    np.testing.assert_allclose(x1_ode[4:7], [10, 0, -1], atol=0.02)
    np.testing.assert_allclose(x1_ode[7:10], [10, 0, -0.5], atol=0.02)


# --------------------------- MixtureFluxPose2Pose2 --------------------------

def _weights(rng):
    return dict(W1=rng.normal(size=(4, 8)) * 0.1, b1=rng.normal(size=8) * 0.1,
                W2=rng.normal(size=(8, 48)) * 0.1, b2=rng.normal(size=8) * 0.1,
                W3=rng.normal(size=(2, 8)) * 0.1, b3=np.array([1.0, 0.0]))


def test_nn_forward_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        w = _weights(rng)
        nn_t, nn_j = T.build_pose2_odo_nn_01(**w), R.build_pose2_odo_nn_01(**w)
        for k in nn_j:
            np.testing.assert_array_equal(nn_t[k], nn_j[k])
        data = rng.normal(size=(25, 4))
        want = np.asarray(R.pose2_odo_nn_forward(
            {k: jnp.asarray(v, jnp.float32) for k, v in nn_j.items()}, jnp.asarray(data, jnp.float32)))
        for dt in (torch.float64, torch.float32):
            got = T.pose2_odo_nn_forward({k: torch.as_tensor(v, dtype=dt) for k, v in nn_t.items()},
                                         torch.as_tensor(data, dtype=dt)).double().numpy()
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
            assert got[2] == 0.0
    # the tensorflow get_weights layout (W2 and W3 transposed)
    tf = [w["W1"], w["b1"], w["W2"].T, w["b2"], w["W3"].T, w["b3"]]
    a, b = T.build_pose2_odo_nn_01_from_weights(tf), R.build_pose2_odo_nn_01_from_weights(tf)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_nn_odo_predictor_and_mixture_factor():
    rng = np.random.default_rng(1)
    nn = T.build_pose2_odo_nn_01(**_weights(rng))
    data = rng.normal(size=(25, 4))
    pt, pj = T.NNOdoPredictor(nn, data), R.NNOdoPredictor(nn, data)
    np.testing.assert_allclose(pt.mean(), pj.mean(), atol=1e-6)
    np.testing.assert_array_equal(pt.cov(), pj.cov())
    gen = torch.Generator().manual_seed(0)
    s = pt.sample(gen, 4000, "cpu", torch.float64).numpy()
    assert s.shape == (4000, 3)
    np.testing.assert_allclose(s.mean(0), pt.mean(), atol=4 * 1e-3 / np.sqrt(4000))
    np.testing.assert_allclose(s.std(0), 1e-3, rtol=0.05)

    comp = [T.MvNormal([1.0, 0, 0], np.eye(3) * 0.01)]
    ft = T.MixtureFluxPose2Pose2(nn, data, comp, (0.5, 0.5), DT=1.0)
    fj = R.MixtureFluxPose2Pose2(nn, data, [R.MvNormal([1.0, 0, 0], np.eye(3) * 0.01)],
                                 (0.5, 0.5), DT=1.0)
    assert ft.ftype.name == fj.ftype.name == "Pose2Pose2"
    assert sorted(ft.params) == sorted(fj.params)
    for k in fj.params:
        np.testing.assert_allclose(ft.params[k], fj.params[k], atol=1e-6, rtol=1e-6)
    assert T.FluxModelsPose2Pose2 is T.MixtureFluxPose2Pose2
    # mixture sampling draws from both components
    s = ft.dists[0].sample(torch.Generator().manual_seed(1), 400, "cpu").numpy()
    assert s.shape == (400, 3) and np.isfinite(s).all()
    near_nn = np.linalg.norm(s - pt.mean(), axis=1) < 0.01
    assert 0.3 < near_nn.mean() < 0.7


def test_calc_velocity_inter_pose2_matches_jax():
    for mod in (T, R):
        fac = mod.MixtureFluxPose2Pose2(
            mod.build_pose2_odo_nn_01(), np.zeros((25, 4)),
            [mod.MvNormal([1.0, 0, 0], np.eye(3) * 0.01)], (0.5, 0.5), DT=1.0)
        mod.calc_velocity_inter_pose2(fac, [0, 0, np.pi / 2], [0, 2, np.pi / 2])
        np.testing.assert_allclose(fac.dists[0].components[0].data[:, 2:4],
                                   np.tile([2.0, 0.0], (25, 1)), atol=1e-9)
    fac = T.MixtureFluxPose2Pose2(DT=0.0)
    T.calc_velocity_inter_pose2(fac, [0, 0, 0.3], [1, 2, 0.3])
    assert np.isfinite(fac.dists[0].components[0].data).all()


def test_fluxmix_solves_in_graph():
    """tests/test_ext_factors.py:124-140, and a 20-pose chain of it against
    the JAX package's solution."""
    fg = T.FactorGraph()
    fg.add_variable("x0", T.Pose2)
    fg.add_variable("x1", T.Pose2)
    fg.add_factor(["x0"], T.PriorPose2(T.MvNormal([0, 0, 0], np.eye(3) * 1e-4)))
    fg.add_factor(["x0", "x1"], T.MixtureFluxPose2Pose2(
        T.build_pose2_odo_nn_01(b3=np.array([1.0, 0.0])), np.zeros((25, 4)),
        [T.MvNormal([1.0, 0, 0], np.eye(3) * 0.01)], (0.5, 0.5), DT=1.0))
    fg.init_all()
    res = T.solve_graph_parametric(fg, device="cpu")
    assert res["stats"].converged
    np.testing.assert_allclose(fg.get_coords("x1"), [1, 0, 0], atol=0.05)
    fg_t, fg_j = C.fluxmix_chain_graph(T, 20), C.fluxmix_chain_graph(R, 20)
    res = T.solve_graph_parametric(fg_t, options=T.GNOptions(**C.BIG), device="cpu")
    assert res["stats"].converged
    R.solve_graph_parametric(fg_j, options=R.GNOptions(**C.BIG))
    for k in range(20):
        np.testing.assert_allclose(fg_t.get_coords(f"x{k}"), fg_j.get_coords(f"x{k}"), atol=1e-3)
        np.testing.assert_allclose(fg_t.get_coords(f"x{k}"), [k, 0, 0], atol=1e-3)


# ------------------------------ InertialPose3 -------------------------------

def _ip3_params(rng):
    q = _unit_quat(rng)
    w, x, y, z = q
    rRp = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    pioc = dict(rRp=rRp, rPosp=rng.normal(size=3), rVelp=rng.normal(size=3),
                pBw=rng.normal(size=3) * 0.01, pBa=rng.normal(size=3) * 0.1,
                dt=rng.uniform(0.1, 1.0))
    picg = {k: rng.normal(size=(3, 3)) * 0.1 for k in ("dRdDw", "dVdDw", "dPdDw", "dVdDa", "dPdDa")}
    return pioc, picg


def _ip3_state(rng):
    x = rng.normal(0, 1, 15)
    x[3:6] = rng.uniform(-1.2, 1.2, 3)
    return x


def test_inertialpose3_residuals_match_jax():
    rng = np.random.default_rng(2)
    assert T.InertialPose3V.manifold.dof == 15 and T.get_variable_type("InertialPose3").dof == 15
    for _ in range(6):
        pioc, picg = _ip3_params(rng)
        Z = T.MvNormal(np.zeros(15), np.eye(15) * 0.01)
        ft = T.InertialPose3(Z, pioc, picg, gravity=(0, 0, 9.81))
        fj = R.InertialPose3(R.MvNormal(np.zeros(15), np.eye(15) * 0.01), pioc, picg)
        for k in fj.params:
            np.testing.assert_allclose(ft.params[k], fj.params[k], atol=1e-6, err_msg=k)
        xi, xj = _ip3_state(rng), _ip3_state(rng)
        with jax.enable_x64():
            jp = {k: jnp.asarray(v) for k, v in ft.params.items()}
            want = np.asarray(JL.INERTIAL_POSE3.residual(jp, jnp.asarray(xi), jnp.asarray(xj)))
        tp = {k: torch.as_tensor(v) for k, v in ft.params.items()}
        got = ft.ftype.residual(tp, torch.as_tensor(xi), torch.as_tensor(xj)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)
        z = rng.normal(0, 0.5, 15)
        pt = T.PriorInertialPose3(T.MvNormal(z, np.eye(15) * 0.1))
        with jax.enable_x64():
            want = np.asarray(JL.PRIOR_INERTIAL_POSE3.residual(
                {k: jnp.asarray(v) for k, v in pt.params.items()}, jnp.asarray(xi)))
        got = pt.ftype.residual({k: torch.as_tensor(v) for k, v in pt.params.items()},
                                torch.as_tensor(xi)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)
    assert TL.INERTIAL_POSE3.coord_types == JL.INERTIAL_POSE3.coord_types


def test_inertialpose3_freefall_zero_residual():
    """tests/test_ext_factors.py:143-165."""
    Dt = 0.5
    fac = T.InertialPose3(T.MvNormal(np.zeros(15), np.eye(15) * 0.01),
                          dict(rRp=np.eye(3), rPosp=np.zeros(3), rVelp=np.zeros(3),
                               pBw=np.zeros(3), pBa=np.zeros(3), dt=Dt))
    posej = np.zeros(15)
    posej[6:9] = [0, 0, -9.81 * Dt]
    posej[0:3] = [0, 0, -0.5 * 9.81 * Dt**2]
    for dt in (torch.float32, torch.float64):
        r = fac.ftype.residual({k: torch.as_tensor(v, dtype=dt) for k, v in fac.params.items()},
                               torch.zeros(15, dtype=dt), torch.as_tensor(posej, dtype=dt))
        np.testing.assert_allclose(r.numpy(), np.zeros(15), atol=1e-4)


@pytest.mark.parametrize("n", [2, 10])
def test_inertialpose3_graph_solve(n):
    """tests/test_ext_factors.py:168-188 (n = 2) and the smoke run's
    free-fall chain at 10 states, against the JAX package's solution."""
    Dt = 0.5
    fg = C.freefall_chain_graph(T, n, Dt)
    fg.init_all()
    res = T.solve_graph_parametric(fg, options=T.GNOptions(max_iters=200), device="cpu")
    assert res["stats"].converged
    fj = C.freefall_chain_graph(R, n, Dt)
    fj.init_all()
    R.solve_graph_parametric(fj, options=R.GNOptions(max_iters=200))
    for k in range(n):
        x = fg.get_coords(f"x{k}")
        t = Dt * k
        np.testing.assert_allclose(x[6:9], [0, 0, -9.81 * t], atol=1e-2)
        np.testing.assert_allclose(x[0:3], [0, 0, -0.5 * 9.81 * t**2], atol=1e-2)
        np.testing.assert_allclose(x, fj.get_coords(f"x{k}"), atol=1e-3)
    assert TO.INERTIAL_DYNAMIC.coord_types == JO.INERTIAL_DYNAMIC.coord_types
