"""The inertial stack (rome_tpu_torch/canonical/inertial_sim.py,
factors/inertial.py) against the JAX package.

- ``inertial_sim``: the same streams, bit for bit, for the same seed.
- ``preintegrate_imu`` and ``integrate_imu_delta``: delta, Sigma and J_b
  within 1e-10 (Sigma relative to its largest entry) in float64; the JAX
  side runs its own float64 scan.
- ``IMUDeltaFactor``'s params (z, sqrt_info, delta, J_b, b0, dt, gravity)
  at 1e-10 (sqrt_info relative to its largest entry) for all three
  signatures; the residuals of the three signatures and of the five support
  factors on seeded random points at 1e-10 in float64 (JAX under x64).
- The initializer: the JAX package evaluates it in float32, so it is held
  there at float32 tolerance; the port's (float64) is exact: the residual
  at (x_i, init(x_i)) vanishes.
- tests/test_inertial.py's fixtures through the port.

The 61-keyframe rehearsal of chip_smoke's ``imu_euroc_mh01`` is in
tests/test_torch_imu_rehearsal.py.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu_torch as T  # noqa: E402
from rome_tpu.canonical import inertial_sim as JS  # noqa: E402
from rome_tpu.factors import inertial as JI  # noqa: E402
from rome_tpu_torch.canonical import inertial_sim as TS  # noqa: E402
from rome_tpu_torch.factors import inertial as TI  # noqa: E402
from rome_tpu_torch.manifolds import quat as TQ  # noqa: E402
from rome_tpu_torch.manifolds import sgal3 as TG  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke as C  # noqa: E402

TOL = 1e-10
EUROC = dict(dt=C.IMU_DT, rate=C.IMU_RATE, accel0=C.IMU_GRAVITY, b_a=C.IMU_BIAS_A,
             sigma_a=C.IMU_SIGMA_A, sigma_w=C.IMU_SIGMA_W)


def _stream(mod_sim, **kw):
    return mod_sim.generate_field_inertial_measurement(**{**EUROC, "N": 400, "seed": 0, **kw})


@pytest.mark.parametrize("kw", [{}, {"seed": 5, "w_R_b": np.diag([1.0, -1, -1])},
                                {"sigma_a": 0.0, "sigma_w": 0.0}, "noise"])
def test_inertial_sim_bit_for_bit(kw):
    if kw == "noise":
        a = TS.generate_field_inertial_measurement_noise(N=30, seed=3)
        b = JS.generate_field_inertial_measurement_noise(N=30, seed=3)
    else:
        a, b = _stream(TS, **kw), _stream(JS, **kw)
    for f in ("gyros", "accels", "Sigma_y"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.tspan == b.tspan
    # sample 0 carries no accelerometer bias (the reference's quirk)
    if kw == {}:
        assert not np.allclose(a.accels[0] - C.IMU_GRAVITY, C.IMU_BIAS_A, atol=0.01)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _jax_preintegrate(acc, gyr, dts, Sy, a_b=None, w_b=None):
    return JI.preintegrate_imu(acc, gyr, dts, Sy, a_b, w_b)


@pytest.mark.parametrize("window", [(0, 20, None, None), (20, 40, (0.01, 0.02, -0.03), (1e-3, 0, 2e-3)),
                                    (100, 220, (0.02, -0.01, 0.03), None)])
def test_preintegrate_matches_jax(window):
    lo, hi, a_b, w_b = window
    s = _stream(TS)
    acc, gyr = s.accels[lo:hi], s.gyros[lo:hi]
    dts = np.full(hi - lo, C.IMU_DT)
    got = TI.preintegrate_imu(acc, gyr, dts, s.Sigma_y, a_b, w_b)
    want = _jax_preintegrate(acc, gyr, dts, s.Sigma_y, a_b, w_b)
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=0)
    assert _rel(got[1], want[1]) < TOL, _rel(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=TOL, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"rate": (1.0, -2.0, 3.0), "sigma_w": 0.05}])
def test_preintegrate_equals_integrate_steps(kw):
    """The batched preintegration (running deltas by a scan, the covariance
    and bias-Jacobian recursions in closed form) against the port's own
    ``integrate_imu_delta`` stepped from the identity over 37 samples
    (not a power of two), at 1e-10; the fast-rotating stream turns the
    running delta through about 5 rad."""
    s = _stream(TS, **kw)
    acc, gyr = s.accels[:37], s.gyros[:37]
    a_b, w_b = np.array([0.02, -0.01, 0.03]), np.array([1e-3, -2e-3, 5e-4])
    got = TI.preintegrate_imu(acc, gyr, np.full(37, C.IMU_DT), s.Sigma_y, a_b, w_b)
    f = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))  # noqa: E731
    delta, Sigma, J_b = TG.identity(torch.float64), torch.zeros(10, 10, dtype=torch.float64), \
        torch.zeros(10, 6, dtype=torch.float64)
    for k in range(37):
        delta, Sigma, J_b = TI.integrate_imu_delta(
            delta, Sigma, J_b, f(acc[k]), f(gyr[k]), f(a_b), f(w_b), f([C.IMU_DT]), f(s.Sigma_y))
    np.testing.assert_allclose(got[0], delta.numpy(), atol=TOL, rtol=0)
    assert _rel(got[1], Sigma.numpy()) < TOL, _rel(got[1], Sigma.numpy())
    np.testing.assert_allclose(got[2], J_b.numpy(), atol=TOL, rtol=0)


def test_integrate_imu_delta_step_matches_jax():
    rng = np.random.default_rng(4)
    delta = TG.exp(torch.as_tensor(np.concatenate([rng.normal(0, 0.3, 9), [0.4]]))).numpy()
    Sigma = np.diag(rng.uniform(1e-8, 1e-6, 10))
    J_b = rng.normal(0, 0.1, (10, 6))
    a, w = rng.normal(0, 1, 3) + [0, 0, 9.81], rng.normal(0, 0.3, 3)
    a_b, w_b = rng.normal(0, 0.01, 3), rng.normal(0, 1e-3, 3)
    Sy = np.diag(rng.uniform(1e-6, 1e-4, 6))
    got = TI.integrate_imu_delta(*(torch.as_tensor(x) for x in (delta, Sigma, J_b, a, w, a_b, w_b)),
                                 torch.tensor([0.005], dtype=torch.float64), torch.as_tensor(Sy))
    with jax.enable_x64():
        want = JI.integrate_imu_delta(*(jnp.asarray(x) for x in (delta, Sigma, J_b, a, w, a_b, w_b)),
                                      jnp.asarray(0.005), jnp.asarray(Sy))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=TOL, rtol=1e-10)


SIGNATURES = ["RotVelPos", "RotVelPosBias", "Pose3VelPos3"]


def _factors(signature, lo=40):
    s = _stream(TS)
    args = (s.accels[lo:lo + 20], s.gyros[lo:lo + 20], np.full(20, C.IMU_DT), s.Sigma_y)
    kw = dict(a_b=(0.01, -0.02, 0.0), w_b=(0.0, 1e-3, 0.0), gravity=(0.0, 0.0, 9.8),
              signature=signature)
    return TI.IMUDeltaFactor(*args, **kw), JI.IMUDeltaFactor(*args, **kw)


@pytest.mark.parametrize("signature", SIGNATURES)
def test_imu_factor_params_match_jax(signature):
    ft, fj = _factors(signature)
    assert ft.ftype.name == fj.ftype.name and ft.ftype.coord_types == fj.ftype.coord_types
    assert sorted(ft.params) == sorted(fj.params)
    for k in fj.params:
        if k == "sqrt_info":
            assert _rel(ft.params[k], fj.params[k]) < TOL
        else:
            np.testing.assert_allclose(ft.params[k], fj.params[k], atol=TOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(ft.dists[0].cov(), fj.dists[0].cov(), rtol=1e-9, atol=1e-22)


def _rvp(rng):
    q = rng.normal(size=4)
    return np.concatenate([q / np.linalg.norm(q), rng.normal(0, 2, 6)])


def _points(signature, rng):
    if signature == "RotVelPos":
        return [_rvp(rng), _rvp(rng)]
    if signature == "RotVelPosBias":
        return [_rvp(rng), _rvp(rng), rng.normal(0, 0.05, 6)]
    pose = [np.concatenate([rng.normal(0, 3, 3), _rvp(rng)[:4]]) for _ in range(2)]
    return [pose[0], rng.normal(0, 1, 6), pose[1], rng.normal(0, 1, 6)]


def _residuals(ft, pts, params=None):
    params = ft.params if params is None else params
    with jax.enable_x64():
        jf = getattr(JI, _FTYPE_NAMES[ft.ftype.name])
        want = np.asarray(jf.residual({k: jnp.asarray(v) for k, v in params.items()},
                                      *[jnp.asarray(p) for p in pts]))
    got = ft.ftype.residual({k: torch.as_tensor(v) for k, v in params.items()},
                            *[torch.as_tensor(p) for p in pts]).numpy()
    return got, want


_FTYPE_NAMES = {
    "IMUDeltaRotVelPos": "IMU_DELTA_RVP", "IMUDeltaRotVelPosBias": "IMU_DELTA_RVP_BIAS",
    "IMUDeltaPose3VelPos3": "IMU_DELTA_P3VP", "PriorRotVelPos": "PRIOR_ROTVELPOS",
    "PriorVelPos3": "PRIOR_VELPOS3", "PriorIMUBias": "PRIOR_IMUBIAS",
    "VelPosRotVelPos": "VELPOS_ROTVELPOS", "VelAlign": "VELALIGN",
}


@pytest.mark.parametrize("signature", SIGNATURES)
def test_imu_residuals_match_jax(signature):
    rng = np.random.default_rng(SIGNATURES.index(signature))
    ft, _fj = _factors(signature)
    for _ in range(6):
        got, want = _residuals(ft, _points(signature, rng))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


SUPPORT = {
    "PriorRotVelPos": (lambda rng: T.PriorRotVelPos(T.MvNormal(rng.normal(0, 1, 9), np.eye(9) * 0.1)),
                       lambda rng: [_rvp(rng)]),
    "PriorVelPos3": (lambda rng: T.PriorVelPos3(T.MvNormal(rng.normal(0, 1, 6), np.eye(6))),
                     lambda rng: [rng.normal(0, 1, 6)]),
    "PriorIMUBias": (lambda rng: T.PriorIMUBias(T.MvNormal(rng.normal(0, 0.1, 6), np.eye(6))),
                     lambda rng: [rng.normal(0, 0.1, 6)]),
    "VelPosRotVelPos": (lambda rng: T.VelPosRotVelPos(T.MvNormal(rng.normal(0, 1, 6), np.eye(6))),
                        lambda rng: [rng.normal(0, 1, 6), _rvp(rng)]),
    "VelAlign": (lambda rng: T.VelAlign(T.MvNormal(rng.normal(0, 1, 3), np.eye(3))),
                 lambda rng: [rng.normal(0, 1, 6), _rvp(rng), _rvp(rng)[:4]]),
}


@pytest.mark.parametrize("name", sorted(SUPPORT))
def test_support_factors_match_jax(name):
    rng = np.random.default_rng(len(name))
    make, points = SUPPORT[name]
    for _ in range(6):
        f = make(rng)
        jf = getattr(JI, _FTYPE_NAMES[name])
        assert f.ftype.name == jf.name and f.ftype.coord_types == jf.coord_types
        assert sorted(f.ftype.initializers) == sorted(jf.initializers)
        got, want = _residuals(f, points(rng))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        for k, init in f.ftype.initializers.items():
            with jax.enable_x64():
                w = np.asarray(jf.initializers[k]({key: jnp.asarray(v) for key, v in f.params.items()},
                                                  None))
            g = init({key: torch.as_tensor(v) for key, v in f.params.items()}, None).numpy()
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


@pytest.mark.parametrize("signature", ["RotVelPos", "RotVelPosBias"])
def test_imu_initializer(signature):
    rng = np.random.default_rng(7)
    ft, fj = _factors(signature)
    for _ in range(4):
        xi = _rvp(rng)
        p = {k: torch.as_tensor(v) for k, v in ft.params.items()}
        got = ft.ftype.initializers[1](p, [torch.as_tensor(xi), None])
        want = np.asarray(fj.ftype.initializers[1](fj.params, [xi, None]))  # float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * (1 + np.abs(xi).max()), rtol=1e-5)
        # exact in float64: boxminus(x_i, x_j) is the measured delta
        d = TG.boxminus(TI._rvp_to_sgal(torch.as_tensor(xi), 0.0),
                        TI._rvp_to_sgal(got, p["dt"]), gravity=p["gravity"]).numpy()
        dq = TQ.qmul(TQ.qconj(torch.as_tensor(d[:4])), p["delta"][:4]).numpy()
        np.testing.assert_allclose(np.abs(dq[0]), 1.0, atol=1e-12)
        np.testing.assert_allclose(d[4:], ft.params["delta"][4:], atol=1e-12)
        # so the (bias-free) residual vanishes there
        pts = [xi, got.numpy()] + ([ft.params["b0"]] if signature == "RotVelPosBias" else [])
        r = ft.ftype.residual(p, *[torch.as_tensor(x) for x in pts]).numpy()
        np.testing.assert_allclose(r, np.zeros(9), atol=1e-9)
    # batched over particles
    M = 4
    bp = {k: v.expand(M, *v.shape) for k, v in p.items()}
    out = ft.ftype.initializers[1](bp, [torch.as_tensor(xi).expand(M, 10), None])
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(got.numpy(), (M, 10)), atol=1e-14)


# --- tests/test_inertial.py's fixtures through the port -----------------------

def test_preintegrate_rotating_hover():
    dt, N = 0.01, 10
    dT = N * dt
    imu = TS.generate_field_inertial_measurement(dt=dt, N=N, accel0=(0, 0, 9.81), rate=(0, 0, 0.1))
    delta, _Sigma, _J_b = TI.preintegrate_imu(imu.accels, imu.gyros, np.ones(N) * dt,
                                              np.eye(6) * 0.1**2)
    Rm = TQ.qto_matrix(torch.as_tensor(delta[:4])).numpy()
    c, s = np.cos(0.1 * dT), np.sin(0.1 * dT)
    np.testing.assert_allclose(Rm, [[c, -s, 0], [s, c, 0], [0, 0, 1]], atol=1e-8)
    np.testing.assert_allclose(delta[4:7], [0, 0, 9.81 * dT], atol=1e-8)
    np.testing.assert_allclose(delta[7:10], [0, 0, 0.5 * 9.81 * dT**2], rtol=1e-6)
    assert np.isclose(delta[10], dT)


def _uniform_integrate_check(gyros, accels, dt):
    Rm, v, r = np.eye(3), np.zeros(3), np.zeros(3)
    for g, a in zip(gyros, accels):
        Rm = Rm @ TS._rodrigues(np.asarray(g) * dt)
        dv = Rm @ (np.asarray(a) * dt)
        r = r + v * dt + 0.5 * dv * dt
        v = v + dv
    return Rm, v, r


def _isapprox(a, b, rtol):
    return np.linalg.norm(a - b) <= rtol * max(np.linalg.norm(a), np.linalg.norm(b))


@pytest.mark.parametrize("rate", [(0.01, 0, 0), (0, 0.01, 0)])
def test_preintegrate_vs_uniform_integration(rate):
    dt, N = 0.01, 10
    gyros = np.tile(np.asarray(rate, dtype=np.float64), (N, 1))
    accels = np.tile(np.array([0, 0, 9.81]), (N, 1))
    delta, _, _ = TI.preintegrate_imu(accels, gyros, np.ones(N) * dt, np.eye(6) * 0.1**2)
    Rm, v, r = _uniform_integrate_check(gyros, accels, dt)
    np.testing.assert_allclose(TQ.qto_matrix(torch.as_tensor(delta[:4])).numpy(), Rm, atol=1e-9)
    assert _isapprox(delta[4:7], v, 1e-3) and _isapprox(delta[7:10], r, 1e-3)


def _fixture_stream():
    return TS.generate_field_inertial_measurement_noise(
        dt=0.1, N=10, rate=(0, 0, 0.001), accel0=(0, 0, 9.81 - 1),
        sigma_a=1e-4, sigma_w=np.deg2rad(0.0001))


def test_imu_factor_preintegrated_delta():
    dt, N = 0.1, 10
    imu = _fixture_stream()
    delta = T.IMUDeltaFactor(imu.accels, imu.gyros, np.ones(N) * dt, imu.Sigma_y).params["delta"]
    np.testing.assert_allclose(delta[4:7], [0, 0, 8.81], atol=1e-3)
    np.testing.assert_allclose(delta[7:10], [0, 0, 8.81 / 2], atol=1e-3)
    np.testing.assert_allclose(delta[10], 1.0, atol=1e-12)
    Rm, v, r = _uniform_integrate_check(imu.gyros, imu.accels, dt)
    np.testing.assert_allclose(TQ.qto_matrix(torch.as_tensor(delta[:4])).numpy(), Rm, atol=1e-6)
    assert _isapprox(delta[4:7], v, 1e-5) and _isapprox(delta[7:10], r, 1e-5)


def test_imu_factor_parametric_solve():
    dt, N = 0.1, 10
    imu = _fixture_stream()
    fg = T.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", T.RotVelPos)
    fg.add_variable("x1", T.RotVelPos)
    z0 = np.zeros(9)
    z0[3:6] = [10.0, 0, 0]
    fg.add_factor(["x0"], T.PriorRotVelPos(T.MvNormal(z0, np.eye(9) * 1e-3)))
    fg.add_factor(["x0", "x1"], T.IMUDeltaFactor(imu.accels, imu.gyros, np.ones(N) * dt,
                                                 imu.Sigma_y))
    fg.init_all()
    res = T.solve_graph_parametric(fg, options=T.GNOptions(max_iters=100), device="cpu")
    assert res["stats"].converged
    x1 = fg.variables["x1"].points["parametric"]
    th = 0.001
    c, s = np.cos(th), np.sin(th)
    np.testing.assert_allclose(TQ.qto_matrix(torch.as_tensor(x1[:4])).numpy(),
                               [[c, -s, 0], [s, c, 0], [0, 0, 1]], atol=1e-4)
    np.testing.assert_allclose(x1[4:7], [10, 0, -1], atol=1e-3)
    np.testing.assert_allclose(x1[7:10], [10, 0, -0.5], atol=1e-3)

