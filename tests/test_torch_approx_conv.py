"""The port's ``approx_conv`` (the per-factor nonparametric convolution)
against the JAX package's.

- The five convolution asserts of ``tests/test_multimodal.py`` run on the
  port: the odometry projection, the range donut, the bearing-range
  landmark init, the nullhypo mass and the multihypo split.
- Given the same measurement samples, inflated start, association draw and
  nullhypo keep mask (replayed from the JAX package's own key splits), the
  port's deterministic core equals the JAX ``approx_conv`` at atol 1e-4
  in float32 on both sides (the per-particle GN's tolerance), and at 1e-9
  in float64. The range-only donut is held in float64 only: its damped GN
  is rank-deficient (a tangential null direction), so float32 rounding
  moves its particles along the ring by up to ~5e-3 m.
- From the same beliefs, the two packages' outputs agree by the mean
  symmetric k-NN KL < 1.0 (tools/bench_multimodal.py:93's gate).
- ``add_factor``'s multihypo layout errors are the same exceptions with the
  same messages; the point2 factors' residuals equal the JAX ones.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.solvers.multimodal import approx_conv as jax_conv  # noqa: E402
from rome_tpu.solvers.multimodal import init_all_beliefs as jax_init  # noqa: E402
from rome_tpu.solvers.multimodal.convolve import sample_measurements as jax_sample  # noqa: E402
from rome_tpu.solvers.multimodal.kde import silverman_bandwidth as jax_bw  # noqa: E402
from rome_tpu_torch.manifolds.base import SE2_, T2  # noqa: E402
from rome_tpu_torch.solvers.multimodal import approx_conv, init_all_beliefs, manifold_mean  # noqa: E402
from rome_tpu_torch.solvers.multimodal.convolve import conv_with_draws  # noqa: E402
from rome_tpu_torch.solvers.multimodal.metrics import symmetric_kl_knn  # noqa: E402
from rome_tpu_torch.utils.math import sym_rem_np  # noqa: E402

KL_GATE = 1.0


# ---- graphs, built the same way by either package (M = R or T) -------------

def odometry(M):
    fg = M.FactorGraph()
    fg.add_variable("x0", M.Pose2)
    fg.add_factor(["x0"], M.PriorPose2(M.MvNormal([1.0, 2.0, np.pi / 3], [0.01, 0.01, 0.01])))
    fg.add_variable("x1", M.Pose2)
    f = fg.add_factor(["x0", "x1"], M.Pose2Pose2(M.MvNormal([2.0, 0, 0.5], [0.05, 0.05, 0.05])))
    return fg, f.label


def donut(M):
    fg = M.FactorGraph()
    fg.add_variable("x0", M.Pose2)
    fg.add_factor(["x0"], M.PriorPose2(M.MvNormal([0, 0, 0], [0.01, 0.01, 0.01])))
    fg.add_variable("l1", M.Point2)
    # a wide landmark belief, so the ring can be found everywhere
    fg.variables["l1"].beliefs["default"] = np.random.default_rng(3).normal(
        0, 10, (300, 2)).astype(np.float32)
    fg.variables["l1"].initialized["default"] = True
    f = fg.add_factor(["x0", "l1"], M.Pose2Point2Range(M.Normal(10.0, 0.1)))
    return fg, f.label


def bearing_range(M):
    fg = M.FactorGraph()
    fg.add_variable("x0", M.Pose2)
    fg.add_factor(["x0"], M.PriorPose2(M.MvNormal([0, 0, 0], [0.01, 0.01, 0.001])))
    fg.add_variable("l1", M.Point2)
    f = fg.add_factor(
        ["x0", "l1"], M.Pose2Point2BearingRange(M.Normal(np.pi / 4, 0.02), M.Normal(10.0, 0.1))
    )
    return fg, f.label


def nullhypo(M):
    fg = M.FactorGraph()
    fg.add_variable("x0", M.Pose2)
    fg.add_factor(["x0"], M.PriorPose2(M.MvNormal([0, 0, 0], [0.01, 0.01, 0.01])))
    fg.add_variable("l1", M.Point2)
    fg.add_factor(["l1"], M.PriorPoint2(M.MvNormal([0.0, 0.0], [3.0, 3.0])), graphinit=False)
    f = fg.add_factor(
        ["x0", "l1"], M.Pose2Point2BearingRange(M.Normal(0.0, 0.01), M.Normal(20.0, 0.1)),
        nullhypo=0.5, graphinit=False,
    )
    return fg, f.label


def multihypo(M):
    fg = M.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", M.Pose2)
    fg.add_factor(["x0"], M.PriorPose2(M.MvNormal([0, 0, 0], [0.01, 0.01, 0.001])),
                  graphinit=True)
    fg.add_variable("l1", M.Point2)
    fg.add_variable("l2", M.Point2)
    fg.add_factor(["l1"], M.PriorPoint2(M.MvNormal([20.0, 2.0], [0.5, 0.5])))
    fg.add_factor(["l2"], M.PriorPoint2(M.MvNormal([20.0, -2.0], [0.5, 0.5])))
    f = fg.add_factor(
        ["x0", "l1", "l2"],
        M.Pose2Point2BearingRange(M.Normal(0.0, 0.02), M.Normal(20.0, 0.1)),
        multihypo=[1.0, 0.5, 0.5],
    )
    return fg, f.label


GRAPHS = {"odometry": (odometry, 200), "donut": (donut, 300),
          "bearing_range": (bearing_range, 200), "nullhypo": (nullhypo, 400),
          "multihypo": (multihypo, 400)}


def _port(name, seed=0):
    build, N = GRAPHS[name]
    fg, flabel = build(T)
    init_all_beliefs(fg, N=N, seed=seed, device="cpu")
    return fg, flabel, N


def _pair(name, dtype=np.float32):
    """The JAX graph after its own particle init, and the port graph holding
    the same beliefs."""
    build, N = GRAPHS[name]
    fj, flabel = build(R)
    jax_init(fj, N=N)
    ft, _ = build(T)
    for l, rec in fj.variables.items():
        ft.variables[l].beliefs["default"] = np.asarray(rec.beliefs["default"], dtype)
        ft.variables[l].initialized["default"] = True
    return fj, ft, flabel, N


# ---- the test_multimodal.py asserts, on the port ----------------------------

def test_approx_conv_odometry_projection():
    fg, flabel, N = _port("odometry")
    pts = approx_conv(fg, flabel, "x1", N=N, device="cpu")
    assert pts.shape == (N, 3) and pts.dtype == torch.float32
    mu = manifold_mean(SE2_, pts).numpy()
    expect = SE2_.compose(torch.tensor([1, 2, np.pi / 3]), torch.tensor([2.0, 0, 0.5])).numpy()
    np.testing.assert_allclose(mu[:2], expect[:2], atol=0.15)
    assert abs(sym_rem_np(mu[2] - expect[2])) < 0.1


def test_approx_conv_range_donut():
    fg, flabel, N = _port("donut")
    pts = approx_conv(fg, flabel, "l1", N=N, device="cpu").numpy()
    radii = np.linalg.norm(pts, axis=1)
    # particles concentrate on the r = 10 ring with wide angular support
    assert abs(np.median(radii) - 10.0) < 0.3
    assert np.std(radii) < 1.0
    assert np.std(np.arctan2(pts[:, 1], pts[:, 0])) > 0.8


def test_bearing_range_landmark_init():
    fg, _, _ = _port("bearing_range")
    pts = fg.variables["l1"].beliefs["default"]
    assert pts.shape == (200, 2) and pts.dtype == np.float32
    np.testing.assert_allclose(pts.mean(0), 10 * np.array([np.cos(np.pi / 4), np.sin(np.pi / 4)]),
                               atol=0.5)


def test_nullhypo_keeps_prior_mass():
    fg, flabel, N = _port("nullhypo")
    pts = approx_conv(fg, flabel, "l1", N=N, device="cpu").numpy()
    frac = np.mean(np.linalg.norm(pts - np.array([20.0, 0.0]), axis=1) < 2.0)
    assert 0.25 < frac < 0.75


def test_multihypo_splits_association():
    fg, flabel, N = _port("multihypo")
    pts = approx_conv(fg, flabel, "l1", N=N, device="cpu").numpy()
    at_meas = np.mean(np.linalg.norm(pts - np.array([20.0, 0.0]), axis=1) < 1.5)
    assert 0.2 < at_meas < 0.8
    pts_pose = approx_conv(fg, flabel, "x0", N=N, device="cpu").numpy()
    assert pts_pose.shape == (N, 3) and np.all(np.isfinite(pts_pose))
    # graph init ignores the association: every particle takes the first candidate
    init = approx_conv(fg, flabel, "l1", N=N, skip_hypo=True, device="cpu").numpy()
    assert np.mean(np.linalg.norm(init - np.array([20.0, 0.0]), axis=1) < 1.5) > 0.9


# ---- against the JAX package -------------------------------------------------

CORE_CASES = [("odometry", "x1"), ("odometry", "x0"), ("bearing_range", "l1"),
              ("donut", "l1"), ("nullhypo", "l1"), ("multihypo", "l1"), ("multihypo", "l2"),
              ("multihypo", "x0")]


def _core_pair(name, target, dtype):
    """The JAX approx_conv output, and the port's deterministic core fed the
    draws replayed from the JAX package's key splits."""
    fj, ft, flabel, N = _pair(name, dtype)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_conv(fj, flabel, target, key=key, N=N))
    f = fj.factors[flabel]
    arity = f.ftype.arity
    var_idx = list(f.variables).index(target)
    k_meas, k_null, k_assoc, k_infl, _k_pick = jax.random.split(key, 5)
    z = jax_sample(f, k_meas, N)
    tman = fj.variables[target].manifold
    x0 = jnp.asarray(fj.variables[target].beliefs["default"])
    infl = f.inflation if f.inflation is not None else fj.params.inflation
    noise = jax.random.normal(k_infl, (N, tman.dof)) * (jnp.maximum(jax_bw(tman, x0), 1e-2) * infl)
    x0_infl = tman.normalize(tman.boxplus(x0, noise))
    draw = keep = None
    if f.multihypo is not None:
        w = np.asarray(f.multihypo)[arity - 1:]
        draw = torch.as_tensor(np.asarray(
            jax.random.categorical(k_assoc, jnp.log(jnp.asarray(w / w.sum())), shape=(N,))))
    if f.nullhypo:
        keep = torch.as_tensor(np.asarray(jax.random.bernoulli(k_null, p=f.nullhypo, shape=(N,))))
    fp = ft.factors[flabel]
    got = conv_with_draws(
        fp, var_idx, [ft.variables[v].manifold for v in fp.variables[:arity]],
        [torch.as_tensor(np.array(ft.variables[v].beliefs["default"])) for v in fp.variables],
        torch.as_tensor(np.asarray(z)), torch.as_tensor(np.asarray(x0_infl)), draw, keep,
    )
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("name,target", [c for c in CORE_CASES if c[0] != "donut"])
def test_core_matches_jax_given_the_same_draws(name, target):
    got, want = _core_pair(name, target, np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,target", CORE_CASES)
def test_core_matches_jax_in_float64(name, target):
    with jax.enable_x64():
        got, want = _core_pair(name, target, np.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name,target", [
    ("odometry", "x1"), ("bearing_range", "l1"), ("nullhypo", "l1"), ("multihypo", "l1"),
])
def test_approx_conv_agrees_with_jax_by_kl(name, target):
    fj, ft, flabel, N = _pair(name)
    pj = np.asarray(jax_conv(fj, flabel, target, key=jax.random.PRNGKey(4), N=N))
    pt = approx_conv(ft, flabel, target, N=N, seed=4, device="cpu")
    man = SE2_ if pj.shape[1] == 3 else T2
    assert symmetric_kl_knn(man, torch.as_tensor(pj), pt) < KL_GATE


def _layout_error(M, labels, multihypo):
    fg = M.FactorGraph()
    fg.add_variable("x0", M.Pose2)
    fg.add_variable("x1", M.Pose2)
    fg.add_variable("l1", M.Point2)
    fg.add_variable("l2", M.Point2)
    br = M.Pose2Point2BearingRange(M.Normal(0.0, 0.1), M.Normal(20.0, 0.5))
    try:
        fg.add_factor(labels, br, multihypo=multihypo, graphinit=False)
    except (TypeError, ValueError) as e:
        return type(e), str(e)
    return None, fg.factors[fg._fct_order[-1]].multihypo


@pytest.mark.parametrize("labels,multihypo", [
    (["x0", "l1", "l2"], [1.0, 0.5]),            # length mismatch
    (["x0", "l1", "x1"], [1.0, 0.5, 0.5]),       # a candidate of the wrong type
    (["l1", "l2", "l1"], [1.0, 0.5, 0.5]),       # a certain slot of the wrong type
    (["x0", "l1", "l2"], None),                  # extra variables without multihypo
    (["x0", "l1", "l2"], [1.0, 0.5, 0.5]),       # valid
])
def test_multihypo_layout_errors_match_jax(labels, multihypo):
    want = _layout_error(R, labels, multihypo)
    got = _layout_error(T, labels, multihypo)
    assert got == want


def test_adjacency_matches_jax():
    fj, _ = multihypo(R)
    ft, _ = multihypo(T)
    for l in fj._var_order:
        assert ft.neighbors(l) == fj.neighbors(l) == fj._adj[l]
    for fl in fj._fct_order:
        assert ft.neighbors(fl) == fj.neighbors(fl)


@pytest.mark.parametrize("name", ["PriorPoint2", "Point2Point2", "Point2Point2Range"])
def test_point2_residuals_match_jax(name):
    from rome_tpu.factors.base import get_factor_type as jax_type
    from rome_tpu_torch.factors.base import get_factor_type as port_type

    rng = np.random.default_rng(5)
    jt, tt = jax_type(name), port_type(name)
    n = 12
    pts = [rng.normal(0, 5, (n, 2)) for _ in range(jt.arity)]
    z = rng.normal(0, 5, (n, jt.zdim))
    with jax.enable_x64():
        want = np.stack([np.asarray(jt.residual({"z": jnp.asarray(z[i])},
                                                *[jnp.asarray(p[i]) for p in pts]))
                         for i in range(n)])
        inits = {k: np.stack([np.asarray(fn({"z": jnp.asarray(z[i])},
                                            [jnp.asarray(p[i]) for p in pts]))
                              for i in range(n)]) for k, fn in jt.initializers.items()}
    got = tt.residual({"z": torch.as_tensor(z)}, *[torch.as_tensor(p) for p in pts])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert sorted(tt.initializers) == sorted(inits)
    for k, w in inits.items():
        g = tt.initializers[k]({"z": torch.as_tensor(z)}, [torch.as_tensor(p) for p in pts])
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12)
