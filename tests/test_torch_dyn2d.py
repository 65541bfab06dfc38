"""The velocity-augmented 2D factors (rome_tpu_torch/factors/dyn2d.py)
against the JAX package.

- ``needs_dt``: ``add_factor`` fills params["dt"] from the variables'
  timestamps as the JAX package does, and keeps a ctor-set dt.
- Every residual and initializer of the eight factor types on seeded random
  points, at 1e-10 in float64 (the JAX side under x64).
- The six fixtures of tests/test_dyn2d.py through the port (device="cpu"),
  with their assertions, and their solutions within 1e-3 of the JAX
  package's (the parametric-fixture tolerance).
- The DynPoint2 chain's nonparametric solve (N = 30) against the JAX
  package's: mean symmetric k-NN KL over the variables < 1.0, as
  tests/test_torch_loop.py compares the engines. At this size the engine's
  own Monte-Carlo spread is of the same order: two port solves with other
  seeds differ by a mean KL of about 0.9, two JAX solves by about 0.9.
  DynPoint2 (T(4)) products take K3; DynPose2 (SE(2) x T(2)) takes the
  generic score.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.factors import dyn2d as JD  # noqa: E402
from rome_tpu.solvers.multimodal import solve_graph_nonparametric as jax_np_solve  # noqa: E402
from rome_tpu_torch.factors import dyn2d as TD  # noqa: E402
from rome_tpu_torch.ops import pairwise as TP  # noqa: E402
from rome_tpu_torch.solvers.multimodal.metrics import symmetric_kl_knn  # noqa: E402

SEC = 1_000_000_000
TOL = 1e-10
KL_GATE = 1.0

# (type name, variable type names, ctor name, ctor arity: 1 Z or 2 (pose, vel))
TYPES = [
    ("DYNPOINT2_VELOCITY_PRIOR", ("DynPoint2",)),
    ("DYNPOINT2_DYNPOINT2", ("DynPoint2", "DynPoint2")),
    ("POINT2POINT2_VELOCITY", ("DynPoint2", "DynPoint2")),
    ("VELPOINT2_VELPOINT2", ("DynPoint2", "DynPoint2")),
    ("DYNPOSE2_VELOCITY_PRIOR", ("DynPose2",)),
    ("DYNPOSE2_POSE2", ("DynPose2", "Pose2")),
    ("DYNPOSE2_DYNPOSE2", ("DynPose2", "DynPose2")),
    ("VELPOSE2_VELPOSE2", ("DynPose2", "DynPose2")),
]
POINT_DIMS = {"DynPoint2": 4, "DynPose2": 5, "Pose2": 3}


def _random_point(rng, vt):
    x = rng.normal(0, 2, POINT_DIMS[vt])
    if vt != "DynPoint2":
        x[2] = rng.uniform(-np.pi, np.pi)
    return x


def _random_params(rng, ftype):
    zdim = ftype.zdim
    z = rng.normal(0, 1, zdim)
    if ftype.coord_types[2:3] == ("c",):
        z[2] = rng.uniform(-np.pi, np.pi)
    return {"z": z, "sqrt_info": np.eye(zdim), "dt": np.float64(rng.uniform(0.2, 2.0))}


@pytest.mark.parametrize("name,vtypes", TYPES, ids=[t[0] for t in TYPES])
def test_residual_and_initializers_match_jax(name, vtypes):
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    jf, tf = getattr(JD, name), getattr(TD, name)
    assert tf.name == jf.name and tf.zdim == jf.zdim and tf.needs_dt == jf.needs_dt
    assert tf.coord_types == jf.coord_types and tf.partial == jf.partial
    assert sorted(tf.initializers) == sorted(jf.initializers)
    for _ in range(8):
        params = _random_params(rng, tf)
        pts = [_random_point(rng, vt) for vt in vtypes]
        with jax.enable_x64():
            jp = {k: jnp.asarray(v) for k, v in params.items()}
            want = np.asarray(jf.residual(jp, *[jnp.asarray(p) for p in pts]))
            inits = {k: np.asarray(fn(jp, [jnp.asarray(p) for p in pts]))
                     for k, fn in jf.initializers.items()}
        tp = {k: torch.as_tensor(v) for k, v in params.items()}
        got = tf.residual(tp, *[torch.as_tensor(p) for p in pts]).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        for k, fn in tf.initializers.items():
            out = fn(tp, [torch.as_tensor(p) for p in pts]).numpy()
            np.testing.assert_allclose(out, inits[k], atol=TOL, rtol=0)
        # the initializers also run batched (the particles of a convolution)
        for k, fn in tf.initializers.items():
            M = 5
            bp = {key: v.expand(M, *v.shape) for key, v in tp.items()}
            out = fn(bp, [torch.as_tensor(p).expand(M, p.shape[0]) for p in pts]).numpy()
            np.testing.assert_allclose(out, np.broadcast_to(inits[k], out.shape), atol=TOL)


def _dt_graph(mod, dt_ns, explicit=None):
    fg = mod.FactorGraph()
    fg.add_variable("x0", mod.DynPoint2, timestamp_ns=0)
    fg.add_variable("x1", mod.DynPoint2, timestamp_ns=dt_ns)
    f = mod.DynPoint2DynPoint2(mod.MvNormal([1.0, 0, 0, 0], np.eye(4) * 0.1))
    if explicit is not None:
        f.params["dt"] = np.float64(explicit)
    fg.add_factor(["x0", "x1"], f, graphinit=False)
    p = mod.DynPoint2VelocityPrior(mod.MvNormal([0.0, 0, 1, 0], np.eye(4) * 0.1))
    fg.add_factor(["x0"], p, graphinit=False)
    return f, p


@pytest.mark.parametrize("explicit", [None, 0.25])
def test_needs_dt_fills_dt_from_timestamps(explicit):
    fj, pj = _dt_graph(R, 1_500_000_000, explicit)
    ft, pt = _dt_graph(T, 1_500_000_000, explicit)
    assert ft.params["dt"] == fj.params["dt"] == (1.5 if explicit is None else explicit)
    # a factor type without needs_dt gets no dt
    assert "dt" not in pt.params and "dt" not in pj.params


# --- the six fixtures of tests/test_dyn2d.py ---------------------------------

def _dynpoint2_chain(mod):
    fg = mod.FactorGraph()
    fg.add_variable("x0", mod.DynPoint2, timestamp_ns=0)
    fg.add_variable("x1", mod.DynPoint2, timestamp_ns=SEC)
    fg.add_factor(["x0"], mod.DynPoint2VelocityPrior(mod.MvNormal([0, 0, 10, 10], np.eye(4) * 0.1)))
    fg.add_factor(["x0", "x1"], mod.DynPoint2DynPoint2(mod.MvNormal([10, 10, 0, 0], np.eye(4) * 0.1)))
    return fg, {}


def _check_dynpoint2_chain(fg):
    np.testing.assert_allclose(fg.get_coords("x0"), [0, 0, 10, 10], atol=1e-3)
    np.testing.assert_allclose(fg.get_coords("x1"), [20, 20, 10, 10], atol=1e-3)


def _velpoint2_chain(mod):
    fg = mod.FactorGraph()
    for k in range(4):
        fg.add_variable(f"x{k}", mod.DynPoint2, timestamp_ns=k * SEC)
    fg.add_factor(["x0"], mod.DynPoint2VelocityPrior(mod.MvNormal([0, 0, 1, 0], np.eye(4) * 0.01)))
    for k in range(3):
        fg.add_factor([f"x{k}", f"x{k+1}"],
                      mod.VelPoint2VelPoint2(mod.MvNormal([1, 0, 0, 0], np.eye(4) * 0.01)))
    return fg, dict(max_iters=200)


def _check_velpoint2_chain(fg):
    x3 = fg.get_coords("x3")
    np.testing.assert_allclose(x3[:2], [3, 0], atol=0.05)
    np.testing.assert_allclose(x3[2:4], [1, 0], atol=0.05)


def _point2point2velocity(mod):
    fg = mod.FactorGraph()
    fg.add_variable("x0", mod.DynPoint2, timestamp_ns=0)
    fg.add_variable("x1", mod.DynPoint2, timestamp_ns=2 * SEC)
    fg.add_factor(["x0"], mod.DynPoint2VelocityPrior(mod.MvNormal([0, 0, 1, 0], np.eye(4) * 0.01)))
    fg.add_factor(["x0", "x1"],
                  mod.Point2Point2Velocity(mod.MvNormal([2, 0, 0, 0], np.eye(4) * 0.01)))
    return fg, dict(max_iters=200)


def _check_point2point2velocity(fg):
    x1 = fg.get_coords("x1")
    np.testing.assert_allclose(x1[:2], [2, 0], atol=0.05)
    np.testing.assert_allclose(x1[2:4], [1, 0], atol=0.1)


def _dynpose2_velpose2(mod):
    fg = mod.FactorGraph()
    fg.add_variable("x0", mod.DynPose2, timestamp_ns=0)
    fg.add_variable("x1", mod.DynPose2, timestamp_ns=SEC)
    fg.add_factor(["x0"], mod.DynPose2VelocityPrior(
        mod.MvNormal(np.zeros(3), np.diag([0.01, 0.01, 0.001]) ** 2),
        mod.MvNormal([10.0, 0], np.diag([0.1, 0.1]) ** 2)))
    fg.add_factor(["x0", "x1"], mod.VelPose2VelPose2(
        mod.MvNormal([10.0, 0, 0], np.diag([0.01, 0.01, 0.001]) ** 2),
        mod.MvNormal([0.0, 0], np.diag([0.1, 0.1]) ** 2)))
    return fg, dict(max_iters=300)


def _check_dynpose2_velpose2(fg):
    x1 = fg.get_coords("x1")
    np.testing.assert_allclose(x1[0], 10.0, atol=0.75)
    np.testing.assert_allclose(x1[1], 0.0, atol=0.75)
    assert abs(np.arctan2(np.sin(x1[2]), np.cos(x1[2]))) < 0.25
    np.testing.assert_allclose(x1[3], 10.0, atol=0.5)
    np.testing.assert_allclose(x1[4], 0.0, atol=0.5)


def _dynpose2pose2(mod):
    fg = mod.FactorGraph()
    fg.add_variable("x0", mod.DynPose2, timestamp_ns=0)
    fg.add_variable("p1", mod.Pose2, timestamp_ns=SEC)
    fg.add_factor(["x0"], mod.DynPose2VelocityPrior(
        mod.MvNormal([1.0, 2, 0.5], np.eye(3) * 0.001), mod.MvNormal([3.0, 4], np.eye(2) * 0.01)))
    fg.add_factor(["x0", "p1"], mod.DynPose2Pose2(mod.MvNormal([1.0, 0, 0], np.eye(3) * 0.001)))
    return fg, {}


def _check_dynpose2pose2(fg):
    c, s = np.cos(0.5), np.sin(0.5)
    np.testing.assert_allclose(fg.get_coords("p1"), [1 + c, 2 + s, 0.5], atol=1e-3)
    np.testing.assert_allclose(fg.get_coords("x0")[3:5], [3, 4], atol=1e-3)


def _dynpose2dynpose2(mod):
    fg = mod.FactorGraph()
    fg.add_variable("x0", mod.DynPose2, timestamp_ns=0)
    fg.add_variable("x1", mod.DynPose2, timestamp_ns=SEC)
    fg.add_factor(["x0"], mod.DynPose2VelocityPrior(
        mod.MvNormal(np.zeros(3), np.eye(3) * 0.001), mod.MvNormal([2.0, 0], np.eye(2) * 0.01)))
    fg.add_factor(["x0", "x1"],
                  mod.DynPose2DynPose2(mod.MvNormal([1.0, 0, 0, 0, 0], np.eye(5) * 0.01)))
    return fg, dict(max_iters=200)


def _check_dynpose2dynpose2(fg):
    x1 = fg.get_coords("x1")
    np.testing.assert_allclose(x1[:2], [3, 0], atol=1e-2)
    np.testing.assert_allclose(x1[3:5], [2, 0], atol=1e-2)


FIXTURES = {
    "dynpoint2_chain": (_dynpoint2_chain, _check_dynpoint2_chain),
    "velpoint2_chain": (_velpoint2_chain, _check_velpoint2_chain),
    "point2point2velocity_midpoint": (_point2point2velocity, _check_point2point2velocity),
    "dynpose2_velpose2": (_dynpose2_velpose2, _check_dynpose2_velpose2),
    "dynpose2pose2_partial": (_dynpose2pose2, _check_dynpose2pose2),
    "dynpose2dynpose2_legacy": (_dynpose2dynpose2, _check_dynpose2dynpose2),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_dyn2d_fixture_through_the_port(name):
    build, check = FIXTURES[name]
    fg_t, opts = build(T)
    fg_t.init_all()
    res = T.solve_graph_parametric(fg_t, options=T.GNOptions(**opts), device="cpu")
    assert res["stats"].converged
    check(fg_t)
    fg_j, _ = build(R)
    fg_j.init_all()
    R.solve_graph_parametric(fg_j, options=R.GNOptions(**opts))
    for label in fg_t._var_order:
        np.testing.assert_allclose(fg_t.get_coords(label), fg_j.get_coords(label), atol=1e-3)


# --- the DynPoint2 chain, nonparametric ----------------------------------------

def dynpoint2_chain_graph(mod, n=10, fix_every=3):
    """A DynPoint2 chain of ``n`` states 1 s apart moving at 1 m/s along x:
    a DynPoint2VelocityPrior at the truth on x0 and on every ``fix_every``-th
    state (sigma 0.3, position fixes that keep the chain's beliefs from
    drifting apart between runs), and constant-velocity DynPoint2DynPoint2
    odometry (sigma 0.1)."""
    fg = mod.FactorGraph()
    for k in range(n):
        fg.add_variable(f"x{k}", mod.DynPoint2, timestamp_ns=k * SEC)
    for k in range(0, n, fix_every):
        fg.add_factor([f"x{k}"], mod.DynPoint2VelocityPrior(mod.MvNormal([k, 0, 1, 0], [0.3] * 4)))
    for k in range(n - 1):
        fg.add_factor([f"x{k}", f"x{k + 1}"],
                      mod.DynPoint2DynPoint2(mod.MvNormal([0, 0, 0, 0], [0.1] * 4)))
    return fg


def test_dyn2d_manifolds_kernel_dispatch():
    assert TP.pairwise_draw_for(T.DynPoint2.manifold) is not None   # K3, dof 4
    assert TP.pairwise_draw_for(T.DynPose2.manifold) is None        # generic score


def test_dynpoint2_chain_nonparametric_matches_jax():
    N = 30
    fg_t = dynpoint2_chain_graph(T)
    T.solve_graph_nonparametric(fg_t, sweeps=3, N=N, engine="batched", init=True, device="cpu")
    fg_j = dynpoint2_chain_graph(R)
    jax_np_solve(fg_j, sweeps=3, N=N, engine="batched", init=True)
    man = T.DynPoint2.manifold
    kls = []
    for label in fg_t._var_order:
        bt = np.asarray(fg_t.variables[label].beliefs["default"])
        bj = np.asarray(fg_j.variables[label].beliefs["default"])
        assert bt.shape == (N, 4) and np.isfinite(bt).all()
        kls.append(symmetric_kl_knn(man, torch.as_tensor(bt, dtype=torch.float64),
                                    torch.as_tensor(bj, dtype=torch.float64)))
        # the chain's truth: x_k = (k, 0, 1, 0)
        k = int(label[1:])
        np.testing.assert_allclose(bt.mean(0), [k, 0, 1, 0], atol=1.5)
    assert np.mean(kls) < KL_GATE, kls
