"""The port's 3-D, polar and partial factor library against the JAX package.

- One case per factor type the slice adds (15): the same seeded graph
  built in both packages (random points, random measurements with full
  covariances), lowered, and linearized by each package's
  ``batch_linearize`` (the JAX package's ``vmap(jacfwd)``): the lowered
  params equal, the whitened residuals and Jacobians within 1e-10 in
  float64 (float32, at 2e-5: tests/test_torch_factors3d_f32.py); the
  closed-form initializers agree.
- Every factor type of rome_tpu/factors/{pose2,point3,pose3,polar}.py is
  registered in the port with the same signature, zdim, coord types and
  ``partial``.

The partial Pose3 fixtures solved by both packages and the hand-over of the
lowered 3-D batches are in tests/test_torch_partial_pose3.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.factors.base import get_factor_type as jax_factor_type  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.solvers import linearize as JL  # noqa: E402
from rome_tpu_torch.factors.base import get_factor_type  # noqa: E402
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from rome_tpu_torch.solvers import linearize as TL  # noqa: E402
from test_torch_helpers import port_arrays  # noqa: E402

ATOL = {"float32": 2e-5, "float64": 1e-10}


def _cov(rng, d, scale):
    A = rng.normal(0, 0.3, (d, d))
    return np.diag(rng.uniform(0.5, 1.5, d) * scale ** 2) + 0.1 * scale ** 2 * (A @ A.T)


def _gauss(mod, rng, mean, scale):
    mean = np.asarray(mean, float)
    return mod.MvNormal(mean, _cov(rng, mean.size, scale))


# factor type -> (variable types, constructor(mod, rng))
CASES = {
    "PartialPriorYawPose2": (("Pose2",), lambda m, r: m.PartialPriorYawPose2(
        m.Normal(r.uniform(-3, 3), 0.1))),
    "Pose2Point2": (("Pose2", "Point2"), lambda m, r: m.Pose2Point2(
        _gauss(m, r, r.normal(0, 3, 2), 0.2))),
    "PriorPoint3": (("Point3",), lambda m, r: m.PriorPoint3(_gauss(m, r, r.normal(0, 3, 3), 0.3))),
    "Point3Point3": (("Point3", "Point3"), lambda m, r: m.Point3Point3(
        _gauss(m, r, r.normal(0, 3, 3), 0.3))),
    "PriorPose3": (("Pose3",), lambda m, r: m.PriorPose3(
        _gauss(m, r, np.r_[r.normal(0, 3, 3), r.normal(0, 0.5, 3)], 0.1))),
    "Pose3Pose3": (("Pose3", "Pose3"), lambda m, r: m.Pose3Pose3(
        _gauss(m, r, np.r_[r.normal(0, 3, 3), r.normal(0, 0.5, 3)], 0.1))),
    "Pose3Pose3RotOffset": (("Pose3", "Pose3", "Rotation3"), lambda m, r: m.Pose3Pose3RotOffset(
        _gauss(m, r, np.r_[r.normal(0, 3, 3), r.normal(0, 0.5, 3)], 0.1))),
    "Pose3Pose3Transform": (("Pose3", "Pose3", "Pose3"), lambda m, r: m.Pose3Pose3Transform(
        _gauss(m, r, np.r_[r.normal(0, 3, 3), r.normal(0, 0.5, 3)], 0.1))),
    "Pose3Pose3UnitTrans": (("Pose3", "Pose3"), lambda m, r: m.Pose3Pose3UnitTrans(
        _gauss(m, r, np.r_[r.normal(0, 3, 3), r.normal(0, 0.5, 3)], 0.1))),
    "PriorRotation3": (("Rotation3",), lambda m, r: m.PriorRotation3(
        _gauss(m, r, r.normal(0, 0.5, 3), 0.1))),
    "PriorPose3ZRP": (("Pose3",), lambda m, r: m.PriorPose3ZRP(
        m.Normal(r.normal(0, 3), 0.5), _gauss(m, r, r.normal(0, 0.3, 2), 0.1))),
    "Pose3Pose3XYYaw": (("Pose3", "Pose3"), lambda m, r: m.Pose3Pose3XYYaw(
        _gauss(m, r, np.r_[r.normal(0, 3, 2), r.uniform(-3, 3)], 0.1))),
    "Pose3Pose3Rotation": (("Pose3", "Pose3"), lambda m, r: m.Pose3Pose3Rotation(
        _gauss(m, r, r.normal(0, 0.5, 3), 0.05))),
    "PriorPolar": (("Polar",), lambda m, r: m.PriorPolar(
        m.Normal(r.uniform(1, 5), 0.2), m.Normal(r.uniform(-3, 3), 0.05))),
    "PolarPolar": (("Polar", "Polar"), lambda m, r: m.PolarPolar(
        m.Normal(r.uniform(-2, 2), 0.2), m.Normal(r.uniform(-3, 3), 0.05))),
}
N_VARS, N_FACTORS = 5, 8


def _points(vtype, n, rng):
    """n seeded points of a variable type (exp of seeded tangents, f64),
    rotations within 0.6 rad of the identity so no pose is near-vertical."""
    man = T.get_variable_type(vtype).manifold
    xi = rng.normal(0, 2.0, (n, man.dof))
    for k, c in enumerate(man.coord_types):
        if c == "c":
            xi[:, k] = rng.uniform(-0.6, 0.6, n)
    return man.exp(torch.as_tensor(xi)).numpy()


def _graph(mod, name, seed=0):
    vtypes, ctor = CASES[name]
    rng = np.random.default_rng(seed)
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    labels = {}
    for t in dict.fromkeys(vtypes):
        pts = _points(t, N_VARS, rng)
        labels[t] = []
        for i in range(N_VARS):
            lbl = f"{t.lower()}{i}"
            fg.add_variable(lbl, getattr(mod, t))
            fg.set_point(lbl, pts[i])
            labels[t].append(lbl)
    for _ in range(N_FACTORS):
        used, vs = set(), []
        for t in vtypes:
            choice = [l for l in labels[t] if l not in used]
            lbl = choice[rng.integers(len(choice))]
            used.add(lbl)
            vs.append(lbl)
        fg.add_factor(vs, ctor(mod, rng))
    return fg


def _lower_both(name, dtype):
    with jax.enable_x64():
        ga_j = jax_lower(_graph(R, name), dtype=getattr(jnp, dtype))
    ga_t = lower(_graph(T, name), dtype=getattr(torch, dtype), device="cpu")
    return ga_j, ga_t


def check_linearization(name, dtype):
    ga_j, ga_t = _lower_both(name, dtype)
    assert [b.ftype.name for b in ga_t.batches] == [name]
    bj, bt = ga_j.batches[0], ga_t.batches[0]
    for k in bj.params:
        np.testing.assert_allclose(bt.params[k].numpy(), np.asarray(bj.params[k]),
                                   rtol=0, atol=1e-14 if dtype == "float64" else 1e-6)
    with jax.enable_x64():
        # one compiled program (op-by-op dispatch of the quaternion algebra
        # under vmap(jacfwd) compiles each primitive separately)
        r_j, Js_j = jax.jit(lambda v: JL.batch_linearize(ga_j, bj, v))(ga_j.values0)
        r_j, Js_j = np.asarray(r_j), [np.asarray(J) for J in Js_j]
    r_t, Js_t = TL.batch_linearize(ga_t, bt, ga_t.values0)
    assert r_t.dtype == getattr(torch, dtype)
    assert all(J.dtype == getattr(torch, dtype) for J in Js_t)
    assert np.abs(r_j).max() > 1e-3  # the points are off the measurements
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=0, atol=ATOL[dtype])
    assert len(Js_t) == len(Js_j)
    for Jt, Jj in zip(Js_t, Js_j):
        assert np.isfinite(Jt.numpy()).all()
        np.testing.assert_allclose(Jt.numpy(), Jj, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("name", list(CASES))
def test_factor_linearization_matches_jax(name):
    check_linearization(name, "float64")


@pytest.mark.parametrize("name", [n for n in CASES if get_factor_type(n).initializers])
def test_initializers_match_jax(name):
    ftype, jtype = get_factor_type(name), jax_factor_type(name)
    assert sorted(ftype.initializers) == sorted(jtype.initializers)
    fg = _graph(T, name)
    f = fg.factors[fg._fct_order[0]]
    pts = [fg.get_point(v) for v in f.variables]
    for slot, init in ftype.initializers.items():
        got = init({k: torch.as_tensor(v) for k, v in f.params.items()},
                   [torch.as_tensor(p) for p in pts]).numpy()
        with jax.enable_x64():
            want = np.asarray(jtype.initializers[slot](
                {k: jnp.asarray(v) for k, v in f.params.items()}, [jnp.asarray(p) for p in pts]))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_every_factor_type_of_the_slice_is_registered():
    import rome_tpu.factors.point3 as jp3
    import rome_tpu.factors.polar as jpo
    import rome_tpu.factors.pose2 as jp2
    import rome_tpu.factors.pose3 as jp3d

    names = [v.name for mod in (jp2, jp3, jp3d, jpo) for v in vars(mod).values()
             if isinstance(v, type(jax_factor_type("Pose2Pose2")))]
    assert len(set(names)) == 18
    for n in names:
        ft, jt = get_factor_type(n), jax_factor_type(n)
        assert ft.zdim == jt.zdim and ft.coord_types == jt.coord_types
        assert ft.partial == jt.partial, n
        assert [v.name for v in ft.variable_types] == [v.name for v in jt.variable_types]
        assert hasattr(T, n)
