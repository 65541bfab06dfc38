"""The port's SO(3), SE(3) and product manifolds against the JAX package's,
in float64 at atol 1e-12 on seeded points (tests/test_manifolds.py:22's
manifolds plus the product variable types), with the group axioms, the
boxplus/local round trip and broadcasting over leading dims."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rome_tpu.manifolds import base as JM  # noqa: E402
from rome_tpu import variables as JV  # noqa: E402
from rome_tpu_torch.manifolds import base as TM  # noqa: E402
from rome_tpu_torch import variables as TV  # noqa: E402

ATOL = 1e-12


def _pairs():
    """(id, jax manifold, port manifold): tests/test_manifolds.py:22's list
    and the product variable types."""
    out = [
        ("T3", JM.T3, TM.T3), ("SO3", JM.SO3_, TM.SO3_), ("SE3", JM.SE3_, TM.SE3_),
        ("SE2xT2", JM.ProductGroup([JM.SE2_, JM.T2]), TM.ProductGroup([TM.SE2_, TM.T2])),
        ("SO3xT3xT3", JM.ProductGroup([JM.SO3_, JM.T3, JM.T3]),
         TM.ProductGroup([TM.SO3_, TM.T3, TM.T3])),
    ]
    for name in ("RotVelPos", "VelPos3", "DynPoint2", "DynPose2", "BearingRange2", "Polar",
                 "IMUBias", "Point3", "Pose3", "Rotation3"):
        out.append((name, JV.get_variable_type(name).manifold,
                    TV.get_variable_type(name).manifold))
    return out


PAIRS = _pairs()
IDS = [p[0] for p in PAIRS]


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _j(fn, *args):
    with jax.enable_x64():
        return np.array(fn(*(jnp.asarray(a) for a in args)))


def _points(jm, n=64, seed=0, scale=1.0):
    """n points ⊞ of seeded tangents at the identity (the JAX package's
    exp), so both sides start from the same valid points."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, scale, (n, jm.dof))
    with jax.enable_x64():
        e = jm.identity(jnp.float64)
        return np.array(jm.boxplus(jnp.broadcast_to(e, (n, jm.point_dim)), jnp.asarray(xi)))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_shape_and_identity_match(pair):
    _, jm, tm = pair
    assert (tm.point_dim, tm.dof, tm.coord_types) == (jm.point_dim, jm.dof, jm.coord_types)
    assert tm.name == jm.name
    e = tm.identity(torch.float32, "cpu")
    assert e.dtype == torch.float32
    np.testing.assert_array_equal(e.double().numpy(), _j(lambda: jm.identity(jnp.float64)))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_ops_match_jax(pair):
    _, jm, tm = pair
    a, b = _points(jm, seed=1), _points(jm, seed=2)
    xi = np.random.default_rng(3).normal(0, 0.8, (a.shape[0], jm.dof))
    for op, args in (("compose", (a, b)), ("inverse", (a,)), ("exp", (xi,)), ("log", (a,)),
                     ("normalize", (a * 1.01,)), ("boxplus", (a, xi)), ("local", (a, b))):
        got = getattr(tm, op)(*map(_t, args)).numpy()
        np.testing.assert_allclose(got, _j(getattr(jm, op), *args), atol=ATOL, err_msg=op)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_group_axioms(pair):
    _, jm, tm = pair
    p, q, r = (_t(_points(jm, n=16, seed=s, scale=0.7)) for s in (4, 5, 6))
    e = tm.identity().expand_as(p)
    np.testing.assert_allclose(tm.compose(p, e).numpy(), p.numpy(), atol=1e-12)
    np.testing.assert_allclose(tm.compose(e, p).numpy(), p.numpy(), atol=1e-12)
    np.testing.assert_allclose(tm.local(e, tm.normalize(tm.compose(p, tm.inverse(p)))).numpy(),
                               0.0, atol=1e-12)
    a = tm.compose(tm.compose(p, q), r)
    b = tm.compose(p, tm.compose(q, r))
    np.testing.assert_allclose(tm.local(a, b).numpy(), 0.0, atol=1e-12)
    xi = _t(np.random.default_rng(7).normal(0, 0.5, (16, tm.dof)))
    np.testing.assert_allclose(tm.local(p, tm.boxplus(p, xi)).numpy(), xi.numpy(), atol=1e-10)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_local_broadcasts_over_leading_dims(pair):
    """local(ref[:, None], pts[None]) is the all-pairs form the generic Gibbs
    score takes: equal to the pairwise loop."""
    _, jm, tm = pair
    ref, pts = _t(_points(jm, n=5, seed=8)), _t(_points(jm, n=7, seed=9))
    allpairs = tm.local(ref[:, None, :], pts[None, :, :])
    assert allpairs.shape == (5, 7, tm.dof)
    for i in range(5):
        np.testing.assert_allclose(allpairs[i].numpy(),
                                   tm.local(ref[i].expand_as(pts), pts).numpy(), atol=1e-15)


def test_se3_mixed_precision_promotes_like_jax():
    """float64 poses composed with float32 measurements compute in float64,
    as JAX's type promotion does (the LM residual path relies on it)."""
    a, b = _points(JM.SE3_, seed=10), _points(JM.SE3_, seed=11).astype(np.float32)
    got = TM.SE3_.compose(_t(a), torch.as_tensor(b))
    assert got.dtype == torch.float64
    with jax.enable_x64():
        want = np.asarray(JM.SE3_.compose(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_every_variable_type_is_registered():
    """Every type of rome_tpu/variables.py, on the same manifold (the JAX
    package registers more types in its later factor modules)."""
    names = [k for k, v in vars(JV).items() if isinstance(v, JV.VariableType)]
    assert len(names) == 12
    assert set(names) <= set(TV.list_variable_types())
    for n in names:
        assert TV.get_variable_type(n).manifold.name == JV.get_variable_type(n).manifold.name
