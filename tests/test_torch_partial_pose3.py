"""Partial Pose3 solves and the 3-D lowering hand-over, against the JAX
package.

- tests/test_partial_pose3.py's three fixtures solved by both packages in
  float64 from the identity start: poses within 1e-6, the same iteration
  count, and the JAX test's own checks on the port's result.
- The lowered Pose3/Point3/Polar batches cross between the packages
  (graph/convert.py) unchanged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from test_torch_factors3d import _lower_both  # noqa: E402
from test_torch_helpers import port_arrays  # noqa: E402


def _zrp_graph(mod):
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x1", mod.Pose3)
    fg.add_factor(["x1"], mod.PriorPose3(mod.MvNormal(
        [0.0, 5.0, 9.0, 0.1, 0.0, np.pi / 2], np.diag([1, 1, 1, 0.1, 0.1, 0.1]) ** 2)))
    fg.add_factor(["x1"], mod.PriorPose3ZRP(
        mod.Normal(11.0, 1.0), mod.MvNormal([-0.1, 0.0], np.diag([0.1, 0.1]) ** 2)))
    return fg


def _xyyaw_graph(mod):
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", mod.Pose3)
    fg.add_variable("x1", mod.Pose3)
    fg.add_factor(["x0"], mod.PriorPose3(mod.MvNormal(np.zeros(6), np.eye(6) * 1e-4)))
    fg.add_factor(["x0", "x1"], mod.Pose3Pose3XYYaw(
        mod.MvNormal([1.0, 2.0, np.pi / 2], np.diag([0.01, 0.01, 0.001]))))
    return fg


def _rotation_graph(mod):
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", mod.Pose3)
    fg.add_variable("x1", mod.Pose3)
    fg.add_factor(["x0"], mod.PriorPose3(mod.MvNormal(np.zeros(6), np.eye(6) * 1e-4)))
    fg.add_factor(["x0", "x1"], mod.Pose3Pose3Rotation(
        mod.MvNormal([0, 0, np.pi / 4], np.eye(3) * 1e-3)))
    return fg


@pytest.mark.parametrize("build", [_zrp_graph, _xyyaw_graph, _rotation_graph],
                         ids=["zrp_fusion", "xyyaw", "rotation"])
def test_partial_pose3_fixtures_match_jax(build):
    """tests/test_partial_pose3.py's fixtures, each solved by both packages
    in float64 from the identity start."""
    with jax.enable_x64():
        fg_j = build(R)
        fg_j.init_all()
        res_j = R.solve_graph_parametric(fg_j, options=R.GNOptions(max_iters=200),
                                         dtype=jnp.float64)
    fg_t = build(T)
    fg_t.init_all()
    res_t = T.solve_graph_parametric(fg_t, options=T.GNOptions(max_iters=200),
                                     dtype=torch.float64, device="cpu")
    assert res_t["stats"].converged and res_j["stats"].converged
    assert res_t["stats"].iterations == res_j["stats"].iterations
    for lbl in fg_j.ls():
        pj, pt = fg_j.get_point(lbl), fg_t.get_point(lbl)
        np.testing.assert_allclose(pt[:3], pj[:3], rtol=0, atol=1e-6)
        # the rotations by their relative angle (q and -q are one rotation)
        rel = T.Pose3.manifold.local(torch.tensor(pj), torch.tensor(pt))
        assert float(rel.abs().max()) < 1e-6
    if build is _zrp_graph:  # test_partial_pose3.py's own checks
        c = fg_t.get_coords("x1")
        np.testing.assert_allclose(c[:3], [0, 5, 10], atol=0.05)
        np.testing.assert_allclose(c[3:6], [0, 0, np.pi / 2], atol=0.05)


@pytest.mark.parametrize("name", ["Pose3Pose3", "PriorPoint3", "PolarPolar"])
def test_lowered_3d_batches_cross_between_the_packages(name):
    """graph/convert.py: the JAX package's lowered arrays, handed over as
    numpy, are the port's own lowering of the same graph."""
    ga_j, ga_t = _lower_both(name, "float64")
    tg = port_arrays(ga_j)
    assert tg.type_names == ga_t.type_names and tg.counts == ga_t.counts
    for t in tg.type_names:
        assert tg.manifolds[t].name == ga_t.manifolds[t].name
        np.testing.assert_array_equal(tg.values0[t].numpy(), ga_t.values0[t].numpy())
    for bc, bt in zip(tg.batches, ga_t.batches):
        assert bc.ftype is bt.ftype and bc.vtypes == bt.vtypes
        np.testing.assert_array_equal(bc.vslots.numpy(), bt.vslots.numpy())
        for k in bt.params:
            np.testing.assert_allclose(bc.params[k].numpy(), bt.params[k].numpy(),
                                       rtol=0, atol=1e-14)


@pytest.mark.parametrize("vtype", ["Pose3", "Point3"])
def test_zero_pose_default_prior_matches_jax(vtype):
    """generate_graph_zero_pose's default prior for the 3-D types."""
    from rome_tpu.canonical.generators import generate_graph_zero_pose as jax_zero
    from rome_tpu_torch.canonical import generate_graph_zero_pose

    mu = np.arange(1.0, 1.0 + getattr(T, vtype).dof) * 0.1
    with jax.enable_x64():
        fg_j = jax_zero(var_type=getattr(R, vtype), mu0=mu)
    fg_t = generate_graph_zero_pose(var_type=getattr(T, vtype), mu0=mu)
    (fj,), (ft,) = fg_j.factors.values(), fg_t.factors.values()
    assert ft.ftype.name == fj.ftype.name == "Prior" + vtype
    for k in fj.params:
        np.testing.assert_array_equal(ft.params[k], fj.params[k])
    np.testing.assert_allclose(fg_t.get_point("x0"), fg_j.get_point("x0"), rtol=0, atol=1e-15)
