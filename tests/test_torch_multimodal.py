"""The pieces of the port's nonparametric path against the JAX package, on
the beehive-10 graph (11 Pose2, 7 Point2).

- The generator: the same labels, factor order, measurements and simulated
  PPEs, exactly (JAX in float64, as the port propagates the ground truth).
- The points after ``init_all`` at 1e-9 (float64 on both sides).
- The lowering's nonparametric fields (labels, nullhypo, inflation,
  excluded factors) and their hand-over through ``graph_arrays_from_numpy``.
- The propagator's routing, exactly: every source's dest_var / dest_k,
  kmax, has_msg and msg_factor.
- ``_sample_z`` given the same standard-normal draws, and
  ``_gn_solve_target`` per particle given the same z, x0 and other points,
  float32 at atol 1e-4, for both slots of Pose2Pose2 and
  Pose2Point2BearingRange.
- The port's ``solve_graph_parametric`` of beehive-10 against the JAX
  package's, at atol 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.canonical.patterns import generate_graph_beehive as jax_beehive  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.solvers.multimodal import batched as JB  # noqa: E402
from rome_tpu.solvers.multimodal.convolve import _gn_solve_target as jax_gn  # noqa: E402
from rome_tpu_torch.canonical import generate_graph_beehive as port_beehive  # noqa: E402
from rome_tpu_torch.graph.convert import beliefs_from_numpy, graph_arrays_from_numpy  # noqa: E402
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from rome_tpu_torch.solvers.multimodal import batched as TB  # noqa: E402
from rome_tpu_torch.solvers.multimodal.convolve import _gn_solve_target  # noqa: E402

POSES = 10


def _graphs():
    with jax.enable_x64():
        fj = jax_beehive(pose_count_target=POSES, graphinit=False)
    return fj, port_beehive(pose_count_target=POSES, graphinit=False)


def test_beehive_generator_matches_jax():
    fj, ft = _graphs()
    assert ft._var_order == fj._var_order and ft._fct_order == fj._fct_order
    assert len(ft.ls(r"^x\d+$")) == POSES + 1 and len(ft.ls(r"^l\d+$")) == 7
    for lbl in fj._var_order:
        vj, vt = fj.variables[lbl], ft.variables[lbl]
        assert vt.vtype.name == vj.vtype.name and vt.tags == vj.tags
        assert vt.solvable == vj.solvable
        np.testing.assert_array_equal(vt.ppes["simulated"], vj.ppes["simulated"])
    for lbl in fj._fct_order:
        a, b = fj.factors[lbl], ft.factors[lbl]
        assert b.ftype.name == a.ftype.name and b.variables == a.variables
        assert b.nullhypo == a.nullhypo and b.inflation == a.inflation
        assert sorted(b.params) == sorted(a.params)
        for k, v in a.params.items():
            np.testing.assert_array_equal(b.params[k], v)


def test_init_all_matches_jax():
    fj, ft = _graphs()
    with jax.enable_x64():
        fj.init_all("default")
    ft.init_all("default")
    for lbl in fj._var_order:
        np.testing.assert_allclose(
            ft.get_point(lbl, "default"), fj.get_point(lbl, "default"), rtol=0, atol=1e-9
        )


def test_lowering_carries_the_nonparametric_fields():
    fj, ft = _graphs()
    ft.factors[ft._fct_order[3]].nullhypo = 0.25
    fj.factors[fj._fct_order[3]].nullhypo = 0.25
    ft.factors[ft._fct_order[4]].inflation = 2.0
    fj.factors[fj._fct_order[4]].inflation = 2.0
    gj, gt = jax_lower(fj, "default"), lower(ft, "default", device="cpu")
    assert gt.excluded_factors == gj.excluded_factors == []
    assert [b.ftype.name for b in gt.batches] == [b.ftype.name for b in gj.batches]
    for bt, bj in zip(gt.batches, gj.batches):
        assert bt.labels == bj.labels
        np.testing.assert_array_equal(bt.nullhypo.numpy(), np.asarray(bj.nullhypo, np.float32))
        np.testing.assert_array_equal(bt.inflation.numpy(), np.asarray(bj.inflation, np.float32))
    hand = graph_arrays_from_numpy(
        gj.type_names, gj.counts,
        {t: np.asarray(v) for t, v in gj.values0.items()},
        {t: np.asarray(v) for t, v in gj.free.items()},
        [dict(ftype=b.ftype.name, vslots=np.asarray(b.vslots),
              params={k: np.asarray(v) for k, v in b.params.items()},
              weight=np.asarray(b.weight), labels=b.labels,
              nullhypo=b.nullhypo, inflation=b.inflation) for b in gj.batches],
        var_labels=gj.var_labels, excluded_factors=gj.excluded_factors, device="cpu",
    )
    for bh, bt in zip(hand.batches, gt.batches):
        assert bh.labels == bt.labels
        np.testing.assert_array_equal(bh.nullhypo.numpy(), bt.nullhypo.numpy())
        np.testing.assert_array_equal(bh.inflation.numpy(), bt.inflation.numpy())
    bel = beliefs_from_numpy({"Pose2": np.zeros((11, 5, 3)), "Point2": np.ones((7, 5, 2))},
                             device="cpu")
    assert bel["Pose2"].dtype == torch.float32 and bel["Point2"].shape == (7, 5, 2)


def test_propagator_routing_matches_jax():
    fj, ft = _graphs()
    gj, gt = jax_lower(fj, "default"), lower(ft, "default", device="cpu")
    bj = JB.build_propagator(fj, gj, N=30)
    bt = TB.build_propagator(ft, gt, N=30)
    assert bt.kmax == bj.kmax and bt.kmax["Pose2"] == 3
    assert len(bt.sources) == len(bj.sources) == 5
    for st, sj in zip(bt.sources, bj.sources):
        assert (st.b, st.s, st.ttype) == (sj.b, sj.s, sj.ttype)
        np.testing.assert_array_equal(st.dest_var, sj.dest_var)
        np.testing.assert_array_equal(st.dest_k, sj.dest_k)
        np.testing.assert_array_equal(st.dest_var_t.numpy(), sj.dest_var)
    for t in gj.type_names:
        np.testing.assert_array_equal(bt.has_msg[t], bj.has_msg[t])
        np.testing.assert_array_equal(bt.msg_factor[t], bj.msg_factor[t])
    # the structure cache hands the same routing to a same-shape graph
    again = lower(ft, "default", device="cpu")
    assert TB.get_propagator(ft, gt, 30) is TB.get_propagator(ft, again, 30)


def _batch(fj, ft, name):
    gj, gt = jax_lower(fj, "default"), lower(ft, "default", device="cpu")
    i = [b.ftype.name for b in gj.batches].index(name)
    return gj.batches[i], gt.batches[i], gj


def test_sample_z_matches_jax_given_the_same_draws():
    fj, ft = _graphs()
    bj, bt, _ = _batch(fj, ft, "Pose2Point2BearingRange")
    key, N = jax.random.PRNGKey(3), 40
    L = jnp.linalg.inv(bj.params["sqrt_info"])
    want = JB._sample_z(bj.params, L, key, N)
    eps = jax.random.normal(key, (bj.n, N, 2), dtype=jnp.float32)
    got = TB._sample_z(
        bt.params, torch.linalg.inv(bt.params["sqrt_info"]), torch.as_tensor(np.array(eps))
    )
    assert got.shape == (bj.n, N, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,slot", [
    ("Pose2Pose2", 0), ("Pose2Pose2", 1),
    ("Pose2Point2BearingRange", 0), ("Pose2Point2BearingRange", 1),
])
def test_gn_solve_target_matches_jax_per_particle(name, slot):
    fj, ft = _graphs()
    fj.init_all("default")
    bj, bt, gj = _batch(fj, ft, name)
    rng = np.random.default_rng(slot + 10 * len(name))
    P = 8  # particles per factor
    n = bj.n
    vsl = np.asarray(bj.vslots)
    truth = [np.asarray([fj.get_point(gj.var_labels[t][s], "default")
                         for s in vsl[:, k]]) for k, t in enumerate(bj.vtypes)]
    pts = [np.repeat(p, P, 0) + rng.normal(0, 0.3, (n * P, p.shape[1])) for p in truth]
    pts = [p.astype(np.float32) for p in pts]
    z = (np.repeat(np.asarray(bj.params["z"]), P, 0)
         + rng.normal(0, 0.05, (n * P, bj.params["z"].shape[1]))).astype(np.float32)
    x0 = pts[slot]
    params = {"sqrt_info": np.repeat(np.asarray(bj.params["sqrt_info"]), P, 0)}
    mans_j = [gj.manifolds[t] for t in bj.vtypes]
    want = jax.vmap(
        lambda zi, pi, x0i, o: jax_gn(bj.ftype, slot, mans_j, zi, pi, list(o), x0i)
    )(jnp.asarray(z), {k: jnp.asarray(v) for k, v in params.items()},
      jnp.asarray(x0), tuple(jnp.asarray(p) for p in pts))
    mans_t = [T.variables.get_variable_type(t).manifold for t in bt.vtypes]
    got = _gn_solve_target(
        bt.ftype, slot, mans_t, torch.as_tensor(z),
        {k: torch.as_tensor(v) for k, v in params.items()},
        [torch.as_tensor(p) for p in pts], torch.as_tensor(x0),
    )
    assert got.dtype == torch.float32 and got.shape == x0.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_parametric_solve_of_beehive_matches_jax():
    fj, ft = _graphs()
    fj.init_all()
    ft.init_all()
    # start both away from the exact answer so the solve has work to do
    rng = np.random.default_rng(0)
    for lbl in fj._var_order[1:]:
        d = rng.normal(0, 0.3, fj.variables[lbl].vtype.point_dim)
        fj.set_point(lbl, fj.get_point(lbl) + d)
        ft.set_point(lbl, ft.get_point(lbl) + d)
    rj = R.solve_graph_parametric(fj, init=False)
    rt = T.solve_graph_parametric(ft, init=False, device="cpu")
    assert rt["stats"].converged and rj["stats"].converged
    for lbl in fj._var_order:
        np.testing.assert_allclose(ft.get_point(lbl), fj.get_point(lbl), rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["Pose2Point2Bearing", "Pose2Point2Range",
                                  "Pose2Point2BearingRange"])
def test_bearing_range_residuals_match_jax(name):
    """Residuals and the landmark initializer of the bearing/range factors,
    per factor (JAX, float64) against the port's batched form at 1e-12."""
    from rome_tpu.factors.base import get_factor_type as jax_type
    from rome_tpu_torch.factors.base import get_factor_type as port_type

    rng = np.random.default_rng(3)
    jt, tt = jax_type(name), port_type(name)
    n = 16
    p = np.c_[rng.normal(0, 5, (n, 2)), rng.uniform(-np.pi, np.pi, n)]
    l = rng.normal(0, 5, (n, 2))
    z = np.c_[rng.uniform(-np.pi, np.pi, n), rng.uniform(1, 20, n)][:, : jt.zdim]
    with jax.enable_x64():
        want = np.stack([np.asarray(jt.residual({"z": jnp.asarray(z[i])}, jnp.asarray(p[i]),
                                                jnp.asarray(l[i]))) for i in range(n)])
        init = jt.initializers.get(1)
        want_l = None if init is None else np.stack([
            np.asarray(init({"z": jnp.asarray(z[i])}, [jnp.asarray(p[i]), None]))
            for i in range(n)])
    got = tt.residual({"z": torch.as_tensor(z)}, torch.as_tensor(p), torch.as_tensor(l))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert (tt.initializers.get(1) is None) == (want_l is None)
    if want_l is not None:
        got_l = tt.initializers[1]({"z": torch.as_tensor(z)}, [torch.as_tensor(p), None])
        np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=1e-12)
