"""Graph persistence of the port (rome_tpu_torch.io.serialization) on the
fixtures of tests/test_serialization.py, and across the two packages.

The port writes the JAX package's document (format "rome_tpu.dfg", version,
keys, arrays as base64 of little-endian float64), so:

- the port's own round trip is bit-exact (points, beliefs, ppes, params);
- a file saved by JAX loads in the port, and one saved by the port loads in
  JAX, for the graph zoo, in .json and .tar.gz; re-saved, the document is
  equal, as parsed JSON, to the one that was loaded;
- every registered factor type's packed record goes JAX -> port -> JAX
  unchanged;
- a graph that went port -> JAX -> port solves to the original's poses at
  1e-10 (float64);
- save_tree / load_tree work across the packages.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rome_tpu as R  # noqa: E402
import rome_tpu.factors.fluxmix  # noqa: E402,F401
import rome_tpu.factors.ode  # noqa: E402,F401
import rome_tpu.io.serialization as JS  # noqa: E402
import rome_tpu.services.scalar_fields  # noqa: E402,F401
from rome_tpu.canonical.inertial_sim import generate_field_inertial_measurement as jax_imu  # noqa: E402
from rome_tpu.factors.inertial import IMUDeltaFactor as JIMU, PriorRotVelPos as JPRVP  # noqa: E402

import rome_tpu_torch as T  # noqa: E402
import rome_tpu_torch.factors.fluxmix as TFM  # noqa: E402
import rome_tpu_torch.factors.ode  # noqa: E402,F401
import rome_tpu_torch.io.serialization as TS  # noqa: E402
import rome_tpu_torch.services.scalar_fields as TSF  # noqa: E402
from rome_tpu_torch.canonical.inertial_sim import (  # noqa: E402
    generate_field_inertial_measurement as port_imu,
)
from rome_tpu_torch.factors.inertial import IMUDeltaFactor as TIMU, PriorRotVelPos as TPRVP  # noqa: E402
from rome_tpu_torch.manifolds.base import SE2, ProductGroup, TranslationGroup  # noqa: E402
from rome_tpu_torch.solvers.multimodal.kde import ManifoldKernelDensity  # noqa: E402

SIDES = {"jax": (R, JS, JIMU, JPRVP, jax_imu), "port": (T, TS, TIMU, TPRVP, port_imu)}


def _zoo_graph(side):
    """tests/test_serialization.py's zoo, built by either package."""
    mod, _S, IMU, PRVP, imu_sim = SIDES[side]
    fg = mod.FactorGraph()
    fg.params.graphinit = False
    fg.params.logpath = "rome_tpu_logs"
    fg.add_variable("x0", mod.Pose2, timestamp_ns=0, tags=("POSE",))
    fg.add_variable("x1", mod.Pose2, timestamp_ns=10**9)
    fg.add_variable("l1", mod.Point2, timestamp_ns=7, tags=("LANDMARK",))
    fg.add_variable("p3", mod.Pose3, timestamp_ns=8)
    fg.add_variable("d0", mod.DynPose2, timestamp_ns=0)
    fg.add_variable("d1", mod.DynPose2, timestamp_ns=10**9)
    fg.add_variable("r0", mod.RotVelPos, timestamp_ns=9)
    fg.add_variable("r1", mod.RotVelPos, timestamp_ns=10)
    kw = dict(timestamp_ns=11)
    fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])), **kw)
    fg.add_factor(["x0", "x1"], mod.Pose2Pose2(mod.MvNormal([1, 0, 0.1], np.eye(3) * 0.01)),
                  **kw)
    fg.add_factor(["x0", "l1"],
                  mod.Pose2Point2BearingRange(mod.Normal(0.2, 0.05), mod.Normal(5.0, 0.5)), **kw)
    fg.add_factor(["p3"], mod.PriorPose3(mod.MvNormal(np.zeros(6), np.eye(6) * 0.01)), **kw)
    fg.add_factor(["p3"], mod.PriorPose3ZRP(mod.Normal(2.0, 0.1),
                                            mod.MvNormal([0, 0], np.eye(2) * 0.01)), **kw)
    fg.add_factor(["d0"], mod.DynPose2VelocityPrior(
        mod.MvNormal(np.zeros(3), np.eye(3) * 0.01), mod.MvNormal([1.0, 0], np.eye(2) * 0.1)),
        **kw)
    fg.add_factor(["d0", "d1"], mod.VelPose2VelPose2(
        mod.MvNormal([1.0, 0, 0], np.eye(3) * 0.01), mod.MvNormal([0.0, 0], np.eye(2) * 0.1)),
        **kw)
    imu = imu_sim(dt=0.1, N=5, accel0=(0, 0, 9.81), rate=(0, 0, 0.1))
    fg.add_factor(["r0"], PRVP(mod.MvNormal(np.zeros(9), np.eye(9) * 1e-3)), **kw)
    fg.add_factor(["r0", "r1"], IMU(np.asarray(imu.accels), np.asarray(imu.gyros),
                                    np.ones(5) * 0.1, np.eye(6) * 1e-4), **kw)
    fg.set_ppe("x1", [1.0, 0.0, 0.1], "simulated")
    fg.variables["x0"].beliefs["default"] = np.random.default_rng(0).normal(size=(100, 3))
    fg.init_all()
    return fg


def _doc(path):
    """The saved document, as parsed JSON."""
    payload = open(path, "rb").read()
    if path.endswith(".tar.gz"):
        import tarfile

        with tarfile.open(path, "r:gz") as tar:
            payload = tar.extractfile(tar.getmember("dfg.json")).read()
    return json.loads(payload.decode())


def _assert_graphs_equal(a, b):
    assert a.ls() == b.ls() and a.lsf() == b.lsf()
    for label in a.ls():
        ra, rb = a.variables[label], b.variables[label]
        assert (ra.vtype.name, ra.timestamp_ns, tuple(ra.tags), ra.solvable, ra.marginalized) == (
            rb.vtype.name, rb.timestamp_ns, tuple(rb.tags), rb.solvable, rb.marginalized)
        for store in ("points", "beliefs", "ppes"):
            da, db = getattr(ra, store), getattr(rb, store)
            assert set(da) == set(db)
            for k in da:
                np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]))  # bit-exact
    for label in a.lsf():
        fa, fb = a.factors[label], b.factors[label]
        assert (fa.ftype.name, tuple(fa.variables), len(fa.dists)) == (
            fb.ftype.name, tuple(fb.variables), len(fb.dists))
        assert set(fa.params) == set(fb.params)
        for k in fa.params:
            np.testing.assert_array_equal(np.asarray(fa.params[k]), np.asarray(fb.params[k]))


@pytest.mark.parametrize("suffix", ["json", "tar.gz"])
def test_save_load_roundtrip(tmp_path, suffix):
    fg = _zoo_graph("port")
    written = T.save_dfg(fg, str(tmp_path / f"graph.{suffix}"))
    _assert_graphs_equal(fg, T.load_dfg(written))


@pytest.mark.parametrize("suffix", ["json", "tar.gz"])
@pytest.mark.parametrize("origin", ["jax", "port"])
def test_zoo_crosses_the_packages(tmp_path, suffix, origin):
    """Saved by one package, loaded by the other and re-saved: the same
    document; loaded back by the first: the same graph."""
    other = "port" if origin == "jax" else "jax"
    fg = _zoo_graph(origin)
    S0, S1 = SIDES[origin][1], SIDES[other][1]
    first = S0.save_dfg(fg, str(tmp_path / f"a.{suffix}"))
    loaded = S1.load_dfg(first)
    second = S1.save_dfg(loaded, str(tmp_path / f"b.{suffix}"))
    assert _doc(first) == _doc(second)
    _assert_graphs_equal(fg, S0.load_dfg(second))


def test_every_registered_factor_type_crosses_the_packages():
    """The registry sweep of tests/test_serialization.py: a record of every
    registered factor type, packed by JAX, unpacked and packed by the port,
    is the same record; unpacked by the port it holds the same arrays."""
    import rome_tpu.services.scalar_fields  # noqa: F401 -- registers its factor types
    import rome_tpu.vision  # noqa: F401
    import rome_tpu_torch.services.scalar_fields  # noqa: F401
    import rome_tpu_torch.vision  # noqa: F401
    from rome_tpu.factors.base import Factor as JFactor, get_factor_type, list_factor_types
    from rome_tpu_torch.factors.base import list_factor_types as port_types

    # every factor type of the JAX package, the vision module's included
    assert set(port_types()) == set(list_factor_types())
    names = port_types()
    assert "GenericProjection" in names and len(names) >= 46
    rng = np.random.default_rng(7)
    for name in names:
        ft = get_factor_type(name)
        zd = max(ft.zdim, 1)
        f = JFactor(
            ftype=ft, variables=tuple(f"v{i}" for i in range(ft.arity)),
            params={"z": rng.normal(size=zd),
                    "sqrt_info": np.eye(zd) + 0.01 * rng.normal(size=(zd, zd)),
                    "extra_blob": rng.normal(size=(3, 4))},
            dists=(R.MvNormal(rng.normal(size=zd), np.eye(zd)),),
            label=f"f_{name}", multihypo=None, nullhypo=0.125, solvable=1, tags=("TEST",),
            timestamp_ns=123456789, inflation=3.5,
        )
        doc = json.loads(json.dumps(JS.pack_factor(f)))
        g = TS.unpack_factor(doc)
        assert g.ftype.name == name and g.variables == f.variables
        assert (g.nullhypo, g.inflation, g.timestamp_ns) == (0.125, 3.5, 123456789)
        for k in f.params:
            np.testing.assert_array_equal(g.params[k], f.params[k])
        assert json.loads(json.dumps(TS.pack_factor(g))) == doc, name


def test_pack_distribution_roundtrip():
    dists = [T.Normal(1.5, 0.3), T.MvNormal([1, 2, 3], np.diag([0.1, 0.2, 0.3])),
             T.Uniform(-1, 2), T.Categorical([0.2, 0.8]),
             T.Mixture([T.Normal(0, 1), T.Normal(5, 2)], [0.3, 0.7])]
    for d in dists:
        doc = TS.pack_distribution(d)
        d2 = TS.unpack_distribution(doc)
        assert type(d2) is type(d)
        np.testing.assert_allclose(d2.mean(), d.mean())
        np.testing.assert_allclose(d2.cov(), d.cov())
        # the JAX package reads the same record to the same moments
        dj = JS.unpack_distribution(json.loads(json.dumps(doc)))
        np.testing.assert_allclose(np.asarray(dj.mean()), d.mean())
        assert JS.pack_distribution(dj) == json.loads(json.dumps(doc))


def test_pack_factor_roundtrip():
    f = T.Pose2Pose2(T.MvNormal([1, 0, 0.1], np.eye(3) * 0.01))
    f.variables = ("x0", "x1")
    f.label = "x0x1f1"
    f2 = TS.unpack_factor(TS.pack_factor(f))
    assert f2.ftype.name == "Pose2Pose2" and f2.variables == ("x0", "x1")
    np.testing.assert_array_equal(f2.params["z"], f.params["z"])
    np.testing.assert_array_equal(f2.params["sqrt_info"], f.params["sqrt_info"])


def test_pack_extended_distributions():
    """NN odometry predictors, scalar-field level-set beliefs and particle
    (manifold KDE) beliefs round-trip in the port, and their records equal
    the JAX package's re-pack of them."""
    rng = np.random.default_rng(3)

    def rt(d):
        doc = json.loads(json.dumps(TS.pack_distribution(d)))
        assert JS.pack_distribution(JS.unpack_distribution(doc)) == doc
        return TS.unpack_distribution(doc)

    nn = TFM.build_pose2_odo_nn_01(*[rng.normal(size=s) for s in
                                     [(4, 8), (8,), (8, 48), (8,), (2, 8), (2,)]])
    d = TFM.NNOdoPredictor(nn, rng.normal(size=(25, 4)), jitter=2e-3)
    d2 = rt(d)
    assert type(d2) is TFM.NNOdoPredictor and d2.jitter == d.jitter
    for k in nn:
        np.testing.assert_array_equal(d2.nn[k], d.nn[k])
    np.testing.assert_array_equal(d2.mean(), d.mean())

    img = rng.random((16, 12))
    ls = TSF.LevelSetGridNormal(img, (np.linspace(0, 10, 16), np.linspace(0, 8, 12)), 0.4, 0.1,
                                sigma_scale=2.0, N=500)
    ls2 = rt(ls)
    assert type(ls2) is TSF.LevelSetGridNormal
    np.testing.assert_array_equal(ls2.img, ls.img)
    np.testing.assert_allclose(ls2.mean(), ls.mean())
    np.testing.assert_allclose(ls2.cov(), ls.cov())

    for man in [SE2(), TranslationGroup(3), ProductGroup([SE2(), TranslationGroup(2)])]:
        pts = man.normalize(torch.as_tensor(rng.normal(size=(50, man.point_dim)),
                                            dtype=torch.float32))
        kde = ManifoldKernelDensity.from_points(man, pts)
        kde2 = rt(kde)
        assert type(kde2) is ManifoldKernelDensity
        assert kde2.points.dtype == torch.float32
        assert torch.equal(kde2.points, kde.points)           # bit-exact f32 particles
        assert torch.equal(kde2.bandwidth, kde.bandwidth)
        assert (kde2.manifold.point_dim, kde2.manifold.dof, kde2.manifold.name) == (
            man.point_dim, man.dof, man.name)

    mix = T.Mixture([TFM.NNOdoPredictor(nn, np.zeros((25, 4))),
                     T.MvNormal(np.zeros(3), np.eye(3))], [0.4, 0.6])
    assert type(rt(mix).components[0]) is TFM.NNOdoPredictor


def test_zoo_with_ext_factors_roundtrip(tmp_path):
    """A graph carrying flux-mixture odometry and a level-set partial prior
    reloads with its measurement beliefs intact and solves the same."""
    rng = np.random.default_rng(11)
    fg = T.FactorGraph()
    fg.params.graphinit = False
    for i in range(3):
        fg.add_variable(f"x{i}", T.Pose2)
    fg.add_factor(["x0"], T.PriorPose2(T.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    nn = TFM.build_pose2_odo_nn_01(*[rng.normal(size=s) * 0.1 for s in
                                     [(4, 8), (8,), (8, 48), (8,), (2, 8), (2,)]])
    fg.add_factor(["x0", "x1"],
                  TFM.MixtureFluxPose2Pose2(fluxmodels=nn, data=rng.normal(size=(25, 4))))
    fg.add_factor(["x1", "x2"], T.Pose2Pose2(T.MvNormal([1, 0, 0], np.eye(3) * 0.01)))
    ls = TSF.LevelSetGridNormal(rng.random((8, 8)), (np.linspace(0, 4, 8), np.linspace(0, 4, 8)),
                                0.5, 0.2)
    fg.add_factor(["x2"], TSF.PartialPriorPassThrough(ls, (1, 2), "Pose2"))
    fg.init_all()
    fg2 = T.load_dfg(T.save_dfg(fg, str(tmp_path / "ext.tar.gz")))
    _assert_graphs_equal(fg, fg2)
    for label in fg.lsf():
        for da, db in zip(fg.factors[label].dists, fg2.factors[label].dists):
            assert type(da) is type(db)
            np.testing.assert_allclose(np.asarray(da.mean()), np.asarray(db.mean()))
    T.solve_graph_parametric(fg, init=False, dtype=torch.float64, device="cpu")
    T.solve_graph_parametric(fg2, init=False, dtype=torch.float64, device="cpu")
    for label in fg.ls():
        np.testing.assert_allclose(fg.get_coords(label), fg2.get_coords(label), atol=1e-10)


def test_graph_through_jax_solves_to_the_same_poses(tmp_path):
    """The hexagonal graph: port -> save -> JAX load -> JAX save -> port
    load; both solve (float64) to the same poses within 1e-10."""
    fg = T.generate_graph_hexagonal()
    fg.init_all()
    a = T.save_dfg(fg, str(tmp_path / "hex.json"))
    b = JS.save_dfg(JS.load_dfg(a), str(tmp_path / "hex_jax.json"))
    fg2 = T.load_dfg(b)
    _assert_graphs_equal(fg, fg2)
    r1 = T.solve_graph_parametric(fg, init=False, dtype=torch.float64, device="cpu")
    r2 = T.solve_graph_parametric(fg2, init=False, dtype=torch.float64, device="cpu")
    assert r1["stats"].converged and r2["stats"].converged
    for label in fg.ls():
        np.testing.assert_allclose(fg.get_coords(label), fg2.get_coords(label), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("origin", ["jax", "port"])
def test_save_load_tree_across_the_packages(tmp_path, origin):
    """saveTree/loadTree (MITDatasetBatch.jl:45): a Bayes tree saved by one
    package loads in the other with the same cliques, and re-saves to the
    same document."""
    from rome_tpu.canonical.generators import generate_graph_hexagonal as jax_hex
    from rome_tpu.solvers.multimodal.tree import build_tree_from_ordering as jax_build
    from rome_tpu_torch.solvers.multimodal.tree import build_tree_from_ordering as port_build

    build = {"jax": lambda: jax_build(jax_hex()),
             "port": lambda: port_build(T.generate_graph_hexagonal())}
    other = "port" if origin == "jax" else "jax"
    S0, S1 = SIDES[origin][1], SIDES[other][1]
    tree = build[origin]()
    p = S0.save_tree(tree, str(tmp_path / "tree"))
    tree2 = S1.load_tree(p)
    assert tree2.num_cliques == tree.num_cliques and tree2.order == tree.order
    for a, b in zip(tree.cliques, tree2.cliques):
        assert (a.signature, a.parent, a.frontals, a.separator) == (
            b.signature, b.parent, b.frontals, b.separator)
    q = S1.save_tree(tree2, str(tmp_path / "tree2"))
    assert json.load(open(p)) == json.load(open(q))
    # the two packages build the same tree of the same graph
    assert [c.signature for c in build[other]().cliques] == [c.signature for c in tree.cliques]


def test_load_unknown_format(tmp_path):
    p = tmp_path / "bogus.json"
    p.write_text('{"format": "something_else"}')
    with pytest.raises(ValueError, match="rome_tpu.dfg"):
        T.load_dfg(str(p))


def test_solver_params_carry_the_jax_fields(tmp_path):
    """The port's saved params block is the JAX package's set of keys (the
    fields no solver reads at their defaults, io.serialization's
    REFERENCE_ONLY_PARAMS), and a qfl set in one package arrives in the
    other; a JAX file with those fields set loads in the port, which ignores
    them."""
    fg = T.FactorGraph()
    fg.params.qfl = 25
    fg.add_variable("x0", T.Pose2)
    p = T.save_dfg(fg, str(tmp_path / "params.json"))
    doc = _doc(p)
    jdoc = JS._graph_to_doc(R.FactorGraph())
    assert set(doc["params"]) == set(jdoc["params"])
    assert {k: doc["params"][k] for k in TS.REFERENCE_ONLY_PARAMS} == {
        k: jdoc["params"][k] for k in TS.REFERENCE_ONLY_PARAMS}
    g = JS.load_dfg(p)
    assert (g.params.qfl, g.params.isfixedlag) == (25, False)
    jg = R.FactorGraph()
    jg.params.qfl, jg.params.isfixedlag = 30, True
    jg.add_variable("x0", R.Pose2)
    t = T.load_dfg(JS.save_dfg(jg, str(tmp_path / "jax_params.json")))
    assert t.params.qfl == 30 and not hasattr(t.params, "isfixedlag")
