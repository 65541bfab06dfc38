"""The port's scalar-field services (rome_tpu_torch.services.scalar_fields)
against the JAX package's, on tests/test_services.py's scalar-field
fixtures (testScalarFields.jl analogue).

Tolerances: the canyon DEM and the terrain mesh graph equal; ``dem_interp``
(float32 in both) within 1e-6 relative of JAX's at seeded points and within
2e-5 of the grid values; the LevelSetGridNormal moments at 1e-12 (float64
numpy in both); its samples (the port's Gumbel-max draw and JAX's
``categorical`` are different streams): the sample mean within four
standard errors of JAX's and each covariance entry within 10 % of the
largest; the PartialPriorPassThrough residual at 1e-10 (float64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu.services.scalar_fields as JF  # noqa: E402

import rome_tpu_torch as T  # noqa: E402
import rome_tpu_torch.services as TSV  # noqa: E402
import rome_tpu_torch.services.scalar_fields as TF  # noqa: E402
from rome_tpu_torch.solvers.multimodal.convolve import approx_conv  # noqa: E402


def test_canyon_dem_equals_jax():
    for args in ((1, 50), (2.0, 30, True)):
        for a, b in zip(TF.generate_field_canyon_dem(*args), JF.generate_field_canyon_dem(*args)):
            np.testing.assert_array_equal(a, b)


def test_dem_interp_matches_grid_and_jax():
    """testScalarFields.jl:38-41: the interpolation reproduces the grid
    values; between them it is JAX's bilinear form."""
    x, y, img = TF.generate_field_canyon_dem(1, 50)
    h = TF.dem_interp(x, y, img, device="cpu")
    ii, jj = np.array([0, 7, 23, 48]), np.array([1, 11, 30, 49])
    got = h(torch.as_tensor(x[ii], dtype=torch.float32), torch.as_tensor(y[jj], dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), img[ii, jj], rtol=2e-5)
    rng = np.random.default_rng(4)
    px = rng.uniform(-9500, 9500, 500).astype(np.float32)  # a few off the grid (clamped)
    py = rng.uniform(-9500, 9500, 500).astype(np.float32)
    want = np.asarray(jax.vmap(JF.dem_interp(x, y, img))(px, py))
    np.testing.assert_allclose(h(torch.as_tensor(px), torch.as_tensor(py)).numpy(), want,
                               rtol=1e-6, atol=0)


def test_build_graph_scalar_field_equals_jax():
    """ScalarFields.jl:12-64: marginalized Point3 mesh with row / column /
    diagonal factors, the same graph in both packages."""
    x, y, img = TF.generate_field_canyon_dem(1, 5)
    graphs = {}
    for name, mod, build in (("port", T, TF.build_graph_scalar_field),
                             ("jax", R, JF.build_graph_scalar_field)):
        fg = mod.FactorGraph()
        fg.params.graphinit = False
        build(fg, img, x, y)
        graphs[name] = fg
    fg = graphs["port"]
    assert len(fg.ls(r"^pt\d+_\d+$")) == 25 and fg.num_factors == 20 + 20 + 16
    assert all(fg.variables[l].marginalized and fg.variables[l].solvable == 0
               for l in fg.ls(r"^pt"))
    np.testing.assert_allclose(fg.variables["pt1_1"].ppes["simulated"], [x[0], y[0], img[0, 0]])
    j = graphs["jax"]
    assert fg.ls() == j.ls() and fg.lsf() == j.lsf()
    for l in fg.lsf():
        a, b = fg.factors[l], j.factors[l]
        assert a.variables == b.variables and a.solvable == b.solvable
        for k in a.params:
            np.testing.assert_array_equal(a.params[k], np.asarray(b.params[k]))
    for l in fg.ls():
        np.testing.assert_array_equal(fg.get_point(l), np.asarray(j.get_point(l)))


def _levelset(mod_fields, n=60):
    x, y, img = mod_fields.generate_field_canyon_dem(1, n)
    truth = np.array([x[n // 2], y[2 * n // 3]])
    h = TF.dem_interp(x, y, img, device="cpu")
    z = float(h(torch.tensor(truth[0], dtype=torch.float32),
                torch.tensor(truth[1], dtype=torch.float32)))
    return x, y, img, z, h


def test_levelset_moments_equal_jax_and_samples_agree():
    x, y, img, z, h = _levelset(TF)
    port = TF.LevelSetGridNormal(img, (x, y), z, 5.0, N=2000)
    ref = JF.LevelSetGridNormal(img, (x, y), z, 5.0, N=2000)
    np.testing.assert_allclose(port.mean(), ref.mean(), rtol=0, atol=1e-12 * np.abs(ref.mean()).max())
    np.testing.assert_allclose(port.cov(), ref.cov(), rtol=1e-12)
    n = 4000
    ps = port.sample(torch.Generator().manual_seed(0), n)
    assert ps.shape == (n, 2) and ps.dtype == torch.float32
    ps = ps.double().numpy()
    js = np.asarray(ref.sample(jax.random.PRNGKey(0), n), dtype=np.float64)
    se = np.sqrt(np.diag(ref.cov()) / n)
    assert np.all(np.abs(ps.mean(0) - js.mean(0)) <= 4 * np.sqrt(2) * se)
    cp, cj = np.cov(ps.T), np.cov(js.T)
    assert np.abs(cp - cj).max() <= 0.1 * np.abs(cj).max()
    # every sample on the level set (tests/test_services.py:57-75)
    zs = h(torch.as_tensor(ps[:, 0], dtype=torch.float32),
           torch.as_tensor(ps[:, 1], dtype=torch.float32)).numpy()
    assert np.mean(np.abs(zs - z) < 4 * 5.0) > 0.9


def test_partial_prior_pass_through_residual_matches_jax():
    """The pass-through prior's factor record and residual (Pose2 and
    Point2), the port against JAX under x64, at 1e-10."""
    rng = np.random.default_rng(8)
    x, y, img, z, _h = _levelset(TF, n=20)
    for vtype, dim in (("Pose2", 3), ("Point2", 2)):
        fp = TF.PartialPriorPassThrough(TF.LevelSetGridNormal(img, (x, y), z, 5.0), (1, 2), vtype)
        fj = JF.PartialPriorPassThrough(JF.LevelSetGridNormal(img, (x, y), z, 5.0), (1, 2), vtype)
        assert fp.ftype.name == fj.ftype.name and fp.ftype.partial == fj.ftype.partial
        for k in fp.params:
            np.testing.assert_allclose(fp.params[k], np.asarray(fj.params[k]), rtol=1e-12)
        pts = rng.normal(0, 3000, (16, dim))
        got = fp.ftype.residual({k: torch.as_tensor(v) for k, v in fp.params.items()},
                                torch.as_tensor(pts))
        with jax.enable_x64():
            want = fj.ftype.residual({k: jnp.asarray(v) for k, v in fj.params.items()},
                                     jnp.asarray(pts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    with pytest.raises(NotImplementedError):
        TF.PartialPriorPassThrough(fp.dists[0], (1, 3))


def test_levelset_localization_through_approx_conv():
    """testScalarFields.jl:44-56: the pass-through prior on a Pose2 puts the
    belief's samples on the measured contour through approx_conv."""
    x, y, img, z, h = _levelset(TF, n=80)
    hmd = TF.LevelSetGridNormal(img, (x, y), z, 5.0, N=2000)
    fg = T.FactorGraph()
    fg.params.graphinit = False
    fg.params.N = 500
    fg.add_variable("x0", T.Pose2)
    f = fg.add_factor(["x0"], TF.PartialPriorPassThrough(hmd, (1, 2)), nullhypo=0.1)
    seed = hmd.sample(torch.Generator().manual_seed(9), 500).double().numpy()
    fg.variables["x0"].beliefs["default"] = np.concatenate([seed, np.zeros((500, 1))], axis=1)
    pts = approx_conv(fg, f.label, "x0", device="cpu")
    zs = h(pts[:, 0].float(), pts[:, 1].float()).numpy()
    assert np.mean(np.abs(zs - z) < 4 * 5.0) > 0.8


def test_services_exports_and_dem_image(tmp_path):
    import rome_tpu.services as JSV

    # the scalar-field names, and since the analysis helpers were ported,
    # every other name the JAX package's services exports
    assert {"LevelSetGridNormal", "PartialPriorPassThrough", "build_graph_scalar_field",
            "dem_interp", "generate_field_canyon_dem", "load_dem_image"} <= set(TSV.__all__)
    assert sorted(TSV.__all__) == sorted(JSV.__all__)
    Image = pytest.importorskip("PIL.Image")
    arr = (np.arange(12 * 8).reshape(12, 8) % 251).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "dem.png")
    got = TF.load_dem_image(str(tmp_path / "dem.png"), (0, 10), (0, 5))
    want = JF.load_dem_image(str(tmp_path / "dem.png"), (0, 10), (0, 5))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2].shape == (12, 8)
