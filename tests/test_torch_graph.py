"""g2o load and lowering of the port against the JAX package: the lowered
params, slots, weights, free masks and initial values must be EXACTLY equal
on data/citygrid.g2o (10,000 poses, 13,085 EDGE_SE2 lines, plus the x0
prior) and on the synthesized octagon. Both sides build their graph in
float64 (JAX under enable_x64) and lower to float32."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.graph.lower import bucket_size as jax_bucket_size  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.io.g2o import import_g2o as jax_import_g2o  # noqa: E402
from rome_tpu.io.g2o import load_g2o as jax_load_g2o  # noqa: E402
from rome_tpu_torch.graph.lower import bucket_size, lower, write_back  # noqa: E402
from rome_tpu_torch.io.g2o import import_g2o, load_g2o  # noqa: E402
from test_torch_helpers import grid_graph, octagon_file  # noqa: E402

CITYGRID = os.path.join(os.path.dirname(__file__), os.pardir, "data", "citygrid.g2o")


def _with_prior(mod, fg):
    fg.add_factor(
        ["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])), graphinit=False
    )
    fg.init_all()
    return fg


def _assert_lowered_equal(ga_j, ga_t):
    assert ga_t.type_names == ga_j.type_names
    assert ga_t.counts == ga_j.counts
    assert ga_t.var_labels == ga_j.var_labels
    assert ga_t.dtype == torch.float32
    for t in ga_j.type_names:
        np.testing.assert_array_equal(ga_t.values0[t].numpy(), np.asarray(ga_j.values0[t]))
        np.testing.assert_array_equal(ga_t.free[t].numpy(), np.asarray(ga_j.free[t]))
    assert [b.ftype.name for b in ga_t.batches] == [b.ftype.name for b in ga_j.batches]
    for bt, bj in zip(ga_t.batches, ga_j.batches):
        assert bt.n == bj.n and bt.vtypes == bj.vtypes and bt.labels == bj.labels
        np.testing.assert_array_equal(bt.vslots.numpy(), np.asarray(bj.vslots))
        np.testing.assert_array_equal(bt.weight.numpy(), np.asarray(bj.weight))
        assert sorted(bt.params) == sorted(bj.params)
        for k in bj.params:
            assert bt.params[k].dtype == torch.float32
            np.testing.assert_array_equal(bt.params[k].numpy(), np.asarray(bj.params[k]))


@pytest.fixture(scope="module")
def citygrid_pair():
    with jax.enable_x64():
        fg_j = _with_prior(R, jax_load_g2o(None, CITYGRID))
        ga_j = jax_lower(fg_j)
    fg_t = _with_prior(T, load_g2o(None, CITYGRID))
    return fg_j, ga_j, fg_t, lower(fg_t, device="cpu")


def test_citygrid_graph_matches(citygrid_pair):
    fg_j, _ga_j, fg_t, _ga_t = citygrid_pair
    assert fg_t.num_variables == fg_j.num_variables == 10000
    assert fg_t.num_factors == fg_j.num_factors == 13086
    assert fg_t._fct_order == fg_j._fct_order
    for lbl in ("x0", "x1", "x4999", "x9999"):
        np.testing.assert_array_equal(fg_t.get_point(lbl), fg_j.get_point(lbl))
    fl = fg_j._fct_order[777]
    for k in ("z", "sqrt_info"):
        np.testing.assert_array_equal(fg_t.factors[fl].params[k], fg_j.factors[fl].params[k])
    np.testing.assert_array_equal(
        fg_t.factors[fl].dists[0].cov(), fg_j.factors[fl].dists[0].cov()
    )


def test_citygrid_lowering_is_exact(citygrid_pair):
    _fg_j, ga_j, _fg_t, ga_t = citygrid_pair
    _assert_lowered_equal(ga_j, ga_t)
    # one Pose2Pose2 batch of 13,085 factors, one PriorPose2 batch, no padding
    assert [(b.ftype.name, b.n) for b in ga_t.batches] == [
        ("Pose2Pose2", 13085), ("PriorPose2", 1)
    ]
    assert ga_t.counts == {"Pose2": 10000}


def test_octagon_lowering_is_exact(tmp_path):
    path = octagon_file(tmp_path)
    assert import_g2o(path) == jax_import_g2o(path)
    with jax.enable_x64():
        fg_j = jax_load_g2o(None, path)
        fg_j.init_all()
        ga_j = jax_lower(fg_j)
    fg_t = load_g2o(None, path)
    fg_t.init_all()
    ga_t = lower(fg_t, device="cpu")
    _assert_lowered_equal(ga_j, ga_t)
    # no VERTEX lines: init_all propagated the ring through the odometry
    for lbl in fg_j.ls():
        np.testing.assert_allclose(fg_t.get_point(lbl), fg_j.get_point(lbl), atol=1e-12)


def test_padded_lowering_matches(tmp_path):
    with jax.enable_x64():
        fg_j = grid_graph(R, 3, 4, seed=1, frozen=("x2",))
        ga_j = jax_lower(fg_j, pad=True)
    ga_t = lower(grid_graph(T, 3, 4, seed=1, frozen=("x2",)), pad=True, device="cpu")
    _assert_lowered_equal(ga_j, ga_t)
    assert ga_t.counts["Pose2"] == bucket_size(12) == 16


@pytest.mark.parametrize("n", [1, 8, 9, 100, 1000, 13085])
def test_bucket_size_matches(n):
    assert bucket_size(n) == jax_bucket_size(n)


def test_vertex_initialization(tmp_path):
    p = tmp_path / "v.g2o"
    p.write_text(
        "VERTEX_SE2 0 1.0 2.0 0.5\n"
        "VERTEX_SE2 1 2.0 3.0 4.0\n"
        "EDGE_SE2 0 1 1.0 0.0 0.2 100 0 0 100 0 100\n"
    )
    fg = load_g2o(None, str(p))
    np.testing.assert_array_equal(fg.get_coords("x0"), [1, 2, 0.5])
    np.testing.assert_allclose(fg.get_coords("x1"), [2, 3, 4.0 - 2 * np.pi], atol=1e-15)
    f = fg.factors[fg._fct_order[0]]
    np.testing.assert_allclose(f.dists[0].cov(), np.eye(3) / 100.0, atol=1e-15)


@pytest.mark.parametrize(
    "line",
    [
        "VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1",
        "EDGE_SE3:QUAT 0 1 1 2 3 0 0 0 1 " + " ".join(["1"] * 21),
        "LANDMARK 0 1 0.1 2.0 100 0 100",
    ],
)
def test_unported_g2o_lines_raise(tmp_path, line):
    """The lines that raised before the SE(3) / landmark factors were ported
    now parse as the JAX package parses them (an EDGE_SE3:QUAT line of 21
    ones is a singular information matrix, which raises in both)."""
    p = tmp_path / "x.g2o"
    p.write_text(line + "\n")
    try:
        with jax.enable_x64():
            fg_j = jax_load_g2o(None, str(p))
    except np.linalg.LinAlgError:
        with pytest.raises(np.linalg.LinAlgError):
            load_g2o(None, str(p))
        line = "EDGE_SE3:QUAT 0 1 1 2 3 0 0 0 1 4 0 0 0 0 0 4 0 0 0 0 4 0 0 0 9 0 0 9 0 9"
        p.write_text(line + "\n")
        with jax.enable_x64():
            fg_j = jax_load_g2o(None, str(p))
    fg_t = load_g2o(None, str(p))
    assert fg_t._var_order == fg_j._var_order and fg_t._fct_order == fg_j._fct_order
    for lbl in fg_j._var_order:
        assert fg_t.variables[lbl].vtype.name == fg_j.variables[lbl].vtype.name
        for key, pt in fg_j.variables[lbl].points.items():
            np.testing.assert_array_equal(fg_t.variables[lbl].points[key], pt)
    for fl in fg_j._fct_order:
        for k, v in fg_j.factors[fl].params.items():
            np.testing.assert_array_equal(fg_t.factors[fl].params[k], v)


def test_write_back_skips_frozen():
    fg = grid_graph(T, 2, 2, seed=2, frozen=("x1",))
    before = fg.get_point("x1").copy()
    ga = lower(fg, device="cpu")
    vals = {"Pose2": ga.values0["Pose2"] + 0.5}
    write_back(fg, ga, vals)
    np.testing.assert_array_equal(fg.get_point("x1"), before)
    np.testing.assert_allclose(
        fg.get_point("x3")[:2], ga.values0["Pose2"][3, :2].double().numpy() + 0.5, atol=1e-6
    )
