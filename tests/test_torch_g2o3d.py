"""g2o SE(3) and landmark lines and ``export_g2o`` of the port against the
JAX package (under enable_x64, as tests/test_torch_graph.py loads g2o):
VERTEX_SE3:QUAT / EDGE_SE3:QUAT / LANDMARK lines parse to the same points,
measurements, covariances and whitening matrices, bit for bit; the lowered
graphs are equal; ``export_g2o`` writes the same text; and the port's
export loads back to the same factors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from test_torch_graph import _assert_lowered_equal  # noqa: E402


def _f(v):
    return repr(float(v))


def _quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def se3_file(tmp_path, n=20, m=30, seed=0, vertices=True):
    """Seeded SE(3) graph: VERTEX_SE3:QUAT lines (file order qx qy qz qw,
    both signs of qw) and EDGE_SE3:QUAT lines with full 21-value
    information."""
    rng = np.random.default_rng(seed)
    lines = []
    if vertices:
        for i in range(n):
            lines.append(f"VERTEX_SE3:QUAT {i} " + " ".join(
                _f(v) for v in list(rng.normal(0, 5, 3)) + list(_quat(rng))))
    for _ in range(m):
        a, b = rng.choice(n, 2, replace=False)
        A = rng.normal(size=(6, 6))
        info = A @ A.T + 6 * np.eye(6)
        vals = [info[i, j] for i in range(6) for j in range(i, 6)]
        lines.append(f"EDGE_SE3:QUAT {a} {b} " + " ".join(
            _f(v) for v in list(rng.normal(0, 5, 3)) + list(_quat(rng)) + vals))
    p = tmp_path / f"se3_{seed}.g2o"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def landmark_file(tmp_path, seed=1):
    """SE(2) poses and odometry with LANDMARK sightings carrying a
    bearing-range cross term."""
    rng = np.random.default_rng(seed)
    lines = [f"VERTEX_SE2 {i} {_f(i)} {_f(rng.normal())} {_f(rng.normal(0, 0.3))}"
             for i in range(6)]
    for i in range(5):
        lines.append(f"EDGE_SE2 {i} {i + 1} 1.0 {_f(rng.normal(0, .1))} {_f(rng.normal(0, .1))} "
                     "100 1 0 100 0 400")
    for i in range(6):
        for l in range(2):
            ib, ir = rng.uniform(50, 200, 2)
            ibr = rng.uniform(-0.4, 0.4) * np.sqrt(ib * ir)
            lines.append(f"LANDMARK {i} {l} {_f(rng.uniform(-3, 3))} {_f(rng.uniform(2, 9))} "
                         f"{_f(ib)} {_f(ibr)} {_f(ir)}")
    p = tmp_path / "landmarks.g2o"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _load_both(path):
    with jax.enable_x64():
        fg_j = R.load_g2o(None, path)
    return fg_j, T.load_g2o(None, path)


def _assert_same_graph(fg_j, fg_t):
    assert fg_t._var_order == fg_j._var_order and fg_t._fct_order == fg_j._fct_order
    for lbl in fg_j._var_order:
        rj, rt = fg_j.variables[lbl], fg_t.variables[lbl]
        assert rt.vtype.name == rj.vtype.name and rt.tags == rj.tags
        if "parametric" in rj.points:
            np.testing.assert_array_equal(fg_t.get_point(lbl), fg_j.get_point(lbl))
    for fl in fg_j._fct_order:
        fj, ft = fg_j.factors[fl], fg_t.factors[fl]
        assert ft.ftype.name == fj.ftype.name and ft.variables == fj.variables
        for k in fj.params:
            np.testing.assert_array_equal(ft.params[k], fj.params[k])
        assert len(ft.dists) == len(fj.dists)
        for dt, dj in zip(ft.dists, fj.dists):
            np.testing.assert_array_equal(dt.mean(), np.asarray(dj.mean()))
            np.testing.assert_array_equal(dt.cov(), np.asarray(dj.cov()))


def test_se3_lines_parse_as_jax(tmp_path):
    fg_j, fg_t = _load_both(se3_file(tmp_path))
    _assert_same_graph(fg_j, fg_t)
    assert {r.vtype.name for r in fg_t.variables.values()} == {"Pose3"}
    # file order (qx, qy, qz, qw) -> (w, x, y, z), unit norm
    q = np.stack([fg_t.get_point(l)[3:] for l in fg_t.ls()])
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-15)


def test_landmark_lines_parse_as_jax(tmp_path):
    fg_j, fg_t = _load_both(landmark_file(tmp_path))
    _assert_same_graph(fg_j, fg_t)
    f = next(f for f in fg_t.factors.values() if f.ftype.name == "Pose2Point2BearingRange")
    cov = f.dists[0].cov()
    assert cov[0, 1] != 0.0  # the cross term is kept
    assert fg_t.variables["l0"].tags == ("LANDMARK",)


@pytest.mark.parametrize("kind", ["se3", "se3_no_vertices", "landmarks"])
def test_lowering_matches_jax(tmp_path, kind):
    path = (landmark_file(tmp_path) if kind == "landmarks"
            else se3_file(tmp_path, vertices=kind == "se3"))
    with jax.enable_x64():
        fg_j = R.load_g2o(None, path)
        fg_j.init_all()
        ga_j = jax_lower(fg_j)
    fg_t = T.load_g2o(None, path)
    fg_t.init_all()
    _assert_lowered_equal(ga_j, lower(fg_t, device="cpu"))


@pytest.mark.parametrize("kind,solve_key", [
    ("se3", None), ("se3", "parametric"), ("landmarks", None), ("landmarks", "parametric"),
])
def test_export_text_equals_jax(tmp_path, kind, solve_key):
    path = landmark_file(tmp_path) if kind == "landmarks" else se3_file(tmp_path)
    fg_j, fg_t = _load_both(path)
    with jax.enable_x64():
        out_j = R.export_g2o(fg_j, str(tmp_path / "j.g2o"), solve_key=solve_key)
    out_t = T.export_g2o(fg_t, str(tmp_path / "t.g2o"), solve_key=solve_key)
    text = open(out_t).read()
    assert text and text == open(out_j).read()


def test_export_round_trip(tmp_path):
    """The port's export loads back to the same measurements and
    information (the quaternion sign of a rotation vector is canonical)."""
    fg = T.load_g2o(None, se3_file(tmp_path, seed=3))
    back = T.load_g2o(None, T.export_g2o(fg, str(tmp_path / "rt.g2o"), solve_key="parametric"))
    assert len(back.factors) == len(fg.factors)
    for fa, fb in zip((fg.factors[l] for l in fg._fct_order),
                      (back.factors[l] for l in back._fct_order)):
        # rotations near pi lose a few digits through the quaternion
        np.testing.assert_allclose(fb.params["z"], fa.params["z"], rtol=0, atol=1e-10)
        np.testing.assert_allclose(fb.params["sqrt_info"], fa.params["sqrt_info"],
                                   rtol=1e-9, atol=1e-12)
    # export renumbers the poses by first appearance: map them by factor slot
    for fa, fb in zip((fg.factors[l] for l in fg._fct_order),
                      (back.factors[l] for l in back._fct_order)):
        for la, lb in zip(fa.variables, fb.variables):
            rel = T.Pose3.manifold.local(torch.as_tensor(fg.get_point(la)),
                                         torch.as_tensor(back.get_point(lb)))
            assert float(rel.abs().max()) < 1e-10
