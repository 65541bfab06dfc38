"""The port's Helix and Boxes generators against the JAX package's: the same
variables, factors, measurement parameters and simulated PPEs at atol 1e-12
(both propagate their ground truth in float64 numpy), and the port on
tests/test_patterns.py's exact cases (atol as there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu.canonical.patterns as JP  # noqa: E402
import rome_tpu_torch.canonical as TC  # noqa: E402
import rome_tpu_torch.canonical.patterns as TP  # noqa: E402
from test_torch_canonical import assert_same_graph  # noqa: E402

CASES = {
    "helix_base": lambda P: P.generate_graph_helix2d(5, posesperturn=15, radius=10),
    "helix_default": lambda P: P.generate_graph_helix2d(),
    "helix_mu0": lambda P: P.generate_graph_helix2d(12, mu0=(3.0, -2.0, 0.4),
                                                     Qd=np.diag([0.2, 0.1, 0.02])),
    "slew": lambda P: P.generate_graph_helix2d_slew(46, slew_x=2 / 3, posesperturn=15,
                                                   radius=10),
    "spiral": lambda P: P.generate_graph_helix2d_spiral(60, rate_r=0.6, rate_a=6, radius=100),
    "boxes": lambda P: P.generate_graph_boxes2d(8),
    "boxes_slewed": lambda P: P.generate_graph_boxes2d(10, length_x=7.0, length_y=3.0,
                                                       slew_x=0.5),
}


def _both(call):
    with jax.enable_x64():
        fj = call(JP)
    return fj, call(TP)


@pytest.mark.parametrize("case", sorted(CASES))
def test_generators_match_jax(case):
    fj, ft = _both(CASES[case])
    assert_same_graph(fj, ft)


def test_helix_extends_like_jax():
    fj, ft = _both(lambda P: P.generate_graph_helix2d(5, posesperturn=15, radius=10))
    for n in (5, 6, 9):
        with jax.enable_x64():
            JP.generate_graph_helix2d(n, fg=fj, posesperturn=15, radius=10)
        TP.generate_graph_helix2d(n, fg=ft, posesperturn=15, radius=10)
        assert_same_graph(fj, ft)
    assert len(ft.ls(r"^x\d+$")) == 9


def test_drive_one_box_on_an_existing_graph_matches_jax():
    fj, ft = _both(lambda P: P.generate_graph_boxes2d(4))
    with jax.enable_x64():
        lj = JP.drive_one_box(fj, slew_x=0.25, length_x=4.0)
        lj = JP.drive_leg(fj, lj, [1.0, 2.0], "POSITIVE_X", Qd=np.eye(2) * 0.3)
    lt = TP.drive_one_box(ft, slew_x=0.25, length_x=4.0)
    lt = TP.drive_leg(ft, lt, [1.0, 2.0], "POSITIVE_X", Qd=np.eye(2) * 0.3)
    assert lt == lj
    assert_same_graph(fj, ft)


def test_calc_helix_T_equals_jax():
    for kw in ({}, {"radius": 3.0, "spine_t": lambda t: 0.5 * t + 0.2j * t}):
        got = TP.calc_helix_T(0.1, 2.5, 13, **kw)
        want = JP.calc_helix_T(0.1, 2.5, 13, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_boxes2d_ppes():
    """tests/test_patterns.py::test_boxes2d_ppes on the port."""
    fg = TC.generate_graph_boxes2d(8)
    expected = {"x0": [0, 0], "x1": [15, 0], "x2": [15, 15], "x3": [5, 15], "x4": [5, 0],
                "x5": [20, 0], "x6": [20, 15], "x7": [10, 15], "x8": [10, 0]}
    for lbl, exp in expected.items():
        np.testing.assert_allclose(fg.get_ppe(lbl, "simulated"), exp, atol=1e-3)
    assert "POSITIVE_X" in fg.variables["x1"].tags
    assert "NEGATIVE_Y" in fg.variables["x4"].tags


def test_helix2d_base_ppes():
    """tests/test_patterns.py::test_helix2d_base_ppes on the port."""
    fg = TC.generate_graph_helix2d(5, posesperturn=15, radius=10)
    assert not fg.params.graphinit
    expected = [[0.0, 0.0, 1.5707963267948966],
                [0.8645454235739924, 4.067366430758004, 1.151917276019672],
                [3.3086939364114176, 7.431448254773942, 0.7330382545911657],
                [6.909830056250526, 9.510565162951536, 0.31415923447063226],
                [11.045284632676536, 9.945218953682733, -0.10471978645923721]]
    for i, exp in enumerate(expected):
        np.testing.assert_allclose(fg.get_ppe(f"x{i}", "simulated"), exp, atol=1e-5)
    TC.generate_graph_helix2d(6, fg=fg, posesperturn=15, radius=10)
    np.testing.assert_allclose(fg.get_ppe("x5", "simulated"),
                               [15.0, 8.660254037844387, -0.5235988055902416], atol=1e-5)


def test_helix2d_slew_lastpose():
    """tests/test_patterns.py::test_helix2d_slew_lastpose on the port."""
    fg = TC.generate_graph_helix2d_slew(46, slew_x=2 / 3, posesperturn=15, radius=10)
    np.testing.assert_allclose(fg.get_ppe("x45", "simulated"), [20, 0, 1.465088], atol=1e-3)


def test_aliases():
    assert TP.generateGraph_Helix2D is TP.generate_graph_helix2d
    assert TP.generateGraph_Helix2DSlew is TP.generate_graph_helix2d_slew
    assert TP.generateGraph_Helix2DSpiral is TP.generate_graph_helix2d_spiral
    assert TP.generateGraph_Boxes2D is TP.generate_graph_boxes2d
