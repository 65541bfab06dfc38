"""The port's canonical generators against the JAX package's: the pose
chain, the two-pose odometry graph, the circle, the hexagon and the
honeycomb grown 7 -> 14 -> 21 poses. The same variables (labels, types,
tags, order), the same factors (type, variables, order, measurement
parameters, nullhypo, multihypo) and the same simulated ground-truth PPEs,
at atol 1e-12 (the JAX package propagates its ground truth in float64)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu.canonical.generators as JG  # noqa: E402
import rome_tpu.canonical.patterns as JP  # noqa: E402
import rome_tpu_torch.canonical.generators as TG  # noqa: E402
import rome_tpu_torch.canonical.patterns as TP  # noqa: E402
from rome_tpu.distributions import MvNormal as JMv  # noqa: E402
from rome_tpu_torch.distributions import MvNormal as TMv  # noqa: E402


def assert_same_graph(fj, ft):
    assert ft._var_order == fj._var_order and ft._fct_order == fj._fct_order
    assert ft.params.N == fj.params.N and ft.params.graphinit == fj.params.graphinit
    for lbl in fj._var_order:
        vj, vt = fj.variables[lbl], ft.variables[lbl]
        assert (vt.vtype.name, vt.tags, vt.solvable, vt.slot) == \
            (vj.vtype.name, vj.tags, vj.solvable, vj.slot)
        assert sorted(vt.ppes) == sorted(vj.ppes)
        for k, v in vj.ppes.items():
            np.testing.assert_allclose(vt.ppes[k], v, rtol=0, atol=1e-12)
        assert ft.neighbors(lbl) == fj.neighbors(lbl)
    for lbl in fj._fct_order:
        a, b = fj.factors[lbl], ft.factors[lbl]
        assert (b.ftype.name, b.variables, b.solvable, b.nullhypo, b.multihypo) == \
            (a.ftype.name, a.variables, a.solvable, a.nullhypo, a.multihypo)
        assert sorted(b.params) == sorted(a.params)
        for k, v in a.params.items():
            np.testing.assert_allclose(b.params[k], v, rtol=0, atol=1e-12)
        assert [type(d).__name__ for d in b.dists] == [type(d).__name__ for d in a.dists]


def _both(fn_j, fn_t):
    with jax.enable_x64():
        fj = fn_j()
    return fj, fn_t()


@pytest.mark.parametrize("case", ["chain", "chain_custom", "two_pose", "two_pose_bare",
                                  "circle", "circle_bias", "hexagonal", "hexagonal_open"])
def test_generators_match_jax(case):
    def custom(mv):
        return [mv([5.0, 1.0, 0.2], np.diag([0.2, 0.1, 0.05])) for _ in range(4)]

    calls = {
        "chain": lambda G, mv: G.build_graph_chain(),
        "chain_custom": lambda G, mv: G.build_graph_chain(custom(mv)),
        "two_pose": lambda G, mv: G.generate_graph_two_pose_odo(),
        "two_pose_bare": lambda G, mv: G.generate_graph_two_pose_odo(add_landmark=False),
        "circle": lambda G, mv: G.generate_graph_circle(8),
        "circle_bias": lambda G, mv: G.generate_graph_circle(
            5, bias_turn=0.1, kappa_odo=2.0, loop_closure=False),
        "hexagonal": lambda G, mv: G.generate_graph_hexagonal(N=50),
        "hexagonal_open": lambda G, mv: G.generate_graph_hexagonal(landmark=False,
                                                                    graphinit=False),
    }
    fj, ft = _both(lambda: calls[case](JG, JMv), lambda: calls[case](TG, TMv))
    assert_same_graph(fj, ft)


def test_honeycomb_grow_matches_jax():
    fj = ft = None
    for target in (7, 14, 21):
        with jax.enable_x64():
            fj = JP.generate_graph_honeycomb(pose_count_target=target, fg=fj, graphinit=True)
        ft = TP.generate_graph_honeycomb(pose_count_target=target, fg=ft, graphinit=True)
        assert_same_graph(fj, ft)
        assert len(ft.ls(r"^x\d+$")) == target + 1
    assert len(ft.ls(r"^l\d+$")) == 14 and ft.num_factors == 44
    # graphinit propagated a point into every pose
    for lbl in ft.ls(r"^x\d+$"):
        np.testing.assert_allclose(ft.get_point(lbl), fj.get_point(lbl), rtol=0, atol=1e-9)


def test_honeycomb_offset_legs_match_jax():
    with jax.enable_x64():
        fj = JP.generate_graph_honeycomb(pose_count_target=44, graphinit=False)
    ft = TP.generate_graph_honeycomb(pose_count_target=44, graphinit=False)
    assert_same_graph(fj, ft)
    assert TP._HONEYCOMB_OFFSET_LEGS == JP._HONEYCOMB_OFFSET_LEGS
    assert TP.generateGraph_Honeycomb is TP.generate_graph_honeycomb
    assert TG.generateGraph_Hexagonal is TG.generate_graph_hexagonal
