"""The port's Bayes tree against the JAX package's.

- ``get_elimination_order`` and ``build_tree_from_ordering`` are exactly
  equal on the chain-6, the hexagonal graph and honeycomb-14: order, every
  clique's frontals, separator, factors, parent, children and signature,
  the levels; so are ``_dirty_cliques``, the recycled counts and the
  ``format_tree`` text after a regrow (chain 6 -> 7, honeycomb 7 -> 14).
- The maxincidence guard raises as the JAX one does.
- ``solve_tree`` (batched level schedule and loop schedule) keeps a chain's
  particle medians within 0.6 m of the truth (tests/test_bayes_tree.py's
  gate), agrees with the JAX ``solve_tree`` by mean symmetric k-NN KL < 1.0,
  and on a regrow keeps every recycled clique's frontal beliefs and points
  bit-identical (tests/test_bayes_tree.py:121-155's contract).
- ``showtree``/``drawtree``/``dbg`` write what the JAX package writes.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.canonical.generators import generate_graph_hexagonal as jax_hex  # noqa: E402
from rome_tpu.canonical.patterns import generate_graph_honeycomb as jax_honeycomb  # noqa: E402
from rome_tpu.solvers.multimodal import tree as JT  # noqa: E402
from rome_tpu_torch.canonical import generate_graph_hexagonal, generate_graph_honeycomb  # noqa: E402
from rome_tpu_torch.manifolds.base import SE2_  # noqa: E402
from rome_tpu_torch.solvers.multimodal import tree as TT  # noqa: E402
from rome_tpu_torch.solvers.multimodal.metrics import symmetric_kl_knn  # noqa: E402

N = 50


def chain(M, n=5):
    fg = M.FactorGraph()
    fg.params.N = N
    fg.add_variable("x0", M.Pose2)
    fg.add_factor(["x0"], M.PriorPose2(M.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    for i in range(1, n):
        grow(M, fg, i)
    return fg


def grow(M, fg, i):
    fg.add_variable(f"x{i}", M.Pose2)
    fg.add_factor([f"x{i-1}", f"x{i}"], M.Pose2Pose2(M.MvNormal([1, 0, 0], np.eye(3) * 0.01)))


def _graphs(name):
    if name == "chain6":
        return chain(R, 6), chain(T, 6)
    if name == "hexagonal":
        return jax_hex(), generate_graph_hexagonal()
    return (jax_honeycomb(pose_count_target=14, graphinit=False),
            generate_graph_honeycomb(pose_count_target=14, graphinit=False))


def _tree_fields(tree):
    return dict(
        order=tree.order, levels=tree.levels, num_recycled=tree.num_recycled,
        cliques=[(c.index, c.frontals, c.separator, c.factors, c.parent, c.children,
                  c.signature, c.variables, repr(c)) for c in tree.cliques],
    )


@pytest.mark.parametrize("name", ["chain6", "hexagonal", "honeycomb14"])
def test_elimination_order_and_tree_equal_jax(name):
    fj, ft = _graphs(name)
    assert TT.get_elimination_order(ft) == JT.get_elimination_order(fj)
    for constraints in (["x0"], ["x2", "x1"]):
        assert TT.get_elimination_order(ft, constraints=constraints) == \
            JT.get_elimination_order(fj, constraints=constraints)
    tj, tt = JT.build_tree_from_ordering(fj), TT.build_tree_from_ordering(ft)
    assert _tree_fields(tt) == _tree_fields(tj)
    assert tt.num_cliques == tj.num_cliques
    assert tt.clique_of("x1").index == tj.clique_of("x1").index
    assert sorted(v for c in tt.cliques for v in c.frontals) == sorted(ft.ls())
    # an explicit order builds the same tree as well
    order = list(reversed(ft._var_order))
    assert _tree_fields(TT.build_tree_from_ordering(ft, order)) == \
        _tree_fields(JT.build_tree_from_ordering(fj, order))


def _regrow(name):
    """(JAX, port) trees before and after one growth step, with dirty sets."""
    if name == "chain":
        fj, ft = chain(R, 6), chain(T, 6)
        oj, ot = JT.build_tree_from_ordering(fj), TT.build_tree_from_ordering(ft)
        grow(R, fj, 6)
        grow(T, ft, 6)
    else:
        fj = jax_honeycomb(pose_count_target=7, graphinit=False)
        ft = generate_graph_honeycomb(pose_count_target=7, graphinit=False)
        oj, ot = JT.build_tree_from_ordering(fj), TT.build_tree_from_ordering(ft)
        jax_honeycomb(pose_count_target=14, fg=fj, graphinit=False)
        generate_graph_honeycomb(pose_count_target=14, fg=ft, graphinit=False)
    tj = JT.build_tree_from_ordering(fj, old_tree=oj)
    tt = TT.build_tree_from_ordering(ft, old_tree=ot)
    return (oj, tj), (ot, tt)


@pytest.mark.parametrize("name", ["chain", "honeycomb"])
def test_recycling_and_format_equal_jax(name):
    (oj, tj), (ot, tt) = _regrow(name)
    assert TT.calc_cliques_recycled(tt) == JT.calc_cliques_recycled(tj)
    dj, dt = JT._dirty_cliques(tj, oj), TT._dirty_cliques(tt, ot)
    assert dt == dj
    assert TT.calc_cliques_recycled(tt) == JT.calc_cliques_recycled(tj)
    total, recycled = TT.calc_cliques_recycled(tt)
    assert 0 < recycled < total
    tj.dirty, tt.dirty = dj, dt
    assert TT.format_tree(tt) == JT.format_tree(tj)
    assert TT._dirty_cliques(tt, None) == JT._dirty_cliques(tj, None)
    assert tt.num_recycled == 0
    assert TT.drawTree is TT.format_tree and TT.solveTree is TT.solve_tree


def test_maxincidence_guard():
    def hub(M):
        fg = M.FactorGraph()
        fg.params.maxincidence = 3
        fg.add_variable("hub", M.Pose2)
        fg.add_factor(["hub"], M.PriorPose2(M.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
        for i in range(6):
            fg.add_variable(f"x{i}", M.Pose2)
            fg.add_factor(["hub", f"x{i}"], M.Pose2Pose2(M.MvNormal([1, 0, 0], np.eye(3) * 0.01)))
        return fg

    with pytest.raises(RuntimeError, match="maxincidence") as ej:
        JT.get_elimination_order(hub(R))
    with pytest.raises(RuntimeError, match="maxincidence") as et:
        TT.get_elimination_order(hub(T))
    assert str(et.value) == str(ej.value)
    assert TT.get_elimination_order(hub(T), maxincidence=6) == \
        JT.get_elimination_order(hub(R), maxincidence=6)


def _medians_ok(fg, n, gate=0.6):
    for i in range(n):
        pts = fg.variables[f"x{i}"].beliefs["default"]
        assert pts.shape == (N, 3) and np.isfinite(pts).all()
        assert abs(np.median(pts[:, 0]) - i) < gate, (i, np.median(pts[:, 0]))


@pytest.mark.parametrize("engine", ["batched", "loop"])
def test_solve_tree_chain_accuracy(engine):
    fg = chain(T, 4)
    tree = TT.solve_tree(fg, N=N, engine=engine, seed=3, device="cpu")
    assert tree.num_cliques >= 1 and tree.dirty == set(range(tree.num_cliques))
    _medians_ok(fg, 4)
    for i in range(4):
        assert abs(fg.get_point(f"x{i}", "default")[0] - i) < 0.6


def test_solve_tree_agrees_with_jax_by_kl():
    fj, ft = chain(R, 4), chain(T, 4)
    JT.solve_tree(fj, N=N, key=jax.random.PRNGKey(1))
    TT.solve_tree(ft, N=N, seed=1, device="cpu")
    kl = np.mean([
        symmetric_kl_knn(SE2_, torch.as_tensor(np.asarray(fj.variables[l].beliefs["default"])),
                         torch.as_tensor(ft.variables[l].beliefs["default"]))
        for l in ft.ls()
    ])
    assert kl < 1.0


def test_recycled_cliques_bit_identical():
    fg = chain(T, 8)
    tree1 = TT.solve_tree(fg, N=N, seed=5, device="cpu")
    before = {v: np.array(fg.variables[v].beliefs["default"]) for v in fg.ls()}
    pts_before = {v: np.array(fg.get_point(v, "default")) for v in fg.ls()}
    grow(T, fg, 8)
    tree2 = TT.solve_tree(fg, tree1, N=N, seed=6, device="cpu")
    assert tree2.num_recycled > 0
    recycled = [v for c in tree2.cliques if c.index not in tree2.dirty
                for v in c.frontals if v in before]
    assert recycled, "expected at least one recycled clique"
    for v in recycled:
        np.testing.assert_array_equal(fg.variables[v].beliefs["default"], before[v])
        np.testing.assert_array_equal(fg.get_point(v, "default"), pts_before[v])
    assert abs(np.median(fg.variables["x8"].beliefs["default"][:, 0]) - 8) < 1.0


def test_treeinit_routes_through_the_tree_and_writes_logs(tmp_path, capsys):
    fg = chain(T, 3)
    fg.params.treeinit = True
    fg.params.showtree = fg.params.drawtree = fg.params.dbg = True
    fg.params.logpath = str(tmp_path)
    T.solve_graph_nonparametric(fg, N=N, seed=2, device="cpu")
    _medians_ok(fg, 3)
    text = (tmp_path / "bt.txt").read_text()
    assert text.startswith("BayesTree: ") and text in capsys.readouterr().out
    dbg = json.loads((tmp_path / "solve_dbg.json").read_text())
    assert dbg["num_recycled"] == 0 and dbg["dirty"] == list(range(dbg["num_cliques"]))
