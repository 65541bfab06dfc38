"""The rest of the port's sums in a fixed order (ops/segment_sum.SegmentPlan):
the chordal stage, the dense normal equations and the distributed paths'
own sums.

- The chordal start (solvers/init2d.py) on a 6 x 6 grid (36 poses: the
  dense path) and an 18 x 18 grid (324 poses: the nested-dissection path),
  with and without a frozen pose: bit-equal when the same graph's
  Pose2Pose2 factors are added in two other orders (a CPU ``index_add_``
  sums in row order, so the parent's start moved in its last bits), and within the atol 1e-4 of
  tests/test_torch_slice.py of the JAX package's ``chordal_init_pose2`` on
  the same inputs. The ND symbolic plan does not depend on the factors'
  order (its separator tree and levels are the same), so the whole start
  is held bit-equal. Each of the stage's sums (the diagonal, both
  gradients, one matvec of each stage, the dense matrix) equals the
  ``index_add_`` / ``index_put_(accumulate=True)`` it replaced in float64
  at 1e-12 of its terms' magnitude.
- ``dense_normal_eqs`` on a Pose2 / Point2 graph with a frozen pose: H and g
  bit-equal when each type's factors are added in another order, within 1e-12 (float64) or 1e-6
  (float32) relative of the ``index_put_`` reference; a solver keeps one
  dense plan for its own connectivity.
- The distributed paths at world 1 on the CPU (a mesh without a process
  group) on tests/test_sharding.py's 256-pose chain, its batches' rows
  permuted: the factor-sharded step's update and the varpart gradient
  bit-equal; the LM solves take the same iterations and reason to final
  costs within 1e-9 relative (the costs themselves are sums over the rows
  in their order), the varpart one to the same poses bit for bit, the
  sharded one within tests/test_torch_sharding.py's 1e-6 of the JAX
  package's at ndev 1.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.parallel import sharding as JS  # noqa: E402
from rome_tpu.solvers.init2d import chordal_init_pose2 as jax_chordal  # noqa: E402
from rome_tpu_torch.graph.convert import graph_arrays_to_numpy as arrays_of  # noqa: E402
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from rome_tpu_torch.parallel.distributed import Mesh  # noqa: E402
from rome_tpu_torch.parallel.sharding import make_sharded_gn_step, solve_distributed  # noqa: E402
from rome_tpu_torch.parallel.varpart import make_varpart_solver  # noqa: E402
from rome_tpu_torch.solvers import init2d as I  # noqa: E402
from rome_tpu_torch.solvers import linearize as L  # noqa: E402
from rome_tpu_torch.solvers.gauss_newton import GNOptions, ParametricSolver  # noqa: E402
from rome_tpu_torch.solvers.sparse.symbolic import entry_coords  # noqa: E402
from test_torch_fixed_order import _graph  # noqa: E402
from test_torch_helpers import grid_graph  # noqa: E402
from test_torch_sharding import to_f64  # noqa: E402
from torch_ranks import port_ga  # noqa: E402

F32, F64 = torch.float32, torch.float64
ORDERS = (1, 2)


def reordered(src, seed):
    """The port graph ``src`` with the same variables (same order, points
    and solvable flags) and the factors of each type added in a seeded other
    order (the types first appear in the same order, so the lowered batches
    keep theirs and only their rows move)."""
    fg = T.FactorGraph()
    for lbl in src._var_order:
        fg.add_variable(lbl, src.variables[lbl].vtype,
                        solvable=src.variables[lbl].solvable)
        fg.set_point(lbl, src.get_point(lbl))
    labels = list(src._fct_order)
    types = list(dict.fromkeys(src.factors[l].ftype.name for l in labels))
    perm = np.random.default_rng(seed).permutation(len(labels))
    for k in sorted(perm, key=lambda k: types.index(src.factors[labels[k]].ftype.name)):
        f = src.factors[labels[k]]
        fg.add_factor(list(f.variables), copy.copy(f), label=labels[k], graphinit=False)
    return fg


def _assert_rows_permuted(ga, gp):
    permuted = False
    for b, bp in zip(ga.batches, gp.batches):
        assert b.ftype.name == bp.ftype.name and b.n == bp.n
        permuted |= b.n > 1 and not torch.equal(b.vslots, bp.vslots)
    assert permuted


# --- the chordal stage -------------------------------------------------------

def _chordal_inputs(side, frozen):
    fg = grid_graph(T, side, side, seed=4, frozen=frozen)
    noise = np.random.default_rng(5).normal(0, 0.3, (side * side, 3))
    gas = [lower(g, dtype=F32, device="cpu") for g in [fg] + [reordered(fg, s) for s in ORDERS]]
    v0 = (gas[0].values0["Pose2"].numpy() + noise).astype(np.float32)
    return gas, v0


@pytest.mark.parametrize("side,frozen", [(6, ()), (6, ("x7",)), (18, ()), (18, ("x100",))])
def test_chordal_start_is_one_answer_per_input(side, frozen):
    gas, v0 = _chordal_inputs(side, frozen)
    for gp in gas[1:]:
        _assert_rows_permuted(gas[0], gp)
    starts = [I.chordal_init_pose2(ga, {"Pose2": torch.as_tensor(v0)})["Pose2"] for ga in gas]
    for s in starts[1:]:
        assert torch.equal(starts[0], s)
    with jax.enable_x64():
        jga = jax_lower(grid_graph(R, side, side, seed=4, frozen=frozen))
        assert jga.var_labels["Pose2"] == gas[0].var_labels["Pose2"]
        want = np.asarray(jax_chordal(jga, {"Pose2": jnp.asarray(v0)})["Pose2"])
    np.testing.assert_allclose(starts[0].numpy(), want, rtol=0, atol=1e-4)
    for lbl in frozen:
        s = gas[0].var_labels["Pose2"].index(lbl)
        np.testing.assert_array_equal(starts[0][s].numpy(), v0[s])
    plans = [I._chordal_plan(side * side, I._pose2_edges(ga), I._pose2_priors(ga), "cpu")[0]
             for ga in gas]
    assert (plans[0].sym is None) == (side * side < I._SPARSE_THRESHOLD)
    if plans[0].sym is not None:
        # the ND symbolic order follows the graph, not the factors' order
        for p in plans[1:]:
            assert p.sym.plan == plans[0].sym.plan
            for k in ("rows", "cols"):
                assert not np.array_equal(p.sym.arrs[k], plans[0].sym.arrs[k])


def _close_to_terms(got, want, terms_abs):
    """|got - want| <= 1e-12 of each destination's summed magnitudes."""
    assert torch.all((got - want).abs() <= 1e-12 * terms_abs + 1e-300)


@pytest.mark.parametrize("side", [6, 18])
def test_chordal_sums_equal_index_add(side):
    gas, v0 = _chordal_inputs(side, ())
    ga, n = gas[0], side * side
    edges = [(i, j, z.double(), S.double(), w.double()) for i, j, z, S, w in I._pose2_edges(ga)]
    priors = [(i, z.double(), S.double(), w.double()) for i, z, S, w in I._pose2_priors(ga)]
    plan, arrs = I._chordal_plan(n, I._pose2_edges(ga), I._pose2_priors(ga), "cpu")
    rng = np.random.default_rng(7)
    u0 = torch.as_tensor(rng.normal(size=(n, 2)))
    x = torch.as_tensor(rng.normal(size=(n, 2)))
    R2 = I.rot2(torch.as_tensor(v0[:, 2]).double())
    et1, pt1 = I._rot_terms(edges, priors)
    et2, pt2 = I._tr_terms(edges, priors, R2)
    slots = torch.cat([v for i, j, *_ in et1 for v in (i, j)] + [p[0] for p in pt1])
    for parts in (I._rot_rows(et1, pt1, u0, grad=True), I._rot_rows(et1, pt1, x),
                  I._tr_rows(et2, pt2, x, grad=True), I._tr_rows(et2, pt2, x)):
        c = torch.cat(parts)
        got = arrs["rows"].add_(torch.zeros((n, 2), dtype=F64), c)
        want = torch.zeros((n, 2), dtype=F64).index_add_(0, slots, c)
        _close_to_terms(got, want, torch.zeros((n, 2), dtype=F64).index_add_(0, slots, c.abs()))
    assert arrs["rows"].max_run > 2
    vals = I._rot_entries(et1, pt1).double()
    rows, cols = (torch.as_tensor(a) for a in entry_coords(["U"], {"U": n}, {"U": 2},
                                                          plan.specs))
    if plan.sym is None:
        got = arrs["dense"].add_(torch.zeros(4 * n * n, dtype=F64), vals).view(2 * n, 2 * n)
        want = torch.zeros((2 * n, 2 * n), dtype=F64).index_put_((rows, cols), vals,
                                                                 accumulate=True)
        terms = torch.zeros((2 * n, 2 * n), dtype=F64).index_put_((rows, cols), vals.abs(),
                                                                  accumulate=True)
    else:
        nd = arrs["nd"]
        got = nd["sum_diag"].add_(torch.zeros(2 * n, dtype=F64), vals)
        want = torch.zeros(2 * n, dtype=F64).index_add_(0, nd["diag_dst"],
                                                        vals[nd["diag_src"]])
        terms = want.abs()
        assert nd["sum_diag"].max_run > 2
    _close_to_terms(got, want, terms)


# --- the dense normal equations ----------------------------------------------

def _dense_graphs(dtype):
    fg = _graph()
    fg.variables["x7"].solvable = 0
    gas = [lower(g, dtype=dtype, device="cpu") for g in [fg] + [reordered(fg, s) for s in ORDERS]]
    return gas, [L.linearize_all(ga, ga.values0) for ga in gas]


def _index_put_reference(ga, lins, dtype):
    base, D = L.tangent_offsets(ga)
    H = torch.zeros((D, D), dtype=dtype)
    g = torch.zeros(D, dtype=dtype)
    for b, r0, Js, vs in lins:
        Js = [J.to(dtype) for J in Js]
        offs = [base[t] + vs[:, k, None] * ga.manifolds[t].dof
                + torch.arange(ga.manifolds[t].dof) for k, t in enumerate(b.vtypes)]
        for k, Jk in enumerate(Js):
            g.index_add_(0, offs[k].reshape(-1),
                         torch.einsum("nij,ni->nj", Jk, r0.to(dtype)).reshape(-1))
            for m, Jm in enumerate(Js):
                blk = torch.einsum("nij,nik->njk", Jk, Jm)
                H.index_put_((offs[k][:, :, None].expand(blk.shape).reshape(-1),
                              offs[m][:, None, :].expand(blk.shape).reshape(-1)),
                             blk.reshape(-1), accumulate=True)
    f = L.free_vector(ga).to(dtype)
    return H * f[:, None] * f[None, :] + torch.diag(1.0 - f), g * f


@pytest.mark.parametrize("dtype,rtol", [(F64, 1e-12), (F32, 1e-6)])
def test_dense_normal_eqs_one_answer_per_input(dtype, rtol):
    gas, linss = _dense_graphs(dtype)
    for gp in gas[1:]:
        _assert_rows_permuted(gas[0], gp)
    out = [L.dense_normal_eqs(ga, lins, dtype=dtype) for ga, lins in zip(gas, linss)]
    for H, g in out[1:]:
        assert torch.equal(H, out[0][0]) and torch.equal(g, out[0][1])
    H, g = out[0]
    Href, gref = _index_put_reference(gas[0], linss[0], dtype)
    torch.testing.assert_close(H, Href, rtol=0, atol=rtol * float(Href.abs().max()))
    torch.testing.assert_close(g, gref, rtol=0, atol=rtol * float(gref.abs().max()))
    # the frozen pose: an identity row and column, a zero gradient
    s = 3 * gas[0].var_labels["Pose2"].index("x7")
    assert torch.equal(H[s, s], torch.ones((), dtype=dtype)) and float(g[s].abs()) == 0.0
    plan = L.DenseScatter.of(gas[0], [vs for *_x, vs in linss[0]])
    assert plan.h.max_run > 4 and plan.g.max_run > 4


@pytest.mark.parametrize("linear", ["dense", "dense32", "mixed"])
def test_dense_solvers_keep_one_plan(linear):
    gas, _linss = _dense_graphs(F64)
    solver = ParametricSolver(gas[0], GNOptions(linear=linear, max_iters=2))
    _v, rt = solver._start(None, None)
    assert rt["dense"] is solver._dense
    _v, rt2 = solver._start(None, None)
    assert rt2["dense"] is solver._dense
    # another connectivity of the same structure: a plan of its own
    _v, rt3 = solver._start(None, L.runtime_state(gas[1]))
    assert rt3["dense"] is not solver._dense
    _v, stats = solver.solve()
    assert np.isfinite(stats.final_cost)


def test_ndchol_and_pcg_make_no_dense_plan():
    gas, _linss = _dense_graphs(F64)
    for linear in ("ndchol", "pcg"):
        solver = ParametricSolver(gas[0], GNOptions(linear=linear, max_iters=2))
        _v, rt = solver._start(None, None)
        assert "dense" not in rt and solver._dense is None


# --- the distributed paths at world 1 ----------------------------------------

def _permuted_rows(ga, seed):
    """``ga`` with every batch's rows in a seeded other order (the factors
    added in another order)."""
    rng = np.random.default_rng(seed)
    batches = []
    for b in ga.batches:
        p = torch.as_tensor(rng.permutation(b.n))
        batches.append(dataclasses.replace(
            b, vslots=b.vslots[p], weight=b.weight[p],
            params={k: v[p] for k, v in b.params.items()}))
    return dataclasses.replace(ga, batches=batches)


@pytest.fixture(scope="module")
def chain():
    with jax.enable_x64():
        jga = to_f64(ge._build_chain_fixture(256, "local"))
        step, ga_p = JS.make_sharded_gn_step(jga, JMesh(np.array(jax.devices()[:1]), ("f",)),
                                             pcg_iters=100)
        _v, it, code, fc = step.solve(ga_p.values0, jnp.asarray(1e-4, jnp.float64))
    ga = port_ga(arrays_of(jga))
    return [ga] + [_permuted_rows(ga, s) for s in ORDERS], float(fc)


def _mesh():
    return Mesh(axis="f", world=1, rank=0, device=torch.device("cpu"))


def test_sharded_sums_one_answer_per_input(chain):
    gas, jax_cost = chain
    steps = []
    for ga in gas:
        step, ga_p = make_sharded_gn_step(ga, _mesh(), pcg_iters=100, device="cpu")
        steps.append(step(ga_p.values0, 1e-4))
    v0, c00, c10, _gn, ok0 = steps[0]
    assert ok0
    for v, c0, c1, _gn, ok in steps[1:]:
        assert ok
        for t in v0:
            assert torch.equal(v[t], v0[t])
        assert abs(c0 - c00) <= 1e-12 * c00 and abs(c1 - c10) <= 1e-12 * c10
    stats = [solve_distributed(ga, _mesh(), max_iters=100, pcg_iters=100, device="cpu")[1]
             for ga in gas]
    for s in stats:
        assert (s["iterations"], s["reason"]) == (stats[0]["iterations"], stats[0]["reason"])
        assert abs(s["final_cost"] - stats[0]["final_cost"]) <= 1e-9 * stats[0]["final_cost"]
        assert abs(s["final_cost"] - jax_cost) <= 1e-6 * max(1.0, jax_cost)


def test_varpart_sums_one_answer_per_input(chain):
    gas, _jax_cost = chain
    solvers = [make_varpart_solver(ga, _mesh(), max_iters=60, device="cpu")[0] for ga in gas]
    grads = [s.probe("grad") for s in solvers]
    for g in grads[1:]:
        for t in g:
            assert torch.equal(g[t], grads[0][t])
    runs = [s(lam0=1e-4) for s in solvers]
    values0, stats0 = runs[0]
    assert stats0["converged"]
    for values, stats in runs[1:]:
        assert (stats["iterations"], stats["reason"]) == (stats0["iterations"], stats0["reason"])
        assert abs(stats["final_cost"] - stats0["final_cost"]) <= 1e-9 * max(
            stats0["final_cost"], 1e-12)
        # every Schur step the same: the same poses, bit for bit
        for t in values0:
            assert torch.equal(values[t], values0[t])
