"""The LM path's sums in a fixed order (ops/segment_sum.SegmentPlan).

- Every fixed-order sum equals the atomic ``index_add_`` it replaces, in
  float64 at atol 1e-12 (the two add the same terms in another order): the
  plan itself on random indices, the gradient, Hvp and block diagonal of a
  mixed Pose2 / Point2 graph (``TangentScatter``), and the ndchol assembly,
  extend-add and forward sweep (``sum_*`` plans of ``device_arrs``).
- The planned order follows the structure: the same graph with its factors
  added in another order (so every batch's rows permuted) gives bit-equal
  gradients, Hvps, block diagonals, diagonals of H and assembled fronts.
- Calls with the same inputs give the same bits (on the CPU this checks the
  plumbing; chip_smoke.py repeats the solves on the card).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rome_tpu_torch as T  # noqa: E402
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from rome_tpu_torch.ops.segment_sum import SegmentPlan  # noqa: E402
from rome_tpu_torch.solvers import linearize as L  # noqa: E402
from rome_tpu_torch.solvers.gauss_newton import ndchol_plan  # noqa: E402
from rome_tpu_torch.solvers.sparse import ndchol as N  # noqa: E402

ATOL = 1e-12
F64 = torch.float64


@pytest.mark.parametrize("trail", [(), (3,), (3, 3)])
@pytest.mark.parametrize("dup", [True, False])
def test_plan_equals_index_add(trail, dup):
    rng = np.random.default_rng(1)
    E, M = 5000, 700
    dst = rng.integers(0, M, E) if dup else rng.permutation(M)[:E // 10]
    src = rng.permutation(len(dst)) if dup else None
    vals = torch.as_tensor(rng.normal(size=(len(dst),) + trail) * 10.0 ** rng.integers(
        -3, 4, (len(dst),) + trail), dtype=F64)
    plan = SegmentPlan(dst, src, keys=(rng.integers(0, 5, (len(dst), 2)),))
    assert (plan.offsets is not None) == dup
    got = plan.add_(torch.ones((M,) + trail, dtype=F64), vals)
    g = vals if src is None else vals[torch.as_tensor(src)]
    want = torch.ones((M,) + trail, dtype=F64).index_add_(0, torch.as_tensor(dst), g)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL * float(vals.abs().max()))
    again = plan.add_(torch.ones((M,) + trail, dtype=F64), vals)
    assert torch.equal(got, again)


def test_plan_orders_by_key_then_position():
    dst = np.array([2, 0, 2, 2, 0])
    key = np.array([9, 1, 3, 3, 0])
    plan = SegmentPlan(dst, keys=(key,))
    assert plan.src.tolist() == [4, 1, 2, 3, 0]
    assert plan.dst.tolist() == [0, 2] and plan.offsets.tolist() == [0, 2, 5]
    assert plan.max_run == 3
    empty = SegmentPlan(np.zeros(0, np.int64))
    out = torch.zeros(3, dtype=F64)
    assert empty.add_(out, torch.zeros(0, dtype=F64)) is out


def _graph(order_seed=None, rows=5, cols=5, landmarks=6, seed=0):
    """A Pose2 grid with Point2 landmarks seen by bearing-range (two batch
    types of arity 2 over two variable types, a prior); with
    ``order_seed``, the same factors added in a shuffled order."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    factors = [(["x0"], T.PriorPose2(T.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))]
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for j, d in ((i + 1, (1, 0)), (i + cols, (0, 1))):
                if (d[0] and c + 1 < cols) or (d[1] and r + 1 < rows):
                    z = [d[0] + rng.normal(0, 0.02), d[1] + rng.normal(0, 0.02),
                         rng.normal(0, 0.01)]
                    factors.append(([f"x{i}", f"x{j}"],
                                    T.Pose2Pose2(T.MvNormal(z, [0.1, 0.1, 0.05]))))
    for k in range(landmarks):
        for i in rng.choice(n, 4, replace=False):
            factors.append(([f"x{i}", f"l{k}"], T.Pose2Point2BearingRange(
                T.Normal(rng.uniform(-3, 3), 0.05), T.Normal(rng.uniform(1, 4), 0.1))))
    if order_seed is not None:
        perm = np.random.default_rng(order_seed).permutation(len(factors) - 1) + 1
        factors = [factors[0]] + [factors[i] for i in perm]
    fg = T.FactorGraph()
    for i in range(n):
        fg.add_variable(f"x{i}", T.Pose2)
    for k in range(landmarks):
        fg.add_variable(f"l{k}", T.Point2)
    for labels, f in factors:
        fg.add_factor(labels, copy.copy(f), graphinit=False)
    vrng = np.random.default_rng(seed + 1)
    for i in range(n):
        fg.set_point(f"x{i}", [i % cols + vrng.normal(0, .1), i // cols + vrng.normal(0, .1),
                               vrng.normal(0, .1)])
    for k in range(landmarks):
        fg.set_point(f"l{k}", vrng.normal(2, 1, 2))
    return fg


def _lowered(order_seed=None):
    ga = lower(_graph(order_seed), dtype=F64, device="cpu")
    lins = L.linearize_all(ga, ga.values0)
    return ga, lins


def _index_add_reference(ga, lins, fn):
    out = {}
    for batch, r0, Js, vs in lins:
        for k, t in enumerate(batch.vtypes):
            c = fn(batch, r0, Js, vs, k)
            if t not in out:
                out[t] = torch.zeros((ga.counts[t],) + c.shape[1:], dtype=F64)
            out[t].index_add_(0, vs[:, k], c)
    return out


def test_tangent_sums_equal_index_add():
    ga, lins = _lowered()
    v = {t: torch.as_tensor(np.random.default_rng(3).normal(size=(ga.counts[t],
         ga.manifolds[t].dof)), dtype=F64) for t in ga.type_names}
    g = L.gradient_from_lins(ga, lins)
    want = _index_add_reference(ga, lins, lambda b, r0, Js, vs, k: torch.einsum(
        "nij,ni->nj", Js[k], r0))
    H = L.hvp_from_lins(ga, lins, v)

    def hv(b, r0, Js, vs, k):
        u = sum(torch.einsum("nij,nj->ni", Js[m], v[t][vs[:, m]])
                for m, t in enumerate(b.vtypes))
        return torch.einsum("nij,ni->nj", Js[k], u)

    D = L.block_diag_from_lins(ga, lins)
    wantD = _index_add_reference(ga, lins, lambda b, r0, Js, vs, k: torch.einsum(
        "nij,nik->njk", Js[k], Js[k]))
    for t in ga.type_names:
        free = ga.free[t][:, None]
        torch.testing.assert_close(g[t], want[t] * free, rtol=0, atol=ATOL)
        torch.testing.assert_close(H[t], _index_add_reference(ga, lins, hv)[t] * free,
                                   rtol=0, atol=ATOL)
        torch.testing.assert_close(D[t], wantD[t], rtol=0, atol=ATOL)
    # contributions collide: a pose's rows get several, a landmark's four
    runs = {t: p.max_run for t, p in L.tangent_scatter(ga).plans.items()}
    assert runs["Pose2"] > 4 and runs["Point2"] == 4


def _ndchol_inputs(ga, lins, lam=1e-3):
    sym, arrs = ndchol_plan(ga, 4)
    vals = L.normal_eq_entry_values(ga, lins)
    fvec = L.free_vector(ga)
    diag_H = arrs["sum_diag"].add_(torch.zeros(sym.D, dtype=F64), vals) * fvec
    df = torch.rsqrt(torch.clamp(diag_H * (1 + lam), min=1e-12)) * fvec
    diag_add = fvec * (lam / (1 + lam) + 1e-7) + (1 - fvec)
    return sym, arrs, vals, diag_H, df, diag_add


def test_ndchol_sums_equal_index_add():
    ga, lins = _lowered()
    sym, arrs, vals, diag_H, df, diag_add = _ndchol_inputs(ga, lins)
    want = torch.zeros(sym.D, dtype=F64).index_add_(0, arrs["diag_dst"],
                                                    vals[arrs["diag_src"]])
    torch.testing.assert_close(diag_H, want, rtol=0, atol=ATOL)
    Ws = N.ndchol_assemble(sym, arrs, vals, df, diag_add)
    sv = vals * df[arrs["rows"]] * df[arrs["cols"]]
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        f = sm + bm
        w = torch.zeros(n_l * f * f, dtype=F64)
        if n_l:
            w.index_add_(0, arrs[f"asm_dst_{l}"], sv[arrs[f"asm_src_{l}"]])
            w.index_add_(0, arrs[f"dummy_diag_{l}"], torch.ones(
                len(arrs[f"dummy_diag_{l}"]), dtype=F64))
            w.index_add_(0, arrs[f"real_diag_{l}"], diag_add[arrs[f"real_diag_scalar_{l}"]])
        torch.testing.assert_close(Ws[l].reshape(-1), w, rtol=0, atol=ATOL)
        # the scatters left as index_add_ write each position once
        for k in (f"dummy_diag_{l}", f"real_diag_{l}"):
            assert len(torch.unique(arrs[k])) == len(arrs[k])
    assert any(p.offsets is not None for k, p in arrs.items() if k.startswith("sum_ea_"))
    # the extend-add and the forward sweep: the factor and the solution
    Linvs, L21s, _ = N.ndchol_factorize(sym, arrs, Ws)
    b = torch.as_tensor(np.random.default_rng(5).normal(size=sym.D), dtype=F64)
    x = N.ndchol_solve(sym, arrs, Linvs, L21s, b)
    plain = _plain(sym, arrs)
    Ws0 = N.ndchol_assemble(sym, plain, vals, df, diag_add)
    for a, c in zip(Ws, Ws0):
        torch.testing.assert_close(a, c, rtol=0, atol=ATOL)
    Linvs0, L21s0, _ = N.ndchol_factorize(sym, plain, [W.clone() for W in Ws])
    x0 = N.ndchol_solve(sym, plain, Linvs0, L21s0, b)
    for a, c in zip(Linvs, Linvs0):
        if a is not None:
            torch.testing.assert_close(a, c, rtol=0, atol=1e-10)
    torch.testing.assert_close(x, x0, rtol=0, atol=1e-10)


class _IndexAdd:
    """The atomic scatter a ``sum_*`` plan replaced: ``out[dst] += vals[src]``."""

    def __init__(self, dst, src):
        self.dst, self.src = dst, src

    def add_(self, out, vals):
        return out.index_add_(0, self.dst, vals[self.src])


def _plain(sym, arrs):
    """``arrs`` with every ``sum_*`` plan replaced by the index_add_ of the
    symbolic phase's own maps, at the flat buffers' offsets."""
    out = {k: v for k, v in arrs.items() if not k.startswith("sum_")}
    fo, ro = arrs["front_offsets"], arrs["rhs_offsets"]
    out["sum_asm"] = _IndexAdd(
        torch.cat([arrs[f"asm_dst_{l}"] + fo[l] for l in range(sym.nlev)]),
        torch.cat([arrs[f"asm_src_{l}"] for l in range(sym.nlev)]))
    for kind, pairs, offs in (("ea", sym.ea_pairs, fo), ("fea", sym.fea_pairs, ro)):
        for l in range(sym.nlev):
            ms = [m for ll, m in pairs if ll == l]
            if ms:
                out[f"sum_{kind}_{l}"] = _IndexAdd(
                    torch.cat([arrs[f"{kind}_dst_{l}_{m}"] + offs[m] for m in ms]),
                    torch.cat([arrs[f"{kind}_src_{l}_{m}"] for m in ms]))
    return out


def test_planned_order_is_independent_of_the_row_order():
    ga, lins = _lowered()
    gp, lp = _lowered(order_seed=7)
    for (b, _r, _J, vs), (bp, _rp, _Jp, vsp) in zip(lins, lp):
        assert b.ftype.name == bp.ftype.name
        if b.n > 1:
            assert not torch.equal(vs, vsp)  # the rows are permuted
    v = {t: torch.as_tensor(np.random.default_rng(3).normal(size=(ga.counts[t],
         ga.manifolds[t].dof)), dtype=F64) for t in ga.type_names}
    for fn in (lambda g, l: L.gradient_from_lins(g, l),
               lambda g, l: L.hvp_from_lins(g, l, v),
               lambda g, l: L.block_diag_from_lins(g, l)):
        a, c = fn(ga, lins), fn(gp, lp)
        for t in ga.type_names:
            assert torch.equal(a[t], c[t]), t
    s1, a1, _v1, d1, df1, da1 = _ndchol_inputs(ga, lins)
    s2, a2, _v2, d2, df2, da2 = _ndchol_inputs(gp, lp)
    assert s1.plan == s2.plan
    assert torch.equal(d1, d2)
    W1 = N.ndchol_assemble(s1, a1, _v1, df1, da1)
    W2 = N.ndchol_assemble(s2, a2, _v2, df2, da2)
    for x, y in zip(W1, W2):
        assert torch.equal(x, y)


def test_solver_keeps_one_plan_per_connectivity():
    ga, _lins = _lowered()
    solver = T.solvers.gauss_newton.ParametricSolver(
        ga, T.GNOptions(linear="ndchol", max_iters=3))
    _values, rt = solver._start(None, None)
    own = solver._own["scatter"]
    assert rt["scatter"] is own
    from rome_tpu_torch.solvers.linearize import runtime_state

    # found by the connectivity key, not by the slot tensors' identity
    again = solver.plans(runtime_state(_lowered()[0]))
    assert again["scatter"] is own and again["ndchol"] is rt["ndchol"]
    gp, _lp = _lowered(order_seed=7)
    _values, rt2 = solver._start(None, runtime_state(gp))
    assert rt2["scatter"] is not own
    assert set(rt2["scatter"].plans) == set(own.plans)
