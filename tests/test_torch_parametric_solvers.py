"""The port's parametric solvers and loops against the JAX package.

- dense32, pcg and mixed on the 6x6 grid (seed 3) with the options of
  tests/test_ndchol.py:176-180 under schedule="host": same iteration count
  and reason, final cost within 1e-6 relative, poses at atol 1e-4. pcg and
  mixed carry values in the graph dtype; in float32 both packages stop on a
  rejected step at float32 noise, so there the iteration count is set by
  rounding and only the reason, cost and poses are held.
- pcg on the square of tests/test_parametric.py:25-57 (testParametric.jl's
  poses, 1e-3); ``auto`` above ``dense_threshold`` picks dense32 and solves.
- The speculative-accept ndchol loop (the default ``schedule="fused"``)
  against the JAX package's fused schedule, against the port's host loop,
  its linearize and cost-pass counts, and a rejected step that keeps the
  carried linearization.
- ``precond_reuse=True`` under both schedules and
  ``ndchol_factorize(blocked=True)`` against the JAX package.
- ``ParametricSolver.cached`` and a solve with another graph's runtime state;
  ``multiproc`` on one device; the ``solveGraphParametric`` alias.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.solvers import linearize as JL  # noqa: E402
from rome_tpu.solvers.sparse import (  # noqa: E402
    ndchol_assemble as j_assemble,
    ndchol_factorize as j_factorize,
    ndchol_solve as j_solve,
    symbolic_factor as j_symbolic,
)
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from rome_tpu_torch.solvers import gauss_newton as GN  # noqa: E402
from rome_tpu_torch.solvers.gauss_newton import ParametricSolver  # noqa: E402
from rome_tpu_torch.solvers.linearize import runtime_state  # noqa: E402
from rome_tpu_torch.solvers.sparse import (  # noqa: E402
    ndchol_assemble,
    ndchol_factorize,
    ndchol_solve,
    symbolic_factor,
)
from test_torch_helpers import grid_graph, reordered_graph  # noqa: E402
from test_torch_slice import NDCHOL_OPTS, _assert_same_solve, _coords  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}


def _solve_both(linear, dtype="float32", schedule="host", **extra):
    jdt, tdt = DTYPES[dtype]
    opts = dict(NDCHOL_OPTS, linear=linear, **extra)
    with jax.enable_x64():
        fg_j = grid_graph(R, 6, 6, seed=3)
        res_j = R.solve_graph_parametric(
            fg_j, init=False, options=R.GNOptions(**opts), chordal_init=True,
            schedule=schedule, dtype=jdt,
        )
    fg_t = grid_graph(T, 6, 6, seed=3)
    res_t = T.solve_graph_parametric(
        fg_t, init=False, options=T.GNOptions(**opts), chordal_init=True,
        schedule=schedule, dtype=tdt, device="cpu",
    )
    assert res_t["linear_solver"] == res_j["linear_solver"]
    return res_j, fg_j, res_t, fg_t


@pytest.mark.parametrize("linear,dtype", [
    ("dense32", "float32"), ("dense32", "float64"), ("pcg", "float64"),
    ("mixed", "float64"), ("pcg", "float32"), ("mixed", "float32"),
])
def test_linear_solver_matches_jax_on_grid(linear, dtype):
    res_j, fg_j, res_t, fg_t = _solve_both(linear, dtype)
    if linear != "dense32" and dtype == "float32":
        sj, st = res_j["stats"], res_t["stats"]
        assert st.converged and sj.converged and st.reason == sj.reason
        assert abs(st.final_cost - sj.final_cost) <= 1e-6 * max(1.0, sj.final_cost)
        np.testing.assert_allclose(_coords(fg_t), _coords(fg_j), rtol=0, atol=1e-4)
    else:
        _assert_same_solve(res_j, fg_j, res_t, fg_t)
    if linear == "dense32":
        # every step went through the factor-preconditioned CG
        assert all(h["cg"] >= 1 for h in res_t["stats"].history)


def _square_graph():
    """testParametric.jl:18-41: prior at (10, 10, -pi + 1e-5) and four
    odometry legs of (10, 0, pi/2) driving a square."""
    fg = T.FactorGraph()
    fg.add_variable("x0", T.Pose2)
    fg.add_factor(["x0"], T.PriorPose2(T.MvNormal([10, 10, -np.pi + 1e-5], [0.1, 0.1, 0.05])))
    for i in range(4):
        fg.add_variable(f"x{i+1}", T.Pose2)
        fg.add_factor([f"x{i}", f"x{i+1}"],
                      T.Pose2Pose2(T.MvNormal([10.0, 0, np.pi / 2], [0.1, 0.1, 0.1])))
    return fg


def test_pcg_solves_the_square():
    fg = _square_graph()
    res = T.solve_graph_parametric(fg, options=T.GNOptions(linear="pcg"), device="cpu")
    assert res["stats"].converged and res["linear_solver"] == "pcg"
    expected = {"x0": [10, 10, -np.pi], "x1": [0, 10, -np.pi / 2], "x2": [0, 0, 0],
                "x3": [10, 0, np.pi / 2], "x4": [10, 10, -np.pi]}
    for lbl, exp in expected.items():
        got = fg.get_coords(lbl)
        np.testing.assert_allclose(got[:2], exp[:2], atol=1e-3)
        assert abs((got[2] - exp[2] + np.pi) % (2 * np.pi) - np.pi) < 1e-3, (lbl, got)


def test_auto_picks_dense_below_and_dense32_above_the_threshold():
    ga = lower(grid_graph(T, 3, 3), device="cpu")
    assert ParametricSolver(ga, T.GNOptions()).linear == "dense"
    solver = ParametricSolver(ga, T.GNOptions(dense_threshold=10))
    assert solver.linear == "dense32" and solver._use64
    _values, stats = solver.solve()
    assert stats.converged and stats.linear == "dense32"
    with pytest.raises(ValueError, match="unknown linear solver"):
        ParametricSolver(ga, T.GNOptions(linear="cholmod"))


def test_speculative_ndchol_matches_jax_fused_schedule():
    res_j, fg_j, res_t, fg_t = _solve_both("ndchol", schedule="fused")
    _assert_same_solve(res_j, fg_j, res_t, fg_t)
    # the carried f64 cost, as the JAX package's fused loop returns it
    assert abs(res_t["stats"].final_cost - res_j["stats"].final_cost) <= 1e-9


def test_speculative_and_host_schedules_agree():
    out = {}
    for schedule in ("fused", "host"):
        fg = grid_graph(T, 6, 6, seed=3)
        res = T.solve_graph_parametric(
            fg, init=False, options=T.GNOptions(linear="ndchol", **NDCHOL_OPTS),
            chordal_init=True, schedule=schedule, device="cpu",
        )
        out[schedule] = (res["stats"], _coords(fg))
    (sf, cf), (sh, ch) = out["fused"], out["host"]
    assert sf.converged and sh.converged
    assert sf.iterations == sh.iterations and sf.reason == sh.reason
    assert [h["cg"] for h in sf.history] == [h["cg"] for h in sh.history]
    np.testing.assert_allclose(cf, ch, rtol=0, atol=1e-9)


def test_speculative_loop_linearizes_once_per_iteration_and_skips_cost_passes(monkeypatch):
    ga = lower(grid_graph(T, 6, 6, seed=3), device="cpu")
    solver = ParametricSolver(ga, T.GNOptions(linear="ndchol", **NDCHOL_OPTS))
    counts = {"linearize": 0, "cost_at": 0}
    lin, cost = solver._linearize, GN.cost_at

    def counted_lin(*a):
        counts["linearize"] += 1
        return lin(*a)

    def counted_cost(*a, **k):
        counts["cost_at"] += 1
        return cost(*a, **k)

    monkeypatch.setattr(solver, "_linearize", counted_lin)
    monkeypatch.setattr(GN, "cost_at", counted_cost)
    _values, stats = solver.solve()
    assert stats.converged
    assert counts == {"linearize": stats.iterations + 1, "cost_at": 0}
    # the two normal-equation workspaces alternate, made once per solver
    assert solver._ws is not solver._ws_trial


def test_rejected_speculative_step_keeps_the_carried_linearization():
    """A NaN step is rejected; the next linear solve gets the linearization
    of the point before the trial (its residuals and Jacobians bit-equal),
    although the trial was linearized in between."""
    ga = lower(grid_graph(T, 4, 4, seed=6), device="cpu")
    solver = ParametricSolver(ga, T.GNOptions(linear="ndchol", **NDCHOL_OPTS))
    assert solver._mixed_j and solver._speculative
    real = solver._solve_ndchol
    seen = []

    def flaky(lins, lam, rt, parts, pstate, **kw):
        got = [t.clone() for _b, r0, Js, _v in lins for t in (r0,) + tuple(Js)]
        delta, g, exact, extras = real(lins, lam, rt, parts, pstate, **kw)
        # the entry vector once the solve has filled in the generic batches
        seen.append(got + [parts.vals.clone()])
        if len(seen) == 2:
            delta = {t: torch.full_like(d, float("nan")) for t, d in delta.items()}
        return delta, g, exact, extras

    solver._solve_ndchol = flaky
    _values, stats = solver.solve()
    assert stats.converged
    assert stats.history[1]["accepted"] is False
    assert stats.history[1]["lam"] > stats.history[0]["lam"]
    assert stats.history[2]["cost0"] == stats.history[1]["cost0"]
    assert all(torch.equal(a, b) for a, b in zip(seen[1], seen[2]))
    assert not all(torch.equal(a, b) for a, b in zip(seen[2], seen[3]))


@pytest.mark.parametrize("schedule", ["host", "fused"])
def test_precond_reuse_matches_jax(schedule):
    res_j, fg_j, res_t, fg_t = _solve_both("ndchol", schedule=schedule, precond_reuse=True)
    _assert_same_solve(res_j, fg_j, res_t, fg_t)
    cg_j = [h["cg"] for h in res_j["stats"].history]
    assert [h["cg"] for h in res_t["stats"].history] == cg_j
    # some iteration reused the factorization: its CG ran past the fresh
    # factor's 2 iterations
    assert max(cg_j) > 2


def test_blocked_factorization_matches_jax():
    """Fronts above 32 columns take the recursive blocked Cholesky and
    triangular inverse; the solve matches the JAX package's blocked
    factorization and the native one at f64 accuracy."""
    lam = 1e-4
    with jax.enable_x64():
        ga = jax_lower(grid_graph(R, 12, 12, seed=1), dtype=jnp.float64)
        dofs = {t: ga.manifolds[t].dof for t in ga.type_names}
        specs = [(b.vtypes, np.asarray(b.vslots)) for b in ga.batches]
        sym_j = j_symbolic(ga.type_names, ga.counts, dofs, specs, leaf=16)
        rt = JL.runtime_state(ga)
        lins = JL.linearize_all(ga, ga.values0, rt)
        arrs_j = sym_j.device_arrs()
        vals = JL.normal_eq_entry_values(ga, lins, dtype=jnp.float64)
        fvec = JL.free_vector(ga, rt).astype(jnp.float64)
        diag_H = jnp.zeros(sym_j.D, jnp.float64).at[arrs_j["diag_dst"]].add(
            vals[arrs_j["diag_src"]] * fvec[arrs_j["diag_dst"]] ** 2)
        df = fvec / jnp.sqrt(jnp.maximum(diag_H * (1.0 + lam), 1e-12))
        diag_add = fvec * (lam / (1.0 + lam)) + (1.0 - fvec)
        b = jnp.asarray(np.random.default_rng(0).normal(size=sym_j.D))

        def run(vals, df, diag_add, b, arrs):
            Ws = j_assemble(sym_j, arrs, vals, df, diag_add)
            Linvs, L21s, _ = j_factorize(sym_j, arrs, Ws, blocked=True)
            return j_solve(sym_j, arrs, Linvs, L21s, b)

        x_jax = np.asarray(jax.jit(run)(vals, df, diag_add, b, arrs_j))
    sym = symbolic_factor(ga.type_names, ga.counts, dofs, specs, leaf=16)
    assert max(sm for n, sm, bm in sym.plan if n) > 32
    arrs = sym.device_arrs("cpu")
    t = [torch.tensor(np.asarray(v)) for v in (vals, df, diag_add, b)]
    x = {}
    for blocked in (True, False):
        Ws = ndchol_assemble(sym, arrs, t[0], t[1], t[2])
        Linvs, L21s, _ = ndchol_factorize(sym, arrs, Ws, blocked=blocked)
        x[blocked] = ndchol_solve(sym, arrs, Linvs, L21s, t[3]).numpy()
    np.testing.assert_allclose(x[True], x_jax, rtol=0, atol=1e-9)
    np.testing.assert_allclose(x[True], x[False], rtol=0, atol=1e-9)


@pytest.mark.parametrize("linear", ["ndchol", "dense32"])
def test_cached_solver_serves_another_graph(linear):
    # the store clears whole when full: start it empty, whatever ran before
    GN._SOLVER_CACHE.clear()
    opts = T.GNOptions(linear=linear, **NDCHOL_OPTS)
    ga_a = lower(grid_graph(T, 6, 6, seed=3), device="cpu")
    solver = ParametricSolver.cached(ga_a, opts)
    assert ParametricSolver.cached(ga_a, T.GNOptions(linear=linear, **NDCHOL_OPTS)) is solver
    assert ParametricSolver.cached(ga_a, T.GNOptions(linear=linear, max_iters=7)) is not solver
    for order in (range(36), range(35, -1, -1)):
        fg_b = grid_graph(T, 6, 6, seed=8)
        if order[0]:  # the same factors over variables created in reverse
            fg_b = reordered_graph(T, fg_b, list(order))
        ga_b = lower(fg_b, device="cpu")
        assert ParametricSolver.cached(ga_b, opts) is solver
        rt_b = runtime_state(ga_b)
        if linear == "ndchol":
            other_plan = solver.plans(rt_b)["ndchol"][0] is not solver.plans()["ndchol"][0]
            assert other_plan == bool(order[0])
        v_c, st_c = solver.solve(ga_b.values0, rt=rt_b)
        v_f, st_f = ParametricSolver(ga_b, opts).solve()
        assert st_c.converged and st_c.history == st_f.history
        assert torch.equal(v_c["Pose2"], v_f["Pose2"])


def test_multiproc_on_one_device_solves_as_usual():
    out = []
    for multiproc in (False, True):
        fg = grid_graph(T, 4, 4, seed=2)
        fg.params.multiproc = multiproc
        res = T.solve_graph_parametric(fg, init=False, device="cpu")
        out.append((res["stats"], _coords(fg)))
    assert out[0][0].converged and out[0][0].history == out[1][0].history
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert T.solveGraphParametric is T.solve_graph_parametric
