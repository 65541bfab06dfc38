"""Marginal covariances of the port against the JAX package.

- ``ndchol_takahashi`` (the selected inverse on the filled pattern) against
  the JAX function on the same fronts and against the dense inverse of the
  scaled system, atol 1e-8 (tests/test_ndchol.py:148-168), on the 5x5 grid.
- ``marginal_covariances`` by the dense inverse and by Takahashi against the
  JAX package at atol 1e-8 on the 5x5 grid (float64) and on the Pose2 +
  Point2 bearing-range graph of tests/test_ndchol.py:218; "auto" picks dense
  at this size.
- The vectorized Takahashi gather equals the loop of the JAX package
  (``rome_tpu/solvers/gauss_newton.py:1577-1611``, kept here as the
  reference), and the Takahashi plan follows the connectivity of the rt it
  is given.
- ``solve_graph_parametric(compute_covariances=True)``: the covariance
  fusion fixture of tests/test_parametric.py:60-73 (0.05 I at atol 1e-4) and
  per-label blocks of a grid solve against the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.solvers import gauss_newton as JGN  # noqa: E402
from rome_tpu.solvers import linearize as JL  # noqa: E402
from rome_tpu.solvers.sparse import (  # noqa: E402
    ndchol_assemble as j_assemble,
    ndchol_factorize as j_factorize,
    ndchol_takahashi as j_takahashi,
    symbolic_factor as j_symbolic,
)
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from rome_tpu_torch.solvers import gauss_newton as GN  # noqa: E402
from rome_tpu_torch.solvers.linearize import runtime_state, tangent_offsets  # noqa: E402
from rome_tpu_torch.solvers.sparse import (  # noqa: E402
    ndchol_assemble,
    ndchol_factorize,
    ndchol_takahashi,
    symbolic_factor,
)
from test_torch_helpers import grid_graph, port_arrays, reordered_graph  # noqa: E402


def landmark_graph(mod):
    """tests/test_ndchol.py:218's bearing-range graph: 40 Pose2 in a chain,
    8 Point2 landmarks sighted from every third pose."""
    rng = np.random.default_rng(9)
    fg = mod.FactorGraph()
    n = 40
    for i in range(n):
        fg.add_variable(f"x{i}", mod.Pose2)
    for j in range(8):
        fg.add_variable(f"l{j}", mod.Point2)
    fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    for i in range(n - 1):
        fg.add_factor([f"x{i}", f"x{i+1}"], mod.Pose2Pose2(
            mod.MvNormal([1, 0, rng.normal(0, 0.05)], [0.1, 0.1, 0.05])))
    for i in range(0, n, 3):
        fg.add_factor([f"x{i}", f"l{(i // 3) % 8}"], mod.Pose2Point2BearingRange(
            mod.Normal(rng.uniform(-1, 1), 0.05), mod.Normal(5.0, 0.3)))
    fg.init_all()
    return fg


GRAPHS = {"grid5": lambda mod: grid_graph(mod, 5, 5, seed=2), "landmarks": landmark_graph}


def test_takahashi_matches_jax_and_the_dense_inverse():
    lam = 1e-4
    with jax.enable_x64():
        ga = jax_lower(grid_graph(R, 5, 5), dtype=jnp.float64)
        dofs = {t: ga.manifolds[t].dof for t in ga.type_names}
        specs = [(b.vtypes, np.asarray(b.vslots)) for b in ga.batches]
        sym_j = j_symbolic(ga.type_names, ga.counts, dofs, specs, leaf=4)
        rt = JL.runtime_state(ga)
        lins = JL.linearize_all(ga, ga.values0, rt)
        arrs_j = sym_j.device_arrs()
        vals = JL.normal_eq_entry_values(ga, lins, dtype=jnp.float64)
        fvec = JL.free_vector(ga, rt).astype(jnp.float64)
        diag_H = jnp.zeros(sym_j.D, jnp.float64).at[arrs_j["diag_dst"]].add(
            vals[arrs_j["diag_src"]] * fvec[arrs_j["diag_dst"]] ** 2)
        df = fvec / jnp.sqrt(jnp.maximum(diag_H * (1.0 + lam), 1e-12))
        diag_add = fvec * (lam / (1.0 + lam)) + (1.0 - fvec)
        H, _g = JL.dense_normal_eqs(ga, lins, dtype=jnp.float64, rt=rt)
        Hd = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-8))
        d = 1.0 / jnp.sqrt(jnp.maximum(jnp.diag(Hd), 1e-12))
        Hinv = np.linalg.inv(np.asarray(Hd * d[:, None] * d[None, :]))

        def run(vals, df, diag_add, arrs):
            Ws = j_assemble(sym_j, arrs, vals, df, diag_add)
            Linvs, L21s, _ = j_factorize(sym_j, arrs, Ws)
            return j_takahashi(sym_j, arrs, Linvs, L21s)

        Xs_jax = [None if X is None else np.asarray(X)
                  for X in jax.jit(run)(vals, df, diag_add, arrs_j)]
    sym = symbolic_factor(ga.type_names, ga.counts, dofs, specs, leaf=4)
    arrs = sym.device_arrs("cpu")
    Ws = ndchol_assemble(sym, arrs, *(torch.tensor(np.asarray(v)) for v in (vals, df, diag_add)))
    Linvs, L21s, _ = ndchol_factorize(sym, arrs, Ws)
    Xs = ndchol_takahashi(sym, arrs, Linvs, L21s)
    checked = 0
    for lvl, (n_l, sm, bm) in enumerate(sym.plan):
        if n_l == 0:
            assert Xs[lvl] is None
            continue
        X = Xs[lvl].numpy()
        np.testing.assert_allclose(X, Xs_jax[lvl], rtol=0, atol=1e-8)
        sup_idx = np.asarray(sym.arrs[f"sup_idx_{lvl}"])
        for j in range(n_l):
            real = sup_idx[j] < sym.D
            ridx = sup_idx[j][real]
            blk = X[j][: sm, : sm][real][:, real]
            np.testing.assert_allclose(blk, Hinv[np.ix_(ridx, ridx)], rtol=0, atol=1e-8)
            checked += len(ridx)
    assert checked == sym.D


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("method", ["dense", "takahashi"])
def test_marginal_covariances_match_jax(graph, method):
    with jax.enable_x64():
        ga = jax_lower(GRAPHS[graph](R), dtype=jnp.float64)
        # jitted: the JAX package's eager dispatch is slow on the CPU
        want = {t: np.asarray(v) for t, v in jax.jit(
            lambda v: JGN.marginal_covariances(ga, v, method=method))(ga.values0).items()}
    tg = port_arrays(ga)
    got = GN.marginal_covariances(tg, tg.values0, method=method)
    assert sorted(got) == sorted(want)
    for t in want:
        assert got[t].dtype == torch.float64 and got[t].shape == want[t].shape
        np.testing.assert_allclose(got[t].numpy(), want[t], rtol=0, atol=1e-8)
    if method == "dense":
        auto = GN.marginal_covariances(tg, tg.values0)  # 75 / 136 dof: dense
        assert all(torch.equal(auto[t], got[t]) for t in got)
    else:
        with pytest.raises(ValueError, match="unknown covariance method"):
            GN.marginal_covariances(tg, tg.values0, method="cholmod")


def _loop_gather(sym, base, n, d):
    """The JAX package's host loop (gauss_newton.py:1577-1611) that maps each
    variable's d x d block into its level's flattened X fronts."""
    scal = base + np.arange(n * d).reshape(n, d)
    gidx = np.zeros((n, d, d), np.int64)
    glev = np.zeros((n,), np.int64)
    for l in range(sym.nlev):
        n_l, sm, bm = sym.plan[l]
        if n_l == 0:
            continue
        sup_idx = np.asarray(sym.arrs[f"sup_idx_{l}"])
        pos = {}
        for j in range(n_l):
            for a in range(sm):
                s = sup_idx[j, a]
                if s < sym.D:
                    pos[int(s)] = (j, a)
        f = sm + bm
        for i in range(n):
            s0 = int(scal[i, 0])
            if s0 in pos:
                j, _a = pos[s0]
                offs = np.array([pos[int(scal[i, k])][1] for k in range(d)])
                assert (np.array([pos[int(scal[i, k])][0] for k in range(d)]) == j).all()
                gidx[i] = j * f * f + offs[:, None] * f + offs[None, :]
                glev[i] = l
    return scal, gidx, glev


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_vectorized_takahashi_gather_equals_the_loop(graph):
    tg = lower(GRAPHS[graph](T), dtype=torch.float64, device="cpu")
    dofs = {t: tg.manifolds[t].dof for t in tg.type_names}
    specs = [(b.vtypes, b.vslots.numpy()) for b in tg.batches]
    sym = symbolic_factor(tg.type_names, tg.counts, dofs, specs)
    locations = GN._takahashi_locations(sym)
    base, _D = tangent_offsets(tg)
    for t in tg.type_names:
        scal, gidx, glev = _loop_gather(sym, base[t], tg.counts[t], dofs[t])
        got_idx, got_lev = GN._takahashi_gather(sym, locations, scal)
        assert got_idx.dtype == gidx.dtype and got_lev.dtype == glev.dtype
        np.testing.assert_array_equal(got_idx, gidx)
        np.testing.assert_array_equal(got_lev, glev)


def test_takahashi_plan_follows_the_rt_connectivity():
    """One GraphArrays, another graph's rt (the same factors over variables
    created in reverse, so other slots): the covariances are those of the
    other graph, not of a plan cached for the first."""
    ga_a = lower(grid_graph(T, 5, 5, seed=2), dtype=torch.float64, device="cpu")
    fg_b = reordered_graph(T, grid_graph(T, 5, 5, seed=2), range(24, -1, -1))
    ga_b = lower(fg_b, dtype=torch.float64, device="cpu")
    GN.marginal_covariances(ga_a, ga_a.values0, method="takahashi")  # caches ga_a's plan
    got = GN.marginal_covariances(ga_a, ga_b.values0, rt=runtime_state(ga_b),
                                  method="takahashi")
    want = GN.marginal_covariances(ga_b, ga_b.values0, method="takahashi")
    np.testing.assert_allclose(got["Pose2"].numpy(), want["Pose2"].numpy(), rtol=0, atol=1e-12)
    # and the dense inverse within the ridges' difference (1e-8 relative
    # against 1e-8 absolute), as tests/test_ndchol.py:200-215 holds it
    dense = GN.marginal_covariances(ga_b, ga_b.values0, method="dense")
    np.testing.assert_allclose(got["Pose2"].numpy(), dense["Pose2"].numpy(), rtol=0, atol=1e-6)


def test_covariance_fusion_fixture():
    """testParametricCovariances.jl:33-55: two PriorPoint2 beliefs fuse to the
    precision-weighted mean (1.05, 0) with covariance 0.05 I."""
    fg = T.FactorGraph()
    fg.add_variable("x0", T.Point2)
    fg.add_factor(["x0"], T.PriorPoint2(T.MvNormal([1.0, 0.0], np.diag([0.1, 0.1]))))
    fg.add_factor(["x0"], T.PriorPoint2(T.MvNormal([1.1, 0.0], np.diag([0.1, 0.1]))))
    res = T.solve_graph_parametric(fg, compute_covariances=True, device="cpu")
    np.testing.assert_allclose(fg.get_coords("x0"), [1.05, 0.0], atol=1e-4)
    np.testing.assert_allclose(res["covariances"]["x0"], 0.05 * np.eye(2), atol=1e-4)


def test_solve_with_covariances_matches_jax_per_label():
    opts = dict(linear="ndchol", max_iters=30, polish_tol=1e-8, lam0=1e-6, lam_down=0.1,
                chol_jitter=1e-7, ftol=1e-12, gtol=1e-10, nd_leaf=4)
    with jax.enable_x64():
        res_j = R.solve_graph_parametric(grid_graph(R, 5, 5, seed=2), init=False,
                                         options=R.GNOptions(**opts), compute_covariances=True)
    res_t = T.solve_graph_parametric(grid_graph(T, 5, 5, seed=2), init=False,
                                     options=T.GNOptions(**opts), compute_covariances=True,
                                     device="cpu")
    cj, ct = res_j["covariances"], res_t["covariances"]
    assert sorted(ct) == sorted(cj) and len(ct) == 25
    for lbl in cj:
        assert ct[lbl].shape == (3, 3) and ct[lbl].dtype == np.float64
        np.testing.assert_allclose(ct[lbl], ct[lbl].T, rtol=0, atol=1e-9)
        np.testing.assert_allclose(ct[lbl], cj[lbl], rtol=1e-4, atol=1e-9)
    assert np.all(np.linalg.eigvalsh(ct["x24"]) > 0)
