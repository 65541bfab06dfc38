"""The port's batch SE(2) solve against the JAX package, end to end.

- Chordal initialization on the same lowered arrays: 36 poses (dense
  branch) and 324 poses (sparse nested-dissection branch, >= 300 poses).
  Both sides solve the same f64 systems with an f32 preconditioner and a CG
  stopped at 1e-7 relative residual, so they agree to about that relative
  precision; poses are compared at atol 1e-4 m / rad.
- solve_graph_parametric with linear="ndchol" and the options of
  tests/test_ndchol.py:176-180 on the 6x6 grid (seed 3), against the JAX
  package's host-scheduled loop: same iteration count, final cost within
  1e-6 relative, poses at atol 1e-4 (tests/test_ndchol.py:189-197).
- The same for the octagon ring (no prior: gauge freeze) with bench.py:78's
  ``dense`` options.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.solvers.init2d import chordal_init_pose2 as jax_chordal  # noqa: E402
from rome_tpu_torch.graph.lower import lower  # noqa: E402
from rome_tpu_torch.solvers.gauss_newton import ParametricSolver  # noqa: E402
from rome_tpu_torch.solvers.init2d import chordal_init_pose2  # noqa: E402
from test_torch_helpers import grid_graph, octagon_file, port_arrays  # noqa: E402

NDCHOL_OPTS = dict(
    max_iters=30, polish_tol=1e-8, polish_iters=40, lam0=1e-6,
    lam_down=0.1, lam_min=1e-12, chol_jitter=1e-7, ftol=1e-12,
    gtol=1e-10, nd_leaf=4,
)
DENSE_OPTS = dict(max_iters=50, linear="dense", lam0=1e-4, ftol=1e-10)


@pytest.mark.parametrize("side,frozen", [(6, ()), (6, ("x7",)), (18, ()), (18, ("x100",))])
def test_chordal_init_matches_jax(side, frozen):
    with jax.enable_x64():
        ga = jax_lower(grid_graph(R, side, side, seed=4, frozen=frozen))
        # start far from the answer so the init has real work to do
        rng = np.random.default_rng(5)
        v0 = np.asarray(ga.values0["Pose2"]) + rng.normal(0, 0.3, (side * side, 3))
        v0 = v0.astype(np.float32)
        want = np.asarray(jax_chordal(ga, {"Pose2": jnp.asarray(v0)})["Pose2"])
    tg = port_arrays(ga)
    got = chordal_init_pose2(tg, {"Pose2": torch.as_tensor(v0)})["Pose2"]
    assert got.dtype == torch.float32 and got.shape == (side * side, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # frozen poses stay bit-identical
    for lbl in frozen:
        s = tg.var_labels["Pose2"].index(lbl)
        np.testing.assert_array_equal(got[s].numpy(), v0[s])
    if not frozen:
        # the init lands near the grid's optimum (unit steps from the prior)
        assert np.abs(got[1, :2].numpy() - [1.0, 0.0]).max() < 0.2


def _coords(fg):
    return np.stack([fg.get_coords(l) for l in fg.ls()])


def _assert_same_solve(res_j, fg_j, res_t, fg_t, atol=1e-4):
    sj, st = res_j["stats"], res_t["stats"]
    assert st.converged and sj.converged
    assert st.iterations == sj.iterations
    assert st.reason == sj.reason
    assert abs(st.final_cost - sj.final_cost) <= 1e-6 * max(1.0, abs(sj.final_cost))
    assert fg_t.ls() == fg_j.ls()
    np.testing.assert_allclose(_coords(fg_t), _coords(fg_j), rtol=0, atol=atol)


def test_ndchol_solve_matches_jax_on_grid():
    with jax.enable_x64():
        fg_j = grid_graph(R, 6, 6, seed=3)
        res_j = R.solve_graph_parametric(
            fg_j, init=False, options=R.GNOptions(linear="ndchol", **NDCHOL_OPTS),
            chordal_init=True, schedule="host",
        )
    fg_t = grid_graph(T, 6, 6, seed=3)
    res_t = T.solve_graph_parametric(
        fg_t, init=False, options=T.GNOptions(linear="ndchol", **NDCHOL_OPTS),
        chordal_init=True, schedule="host", device="cpu",
    )
    assert res_t["linear_solver"] == "ndchol"
    _assert_same_solve(res_j, fg_j, res_t, fg_t)
    # every accepted step went through the f64 CG polish
    assert all(h["cg"] >= 1 for h in res_t["stats"].history)


def test_dense_solve_matches_jax_on_octagon(tmp_path):
    path = octagon_file(tmp_path)
    with jax.enable_x64():
        fg_j = R.load_g2o(None, path)
        res_j = R.solve_graph_parametric(
            fg_j, options=R.GNOptions(**DENSE_OPTS), chordal_init=True, schedule="host",
        )
    fg_t = T.load_g2o(None, path)
    res_t = T.solve_graph_parametric(
        fg_t, options=T.GNOptions(**DENSE_OPTS), chordal_init=True, device="cpu",
    )
    assert res_t["gauge_frozen"] == res_j["gauge_frozen"] == "x0"
    assert res_t["linear_solver"] == "dense"
    _assert_same_solve(res_j, fg_j, res_t, fg_t)
    # ring geometry: radius 0.5 / sin(pi/8)
    c0, c4 = fg_t.get_coords("x0"), fg_t.get_coords("x4")
    np.testing.assert_allclose(np.linalg.norm(c4[:2] - c0[:2]), 1.0 / np.sin(np.pi / 8), rtol=1e-3)


def test_lm_rejects_nan_step_and_recovers():
    """A linear solve that returns a non-finite step is rejected like any
    bad step (lam grows) and the solve still converges."""
    fg = grid_graph(T, 4, 4, seed=6)
    ga = lower(fg, device="cpu")
    solver = ParametricSolver(ga, T.GNOptions(linear="ndchol", **NDCHOL_OPTS))
    real = solver._solve_ndchol
    calls = {"n": 0}

    def flaky(lins, lam, rt, parts, pstate, **kw):
        calls["n"] += 1
        delta, g, exact, extras = real(lins, lam, rt, parts, pstate, **kw)
        if calls["n"] == 2:
            delta = {t: torch.full_like(d, float("nan")) for t, d in delta.items()}
        return delta, g, exact, extras

    solver._solve_ndchol = flaky
    _values, stats = solver.solve()
    assert stats.converged
    assert stats.history[1]["accepted"] is False
    assert stats.history[1]["lam"] > stats.history[0]["lam"]
