"""The port's default nonparametric solve, ``solve_graph_nonparametric(fg)``
(``engine="batched", init=True``: the particle graph init, three
Gauss-Seidel passes and the Jacobi sweeps), against the JAX package's, at
small sizes (honeycomb-7, N = 30).

- An ``init=True`` solve of honeycomb-7 passes the 4 m landmark and pose
  gates (tools/bench_multimodal.py:154-196) in both packages.
- A grown graph re-solves from the beliefs it holds: only the new variables
  take the particle init.
- A graph with a multihypo factor solves with ``init=True`` through the
  fallback splice, every belief finite.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu_torch as T  # noqa: E402
from rome_tpu.canonical.patterns import generate_graph_honeycomb as jax_honeycomb  # noqa: E402
from rome_tpu.solvers.multimodal import solve_graph_nonparametric as jax_nonparametric  # noqa: E402
from rome_tpu_torch.canonical import generate_graph_honeycomb  # noqa: E402
from rome_tpu_torch.solvers.multimodal import batched as TB  # noqa: E402
from rome_tpu_torch.solvers.multimodal import solve as TS  # noqa: E402

N = 30
GATE_M = 4.0


def _truth(poses):
    """The port's parametric optimum of honeycomb-``poses``."""
    fp = generate_graph_honeycomb(pose_count_target=poses, graphinit=True)
    fp.init_all()
    T.solve_graph_parametric(fp, init=False, device="cpu")
    return {l: fp.get_coords(l, "parametric") for l in fp._var_order}


def _errors(fg, truth, pattern):
    return [np.linalg.norm(np.asarray(fg.variables[l].beliefs["default"])[:, :2].mean(0)
                           - truth[l][:2]) for l in fg.ls(pattern)]


def test_default_solve_passes_the_gates_in_both_packages():
    truth = _truth(7)
    fj = jax_honeycomb(pose_count_target=7, graphinit=True)
    jax_nonparametric(fj, sweeps=3, N=N, key=jax.random.PRNGKey(3))
    ft = generate_graph_honeycomb(pose_count_target=7, graphinit=True)
    T.solve_graph_nonparametric(ft, sweeps=3, N=N, seed=3, device="cpu")
    for fg in (fj, ft):
        assert np.mean(_errors(fg, truth, r"^l\d+$")) < GATE_M
        assert np.mean(_errors(fg, truth, r"^x\d+$")) < GATE_M
        for l in fg._var_order:
            bel = np.asarray(fg.variables[l].beliefs["default"])
            assert bel.shape == (N, fg.variables[l].vtype.point_dim) and np.isfinite(bel).all()
            assert np.isfinite(fg.get_point(l, "default")).all()


def test_default_solve_regrows():
    """A grown graph re-solves from the beliefs it already holds: only the
    new variables take the particle init."""
    ft = generate_graph_honeycomb(pose_count_target=3, graphinit=True)
    T.solve_graph_nonparametric(ft, sweeps=1, N=N, seed=1, device="cpu")
    x1 = np.array(ft.variables["x1"].beliefs["default"])
    generate_graph_honeycomb(pose_count_target=5, fg=ft, graphinit=True)
    inits = []
    orig = TS.approx_conv

    def spy(fg, flabel, target, *a, **kw):
        inits.append(target)
        return orig(fg, flabel, target, *a, **kw)

    TS.approx_conv = spy
    try:
        TS.init_all_beliefs(copy.deepcopy(ft), N=N, device="cpu")
    finally:
        TS.approx_conv = orig
    assert inits and "x1" not in inits and "x5" in inits
    T.solve_graph_nonparametric(ft, sweeps=1, N=N, seed=2, device="cpu")
    assert not np.array_equal(ft.variables["x1"].beliefs["default"], x1)
    assert np.mean(_errors(ft, _truth(5), r"^x\d+$")) < GATE_M


def test_multihypo_graph_solves_through_the_fallback():
    fg = T.canonical.generate_graph_hexagonal(N=N)
    fg.add_variable("l2", T.Point2)
    fg.add_factor(["l2"], T.PriorPoint2(T.MvNormal([20.0, 4.0], [0.5, 0.5])))
    fg.add_factor(["x3", "l1", "l2"],
                  T.Pose2Point2BearingRange(T.Normal(np.pi, 0.05), T.Normal(20.0, 0.5)),
                  multihypo=[1.0, 0.5, 0.5])
    solver = TB.BatchedNonparametricSolver(fg, "default", N=N, device="cpu")
    assert [f for f, *_ in solver.bp.fallback] == [fg._fct_order[-1]] * 3
    T.solve_graph_nonparametric(fg, sweeps=2, N=N, seed=4, device="cpu")
    for l in fg._var_order:
        assert np.isfinite(fg.variables[l].beliefs["default"]).all()
    assert np.linalg.norm(fg.get_point("l1", "default") - [20.0, 0.0]) < 4.0
