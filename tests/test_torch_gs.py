"""The port's default nonparametric engine against the JAX package's: the
particle graph init, the Gauss-Seidel (GS) passes and the per-factor
fallback, at small sizes (beehive-10, honeycomb-7, N = 30).

- ``_build_gs_routing`` is exactly equal to the JAX one on beehive-10
  (order, S, src_of, row_of, up_of); with fallback factors (multihypo, a
  non-Gaussian measurement) the propagator's fallback routing is equal and
  both packages decline the GS pass.
- ``init_all_beliefs`` visits the same (factor, variable) pairs in the same
  order as the JAX traversal.
- Seeded at the parametric optimum, forward + reverse GS passes keep the
  mean pose error below 1.0 m (tests/test_gs_sweep.py:50-76's gate).
- From identical particles, the port's GS passes and the JAX ``gs_pass``
  agree by mean symmetric k-NN KL < 1.0, and keep honeycomb-7's mean pose
  error below 1.0 m.

The whole ``init=True`` solve is held in tests/test_torch_default_solve.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.canonical.patterns import generate_graph_beehive as jax_beehive  # noqa: E402
from rome_tpu.canonical.patterns import generate_graph_honeycomb as jax_honeycomb  # noqa: E402
from rome_tpu.solvers.multimodal import batched as JB  # noqa: E402
from rome_tpu.solvers.multimodal import solve as JS  # noqa: E402
from rome_tpu_torch.canonical import generate_graph_beehive, generate_graph_honeycomb  # noqa: E402
from rome_tpu_torch.graph.convert import beliefs_from_numpy  # noqa: E402
from rome_tpu_torch.manifolds.base import SE2_, T2  # noqa: E402
from rome_tpu_torch.solvers.multimodal import batched as TB  # noqa: E402
from rome_tpu_torch.solvers.multimodal import solve as TS  # noqa: E402
from rome_tpu_torch.solvers.multimodal.metrics import symmetric_kl_knn  # noqa: E402

N = 30
GATE_M, KL_GATE = 4.0, 1.0


def _honeycomb(gen):
    return gen(pose_count_target=7, graphinit=True)


@pytest.fixture(scope="module")
def truth():
    """The port's parametric optimum of honeycomb-7."""
    fp = _honeycomb(generate_graph_honeycomb)
    fp.init_all()
    T.solve_graph_parametric(fp, init=False, device="cpu")
    return {l: fp.get_coords(l, "parametric") for l in fp._var_order}


def _errors(fg, truth, pattern):
    return [np.linalg.norm(np.asarray(fg.variables[l].beliefs["default"])[:, :2].mean(0)
                           - truth[l][:2]) for l in fg.ls(pattern)]


def test_gs_routing_equals_jax():
    fj = jax_beehive(pose_count_target=10, graphinit=False)
    ft = generate_graph_beehive(pose_count_target=10, graphinit=False)
    sj, st = JB.BatchedNonparametricSolver(fj, "default", N=20), \
        TB.BatchedNonparametricSolver(ft, "default", N=20, device="cpu")
    rj = JB._build_gs_routing(sj.bp, fj)
    rt = TB._build_gs_routing(st.bp, ft, st.ga)
    assert rt["order"].dtype == rj["order"].dtype
    np.testing.assert_array_equal(rt["order"], rj["order"])
    assert rt["S"] == rj["S"]
    for key in ("src_of", "row_of", "up_of"):
        assert sorted(rt[key]) == sorted(rj[key])
        for t in rj[key]:
            assert rt[key][t].dtype == rj[key][t].dtype
            np.testing.assert_array_equal(rt[key][t], rj[key][t])
    assert st.gs_routing() is st.bp.gs_routing


def _with_fallback(M):
    """beehive-10 plus a multihypo sighting and a non-Gaussian (mixture
    bearing) sighting."""
    fg = (jax_beehive if M is R else generate_graph_beehive)(pose_count_target=10,
                                                             graphinit=False)
    fg.add_factor(["x4", "l0", "l2"],
                  M.Pose2Point2BearingRange(M.Normal(0.0, 0.03), M.Normal(20.0, 0.5)),
                  multihypo=[1.0, 0.5, 0.5], graphinit=False)
    bearing = M.Mixture([M.Normal(0.0, 0.03), M.Normal(0.5, 0.03)], [0.8, 0.2])
    fg.add_factor(["x5", "l1"], M.Pose2Point2BearingRange(bearing, M.Normal(20.0, 0.5)),
                  graphinit=False)
    return fg


def test_fallback_routing_equals_jax():
    fj, ft = _with_fallback(R), _with_fallback(T)
    sj, st = JB.BatchedNonparametricSolver(fj, "default", N=20), \
        TB.BatchedNonparametricSolver(ft, "default", N=20, device="cpu")
    assert st.ga.excluded_factors == sj.ga.excluded_factors != []
    assert st.bp.fallback == sj.bp.fallback
    # the multihypo factor's 3 messages, and 2 of every bearing-range factor:
    # one non-Gaussian factor sends its whole batch to the fallback
    n_br = len([f for f in ft.factors.values()
                if f.ftype.name == "Pose2Point2BearingRange" and f.multihypo is None])
    assert len(st.bp.fallback) == 3 + 2 * n_br
    assert st.bp.kmax == sj.bp.kmax
    assert len(st.bp.sources) == len(sj.bp.sources)
    for t in sj.ga.type_names:
        np.testing.assert_array_equal(st.bp.has_msg[t], sj.bp.has_msg[t])
        np.testing.assert_array_equal(st.bp.msg_factor[t], sj.bp.msg_factor[t])
    assert JB._build_gs_routing(sj.bp, fj) is None
    assert TB._build_gs_routing(st.bp, ft, st.ga) is None
    assert st.gs_pass(st.gather_beliefs(), torch.Generator()) is None


def test_init_all_beliefs_visits_factors_in_the_jax_order(monkeypatch):
    visits = {"jax": [], "port": []}

    def fake_jax(fg, flabel, target, solve_key="default", key=None, N=None, skip_hypo=False):
        visits["jax"].append((flabel, target, skip_hypo))
        return jax.numpy.zeros((N, fg.variables[target].vtype.point_dim))

    def fake_port(fg, flabel, target, solve_key="default", gen=None, N=None, skip_hypo=False,
                  device="cpu"):
        visits["port"].append((flabel, target, skip_hypo))
        return torch.zeros((N, fg.variables[target].vtype.point_dim))

    monkeypatch.setattr(JS, "approx_conv", fake_jax)
    monkeypatch.setattr(TS, "approx_conv", fake_port)
    for gj, gt in ((_with_fallback(R), _with_fallback(T)),
                   (jax_honeycomb(pose_count_target=14), generate_graph_honeycomb(14))):
        visits["jax"].clear()
        visits["port"].clear()
        JS.init_all_beliefs(gj, N=N)
        TS.init_all_beliefs(gt, N=N, device="cpu")
        assert visits["port"] == visits["jax"]
        assert len(visits["port"]) == len({v for _f, v, _s in visits["port"]})
        assert all(s for _f, _v, s in visits["port"])
        # leftovers (variables no factor reached) seed at identity + noise
        for l in gt._var_order:
            assert gt.variables[l].beliefs["default"].shape == (N, gt.variables[l].vtype.point_dim)


def test_gs_pass_seeded_at_the_optimum_stays_there():
    fg = generate_graph_beehive(pose_count_target=10, graphinit=False)
    fg.init_all()
    T.solve_graph_parametric(fg, init=False, device="cpu")
    truth = {l: fg.get_coords(l, "parametric") for l in fg.ls(r"^x\d+$")}
    fg.set_solvable("l1", 0)
    solver = TB.BatchedNonparametricSolver(fg, "default", N=N, device="cpu")
    gen = torch.Generator().manual_seed(0)
    solver.init_beliefs_from_points(gen)
    start = solver.gather_beliefs()
    out = solver.gs_pass(start, gen, up_only=False)
    out = solver.gs_pass(out, gen, up_only=False, reverse=True)
    assert not torch.equal(out["Pose2"], start["Pose2"])
    assert torch.isfinite(out["Pose2"]).all() and torch.isfinite(out["Point2"]).all()
    errs = [np.linalg.norm(out["Pose2"][s, :, :2].mean(0).numpy() - truth[l][:2])
            for s, l in enumerate(solver.ga.var_labels["Pose2"])]
    assert float(np.mean(errs)) < 1.0
    # filtering pass: only messages from earlier variables; x0 keeps its prior
    up = solver.gs_pass(start, gen, up_only=True)
    assert torch.isfinite(up["Pose2"]).all()
    # a frozen variable passes through bit-identical
    l1 = solver.ga.var_labels["Point2"].index("l1")
    assert torch.equal(out["Point2"][l1], start["Point2"][l1])
    assert torch.equal(up["Point2"][l1], start["Point2"][l1])
    assert not torch.equal(out["Point2"], start["Point2"])


def test_gs_pass_agrees_with_jax_from_identical_particles(truth):
    fj = _honeycomb(jax_honeycomb)
    sj = JB.BatchedNonparametricSolver(fj, "default", N=N)
    sj.init_beliefs_from_points(jax.random.PRNGKey(5))
    start = {t: np.asarray(v) for t, v in sj.gather_beliefs().items()}
    bj = sj.gs_pass(sj.gather_beliefs(), jax.random.PRNGKey(6))
    bj = sj.gs_pass(bj, jax.random.PRNGKey(7), reverse=True)

    ft = _honeycomb(generate_graph_honeycomb)
    st = TB.BatchedNonparametricSolver(ft, "default", N=N, device="cpu")
    gen = torch.Generator().manual_seed(6)
    bt = st.gs_pass(beliefs_from_numpy(start, device="cpu"), gen)
    bt = st.gs_pass(bt, gen, reverse=True)
    for t, man in (("Pose2", SE2_), ("Point2", T2)):
        kl = np.mean([symmetric_kl_knn(man, torch.as_tensor(np.asarray(bj[t][s])), bt[t][s])
                      for s in range(bt[t].shape[0])])
        assert kl < KL_GATE, (t, kl)
    st.scatter_beliefs(bt)
    assert np.mean(_errors(ft, truth, r"^x\d+$")) < 1.0
