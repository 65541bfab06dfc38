"""The port's entry points run on the card unless the caller asks for the CPU.

- Every public entry point takes ``device="cuda"`` as its default: the
  parametric and nonparametric solves, the particle init and belief
  prediction, the Bayes-tree solve and its batched schedule, the batched
  solver, measurement sampling and ``approx_conv``, the lowering and the two
  numpy converters.
- The distributed solves' too: the distributed runtime and the global
  mesh, the factor-sharded step and solve, the variable-partitioned solver,
  the sharded nonparametric solver and the graft_entry step and dryrun.
- The front end's too: the solve manager, the odometry chords, the feature tracker
  and its KDE of a sighting, the wheeled navigation system and its drive,
  and the DEM interpolator.
- On a machine without CUDA, an entry point called without ``device=``
  raises (a RuntimeError that names ``device="cpu"``) before it does any
  work: it never returns a CPU result and leaves the graph as it was.
- With ``device="cpu"`` the same calls run (the other tests of the port).
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rome_tpu_torch as T  # noqa: E402
from rome_tpu_torch.graph import convert, lower  # noqa: E402
from rome_tpu_torch.solvers import parametric  # noqa: E402
from rome_tpu_torch.solvers.multimodal import batched, convolve, solve, tree  # noqa: E402
from rome_tpu_torch.frontend import navigation, odometry, slam, tracker  # noqa: E402
from rome_tpu_torch.services import scalar_fields  # noqa: E402
from rome_tpu_torch import graft_entry  # noqa: E402
from rome_tpu_torch.parallel import distributed, multimodal, sharding, varpart  # noqa: E402

ENTRY_POINTS = {
    "solve_graph_parametric": parametric.solve_graph_parametric,
    "init_all_beliefs": solve.init_all_beliefs,
    "predict_belief": solve.predict_belief,
    "solve_graph_nonparametric": solve.solve_graph_nonparametric,
    "solve_tree": tree.solve_tree,
    "_solve_tree_batched": tree._solve_tree_batched,
    "set_points_from_beliefs": batched.set_points_from_beliefs,
    "BatchedNonparametricSolver": batched.BatchedNonparametricSolver,
    "sample_measurements": convolve.sample_measurements,
    "approx_conv": convolve.approx_conv,
    "lower": lower.lower,
    "graph_arrays_from_numpy": convert.graph_arrays_from_numpy,
    "beliefs_from_numpy": convert.beliefs_from_numpy,
    "manage_solve_tree": slam.manage_solve_tree,
    "assemble_chords_dict": odometry.assemble_chords_dict,
    "FeatureTracker": tracker.FeatureTracker,
    "FeatureTracker.init_from": tracker.FeatureTracker.init_from,
    "p2c_pts_kde": tracker.p2c_pts_kde,
    "make_in_situ_system": navigation.make_in_situ_system,
    "adv_odo_by_rules": navigation.adv_odo_by_rules,
    "dem_interp": scalar_fields.dem_interp,
    "init_distributed": distributed.init_distributed,
    "global_mesh": distributed.global_mesh,
    "spawn_ranks": distributed.spawn_ranks,
    "solve_graph_distributed": distributed.solve_graph_distributed,
    "make_sharded_gn_step": sharding.make_sharded_gn_step,
    "solve_distributed": sharding.solve_distributed,
    "make_varpart_solver": varpart.make_varpart_solver,
    "ShardedNonparametricSolver": multimodal.ShardedNonparametricSolver,
    "graft_entry.entry": graft_entry.entry,
    "graft_entry._build_chain_fixture": graft_entry._build_chain_fixture,
    "dryrun_multichip": graft_entry.dryrun_multichip,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    fn = ENTRY_POINTS[name]
    params = inspect.signature(fn.__init__ if inspect.isclass(fn) else fn).parameters
    assert params["device"].default == "cuda"


def test_package_exports_are_the_checked_entry_points():
    for name in ("solve_graph_parametric", "solve_graph_nonparametric", "init_all_beliefs",
                 "predict_belief", "solve_tree", "approx_conv"):
        assert getattr(T, name) is ENTRY_POINTS[name]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has CUDA: the default device runs")


def _hexagonal():
    fg = T.generate_graph_hexagonal(N=10)
    fg.init_all()
    return fg


def _state(fg):
    return {l: (dict(r.points), dict(r.beliefs)) for l, r in fg.variables.items()}


def _calls():
    """Each entry point called without ``device=`` (and what it would touch)."""
    fg = _hexagonal()
    f = fg._fct_order[1]
    gen = torch.Generator().manual_seed(0)
    sighting = np.array([[10.0], [0.0]])
    return fg, {
        "solve_graph_parametric": lambda: T.solve_graph_parametric(fg),
        "init_all_beliefs": lambda: T.init_all_beliefs(fg, N=10),
        "predict_belief": lambda: T.predict_belief(fg, "x1", N=10),
        "solve_graph_nonparametric": lambda: T.solve_graph_nonparametric(fg, N=10),
        "solve_tree": lambda: T.solve_tree(fg, N=10),
        "_solve_tree_batched": lambda: tree._solve_tree_batched(
            fg, tree.build_tree_from_ordering(fg), set(), "default", 10, gen, True),
        "set_points_from_beliefs": lambda: batched.set_points_from_beliefs(
            fg, ["x0"], "default"),
        "BatchedNonparametricSolver": lambda: batched.BatchedNonparametricSolver(fg, N=10),
        "sample_measurements": lambda: convolve.sample_measurements(fg.factors[f], gen, 10),
        "approx_conv": lambda: T.approx_conv(fg, f, "x1", N=10),
        "lower": lambda: lower.lower(fg),
        "graph_arrays_from_numpy": lambda: convert.graph_arrays_from_numpy(
            ["Pose2"], {"Pose2": 1}, {"Pose2": np.zeros((1, 3))}, {"Pose2": np.ones(1)}, []),
        "beliefs_from_numpy": lambda: convert.beliefs_from_numpy(
            {"Pose2": np.zeros((1, 10, 3))}),
        "manage_solve_tree": lambda: slam.manage_solve_tree(slam.SLAMWrapperLocal(dfg=fg)),
        "assemble_chords_dict": lambda: odometry.assemble_chords_dict(fg),
        "FeatureTracker": lambda: tracker.FeatureTracker(),
        "FeatureTracker.init_from": lambda: tracker.FeatureTracker.init_from(sighting),
        "p2c_pts_kde": lambda: tracker.p2c_pts_kde([10.0, 0.0], [0.5, 0.02]),
        "make_in_situ_system": lambda: navigation.make_in_situ_system(np.zeros(3), sighting),
        "adv_odo_by_rules": lambda: navigation.adv_odo_by_rules(
            np.array([[0.1, 1.0, 0.0]]), {1: navigation.LaserFeatures(0.0, sighting)}),
        "dem_interp": lambda: scalar_fields.dem_interp([0.0, 1.0], [0.0, 1.0], np.zeros((2, 2))),
        "init_distributed": lambda: distributed.init_distributed(),
        "global_mesh": lambda: distributed.global_mesh(),
        "spawn_ranks": lambda: distributed.spawn_ranks(distributed.global_mesh, 1),
        "solve_graph_distributed": lambda: distributed.solve_graph_distributed(fg),
        "make_sharded_gn_step": lambda: sharding.make_sharded_gn_step(lower.lower(fg, device="cpu")),
        "solve_distributed": lambda: sharding.solve_distributed(lower.lower(fg, device="cpu")),
        "make_varpart_solver": lambda: varpart.make_varpart_solver(lower.lower(fg, device="cpu")),
        "ShardedNonparametricSolver": lambda: multimodal.ShardedNonparametricSolver(fg, N=10),
        "graft_entry.entry": lambda: graft_entry.entry(),
        "graft_entry._build_chain_fixture": lambda: graft_entry._build_chain_fixture(30),
        "dryrun_multichip": lambda: graft_entry.dryrun_multichip(1),
    }


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_without_cuda_the_default_raises(no_cuda, name):
    fg, calls = _calls()
    assert set(calls) == set(ENTRY_POINTS)
    before = _state(fg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[name]()
    after = _state(fg)
    assert after.keys() == before.keys()
    for label, (points, beliefs) in before.items():
        assert after[label][0].keys() == points.keys(), label
        assert after[label][1].keys() == beliefs.keys(), label


def test_the_solves_return_no_cpu_result_without_cuda(no_cuda):
    """The two solves a user calls first: no result, no estimate written."""
    fg = _hexagonal()
    points = {l: {k: np.array(v) for k, v in r.points.items()} for l, r in fg.variables.items()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.solve_graph_parametric(fg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.solve_graph_nonparametric(fg, N=10)
    for label, rec in fg.variables.items():
        assert rec.points.keys() == points[label].keys()
        for key, p in points[label].items():
            np.testing.assert_array_equal(rec.points[key], p)
        assert "default" not in rec.beliefs
    res = T.solve_graph_parametric(fg, device="cpu")
    assert res["stats"].converged
