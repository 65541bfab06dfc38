"""The front end of the port (rome_tpu_torch.frontend: robot_utils,
odometry, slam) against the JAX package's on the fixtures of
tests/test_frontend.py, plus ``ManifoldKernelDensity.max_point``.

Tolerances: frozen sets and labels equal, the 2-D readers at 1e-6 where
the JAX package's float32 ``get_coords`` is on their path; the tether
accumulation, odometry chains and delta extraction at 1e-12 (float64 numpy
on both sides); the chords at 1e-5 (float32 in both packages); max_point
the same particle. The solve manager runs on the CPU with a tiny graph and
waits on an Event set by its solve function, with a bounded timeout.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu.frontend.odometry as JO  # noqa: E402
import rome_tpu.frontend.robot_utils as JR  # noqa: E402
from rome_tpu.factors.pose2 import MutablePose2Pose2Gaussian as JMutable  # noqa: E402
from rome_tpu.manifolds.base import T2 as JT2  # noqa: E402
from rome_tpu.solvers.multimodal.kde import ManifoldKernelDensity as JKDE  # noqa: E402

import rome_tpu_torch as T  # noqa: E402
import rome_tpu_torch.frontend.odometry as TO  # noqa: E402
import rome_tpu_torch.frontend.robot_utils as TR  # noqa: E402
from rome_tpu_torch.factors.pose2 import MutablePose2Pose2Gaussian as TMutable  # noqa: E402
from rome_tpu_torch.frontend.slam import (  # noqa: E402
    SLAMWrapperLocal,
    check_solve_stride_trigger,
    manage_solve_tree,
    stop_manage_solve_tree,
)
from rome_tpu_torch.manifolds.base import SE2_, T2  # noqa: E402
from rome_tpu_torch.solvers.multimodal.kde import ManifoldKernelDensity  # noqa: E402

PKGS = {"jax": (R, JO, JR, JMutable), "port": (T, TO, TR, TMutable)}


def _odo(mod, dx=(1, 0, 0), sig=(0.01, 0.01, 0.01)):
    return mod.Pose2Pose2(mod.MvNormal(list(dx), list(sig)))


def _chain(side, n=9, **kw):
    mod, _O, RU, _M = PKGS[side]
    fg, _ = RU.init_factor_graph()
    for _ in range(n):
        _O.add_odo_fg(fg, _odo(mod, **kw))
    return fg


def test_accumulate_discrete_local_frame_matches_jax():
    """testDeadReckoningTether.jl:40-80: the accumulated mean is the SE(2)
    composition of the increments, the covariance grows; both packages at
    1e-12 over a seeded sequence."""
    rng = np.random.default_rng(3)
    DXs = rng.normal(0, [0.1, 0.02, 0.05], (25, 3))
    Qc = np.diag([1e-4, 1e-4, 1e-5])
    out = {}
    for side, (_m, O, _r, Mut) in PKGS.items():
        mpp = Mut()
        O.reset_factor(mpp)
        for DX in DXs:
            O.accumulate_discrete_local_frame(mpp, DX, Qc, dt=0.1)
        out[side] = (np.asarray(mpp.params["z"]), np.asarray(mpp.dists[0].cov()),
                     np.asarray(mpp.params["sqrt_info"]))
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    expect = torch.zeros(3, dtype=torch.float64)
    for DX in DXs:
        expect = SE2_.compose(expect, torch.as_tensor(DX))
    np.testing.assert_allclose(out["port"][0], expect.numpy(), atol=1e-12)
    assert np.all(np.linalg.eigvalsh(out["port"][1]) > 0) and out["port"][1][0, 0] > 1e-6


def test_dead_reckon_tether_duplicate():
    """OdometryUtils.jl:67-86: the tether hanging off x0 (solvable 0) is
    snapshot into a standard factor + new pose; the duplicate equals JAX's."""
    got = {}
    for side, (mod, O, RU, Mut) in PKGS.items():
        fg, _ = RU.init_factor_graph()
        fg.init_all()
        mpp = Mut()
        O.reset_factor(mpp)
        fg.add_variable("deadreckon_x0", mod.Pose2, solvable=0)
        fg.add_factor(["x0", "deadreckon_x0"], mpp, solvable=0, graphinit=False)
        for _ in range(5):
            O.accumulate_discrete_local_frame(mpp, [0.2, 0.0, 0.1], np.diag([1e-4, 1e-4, 1e-5]))
        flabel = O.duplicate_to_standard_factor_variable(mpp, fg, "x0", "x1")
        f = fg.factors[flabel]
        assert "x1" in fg.variables and mpp.label != flabel
        assert fg.variables["deadreckon_x0"].solvable == 0
        np.testing.assert_allclose(f.params["z"], mpp.params["z"], atol=1e-12)
        RU.enable_solve_all_not_drt(fg)
        got[side] = (flabel, f.ftype.name, {k: np.asarray(v) for k, v in f.params.items()},
                     {l: r.solvable for l, r in fg.variables.items()},
                     {l: g.solvable for l, g in fg.factors.items()})
    (la, na, pa, va, fa), (lb, nb, pb, vb, fb) = got["port"], got["jax"]
    assert (la, na, va, fa) == (lb, nb, vb, fb)
    assert va["deadreckon_x0"] == 0
    for k in pa:
        np.testing.assert_allclose(pa[k], pb[k], rtol=0, atol=1e-12)


def test_extract_delta_odo_roundtrip_matches_jax():
    th = np.cumsum(np.full(20, 0.1))
    xx, yy = np.cumsum(np.cos(th)), np.cumsum(np.sin(th))
    DX = TO.extract_delta_odo(xx, yy, th)
    np.testing.assert_allclose(DX, JO.extract_delta_odo(xx, yy, th), rtol=0, atol=1e-12)
    p = torch.as_tensor([xx[0], yy[0], th[0]])
    for i in range(1, 20):
        p = SE2_.compose(p, torch.as_tensor(DX[:, i]))
    np.testing.assert_allclose(p.numpy(), [xx[-1], yy[-1], th[-1]], atol=1e-10)


@pytest.mark.parametrize("args", [
    ([1.0, 0, 0], [0, 0, 0], 0.5, 0.3), ([0.1, 0, 0.1], [0, 0, 0], 0.5, 0.3),
    ([0, 0, 0.5], [0, 0, 0], 0.5, 0.3), ([0.2, 0.1, 3.1], [0, 0, -3.1], 0.5, 0.3),
    ([0.1, 0, 0.0], [0, 0, 0], 4.0, 1.0, 0.5, 0.3, 3.0),
    ([0.1, 0, 0.0], [0, 0, 0], 4.0, 2.0, 0.5, 0.3, 1.0),
])
def test_trigger_pose_matches_jax(args):
    assert TO.trigger_pose(*args) == JO.trigger_pose(*args)


def test_trigger_pose_rules():
    """tests/test_frontend.py's cases: distance, none, yaw (wrapped)."""
    assert TO.trigger_pose([1.0, 0, 0], [0, 0, 0], 0.5, 0.3) == 1
    assert TO.trigger_pose([0.1, 0, 0.1], [0, 0, 0], 0.5, 0.3) == 0
    assert TO.trigger_pose([0, 0, 0.5], [0, 0, 0], 0.5, 0.3) == 2
    assert TO.trigger_pose([0, 0, 3.1], [0, 0, -3.1], 0.5, 0.3) == 0


def test_add_odo_fg_and_last_poses():
    fgs = {side: _chain(side, n=4) for side in PKGS}
    for side, fg in fgs.items():
        assert len(fg.ls(r"^x\d+$")) == 5
        assert len(PKGS[side][2].get_last_poses(fg, number=2)) == 2
    assert fgs["port"].ls() == fgs["jax"].ls()
    assert fgs["port"].lsf() == fgs["jax"].lsf()


def test_fixed_lag_freeze_and_means():
    """setSolvableOldPoses!: the frozen set equals JAX's; a port solve keeps
    the frozen poses bit for bit; get_2d_pose_means covers every pose."""
    fgs = {side: _chain(side) for side in PKGS}
    frozen = {side: PKGS[side][2].set_solvable_old_poses(fg, youngest=3)
              for side, fg in fgs.items()}
    assert frozen["port"] == frozen["jax"] and len(frozen["port"]) == 7
    fg = fgs["port"]
    assert fg.variables["x0"].solvable == 0 and fg.variables["x9"].solvable == 1
    fg.init_all()
    before = {l: fg.get_point(l).copy() for l in frozen["port"]}
    T.solve_graph_parametric(fg, init=False, device="cpu")
    for l, p in before.items():
        np.testing.assert_array_equal(fg.get_point(l), p)
    assert len(TR.get_2d_pose_means(fg)) == 10


def test_set_solvable_old_poses_marginalizes_and_sorts_numerically():
    fgs = {side: _chain(side, n=11) for side in PKGS}
    out = {side: (PKGS[side][2].set_solvable_old_poses(fg, youngest=2, oldest=5),
                  sorted(l for l, r in fg.variables.items() if r.marginalized))
           for side, fg in fgs.items()}
    assert out["port"] == out["jax"]
    assert out["port"][0][:3] == ["x0", "x1", "x2"] and "x10" not in out["port"][0]


def test_fifo_freeze_param():
    got = {}
    for side in PKGS:
        fg = _chain(side, n=5)
        fg.params.qfl = 2
        got[side] = PKGS[side][2].fifo_freeze(fg)
    assert got["port"] == got["jax"] and len(got["port"]) == 4


def test_manage_solve_tree_loop():
    """Slam.jl:189-297: producer/consumer with stride-triggered solves in the
    manager's thread, on the CPU; the first solve is awaited on an Event."""
    slam = SLAMWrapperLocal()
    slam.solve_settings.solve_stride = 4
    fg = slam.dfg
    fg.params.graphinit = True
    TR.init_factor_graph(fg)
    solved = threading.Event()
    seen = []

    def solve_fn(g):
        seen.append(sorted(l for l in g.ls(r"^x\d+$") if g.variables[l].solvable))
        T.solve_graph_parametric(g, device="cpu")
        solved.set()

    th = manage_solve_tree(slam, disengage_youngest=100, solve_fn=solve_fn, device="cpu")
    try:
        for _ in range(8):
            with slam.lock:
                new = TO.add_odo_fg(fg, _odo(T), solvable=0)
            slam.pose_count += 1
            slam.solve_settings.solvables.put([new])
            check_solve_stride_trigger(slam)
        assert solved.wait(timeout=120)
    finally:
        stop_manage_solve_tree(slam)
        th.join(timeout=120)
    assert not th.is_alive() and not slam.errors
    assert slam.solve_count >= 1 and len(slam.timing_log) == slam.solve_count
    row = slam.timing_log[0]
    assert {"dt_wait", "dt_solvable", "dt_init", "dt_disengage", "dt_solve"} <= set(row)
    assert seen[0] and "x1" in seen[0]                 # queued poses engaged before the solve
    assert "parametric" in fg.variables["x1"].points


def test_manage_solve_tree_under_a_fast_producer():
    """Stress: a producer adds poses and loop closures under the manager's
    lock while the manager solves every other pose, with the interpreter
    switching threads every microsecond. No solve may see a graph mid-edit:
    no error, one timing row per solve, and every solve's lowering held
    every variable it was given (a lowered graph short of the graph it was
    handed would be a lost update)."""
    import sys

    slam = SLAMWrapperLocal()
    slam.solve_settings.solve_stride = 2
    fg = slam.dfg
    fg.params.graphinit = False
    TR.init_factor_graph(fg)
    fg.init_all()
    seen = []
    solved = [threading.Event(), threading.Event()]

    def solve_fn(g):
        n = g.num_variables
        res = T.solve_graph_parametric(g, init=False, device="cpu")
        seen.append((n, res["num_variables"], g.num_variables))
        for ev in solved[: len(seen)]:
            ev.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    th = manage_solve_tree(slam, disengage_youngest=100, solve_fn=solve_fn, device="cpu")
    try:
        for k in range(1, 61):
            with slam.lock:
                n_fct = len(fg._fct_order)
                TO.add_odo_fg(fg, _odo(T), solvable=0, graphinit=False)
                fg.init_variable(f"x{k}", [float(k), 0.0, 0.0])
                if k >= 4 and k % 3 == 0:
                    fg.add_factor([f"x{k - 3}", f"x{k}"], _odo(T, dx=(3, 0, 0)), solvable=0,
                                  graphinit=False)
                added = fg._fct_order[n_fct:]
            slam.pose_count += 1
            slam.solve_settings.solvables.put([f"x{k}"] + added)
            check_solve_stride_trigger(slam)
            if k == 30:
                # a loaded machine can let the producer run ahead of every
                # solve: have the second half of the poses arrive after one
                assert solved[0].wait(timeout=60), "no solve within 60 s"
        assert solved[1].wait(timeout=60), "no second solve within 60 s"
    finally:
        stop_manage_solve_tree(slam)
        th.join(timeout=120)
        sys.setswitchinterval(old)
    assert not th.is_alive() and not slam.errors, slam.errors
    assert slam.solve_count >= 2 and len(slam.timing_log) == slam.solve_count == len(seen)
    assert all(a == b == c for a, b, c in seen), seen


def test_manage_solve_tree_keeps_the_solve_error():
    """An exception of a solve ends the manager and stays in slam.errors."""
    slam = SLAMWrapperLocal()
    TR.init_factor_graph(slam.dfg)

    def solve_fn(g):
        raise RuntimeError("kernel launch failed")

    th = manage_solve_tree(slam, solve_fn=solve_fn, device="cpu")
    slam.solve_settings.solvables.put(["x0"])
    slam.pose_count = 10
    check_solve_stride_trigger(slam)
    th.join(timeout=60)
    assert not th.is_alive()
    assert len(slam.errors) == 1 and "kernel launch failed" in str(slam.errors[0])
    assert slam.solve_count == 0 and not slam.solve_settings.solve_in_progress


def test_manage_solve_tree_defaults_to_the_card():
    import inspect

    assert inspect.signature(manage_solve_tree).parameters["device"].default == "cuda"


def test_accumulate_factor_chain_and_chords_match_jax():
    """assembleChordsDict (OdometryUtils.jl:169-194): the chords equal the
    composed odometry means; both packages' chords at 1e-5 (float32), the
    chain's odometry composition at 1e-12 and its solution chord at 1e-6."""
    dx = np.array([1.0, 0.0, np.pi / 6])
    cov = np.diag([1e-3, 1e-3, 1e-4])
    out = {}
    for side, (mod, O, _r, _m) in PKGS.items():
        fg = mod.FactorGraph()
        fg.params.graphinit = False
        fg.add_variable("x0", mod.Pose2)
        fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.01] * 3)))
        x = np.zeros(3)
        for i in range(1, 7):
            fg.add_variable(f"x{i}", mod.Pose2)
            fg.add_factor([f"x{i-1}", f"x{i}"], mod.Pose2Pose2(mod.MvNormal(dx, cov)))
            x = TO._se2_vee(TO._se2_mat(x) @ TO._se2_mat(dx + 0.01 * i))
            fg.init_variable(f"x{i}", x)
        fg.init_variable("x0", np.zeros(3))
        on = {"device": "cpu"} if side == "port" else {}
        out[side] = (O.accumulate_factor_chain(fg, "x0", "x3"),
                     O.assemble_chords_dict(fg, maxadi=3, **on))
    (acc_p, soln_p), chords_p = out["port"]
    (acc_j, soln_j), chords_j = out["jax"]
    np.testing.assert_allclose(acc_p, acc_j, rtol=0, atol=1e-12)
    # the JAX package's get_coords (SE(2) log) runs in float32
    np.testing.assert_allclose(soln_p, soln_j, rtol=0, atol=1e-6)
    want = np.zeros(3)
    for _ in range(3):
        want = TO._se2_vee(TO._se2_mat(want) @ TO._se2_mat(dx))
    np.testing.assert_allclose(acc_p, want, atol=1e-12)
    assert chords_p.keys() == chords_j.keys()
    for a in chords_p:
        assert chords_p[a].keys() == chords_j[a].keys()
        for b in chords_p[a]:
            for u, v in zip(chords_p[a][b], chords_j[a][b]):
                assert u.dtype == np.float32
                np.testing.assert_allclose(u, np.asarray(v), rtol=0, atol=1e-5)
    assert set(chords_p["x0"]) == {"x1", "x2", "x3"}


def test_chords_of_a_long_chain_match_its_float64_composition():
    """The port's chords come from a prefix sum of headings and rotated
    steps, JAX's from a sequential scan: on a 200-pose seeded chain whose
    heading wraps many times, both are within 1e-4 of the float64
    composition along the chain (float32 rounding on positions of up to
    about 250 m)."""
    rng = np.random.default_rng(11)
    dxs = np.c_[rng.uniform(0.5, 2.0, 199), rng.normal(0, 0.3, 199), rng.normal(0, 0.6, 199)]
    out = {}
    for side, (mod, O, _r, _m) in PKGS.items():
        fg = mod.FactorGraph()
        fg.params.graphinit = False
        fg.add_variable("x0", mod.Pose2)
        for i, dx in enumerate(dxs, start=1):
            fg.add_variable(f"x{i}", mod.Pose2)
            fg.add_factor([f"x{i-1}", f"x{i}"], mod.Pose2Pose2(mod.MvNormal(dx, [0.03] * 3)))
        on = {"device": "cpu"} if side == "port" else {}
        out[side] = O.assemble_chords_dict(fg, maxadi=10, **on)
    assert out["port"].keys() == out["jax"].keys()
    for i in range(199):
        acc = np.zeros(3)
        assert len(out["port"][f"x{i}"]) == min(10, 199 - i)
        for k in range(i, min(i + 10, 199)):
            acc = TO._se2_vee(TO._se2_mat(acc) @ TO._se2_mat(dxs[k]))
            for side in PKGS:
                got = np.asarray(out[side][f"x{i}"][f"x{k + 1}"][0], dtype=np.float64)
                err = np.r_[got[:2] - acc[:2], TO._sym_rem(got[2] - acc[2])]
                np.testing.assert_allclose(err, 0.0, rtol=0, atol=1e-4, err_msg=side)


def test_max_point_matches_jax():
    """getKDEMax: the particle of highest density, the same one in both."""
    rng = np.random.default_rng(5)
    for _ in range(5):
        pts = rng.normal(0, [2.0, 1.0], (80, 2)).astype(np.float32)
        got = ManifoldKernelDensity.from_points(T2, torch.as_tensor(pts)).max_point()
        want = JKDE.from_points(JT2, jnp.asarray(pts)).max_point()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        lp = ManifoldKernelDensity.from_points(T2, torch.as_tensor(pts)).logpdf(
            torch.as_tensor(pts))
        assert torch.equal(got, torch.as_tensor(pts)[torch.argmax(lp)])


def test_2d_readers_and_linear_array_match_jax():
    """get2DPoseMax / get2DLandmMax / get2DSamples / get2DPoseMeans and
    addLinearArrayConstraint (RobotUtils.jl:175-204, 291-313, 383-401):
    equal in both packages, point estimates and particle beliefs."""
    rng = np.random.default_rng(2)
    bel = rng.normal(0, [0.3, 0.3, 0.05], (60, 3)) + np.array([5.0, 1.0, 0.2])
    out = {}
    for side, (mod, _O, RU, _m) in PKGS.items():
        fg = mod.FactorGraph()
        fg.params.graphinit = False
        for i in range(3):
            fg.add_variable(f"x{i}", mod.Pose2)
            fg.init_variable(f"x{i}", np.array([float(i), 0.5, 0.1]))
        fg.add_variable("x3", mod.Pose2)
        fg.variables["x3"].beliefs["default"] = bel.copy()
        fg.add_variable("p0", mod.Pose3)
        fg.init_variable("p0", np.zeros(6))
        RU.add_linear_array_constraint(fg, (3.0, 0.2), "p0", "l1")
        f = [fg.factors[l] for l in fg._adj["l1"]][0]
        assert f.ftype.name == "LinearRangeBearingElevation"
        fg.init_variable("l1", np.array([4.0, 0.5, 0.0]))
        out[side] = dict(
            pose_max=RU.get_2d_pose_max(fg), landm_max=RU.get_2d_landm_max(fg),
            bel_max=RU.get_2d_pose_max(fg, solve_key="default"),
            samples=RU.get_2d_samples(fg), bel_samples=RU.get_2d_samples(fg, solve_key="default"),
            means=RU.get_2d_pose_means(fg), params=dict(f.params))
    # the readers of point estimates go through get_coords, which the JAX
    # package runs in float32: 1e-6 there, 1e-12 for the raw samples
    p, j = out["port"], out["jax"]
    assert p["pose_max"][0] == j["pose_max"][0] == ["x0", "x1", "x2"]
    for a, b in zip(p["pose_max"][1:], j["pose_max"][1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p["pose_max"][1], [0.0, 1.0, 2.0], atol=1e-12)
    np.testing.assert_allclose(p["pose_max"][3], [0.1] * 3, atol=1e-12)
    assert p["landm_max"][0] == j["landm_max"][0] == ["l1"]
    np.testing.assert_allclose(p["landm_max"][1], j["landm_max"][1], atol=1e-6)
    assert p["bel_max"][0] == j["bel_max"][0] == ["x3"]
    for a, b in zip(p["bel_max"][1:], j["bel_max"][1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)   # the same f32 particle
    for key in ("samples", "bel_samples"):
        for a, b in zip(p[key], j[key]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert p["means"].keys() == j["means"].keys()
    for k in p["means"]:
        np.testing.assert_allclose(p["means"][k], j["means"][k], atol=1e-6)
    for k in p["params"]:
        np.testing.assert_allclose(p["params"][k], np.asarray(j["params"][k]), atol=1e-12)


def test_init_factor_graph_matches_jax():
    got = {}
    for side, (_mod, _O, RU, _m) in PKGS.items():
        fg, labels = RU.init_factor_graph(init=[1.0, 2.0, 0.3])
        fg.init_all()
        f = fg.factors[fg.lsf()[0]]
        got[side] = (labels, f.ftype.name, np.asarray(f.params["z"]),
                     np.asarray(f.params["sqrt_info"]), fg.get_coords("x0"))
    assert got["port"][:2] == got["jax"][:2]
    for a, b in zip(got["port"][2:], got["jax"][2:]):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_reference_aliases():
    for name in ("getLastPoses", "setSolvableOldPoses", "enableSolveAllNotDRT",
                 "initFactorGraph", "get2DSamples", "get2DPoseMeans", "fifoFreeze"):
        assert callable(getattr(TR, name))
    for name in ("accumulateDiscreteLocalFrame", "duplicateToStandardFactorVariable",
                 "resetFactor", "extractDeltaOdo", "addOdoFG", "triggerPose"):
        assert callable(getattr(TO, name))
