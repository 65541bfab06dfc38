"""Robot / fixed-lag utilities (counterpart of
``rome_tpu/frontend/robot_utils.py``; reference: RobotUtils.jl).

Host-side graph bookkeeping: which poses are solvable, the fixed-lag freeze,
the first pose and its prior, and the 2-D readers. The max-belief readers
build a float32 particle KDE on the CPU, as the JAX package's does.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import numpy as np

from rome_tpu_torch.distributions import MvNormal
from rome_tpu_torch.factors.pose2 import PriorPose2
from rome_tpu_torch.graph.graph import FactorGraph, SolverParams
from rome_tpu_torch.utils.profiling import annotate
from rome_tpu_torch.variables import Pose2


def get_last_poses(fg: FactorGraph, filter_label: str = r"^x\d+$", number: int = 5):
    """getLastPoses (RobotUtils.jl:49-60): most recent N pose labels by
    timestamp."""
    xs = [l for l in fg.ls(filter_label)]
    xs.sort(key=lambda l: fg.variables[l].timestamp_ns, reverse=True)
    return xs[:number]


def set_solvable_old_poses(
    fg: FactorGraph,
    youngest: int = 10,
    oldest: int = 100,
    solvable: int = 0,
    filter_label: str = r"^x\d+$",
):
    """setSolvableOldPoses! (RobotUtils.jl:79-98): poses older than the
    ``youngest`` most-recent get their solvable flag set (fixed-lag
    disengage); poses beyond ``oldest`` are marginalized."""
    xs = sorted(
        fg.ls(filter_label), key=lambda l: int(re.search(r"\d+", l).group())
    )
    if len(xs) <= youngest:
        return []
    old = xs[:-youngest]
    for l in old:
        fg.set_solvable(l, solvable)
    for l in xs[:-oldest] if len(xs) > oldest else []:
        fg.set_marginalized(l, True)
    return old


def enable_solve_all_not_drt(fg: FactorGraph):
    """enableSolveAllNotDRT! (RobotUtils.jl:18-23): set solvable=1 on all
    variables/factors except dead-reckon-tether ones (label/tag DRT)."""
    for l, rec in fg.variables.items():
        if "drt" in l.lower() or "DRT" in rec.tags or "deadreckon" in l.lower():
            continue
        rec.solvable = 1
    for l, f in fg.factors.items():
        if "drt" in l.lower() or "DRT" in f.tags:
            continue
        f.solvable = 1


def init_factor_graph(
    fg: Optional[FactorGraph] = None,
    P0: Optional[np.ndarray] = None,
    init: Optional[np.ndarray] = None,
    pose_type=Pose2,
    label: str = "x0",
    solvable: int = 1,
):
    """initFactorGraph! (RobotUtils.jl:107-137): add the first pose with a
    prior at ``init`` with covariance ``P0``."""
    fg = fg or FactorGraph()
    vt = pose_type
    dof = vt.dof if hasattr(vt, "dof") else 3
    init = np.zeros(dof) if init is None else np.asarray(init, float)
    P0 = np.diag([0.03, 0.03, 0.001][:dof]) if P0 is None else np.asarray(P0, float)
    fg.add_variable(label, vt, solvable=solvable)
    fg.add_factor([label], PriorPose2(MvNormal(init, P0)), graphinit=fg.params.graphinit)
    return fg, [label]


def get_2d_samples(
    fg: FactorGraph,
    regex: str = r"^x\d+$",
    solve_key: str = "parametric",
):
    """get2DSamples analogue (RobotUtils.jl:175-204): stacked xy estimates
    for plotting/analysis. For the parametric solveKey this returns point
    estimates; for belief keys it returns particles."""
    xs, ys = [], []
    for l in fg.ls(regex):
        rec = fg.variables[l]
        if solve_key in rec.beliefs:
            pts = np.asarray(rec.beliefs[solve_key])
            xs.append(pts[:, 0])
            ys.append(pts[:, 1])
        elif solve_key in rec.points:
            p = np.asarray(rec.points[solve_key])
            xs.append(p[:1])
            ys.append(p[1:2])
    if not xs:
        return np.zeros(0), np.zeros(0)
    return np.concatenate(xs), np.concatenate(ys)


def get_2d_pose_means(fg: FactorGraph, regex: str = r"^x\d+$", solve_key="parametric"):
    """get2DPoseMeans analogue (RobotUtils.jl:291-313)."""
    out = {}
    for l in fg.ls(regex):
        if solve_key in fg.variables[l].points:
            out[l] = fg.get_coords(l, solve_key)
    return out


def _max_belief_coords(fg: FactorGraph, label: str, solve_key: str):
    """Max-density particle for belief solveKeys, point estimate otherwise."""
    rec = fg.variables[label]
    if solve_key in rec.beliefs:
        import torch

        from rome_tpu_torch.solvers.multimodal.kde import ManifoldKernelDensity

        mkd = ManifoldKernelDensity.from_points(
            rec.manifold,
            torch.as_tensor(np.asarray(rec.beliefs[solve_key]), dtype=torch.float32),
        )
        return rec.manifold.log(mkd.max_point()).numpy()
    if solve_key in rec.points:
        return fg.get_coords(label, solve_key)
    return None


def get_2d_pose_max(
    fg: FactorGraph, regex: str = r"^x\d+$", solve_key: str = "parametric"
):
    """get2DPoseMax analogue (RobotUtils.jl:291-313): per-pose max-belief
    (x, y, theta) arrays plus labels."""
    labels, xs, ys, ths = [], [], [], []
    for l in fg.ls(regex):
        c = _max_belief_coords(fg, l, solve_key)
        if c is None or len(c) < 3:
            continue
        labels.append(l)
        xs.append(float(c[0]))
        ys.append(float(c[1]))
        ths.append(float(c[2]))
    return labels, np.asarray(xs), np.asarray(ys), np.asarray(ths)


def get_2d_landm_max(
    fg: FactorGraph, regex: str = r"^l\d+$", solve_key: str = "parametric"
):
    """get2DLandmMax analogue (RobotUtils.jl:~315): max-belief landmark xy."""
    labels, xs, ys = [], [], []
    for l in fg.ls(regex):
        c = _max_belief_coords(fg, l, solve_key)
        if c is None or len(c) < 2:
            continue
        labels.append(l)
        xs.append(float(c[0]))
        ys.append(float(c[1]))
    return labels, np.asarray(xs), np.asarray(ys)


def add_linear_array_constraint(
    fg: FactorGraph,
    rangebearing,
    pose: str,
    landm: str,
    rangecov: float = 3e-4,
    bearingcov: float = 3e-4,
):
    """addLinearArrayConstraint analogue (RobotUtils.jl:383-401): add a
    DIDSON-style LinearRangeBearingElevation sonar factor between a pose and
    a landmark (creating the Point3 landmark if needed)."""
    from rome_tpu_torch.factors.sensors import LinearRangeBearingElevation
    from rome_tpu_torch.variables import Point3

    if not fg.exists(landm):
        fg.add_variable(landm, Point3)
    rho, theta = float(rangebearing[0]), float(rangebearing[1])
    fct = LinearRangeBearingElevation(
        (rho, math.sqrt(rangecov)), (theta, math.sqrt(bearingcov))
    )
    return fg.add_factor([pose, landm], fct)


def fifo_freeze(fg: FactorGraph, qfl: Optional[int] = None):
    """fifoFreeze! analogue (testFixedLagFG.jl:93): freeze all but the
    newest ``qfl`` poses (uses SolverParams.qfl when not given)."""
    qfl = qfl if qfl is not None else fg.params.qfl
    with annotate("fifo_freeze"):
        return set_solvable_old_poses(fg, youngest=qfl, oldest=10**9, solvable=0)


# reference-style aliases
getLastPoses = get_last_poses
setSolvableOldPoses = set_solvable_old_poses
enableSolveAllNotDRT = enable_solve_all_not_drt
initFactorGraph = init_factor_graph
get2DSamples = get_2d_samples
get2DPoseMeans = get_2d_pose_means
fifoFreeze = fifo_freeze
