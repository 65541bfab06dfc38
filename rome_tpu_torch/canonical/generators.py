"""Canonical graph generators (counterpart of
``rome_tpu/canonical/generators.py``): the zero pose, the pose chain, the
two-pose odometry graph, the circle and the hexagon.

Every generated pose carries a ``simulated`` ground-truth PPE, so tests can
compare solved estimates against noise-free trajectories. The ground truth
is propagated in float64 torch on the CPU.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np
import torch

from rome_tpu_torch.distributions import MvNormal, Normal
from rome_tpu_torch.factors.base import Factor
from rome_tpu_torch.factors.bearing_range import Pose2Point2BearingRange
from rome_tpu_torch.factors.point2 import PriorPoint2
from rome_tpu_torch.factors.point3 import PriorPoint3
from rome_tpu_torch.factors.pose2 import Pose2Pose2, PriorPose2
from rome_tpu_torch.factors.pose3 import PriorPose3
from rome_tpu_torch.graph.graph import FactorGraph, SolverParams
from rome_tpu_torch.variables import Point2, Pose2, get_variable_type


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64)


def _sim_compose(fg: FactorGraph, prev_label: Optional[str], factor: Factor, vtype):
    """Ground-truth propagation: sim_new = sim_prev ∘ exp(z) (relative) or
    exp(z) (prior)."""
    man = get_variable_type(vtype).manifold
    z = _f64(factor.params["z"])
    if factor.ftype.is_prior or prev_label is None:
        pt = man.exp(z)
    else:
        try:
            prev_pt = man.exp(_f64(fg.get_ppe(prev_label, "simulated")))
        except KeyError:
            prev_pt = man.identity(torch.float64)
        pt = man.compose(prev_pt, man.exp(z))
    return man.log(pt).numpy()


def _add_pose_canonical(
    fg: FactorGraph,
    prev_label: Optional[str],
    posecount: int,
    factor: Factor,
    gen_label: Optional[str] = None,
    pose_type=Pose2,
    graphinit: bool = True,
    solvable: int = 1,
    variable_tags=(),
    factor_tags=(),
    do_ref: bool = True,
    override_ppe=None,
    postpose_cb: Optional[Callable] = None,
):
    """_addPoseCanonical! analogue (GenerateCommon.jl:17-55)."""
    gen_label = gen_label or f"x{posecount}"
    fg.add_variable(gen_label, pose_type, tags=variable_tags, solvable=solvable)
    labels = [gen_label] if factor.ftype.is_prior else [prev_label, gen_label]
    fg.add_factor(labels, factor, graphinit=graphinit, solvable=solvable, tags=factor_tags)
    if do_ref:
        ppe = (
            np.asarray(override_ppe, dtype=np.float64)
            if override_ppe is not None
            else _sim_compose(fg, prev_label, factor, pose_type)
        )
        fg.set_ppe(gen_label, ppe, "simulated")
    if postpose_cb is not None:
        postpose_cb(fg, gen_label)
    return fg.get_variable(gen_label)


def generate_graph_zero_pose(
    var_type=Pose2,
    solver_params: Optional[SolverParams] = None,
    fg: Optional[FactorGraph] = None,
    label: str = "x0",
    mu0=None,
    sigma0=None,
    prior_factor: Optional[Factor] = None,
    solvable: int = 1,
    do_ref: bool = True,
    postpose_cb: Optional[Callable] = None,
):
    """generateGraph_ZeroPose (GenerateCommon.jl:70-102): one variable with a
    zero-mean MvNormal prior."""
    fg = fg or FactorGraph(params=solver_params)
    if label in fg.variables:
        return fg
    vt = get_variable_type(var_type)
    dof = vt.dof
    mu0 = np.zeros(dof) if mu0 is None else np.asarray(mu0, float)
    cov0 = np.diag(0.01 * np.ones(dof)) if sigma0 is None else np.asarray(sigma0, float)
    if prior_factor is None:
        if vt.name == "Pose2":
            prior_factor = PriorPose2(MvNormal(mu0, cov0))
        elif vt.name == "Point2":
            prior_factor = PriorPoint2(MvNormal(mu0, cov0))
        elif vt.name == "Pose3":
            prior_factor = PriorPose3(MvNormal(mu0, cov0))
        elif vt.name == "Point3":
            prior_factor = PriorPoint3(MvNormal(mu0, cov0))
        else:
            raise TypeError(f"no default prior for {vt.name}")
    _add_pose_canonical(
        fg, None, 0, prior_factor, gen_label=label, pose_type=vt,
        graphinit=fg.params.graphinit, solvable=solvable, do_ref=do_ref,
        postpose_cb=postpose_cb,
    )
    return fg


def build_graph_chain(
    fct_data=None,
    fct_type=Pose2Pose2,
    var_type=Pose2,
    fg: Optional[FactorGraph] = None,
    do_ref: bool = True,
    postpose_cb: Optional[Callable] = None,
):
    """buildGraphChain! (GenerateCommon.jl:117-163): chain of binary factors."""
    if fct_data is None:
        fct_data = [MvNormal([10, 0, 0.0], np.diag(0.1 * np.ones(3))) for _ in range(3)]
    fg = fg or generate_graph_zero_pose(var_type=var_type, do_ref=do_ref)
    poses = sorted(fg.ls(r"^x\d+$"), key=lambda s: int(re.search(r"\d+", s).group()))
    var_last = poses[-1]
    count = int(re.search(r"\d+", var_last).group())
    for dist in fct_data:
        count += 1
        cur = f"x{count}"
        _add_pose_canonical(
            fg, var_last, count, fct_type(dist), gen_label=cur,
            pose_type=var_type, graphinit=fg.params.graphinit, do_ref=do_ref,
            postpose_cb=postpose_cb,
        )
        var_last = cur
    return fg


def generate_graph_two_pose_odo(
    solver_params: Optional[SolverParams] = None,
    add_landmark: bool = True,
    do_ref: bool = True,
):
    """generateGraph_TwoPoseOdo (GenerateCommon.jl:179-203)."""
    fg = generate_graph_zero_pose(solver_params=solver_params, do_ref=do_ref)
    build_graph_chain(
        [MvNormal([10.0, 0, 0.0], np.diag([1.0, 1.0, 0.01]))], fg=fg, do_ref=do_ref
    )
    if add_landmark:
        fg.add_variable("l1", Point2)
        fg.add_factor(
            ["x1", "l1"],
            Pose2Point2BearingRange(Normal(0.0, 0.01), Normal(20.0, 1.0)),
            graphinit=fg.params.graphinit,
        )
    return fg


def generate_graph_circle(
    poses: int = 6,
    fg: Optional[FactorGraph] = None,
    offset_poses: Optional[int] = None,
    graphinit: bool = True,
    landmark: bool = True,
    loop_closure: bool = True,
    stop_early: int = 9999999,
    bias_turn: float = 0.0,
    kappa_odo: float = 1.0,
    cycle_poses: Optional[int] = None,
):
    """generateGraph_Circle (GenerateCircular.jl:31-94): drive ``poses`` legs
    of (10, 0, 2pi/cycle) odometry around a circle, with an optional landmark
    sighted from x0 and again (the loop closure) from the last pose."""
    fg = fg or FactorGraph()
    cycle_poses = cycle_poses or poses
    if offset_poses is None:
        offset_poses = max(len(fg.ls(r"^x\d+$")) - 1, 0)
    assert offset_poses < poses, "offsetPoses must be smaller than poses"

    if "x0" not in fg.variables:
        fg.add_variable("x0", Pose2)
        fg.add_factor(
            ["x0"],
            PriorPose2(MvNormal(np.zeros(3), 0.01 * np.eye(3))),
            graphinit=graphinit,
        )
        fg.set_ppe("x0", np.zeros(3), "simulated")

    for i in range(offset_poses, poses):
        if stop_early <= i:
            break
        psym, nsym = f"x{i}", f"x{i+1}"
        pp = Pose2Pose2(
            MvNormal(
                [10.0, 0, 2 * np.pi / cycle_poses + bias_turn],
                np.diag((kappa_odo * np.array([0.1, 0.1, 0.1])) ** 2),
            )
        )
        fg.add_variable(nsym, Pose2)
        fg.add_factor([psym, nsym], pp, graphinit=graphinit)
        fg.set_ppe(nsym, _sim_compose(fg, psym, fg.factors[fg._fct_order[-1]], Pose2),
                   "simulated")

    if not landmark:
        return fg
    if "l1" not in fg.variables:
        fg.add_variable("l1", Point2, tags=("LANDMARK",))
        fg.add_factor(
            ["x0", "l1"],
            Pose2Point2BearingRange(Normal(0, 0.1), Normal(20.0, 1.0)),
            graphinit=graphinit,
        )
        fg.set_ppe("l1", np.array([20.0, 0.0]), "simulated")

    if not loop_closure or f"x{poses}" not in fg.variables:
        return fg
    fg.add_factor(
        [f"x{poses}", "l1"],
        Pose2Point2BearingRange(Normal(0, 0.1), Normal(20.0, 1.0)),
        graphinit=graphinit,
    )
    return fg


def generate_graph_hexagonal(
    fg: Optional[FactorGraph] = None,
    landmark: bool = True,
    loop_closure: Optional[bool] = None,
    N: int = 100,
    graphinit: bool = True,
):
    """generateGraph_Hexagonal (GenerateHexagonal.jl:27-42): 7 poses, 1
    landmark, 6 odometry factors, 2 sightings; Circle(6)."""
    fg = fg or FactorGraph()
    fg.params.N = N
    if loop_closure is None:
        loop_closure = landmark
    return generate_graph_circle(
        6, fg=fg, graphinit=graphinit, landmark=landmark, loop_closure=loop_closure
    )


# reference-style aliases
generateGraph_ZeroPose = generate_graph_zero_pose
generateGraph_Circle = generate_graph_circle
generateGraph_Hexagonal = generate_graph_hexagonal
generateGraph_TwoPoseOdo = generate_graph_two_pose_odo
buildGraphChain = build_graph_chain
