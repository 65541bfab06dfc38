"""Canonical graph generators (counterpart of
``rome_tpu/canonical/generators.py``; the parts the beehive needs).

Every generated pose carries a ``simulated`` ground-truth PPE, so tests can
compare solved estimates against noise-free trajectories. The ground truth
is propagated in float64 torch on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from rome_tpu_torch.distributions import MvNormal
from rome_tpu_torch.factors.base import Factor
from rome_tpu_torch.factors.pose2 import PriorPose2
from rome_tpu_torch.graph.graph import FactorGraph, SolverParams
from rome_tpu_torch.variables import Pose2, get_variable_type


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
        if vt.name != "Pose2":
            raise NotImplementedError(
                f"the default prior of {vt.name} is not ported yet (ROADMAP slice B)"
            )
        prior_factor = PriorPose2(MvNormal(mu0, cov0))
    _add_pose_canonical(
        fg, None, 0, prior_factor, gen_label=label, pose_type=vt,
        graphinit=fg.params.graphinit, solvable=solvable, do_ref=do_ref,
        postpose_cb=postpose_cb,
    )
    return fg
