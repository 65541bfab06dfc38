"""Canonical pattern generators (counterpart of
``rome_tpu/canonical/patterns.py``): the Beehive walk and the Honeycomb.

Re-sighted landmarks merge by position against the ``simulated`` ground-truth
PPEs (``_check_variable_by_reference``). The walk draws from
``np.random.default_rng(seed)`` in the JAX package's order, so one seed gives
the same graph in both packages.
"""

from __future__ import annotations

import re as _re
from typing import Callable, Optional

import numpy as np

from rome_tpu_torch.canonical.generators import (
    _add_pose_canonical,
    generate_graph_zero_pose,
)
from rome_tpu_torch.distributions import MvNormal, Normal
from rome_tpu_torch.factors.bearing_range import Pose2Point2BearingRange
from rome_tpu_torch.factors.pose2 import Pose2Pose2
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.variables import Point2, Pose2


def _posecount(fg: FactorGraph, regex=r"^x\d+$") -> int:
    poses = fg.ls(regex)
    if not poses:
        return -1
    return max(int(_re.search(r"\d+", p).group()) for p in poses)


def _check_variable_by_reference(
    fg: FactorGraph, last_pose: str, factor, atol: float = 1.0,
    landmark_regex=r"^l\d+$",
):
    """Predict the sighted landmark's world position from the pose's
    simulated PPE and the measurement mean; an existing landmark whose
    simulated PPE lies within ``atol`` is a re-sighting (loop closure)."""
    ppe = fg.get_ppe(last_pose, "simulated")
    b = float(np.asarray(factor.dists[0].mean()).reshape(()))
    r = float(np.asarray(factor.dists[1].mean()).reshape(()))
    ang = ppe[2] + b
    sim = np.array([ppe[0] + r * np.cos(ang), ppe[1] + r * np.sin(ang)])
    for lm in fg.ls(landmark_regex):
        try:
            lppe = fg.get_ppe(lm, "simulated")
        except KeyError:
            continue
        if np.linalg.norm(np.asarray(lppe)[:2] - sim) < atol:
            return True, sim, lm
    src = int(_re.search(r"\d+", last_pose).group())
    return False, sim, f"l{src}"


def _add_landmark_beehive(
    fg: FactorGraph,
    last_pose: str,
    solvable: int = 1,
    graphinit: bool = True,
    atol: float = 1.0,
):
    """_addLandmarkBeehive! (GenerateHoneycomb.jl:59-100): sight a landmark
    at bearing 0 / range 20; create it or loop-close with perfect data
    association."""
    new_factor = Pose2Point2BearingRange(Normal(0, 0.03), Normal(20, 0.5))
    already, sim, gen_label = _check_variable_by_reference(
        fg, last_pose, new_factor, atol=atol
    )
    if not already:
        fg.add_variable(gen_label, Point2, solvable=solvable, tags=("LANDMARK",))
    fg.add_factor(
        [last_pose, gen_label], new_factor, solvable=solvable, graphinit=graphinit
    )
    if not already:
        fg.set_ppe(gen_label, sim, "simulated")
    return gen_label


def _drive_hex(
    fg: FactorGraph,
    posecount: int,
    pose_count_target=float("inf"),
    graphinit: bool = False,
    add_landmarks: bool = True,
    landmark_solvable: int = 1,
    atol: float = 1.0,
    postpose_cb: Optional[Callable] = None,
):
    """_driveHex! (GenerateHoneycomb.jl:103-132): six +pi/3 legs."""
    for i in range(posecount, posecount + 6):
        if pose_count_target <= posecount:
            break
        psym = f"x{i}"
        pp = Pose2Pose2(MvNormal([10.0, 0, np.pi / 3], np.diag([0.1, 0.1, 0.1]) ** 2))
        posecount += 1
        v = _add_pose_canonical(
            fg, psym, posecount, pp, graphinit=graphinit, postpose_cb=postpose_cb
        )
        if add_landmarks:
            _add_landmark_beehive(
                fg, v.label, solvable=landmark_solvable, atol=atol, graphinit=False
            )
    return posecount


def _offset_hex_leg(
    fg: FactorGraph,
    posecount: int,
    direction: str = "right",
    pose_count_target=float("inf"),
    graphinit: bool = False,
    add_landmarks: bool = True,
    landmark_solvable: int = 1,
    atol: float = 1.0,
    postpose_cb: Optional[Callable] = None,
):
    """_offsetHexLeg (GenerateHoneycomb.jl:134-170): one +/-pi/3 leg."""
    if pose_count_target <= posecount:
        return posecount
    dirsign = {"right": -1.0, "left": +1.0}.get(direction)
    if dirsign is None:
        raise ValueError(f"unknown direction symbol {direction}")
    psym = f"x{posecount}"
    pp = Pose2Pose2(
        MvNormal([10.0, 0, dirsign * np.pi / 3], np.diag([0.1, 0.1, 0.1]) ** 2)
    )
    posecount += 1
    v = _add_pose_canonical(
        fg, psym, posecount, pp, graphinit=graphinit, postpose_cb=postpose_cb
    )
    if add_landmarks:
        _add_landmark_beehive(
            fg, v.label, solvable=landmark_solvable, atol=atol, graphinit=False
        )
    return posecount


def generate_graph_beehive(
    pose_count_target: int = 10,
    fg: Optional[FactorGraph] = None,
    graphinit: bool = True,
    solvable: int = 1,
    add_landmarks: bool = True,
    landmark_solvable: int = 0,
    locality: float = 1.0,
    atol: float = 1.0,
    seed: int = 0,
    yaw0: Optional[float] = None,
    postpose_cb: Optional[Callable] = None,
):
    """generateGraph_Beehive! (GenerateBeehive.jl:20-72): stochastic
    honeycomb walk with loop-closure re-sighting of existing landmarks."""
    rng = np.random.default_rng(seed)
    if fg is None:
        fg = FactorGraph()
        fg.params.graphinit = graphinit
    posecount = _posecount(fg)
    if posecount < 0:
        if yaw0 is None:
            yaw0 = float(rng.choice([0.0, -2 * np.pi / 3, 2 * np.pi / 3]))
        generate_graph_zero_pose(
            fg=fg, var_type=Pose2, mu0=[0, 0, yaw0], postpose_cb=postpose_cb
        )
        if add_landmarks:
            _add_landmark_beehive(
                fg, "x0", solvable=landmark_solvable, atol=atol, graphinit=False
            )
        posecount = 0

    direction = "left" if rng.integers(1, 3) == 1 else "right"
    p_switch = 1.0 / (1.0 + locality)
    while posecount < pose_count_target:
        if rng.random() < p_switch:
            direction = "right" if direction == "left" else "left"
        posecount = _offset_hex_leg(
            fg,
            posecount,
            direction=direction,
            graphinit=graphinit,
            add_landmarks=add_landmarks,
            landmark_solvable=landmark_solvable,
            pose_count_target=pose_count_target,
            atol=atol,
            postpose_cb=postpose_cb,
        )
    for l in fg.ls():
        fg.set_solvable(l, solvable)
    for l in fg.lsf():
        fg.set_solvable(l, solvable)
    return fg


# pose offset legs of the deterministic honeycomb walk
# (GenerateHoneycomb.jl:46-49)
_HONEYCOMB_OFFSET_LEGS = {"x41": "left", "x63": "left", "x78": "left"}


def generate_graph_honeycomb(
    pose_count_target: int = 36,
    fg: Optional[FactorGraph] = None,
    graphinit: bool = False,
    direction: str = "right",
    solvable: int = 1,
    add_landmarks: bool = True,
    landmark_solvable: int = 0,
    atol: float = 1.0,
    postpose_cb: Optional[Callable] = None,
):
    """generateGraph_Honeycomb! (GenerateHoneycomb.jl:180-232): the
    deterministic honeycomb, landmarks merged by simulated-position match.
    Called again on the same graph, it grows it to ``pose_count_target``."""
    if fg is None:
        fg = FactorGraph()
        fg.params.graphinit = graphinit
    posecount = _posecount(fg)
    if posecount < 0:
        generate_graph_zero_pose(fg=fg, var_type=Pose2, postpose_cb=postpose_cb)
        if add_landmarks:
            _add_landmark_beehive(
                fg, "x0", solvable=landmark_solvable, atol=atol, graphinit=False
            )
        posecount = 0

    leg = dict(graphinit=graphinit, add_landmarks=add_landmarks,
               landmark_solvable=landmark_solvable, atol=atol,
               pose_count_target=pose_count_target, postpose_cb=postpose_cb)
    while posecount < pose_count_target:
        posecount = _drive_hex(fg, posecount, **leg)
        last_pose = f"x{posecount}"
        if last_pose in _HONEYCOMB_OFFSET_LEGS:
            posecount = _offset_hex_leg(
                fg, posecount, direction=_HONEYCOMB_OFFSET_LEGS[last_pose], **leg
            )
        posecount = _offset_hex_leg(fg, posecount, direction=direction, **leg)
    for l in fg.ls():
        fg.set_solvable(l, solvable)
    for l in fg.lsf():
        fg.set_solvable(l, solvable)
    return fg


# reference-style aliases
generateGraph_Beehive = generate_graph_beehive
generateGraph_Honeycomb = generate_graph_honeycomb
