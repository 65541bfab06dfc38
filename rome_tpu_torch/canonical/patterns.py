"""Canonical pattern generators (counterpart of
``rome_tpu/canonical/patterns.py``): the Beehive walk, the Honeycomb, the
Helix and the Boxes.

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
from rome_tpu_torch.factors.point2 import Point2Point2
from rome_tpu_torch.factors.pose2 import Pose2Pose2
from rome_tpu_torch.graph.graph import FactorGraph, SolverParams
from rome_tpu_torch.utils.math import sym_rem_np
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


# -------------------------------- Helix -------------------------------------

def calc_helix_T(
    start: float,
    turns: float,
    posesperturn: int,
    radius: float = 10.0,
    spine_t: Callable = lambda t: 0 + 0j,
    xr_t: Optional[Callable] = None,
    yr_t: Optional[Callable] = None,
):
    """Algebraic helix pattern (the AMP calcHelix_T contract, exercised at
    GenerateHelix.jl:60): returns (t, xy (n,2), theta (n,)).

    Trajectory: p(t) = radius*[xr(t) + 1 - cos(2 pi t), yr(t) + sin(2 pi t)]
    with heading = angle of dp/dt (gradient by central difference ~1e-8, as
    the reference docstring notes).
    """
    xr = xr_t or (lambda t: np.real(spine_t(t)))
    yr = yr_t or (lambda t: np.imag(spine_t(t)))
    n = int(np.ceil((turns - start) * posesperturn)) + 1
    ts = start + np.arange(n) / posesperturn

    def pos(t):
        a = 2 * np.pi * t
        return np.stack(
            [radius * (xr(t) + 1.0 - np.cos(a)), radius * (yr(t) + np.sin(a))],
            axis=-1,
        )

    xy = pos(ts)
    h = 1e-8
    v = (pos(ts + h) - pos(ts - h)) / (2 * h)
    theta = np.arctan2(v[..., 1], v[..., 0])
    return ts, xy, theta


def generate_graph_helix2d(
    numposes: int = 40,
    posesperturn: int = 20,
    fg: Optional[FactorGraph] = None,
    solver_params: Optional[SolverParams] = None,
    radius: float = 10.0,
    spine_t: Callable = lambda t: 0 + 0j,
    xr_t: Optional[Callable] = None,
    yr_t: Optional[Callable] = None,
    mu0=(0.0, 0.0, np.pi / 2),
    Qd=None,
    postpose_cb: Optional[Callable] = None,
):
    """generateGraph_Helix2D! (GenerateHelix.jl:20-100). Can be called again
    on the same graph to extend it."""
    if fg is None:
        fg = FactorGraph(params=solver_params)
        if solver_params is None:
            fg.params.graphinit = False
    mu0 = np.asarray(mu0, dtype=np.float64)
    Qd = np.diag([0.1, 0.1, 0.05]) ** 2 if Qd is None else np.asarray(Qd)
    if "x0" not in fg.variables:
        generate_graph_zero_pose(fg=fg, var_type=Pose2, mu0=mu0, postpose_cb=postpose_cb)
        fg.set_ppe("x0", mu0, "simulated")

    posecount = _posecount(fg)
    lastpose = f"x{posecount}"

    turns = numposes / posesperturn
    ts, xy, th = calc_helix_T(
        0, turns, posesperturn, radius=radius, spine_t=spine_t, xr_t=xr_t, yr_t=yr_t
    )
    # world transform: rotate/translate so the pattern starts at mu0
    # (Tmu = SE2(mu0 - [0,0,pi/2]), GenerateHelix.jl:66)
    c0 = mu0[2] - np.pi / 2
    cc, ss = np.cos(c0), np.sin(c0)

    def tmu(p):
        return np.array(
            [
                mu0[0] + cc * p[0] - ss * p[1],
                mu0[1] + ss * p[0] + cc * p[1],
                sym_rem_np(p[2] + c0),
            ]
        )

    world = np.stack([tmu(np.array([xy[k, 0], xy[k, 1], th[k]])) for k in range(len(ts))])

    def se2_local(a, b):
        # body-frame delta a -> b
        ca, sa = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array(
            [ca * d[0] + sa * d[1], -sa * d[0] + ca * d[1], sym_rem_np(b[2] - a[2])]
        )

    oldpose = world[posecount] if posecount < len(world) else world[-1]
    for k in range(posecount + 1, len(world)):
        if numposes - 1 <= posecount:
            break
        newpose = world[k]
        deltaodo = se2_local(oldpose, newpose)
        factor = Pose2Pose2(MvNormal(deltaodo, Qd))
        posecount += 1
        v = _add_pose_canonical(
            fg,
            lastpose,
            posecount,
            factor,
            graphinit=fg.params.graphinit,
            override_ppe=newpose,
            postpose_cb=postpose_cb,
        )
        lastpose = v.label
        oldpose = newpose
    return fg


def generate_graph_helix2d_slew(
    numposes: int = 40, slew_x: float = 2 / 3, slew_y: float = 0.0, **kwargs
):
    """generateGraph_Helix2DSlew! (GenerateHelix.jl:117-121)."""
    return generate_graph_helix2d(
        numposes, spine_t=lambda t: slew_x * t + 1j * slew_y * t, **kwargs
    )


def generate_graph_helix2d_spiral(
    numposes: int = 100, rate_r: float = 0.6, rate_a: float = 6.0, **kwargs
):
    """generateGraph_Helix2DSpiral! (GenerateHelix.jl:139-143)."""
    return generate_graph_helix2d(
        numposes,
        spine_t=lambda t: rate_r * (np.maximum(t, 0.0) ** 0.5)
        * np.exp(1j * rate_a * (np.maximum(t, 0.0) ** 0.4)),
        **kwargs,
    )


# -------------------------------- Boxes -------------------------------------

def _calc_odo_box(leg: int, slew_x: float = 2 / 3, length_x: float = 15.0, length_y=None):
    """_calcOdoBox (GenerateBox.jl:40-65)."""
    length_y = length_x if length_y is None else length_y
    t = leg % 4
    if t == 0:
        return np.array([length_x, 0.0]), "POSITIVE_X"
    if t == 1:
        return np.array([0.0, length_y]), "POSITIVE_Y"
    if t == 2:
        return np.array([-slew_x * length_x, 0.0]), "NEGATIVE_X"
    return np.array([0.0, -length_y]), "NEGATIVE_Y"


def drive_leg(
    fg: FactorGraph,
    last_pose: str,
    odo,
    direction: str,
    Qd=None,
    postpose_cb: Optional[Callable] = None,
):
    """driveLeg! (GenerateBox.jl:70-100): Point2Point2 odometry leg."""
    Qd = np.eye(2) if Qd is None else np.asarray(Qd)
    new_count = int(_re.search(r"\d+", last_pose).group()) + 1
    factor = Point2Point2(MvNormal(np.asarray(odo, np.float64), Qd))
    v = _add_pose_canonical(
        fg,
        last_pose,
        new_count,
        factor,
        pose_type=Point2,
        graphinit=False,
        variable_tags=("POSE", direction),
        factor_tags=("ODOMETRY", direction),
        postpose_cb=postpose_cb,
    )
    return v.label


def drive_one_box(
    fg: FactorGraph,
    last_pose: Optional[str] = None,
    slew_x: float = 2 / 3,
    length_x: float = 15.0,
    length_y=None,
    postpose_cb: Optional[Callable] = None,
):
    """driveOneBox! (GenerateBox.jl:106-127)."""
    if last_pose is None:
        last_pose = f"x{_posecount(fg)}"
    for leg in range(4):
        odo, direction = _calc_odo_box(leg, slew_x=slew_x, length_x=length_x, length_y=length_y)
        last_pose = drive_leg(fg, last_pose, odo, direction, postpose_cb=postpose_cb)
    return last_pose


def generate_graph_boxes2d(
    numposes: int = 16,
    fg: Optional[FactorGraph] = None,
    graphinit: bool = False,
    length_x: float = 15.0,
    length_y=None,
    slew_x: float = 2 / 3,
    postpose_cb: Optional[Callable] = None,
):
    """generateGraph_Boxes2D! (GenerateBox.jl:142-166): Point2 box/slew
    patterns (NED convention, clockwise boxes slewed along x)."""
    if fg is None:
        fg = FactorGraph()
        fg.params.graphinit = graphinit
    generate_graph_zero_pose(
        fg=fg, var_type=Point2, postpose_cb=postpose_cb
    )
    fg.variables["x0"].tags = tuple(set(fg.variables["x0"].tags) | {"POSE"})
    numboxes = int(np.ceil(numposes / 4))
    for _ in range(numboxes):
        drive_one_box(
            fg, slew_x=slew_x, length_x=length_x, length_y=length_y,
            postpose_cb=postpose_cb,
        )
    return fg


# reference-style aliases
generateGraph_Beehive = generate_graph_beehive
generateGraph_Honeycomb = generate_graph_honeycomb
generateGraph_Helix2D = generate_graph_helix2d
generateGraph_Helix2DSlew = generate_graph_helix2d_slew
generateGraph_Helix2DSpiral = generate_graph_helix2d_spiral
generateGraph_Boxes2D = generate_graph_boxes2d
