"""Bearing-range prediction, Mahalanobis gating, simulation helpers and
graph-comparison tools (counterpart of ``rome_tpu/services/analysis.py``).

Host numpy, as in the JAX package; the manifold maps run as float64 torch
on the CPU. ``predict_variable_by_factor`` convolves through ``approx_conv``
on the device it is given (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, MvNormal, Normal
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.utils.device import entry_device
from rome_tpu_torch.utils.math import sym_rem_np


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# ----------------------- bearing-range prediction ---------------------------

def _best_coords(fg: FactorGraph, label: str, solve_key=None):
    """Max/mean belief coords of a variable: the mean of its particles'
    coordinates if it has a belief, else its point's coordinates."""
    rec = fg.variables[str(label)]
    keys = [solve_key] if solve_key else ["default", "parametric"]
    for k in keys:
        if k in rec.beliefs:
            return rec.manifold.log(_f64(rec.beliefs[k])).numpy().mean(axis=0)
    for k in keys + list(rec.points):
        if k in rec.points:
            return rec.manifold.log(_f64(rec.points[k])).numpy()
    raise KeyError(f"{label} has no belief or point")


def predict_body_br(fg: FactorGraph, a: str, b: str, solve_key=None):
    """predictBodyBR: (bearing, range) of variable b seen from pose a's body
    frame, at the current max beliefs."""
    A = _best_coords(fg, a, solve_key)
    B = _best_coords(fg, b, solve_key)
    dx, dy = B[0] - A[0], B[1] - A[1]
    c, s = np.cos(A[2]), np.sin(A[2])
    bx = c * dx + s * dy
    by = -s * dx + c * dy
    return float(np.arctan2(by, bx)), float(np.hypot(bx, by))


def mahalanobis_br(meas, pred, cov):
    """Mahalanobis distance between measured and predicted (bearing, range);
    the reference spells it ``malahanobisBR`` (kept as an alias below)."""
    res = np.asarray(meas, dtype=np.float64) - np.asarray(pred, dtype=np.float64)
    return float(np.sqrt(res @ np.linalg.solve(np.asarray(cov, dtype=np.float64), res)))


malahanobis_br = mahalanobis_br  # reference-parity alias (sic)


def calc_pose_point_bearing_range(pose, point):
    """calcPosePointBearingRange: (bearing, range) of a point from a pose."""
    pose = np.asarray(pose, dtype=np.float64).reshape(3)
    point = np.asarray(point, dtype=np.float64).reshape(2)
    dd = point - pose[:2]
    rng = float(np.linalg.norm(dd))
    the = float(sym_rem_np(np.arctan2(dd[1], dd[0]) - pose[2]))
    return the, rng


def predict_variable_by_factor(fg: FactorGraph, targetsym: str, fct, prevars,
                               device="cuda"):
    """predictVariableByFactor: evaluate a factor NOT yet in the graph by
    building a temporary graph and convolving through it on ``device``.
    Returns (current particles, predicted particles) as numpy arrays, for
    data-association decisions (multihypo gating)."""
    from rome_tpu_torch.solvers.multimodal.convolve import approx_conv

    entry_device(device)
    targetsym = str(targetsym)
    if targetsym not in [str(v) for v in prevars]:
        raise ValueError(f"{targetsym} is not among {list(prevars)}")
    tfg = FactorGraph()
    tfg.params.N = fg.params.N
    tfg.params.graphinit = False
    for var in prevars:
        var = str(var)
        rec = fg.variables[var]
        nrec = tfg.add_variable(var, rec.vtype, timestamp_ns=rec.timestamp_ns)
        if var != targetsym:
            nrec.points = dict(rec.points)
            nrec.beliefs = dict(rec.beliefs)
            nrec.initialized = dict(rec.initialized)
    f = tfg.add_factor([str(v) for v in prevars], fct, graphinit=False)
    pred = approx_conv(tfg, f.label, targetsym, device=device).cpu().numpy()
    rec = fg.variables[targetsym]
    if "default" in rec.beliefs:
        curr = np.asarray(rec.beliefs["default"])
    else:
        point = rec.points.get("parametric")
        if point is None:
            point = rec.manifold.identity(torch.float64).numpy()
        curr = np.broadcast_to(np.asarray(point), (fg.params.N, rec.vtype.point_dim))
    return curr, pred


# ----------------------------- simulation -----------------------------------

def sim_odo(
    fg_gt: FactorGraph,
    fg: FactorGraph,
    DX,
    noiserate=(6e-2, 6e-2, 3e-3),
    driftrate=(0.0, 0.0, 0.0),
    rng=None,
):
    """simOdo!: drive a ground-truth graph and its noisy twin with one
    odometry delta; returns the new pose label."""
    from rome_tpu_torch.factors.pose2 import Pose2Pose2
    from rome_tpu_torch.frontend.odometry import add_odo_fg

    rng = rng or np.random.default_rng()
    DX = np.asarray(DX, dtype=np.float64)
    r = float(np.linalg.norm(DX[:2]))
    add_odo_fg(fg_gt, Pose2Pose2(MvNormal(DX, np.eye(3) * 0.001)))
    nr = np.asarray(noiserate) * r
    cov = np.diag(np.maximum(nr, 1e-9) ** 2)
    DXn = DX + nr * rng.standard_normal(3) + r * np.asarray(driftrate)
    return add_odo_fg(fg, Pose2Pose2(MvNormal(DXn, cov)))


# ------------------------------ analysis ------------------------------------

def range_err_max_point2(fg1: FactorGraph, id1, fg2: FactorGraph, id2):
    """rangeErrMaxPoint2: the 2-D distance between two variables' beliefs."""
    a = _best_coords(fg1, id1)
    b = _best_coords(fg2, id2)
    return float(np.linalg.norm(a[:2] - b[:2]))


def range_comp_all_poses(fg1: FactorGraph, fg2: FactorGraph, regex=r"^x\d+$"):
    """rangeCompAllPoses: range_err_max_point2 of every pose in both graphs."""
    out = []
    for label in fg1.ls(regex):
        if label in fg2.variables:
            out.append(range_err_max_point2(fg1, label, fg2, label))
    return np.asarray(out)


def compare_density(a: Distribution, b: Distribution, tol: float = 1e-10) -> bool:
    """compareDensity: same family, same mean and covariance within tol."""
    if type(a) is not type(b):
        return False
    if isinstance(a, Normal):
        return abs(a.mu - b.mu) < tol and abs(a.sigma - b.sigma) < tol
    if isinstance(a, MvNormal):
        return (
            float(np.linalg.norm(a.mean() - b.mean())) < tol
            and float(np.abs(a.cov() - b.cov()).sum()) < tol
        )
    return bool(
        np.linalg.norm(np.asarray(a.mean()) - np.asarray(b.mean())) < tol
        and np.linalg.norm(np.asarray(a.cov()) - np.asarray(b.cov())) < tol
    )


# -------------------------- homography converters ---------------------------

def homography_to_coordinates(pHq):
    """SE(3) 4x4 homography -> hybrid coordinates [t(3), w(3)]."""
    pHq = np.asarray(pHq, dtype=np.float64)
    w = Q.qlog(Q.qfrom_matrix(_f64(pHq[:3, :3]))).numpy()
    return np.concatenate([pHq[:3, 3], w])


def coordinates_to_homography(pCq):
    """Hybrid coordinates [t(3), w(3)] -> SE(3) 4x4 homography."""
    pCq = np.asarray(pCq, dtype=np.float64).reshape(6)
    H = np.eye(4)
    H[:3, :3] = Q.qto_matrix(Q.qexp(_f64(pCq[3:6]))).numpy()
    H[:3, 3] = pCq[:3]
    return H


# reference-style aliases
predictBodyBR = predict_body_br
malahanobisBR = malahanobis_br
calcPosePointBearingRange = calc_pose_point_bearing_range
predictVariableByFactor = predict_variable_by_factor
simOdo = sim_odo
rangeErrMaxPoint2 = range_err_max_point2
rangeCompAllPoses = range_comp_all_poses
compareDensity = compare_density
