"""g2o dataset import and export (counterpart of ``rome_tpu/io/g2o.py``).

Import: VERTEX_SE2, EDGE_SE2, VERTEX_SE3:QUAT, EDGE_SE3:QUAT and LANDMARK
lines, with the same information-matrix inversion and Hermitian repair as
the JAX package; the file's quaternion order (qx, qy, qz, qw) becomes the
internal (w, x, y, z), normalized; an SE3 edge's 21 upper-triangular
information values fill the 6x6 information matrix; a LANDMARK line keeps
its bearing-range cross term. Export: ``export_g2o`` writes the same text
as the JAX package's.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from rome_tpu_torch.distributions import MvNormal, Normal
from rome_tpu_torch.factors.bearing_range import Pose2Point2BearingRange
from rome_tpu_torch.factors.pose2 import Pose2Pose2
from rome_tpu_torch.factors.pose3 import Pose3Pose3
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.variables import Point2 as Point2V
from rome_tpu_torch.variables import Pose2 as Pose2V
from rome_tpu_torch.variables import Pose3 as Pose3V


def import_g2o(path: str):
    """Read every line of a g2o file into token lists."""
    instructions = []
    with open(path) as fh:
        for ln in fh:
            pieces = ln.split()
            if pieces:
                instructions.append(pieces)
    return instructions


def _info_to_cov(info: np.ndarray) -> np.ndarray:
    cov = np.linalg.inv(info)
    return 0.5 * (cov + cov.T)


def _se3_quat_wxyz(tokens_xyzw):
    qx, qy, qz, qw = (float(v) for v in tokens_xyzw)
    q = np.array([qw, qx, qy, qz])
    return q / np.linalg.norm(q)


def parse_g2o_instruction(
    fg: FactorGraph, tokens, initialize: bool = True
) -> FactorGraph:
    """Apply a single g2o instruction to the graph."""
    cmd = tokens[0]
    if cmd == "VERTEX_SE2":
        label = "x" + tokens[1]
        x, y, th = (float(v) for v in tokens[2:5])
        if label not in fg.variables:
            fg.add_variable(label, Pose2V)
        if initialize:
            fg.set_coords(label, [x, y, th], "parametric")
    elif cmd == "VERTEX_SE3:QUAT":
        label = "x" + tokens[1]
        t = [float(v) for v in tokens[2:5]]
        q = _se3_quat_wxyz(tokens[5:9])
        if label not in fg.variables:
            fg.add_variable(label, Pose3V)
        if initialize:
            fg.set_point(label, np.concatenate([t, q]), "parametric")
    elif cmd == "EDGE_SE2":
        a, b = "x" + tokens[1], "x" + tokens[2]
        mean = np.array([float(v) for v in tokens[3:6]])
        i11, i12, i13, i22, i23, i33 = (float(v) for v in tokens[6:12])
        info = np.array([[i11, i12, i13], [i12, i22, i23], [i13, i23, i33]])
        cov = _info_to_cov(info)
        for lbl in (a, b):
            if lbl not in fg.variables:
                fg.add_variable(lbl, Pose2V)
        fg.add_factor([a, b], Pose2Pose2(MvNormal(mean, cov)))
    elif cmd == "EDGE_SE3:QUAT":
        a, b = "x" + tokens[1], "x" + tokens[2]
        dt = np.array([float(v) for v in tokens[3:6]])
        q = _se3_quat_wxyz(tokens[6:10])
        rotvec = Q.qlog(torch.as_tensor(q, dtype=torch.float64)).numpy()
        vals = [float(v) for v in tokens[10:31]]
        info = np.zeros((6, 6))
        k = 0
        for i in range(6):
            for j in range(i, 6):
                info[i, j] = info[j, i] = vals[k]
                k += 1
        cov = _info_to_cov(info)
        for lbl in (a, b):
            if lbl not in fg.variables:
                fg.add_variable(lbl, Pose3V)
        fg.add_factor([a, b], Pose3Pose3(MvNormal(np.concatenate([dt, rotvec]), cov)))
    elif cmd == "LANDMARK":
        # landmark sighting: full (ib, ibr, ir) information including the
        # bearing-range cross term
        a, b = "x" + tokens[1], "l" + tokens[2]
        bearing, rng = float(tokens[3]), float(tokens[4])
        ib, ibr, ir = (float(v) for v in tokens[5:8])
        if a not in fg.variables:
            fg.add_variable(a, Pose2V)
        if b not in fg.variables:
            fg.add_variable(b, Point2V, tags=("LANDMARK",))
        info = np.array([[max(ib, 1e-12), ibr], [ibr, max(ir, 1e-12)]])
        cov = _info_to_cov(info)
        fg.add_factor(
            [a, b],
            Pose2Point2BearingRange(
                Normal(bearing, np.sqrt(cov[0, 0])),
                Normal(rng, np.sqrt(cov[1, 1])),
                cov=cov,
            ),
        )
    return fg


def load_g2o(
    fg: Optional[FactorGraph],
    path: str,
    initialize: bool = True,
    limit: Optional[int] = None,
) -> FactorGraph:
    """Import a whole g2o file into a graph."""
    if fg is None:
        fg = FactorGraph()
    # avoid O(n) graphinit sweeps per factor during bulk load
    saved = fg.params.graphinit
    fg.params.graphinit = False
    ins = import_g2o(path)
    if limit is not None:
        ins = ins[:limit]
    try:
        for tokens in ins:
            parse_g2o_instruction(fg, tokens, initialize=initialize)
    finally:
        fg.params.graphinit = saved
    return fg


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _fmt(x: float) -> str:
    return repr(float(x))


def _string_pose2pose2(f, ids) -> str:
    info = np.linalg.inv(np.asarray(f.dists[0].cov()))
    info[np.isinf(info)] = 0.0
    m = f.params["z"]
    return " ".join(
        ["EDGE_SE2", str(ids[0]), str(ids[1])]
        + [_fmt(v) for v in m[:3]]
        + [
            _fmt(info[0, 0]), _fmt(info[0, 1]), _fmt(info[0, 2]),
            _fmt(info[1, 1]), _fmt(info[1, 2]), _fmt(info[2, 2]),
        ]
    )


def _string_bearing_range(f, ids) -> str:
    # full information including the bearing-range cross term, from the
    # factor's whitening matrix: info = S^T S
    S = np.asarray(f.params["sqrt_info"])
    info = S.T @ S
    m = np.asarray(f.params["z"])
    return " ".join(
        ["LANDMARK", str(ids[0]), str(ids[1]),
         _fmt(m[0]), _fmt(m[1]),
         _fmt(info[0, 0]), _fmt(info[0, 1]), _fmt(info[1, 1])]
    )


def _string_pose3pose3(f, ids) -> str:
    info = np.linalg.inv(np.asarray(f.dists[0].cov()))
    info[np.isinf(info)] = 0.0
    m = f.params["z"]
    q = Q.qexp(torch.as_tensor(m[3:6], dtype=torch.float64)).numpy()  # w,x,y,z
    parts = ["EDGE_SE3:QUAT", str(ids[0]), str(ids[1])]
    parts += [_fmt(v) for v in m[:3]]
    parts += [_fmt(q[1]), _fmt(q[2]), _fmt(q[3]), _fmt(q[0])]
    for i in range(6):
        for j in range(i, 6):
            parts.append(_fmt(info[i, j]))
    return " ".join(parts)


_STRINGERS = {
    "Pose2Pose2": _string_pose2pose2,
    "MutablePose2Pose2Gaussian": _string_pose2pose2,
    "Pose2Point2BearingRange": _string_bearing_range,
    "Pose3Pose3": _string_pose3pose3,
}


def export_g2o(
    fg: FactorGraph,
    filename: Optional[str] = None,
    ignore_priors: bool = True,
    solve_key: Optional[str] = None,
    pose_regex: str = r"x\d",
) -> str:
    """Write the graph to g2o format: per-factor stringers, prior skipping,
    optional VERTEX lines from the given solveKey. ``filename`` defaults to
    ``rome_tpu_export.g2o`` in the temporary directory. Returns the path."""
    if filename is None:
        filename = os.path.join(tempfile.gettempdir(), "rome_tpu_export.g2o")
    var_ids: dict[str, int] = {}

    def vid(label: str) -> int:
        if label not in var_ids:
            var_ids[label] = len(var_ids)
        return var_ids[label]

    lines = []
    vertex_lines = []
    for flabel in fg._fct_order:
        f = fg.factors[flabel]
        if ignore_priors and f.ftype.is_prior:
            continue
        stringer = _STRINGERS.get(f.ftype.name)
        if stringer is None:
            continue
        ids = [vid(v) for v in f.variables]
        lines.append(stringer(f, ids))

    if solve_key is not None:
        for label, i in var_ids.items():
            rec = fg.variables[label]
            if rec.vtype.name == "Pose2":
                x, y, th = fg.get_coords(label, solve_key)
                vertex_lines.append(f"VERTEX_SE2 {i} {_fmt(x)} {_fmt(y)} {_fmt(th)}")
            elif rec.vtype.name == "Pose3":
                p = fg.get_point(label, solve_key)
                q = p[3:]
                vertex_lines.append(
                    "VERTEX_SE3:QUAT "
                    + " ".join(
                        [str(i)]
                        + [_fmt(v) for v in p[:3]]
                        + [_fmt(q[1]), _fmt(q[2]), _fmt(q[3]), _fmt(q[0])]
                    )
                )

    with open(filename, "w") as fh:
        for ln in vertex_lines + lines:
            fh.write(ln + "\n")
    return filename


# reference-style aliases
importG2o = import_g2o
exportG2o = export_g2o
parseG2oInstruction = parse_g2o_instruction
