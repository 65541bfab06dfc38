"""g2o dataset import (counterpart of ``rome_tpu/io/g2o.py``) for SE(2)
pose graphs: VERTEX_SE2 and EDGE_SE2 lines, with the same information-matrix
inversion and Hermitian repair as the JAX package. SE(3) and landmark lines
raise until their factors are ported (ROADMAP slice B3)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from rome_tpu_torch.distributions import MvNormal
from rome_tpu_torch.factors.pose2 import Pose2Pose2
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.variables import Pose2 as Pose2V

_NOT_PORTED = ("VERTEX_SE3:QUAT", "EDGE_SE3:QUAT", "LANDMARK")


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
    elif cmd in _NOT_PORTED:
        raise NotImplementedError(
            f"g2o {cmd} lines need the SE(3) / bearing-range factors "
            "(ROADMAP slice B3)"
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

