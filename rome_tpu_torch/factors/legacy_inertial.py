"""Legacy 2015-era inertial preintegration factor, InertialPose3
(counterpart of ``rome_tpu/factors/legacy_inertial.py``; reference
InertialPose3.jl:4-313).

The zeta-embedding formulation: a 30-vector embedding of both 15-dof states
(position, Euler attitude, velocity, gyro bias, accel bias) mapped through
the L and C1 Taylor matrices to predict the preintegral delta, with a
15-dof residual against the preintegrated measurement. The reference
replaced it by IMUDeltaFactor in v0.24 but still ships it, and so does the
port. Importing this module registers the ``InertialPose3`` variable type.
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, MvNormal
from rome_tpu_torch.factors.base import Factor, FactorType, gaussian_params, register_factor_type
from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.manifolds.base import SO2_, T3, ProductGroup
from rome_tpu_torch.utils.math import matvec
from rome_tpu_torch.variables import VariableType, register_variable_type

# 15-coord legacy state: [pos(3), euler rpy(3, wrapped), vel(3), bw(3), ba(3)]
InertialPose3V = register_variable_type(
    VariableType(
        "InertialPose3",
        ProductGroup([T3, SO2_, SO2_, SO2_, T3, T3, T3], name="InertialPose3_M"),
    )
)

_GRADS = ("dRdDw", "dVdDw", "dPdDw", "dVdDa", "dPdDa")


def _euler_to_R(rpy):
    """TransformUtils Euler(roll, pitch, yaw) convention: R = Rz Ry Rx."""
    r, p, y = rpy[..., 0:1], rpy[..., 1:2], rpy[..., 2:3]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    m = torch.cat(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return m.reshape(*m.shape[:-1], 3, 3)


def _so3_log(R):
    """vee(log(R)) through the quaternion path."""
    return Q.qlog(Q.qfrom_matrix(R))


def _zeta_embedding(posei, posej, grav):
    """zetaEmbedding (InertialPose3.jl:61-74): 30-vector of both states."""
    Ri = _euler_to_R(posei[..., 3:6])
    Rj = _euler_to_R(posej[..., 3:6])
    dlog = _so3_log(Ri.transpose(-1, -2) @ Rj)
    return torch.cat(
        [
            dlog,                   # 1:3   log(Ri' Rj)
            posej[..., 9:12],       # 4:6   bwj
            posej[..., 6:9],        # 7:9   vj
            posej[..., 0:3],        # 10:12 pj
            posej[..., 12:15],      # 13:15 baj
            posei[..., 9:12],       # 16:18 bwi
            posei[..., 6:9],        # 19:21 vi
            posei[..., 0:3],        # 22:24 pi
            posei[..., 12:15],      # 25:27 bai
            grav,                   # 28:30
        ],
        dim=-1,
    )


def _block_matrix(blocks, like):
    """(..., 15, 30) matrix from {(block row, block col): (..., 3, 3)} on a
    5 x 10 grid of 3 x 3 blocks, zero elsewhere."""
    z = torch.zeros_like(like)
    rows = [torch.cat([blocks.get((i, j), z) for j in range(10)], dim=-1) for i in range(5)]
    return torch.cat(rows, dim=-2)


def _construct_L(biRw, Dt):
    """constructL (InertialPose3.jl:77-88); Dt of shape (..., 1, 1)."""
    eye = torch.eye(3, dtype=biRw.dtype, device=biRw.device).expand(biRw.shape)
    return _block_matrix(
        {(0, 0): eye, (2, 2): biRw, (3, 3): biRw, (2, 6): -biRw,
         (3, 6): -biRw * Dt, (3, 7): -biRw},
        biRw,
    )


def _construct_C1(biRw, picg, Dt):
    """constructC1 (InertialPose3.jl:91-107); Dt of shape (..., 1, 1)."""
    eye = torch.eye(3, dtype=biRw.dtype, device=biRw.device).expand(biRw.shape)
    g1 = -biRw * Dt
    return _block_matrix(
        {(1, 1): eye, (4, 4): eye, (1, 5): -eye, (4, 8): -eye,
         (2, 9): g1, (3, 9): 0.5 * g1 * Dt,
         (0, 5): picg["dRdDw"], (2, 5): picg["dVdDw"], (3, 5): picg["dPdDw"],
         (2, 8): picg["dVdDa"], (3, 8): picg["dPdDa"]},
        biRw,
    )


def _inertialpose3_res(params, posei, posej):
    """residual! (InertialPose3.jl:125-133): preintMeas - (L - C1) zeta."""
    zeta = _zeta_embedding(posei, posej, params["gravity"])
    biRw = _euler_to_R(posei[..., 3:6]).transpose(-1, -2)
    Dt = params["dt"][..., None, None]
    picg = {k: params[k] for k in _GRADS}
    LC = _construct_L(biRw, Dt) - _construct_C1(biRw, picg, Dt)
    return params["pi_meas"] - matvec(LC, zeta)


_IP3_COORDS = ("e",) * 3 + ("c",) * 3 + ("e",) * 9

INERTIAL_POSE3 = register_factor_type(
    FactorType(
        name="InertialPose3",
        variable_types=(InertialPose3V, InertialPose3V),
        zdim=15,
        residual=_inertialpose3_res,
        coord_types=_IP3_COORDS,
        doc="Legacy zeta-embedding inertial preintegration factor "
        "(InertialPose3.jl:125-133, 163-210).",
    )
)


def InertialPose3(Zij: Distribution, pioc: dict, picg: dict = None, gravity=(0, 0, 9.81)) -> Factor:
    """Build from preintegrated measurements: ``pioc`` holds rRp (3x3),
    rPosp, rVelp, pBw, pBa, and the interval seconds ``dt`` (rnTime*1e-9 in
    the reference); ``picg`` holds the five compensation-gradient 3x3 blocks
    (zeros if omitted)."""
    picg = picg or {}
    grads = {k: np.asarray(picg.get(k, np.zeros((3, 3))), dtype=np.float64) for k in _GRADS}
    rRp = np.asarray(pioc.get("rRp", np.eye(3)), dtype=np.float64)
    dlog = _so3_log(torch.as_tensor(rRp)).numpy()
    pi_meas = np.concatenate(
        [
            dlog,
            np.asarray(pioc.get("pBw", np.zeros(3)), np.float64),
            np.asarray(pioc.get("rVelp", np.zeros(3)), np.float64),
            np.asarray(pioc.get("rPosp", np.zeros(3)), np.float64),
            np.asarray(pioc.get("pBa", np.zeros(3)), np.float64),
        ]
    )
    params = gaussian_params(Zij.mean(), Zij.cov())
    params.update(
        pi_meas=pi_meas,
        dt=np.float64(pioc.get("dt", 0.0)),
        gravity=np.asarray(gravity, np.float64),
        **grads,
    )
    return Factor(ftype=INERTIAL_POSE3, variables=(), params=params, dists=(Zij,))


# --- PriorInertialPose3 (InertialPose3.jl:291-313) --------------------------

def _prior_ip3_res(params, x):
    M = InertialPose3V.manifold
    return M.local(x, M.exp(params["z"]))


PRIOR_INERTIAL_POSE3 = register_factor_type(
    FactorType(
        name="PriorInertialPose3",
        variable_types=(InertialPose3V,),
        zdim=15,
        residual=_prior_ip3_res,
        initializers={0: lambda params, pts: params["z"]},
        coord_types=_IP3_COORDS,
        doc="Prior on the legacy 15-dof inertial state "
        "(InertialPose3.jl:291-313).",
    )
)


def PriorInertialPose3(Zi: Distribution = None) -> Factor:
    Zi = Zi or MvNormal(np.zeros(15), np.eye(15) * 0.1)
    params = gaussian_params(Zi.mean(), Zi.cov())
    return Factor(ftype=PRIOR_INERTIAL_POSE3, variables=(), params=params, dists=(Zi,))
