"""SE(3) pose factors (counterpart of ``rome_tpu/factors/pose3.py``).

Points are (t[3], q[4]); tangent coords are (v[3], w[3]) — translation
first, as in the JAX package. The partial factors (PriorPose3ZRP,
Pose3Pose3XYYaw, Pose3Pose3Rotation) carry the dims of the last variable
they constrain in ``partial``.
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, MvNormal, Normal
from rome_tpu_torch.factors.base import (
    Factor,
    FactorType,
    gaussian_params,
    make_gaussian_factor,
    register_factor_type,
)
from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.manifolds.base import SE2_, SE3_, SO3_
from rome_tpu_torch.utils.math import safe_norm
from rome_tpu_torch.variables import Pose3, Rotation3

_SE3_COORDS = ("e",) * 3 + ("c",) * 3


def _default_p3_cov():
    return MvNormal(np.zeros(6), np.diag([0.01] * 3 + [0.0001] * 3))


# --- PriorPose3 (Pose3D.jl:9-19): vee(log(M, p, m)) ------------------------

def _prior_pose3_res(params, p):
    m = SE3_.exp(params["z"])
    return SE3_.local(p, m)


PRIOR_POSE3 = register_factor_type(
    FactorType(
        name="PriorPose3",
        variable_types=(Pose3,),
        zdim=6,
        residual=_prior_pose3_res,
        initializers={0: lambda params, pts: SE3_.exp(params["z"])},
        coord_types=_SE3_COORDS,
        doc="Full SE(3) unary prior (Pose3D.jl:9-19).",
    )
)


def PriorPose3(Z: Distribution = None):
    return make_gaussian_factor(PRIOR_POSE3, (), Z or _default_p3_cov())


# --- Pose3Pose3 (Pose3Pose3.jl:17-29): vee(log(M, q, p ∘ exp(X))) ----------

def _pose3pose3_res(params, p, q):
    qhat = SE3_.compose(p, SE3_.exp(params["z"]))
    return SE3_.local(q, qhat)


POSE3POSE3 = register_factor_type(
    FactorType(
        name="Pose3Pose3",
        variable_types=(Pose3, Pose3),
        zdim=6,
        residual=_pose3pose3_res,
        initializers={
            1: lambda params, pts: SE3_.compose(pts[0], SE3_.exp(params["z"])),
            0: lambda params, pts: SE3_.compose(
                pts[1], SE3_.inverse(SE3_.exp(params["z"]))
            ),
        },
        coord_types=_SE3_COORDS,
        doc="SE(3) odometry factor (Pose3Pose3.jl:9-29).",
    )
)


def Pose3Pose3(Z: Distribution = None):
    return make_gaussian_factor(POSE3POSE3, (), Z or _default_p3_cov())


# --- Pose3Pose3RotOffset (Pose3Pose3.jl:57-76) -----------------------------
# measurement frame a -> body frame b via an extra Rotation3 variable bRa.

def _pose3pose3_rotoffset_res(params, p, q, bRa):
    a_m = SE3_.exp(params["z"])  # (t, q) measurement in frame a
    b_rot = Q.qmul(bRa, a_m[..., 3:])
    b_m = torch.cat([a_m[..., :3], b_rot], dim=-1)
    qhat = SE3_.compose(p, b_m)
    return SE3_.local(q, qhat)


POSE3POSE3ROTOFFSET = register_factor_type(
    FactorType(
        name="Pose3Pose3RotOffset",
        variable_types=(Pose3, Pose3, Rotation3),
        zdim=6,
        residual=_pose3pose3_rotoffset_res,
        coord_types=_SE3_COORDS,
        doc="SE(3) odometry with an extra measurement-frame rotation "
        "variable bRa (Pose3Pose3.jl:57-76).",
    )
)


def Pose3Pose3RotOffset(Z: Distribution = None):
    return make_gaussian_factor(POSE3POSE3ROTOFFSET, (), Z or _default_p3_cov())


# --- Pose3Pose3Transform (Pose3Pose3.jl:80-96) -----------------------------
# an extra Pose3 variable Δ maps the measurement: q̂ = p ∘ (Δ ∘ exp(X)).

def _pose3pose3_transform_res(params, p, q, delta):
    dn = SE3_.compose(delta, SE3_.exp(params["z"]))
    qhat = SE3_.compose(p, dn)
    return SE3_.local(q, qhat)


POSE3POSE3TRANSFORM = register_factor_type(
    FactorType(
        name="Pose3Pose3Transform",
        variable_types=(Pose3, Pose3, Pose3),
        zdim=6,
        residual=_pose3pose3_transform_res,
        coord_types=_SE3_COORDS,
        doc="SE(3) odometry with an extra unknown transform variable "
        "(Pose3Pose3.jl:80-96).",
    )
)


def Pose3Pose3Transform(Z: Distribution = None):
    return make_gaussian_factor(POSE3POSE3TRANSFORM, (), Z or _default_p3_cov())


# --- Pose3Pose3UnitTrans (Pose3Pose3.jl:105-116) ---------------------------
# scale-free: the translation part of the error is normalized.

def _pose3pose3_unittrans_res(params, p, q):
    xc = _pose3pose3_res(params, p, q)
    t = xc[..., :3]
    tn = t / safe_norm(t)[..., None]
    return torch.cat([tn, xc[..., 3:]], dim=-1)


POSE3POSE3UNITTRANS = register_factor_type(
    FactorType(
        name="Pose3Pose3UnitTrans",
        variable_types=(Pose3, Pose3),
        zdim=6,
        residual=_pose3pose3_unittrans_res,
        coord_types=_SE3_COORDS,
        doc="Normalized-translation (scale-free) SE(3) factor "
        "(Pose3Pose3.jl:105-116).",
    )
)


def Pose3Pose3UnitTrans(Z: Distribution = None):
    return make_gaussian_factor(POSE3POSE3UNITTRANS, (), Z or _default_p3_cov())


# --- PriorRotation3: SO(3) prior --------------------------------------------

def _prior_rot3_res(params, r):
    m = SO3_.exp(params["z"])
    return SO3_.local(r, m)


PRIOR_ROTATION3 = register_factor_type(
    FactorType(
        name="PriorRotation3",
        variable_types=(Rotation3,),
        zdim=3,
        residual=_prior_rot3_res,
        initializers={0: lambda params, pts: SO3_.exp(params["z"])},
        coord_types=("c",) * 3,
        doc="SO(3) rotation prior.",
    )
)


def PriorRotation3(Z: Distribution = None):
    return make_gaussian_factor(
        PRIOR_ROTATION3, (), Z or MvNormal(np.zeros(3), np.diag([0.01] * 3))
    )


# ===========================================================================
# Partial Pose3 factors (reference: src/factors/PartialPose3.jl)
# ===========================================================================

def _prior_pose3zrp_res(params, p):
    # coords of p in the hybrid representation: [t(3), w(3)] with w = log(R);
    # the residual is on dims (2, 3, 4) == (z, wx, wy)
    w = Q.qlog(p[..., 3:7])
    c = torch.cat([p[..., 2:3], w[..., 0:2]], dim=-1)
    return params["z"] - c


PRIOR_POSE3ZRP = register_factor_type(
    FactorType(
        name="PriorPose3ZRP",
        variable_types=(Pose3,),
        zdim=3,
        residual=_prior_pose3zrp_res,
        coord_types=("e", "c", "c"),
        partial=(2, 3, 4),
        doc="Partial prior on (z, roll, pitch) of a Pose3, partial=(3,4,5) "
        "in the reference's 1-based indexing (PartialPose3.jl:12-46).",
    )
)


def PriorPose3ZRP(z: Distribution = None, rp: Distribution = None):
    """z: 1-dof height belief; rp: 2-dof (roll, pitch) belief. The (roll,
    pitch) mean maps through R = Ry(pitch) Rx(roll) to so(3) log coords, in
    float64 on the host."""
    z = z or Normal(0.0, 1.0)
    rp = rp or MvNormal(np.zeros(2), np.eye(2) * 0.01)
    r, p = np.asarray(rp.mean(), dtype=np.float64).reshape(2)
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    R = torch.as_tensor(Ry @ Rx, dtype=torch.float64)  # RotYX(pitch, roll)
    w = Q.qlog(Q.qfrom_matrix(R)).numpy()
    zmean = float(np.asarray(z.mean()).reshape(()))
    mean = np.array([zmean, w[0], w[1]])
    cov = np.zeros((3, 3))
    cov[0, 0] = float(np.asarray(z.cov()).reshape(()))
    cov[1:, 1:] = np.asarray(rp.cov(), dtype=np.float64)
    params = gaussian_params(mean, cov)
    return Factor(ftype=PRIOR_POSE3ZRP, variables=(), params=params, dists=(z, rp))


def _se2_of_pose3(p):
    """Project a Pose3 point onto SE(2) coords (x, y, yaw) by normalizing the
    first rotation column (PartialPose3.jl:119-129)."""
    R = Q.qto_matrix(p[..., 3:7])
    rx = R[..., 0:2, 0]
    rx = rx / torch.linalg.norm(rx, dim=-1, keepdim=True)
    yaw = torch.atan2(rx[..., 1:2], rx[..., 0:1])
    return torch.cat([p[..., 0:2], yaw], dim=-1)


def _pose3pose3xyyaw_res(params, p, q):
    p2 = _se2_of_pose3(p)
    q2 = _se2_of_pose3(q)
    qhat = SE2_.compose(p2, SE2_.exp(params["z"]))
    return SE2_.local(q2, qhat)


POSE3POSE3XYYAW = register_factor_type(
    FactorType(
        name="Pose3Pose3XYYaw",
        variable_types=(Pose3, Pose3),
        zdim=3,
        residual=_pose3pose3xyyaw_res,
        coord_types=("e", "e", "c"),
        partial=(0, 1, 5),
        doc="Partial SE(2)-projected factor between Pose3s, partial=(1,2,6) "
        "in the reference's 1-based indexing (PartialPose3.jl:101-136).",
    )
)


def Pose3Pose3XYYaw(Z: Distribution = None):
    return make_gaussian_factor(
        POSE3POSE3XYYAW, (), Z or MvNormal(np.zeros(3), np.diag([0.01, 0.01, 0.001]))
    )


def _pose3pose3rot_res(params, p, q):
    # relative rotation coords log(p^-1 q) on SO(3); res = z - Xc
    # (PartialPose3.jl:212-227)
    Xc = Q.qlog(Q.qmul(Q.qconj(p[..., 3:7]), q[..., 3:7]))
    return params["z"] - Xc


POSE3POSE3ROTATION = register_factor_type(
    FactorType(
        name="Pose3Pose3Rotation",
        variable_types=(Pose3, Pose3),
        zdim=3,
        residual=_pose3pose3rot_res,
        coord_types=("c", "c", "c"),
        partial=(3, 4, 5),
        doc="Rotation-only partial factor between Pose3s, partial=(4,5,6) "
        "in the reference's 1-based indexing (PartialPose3.jl:204-227).",
    )
)


def Pose3Pose3Rotation(Z: Distribution = None):
    return make_gaussian_factor(
        POSE3POSE3ROTATION, (), Z or MvNormal(np.zeros(3), np.eye(3) * 0.001)
    )
