"""Camera models, the pinhole projection factor and multiview
triangulation (counterpart of ``rome_tpu/vision/camera.py``).

The calibration and the legacy pinhole API are host numpy, copied from the
JAX package. ``GenericProjection`` (Pose3 x Point3 -> pixel, with the
front-of-camera penalty) is a registered factor type on the generic
linearize route. ``solve_multiview_landmark`` runs its ``retry`` restarts of
a damped Newton as one batched solve on the device: a (retry, 3) state, the
exact gradient and 3 x 3 Hessian of every restart in closed form and one
batched ``torch.linalg.solve_ex`` an iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, MvNormal
from rome_tpu_torch.factors.base import Factor, FactorType, gaussian_params, register_factor_type
from rome_tpu_torch.manifolds import quat as Q
from rome_tpu_torch.utils.device import entry_device
from rome_tpu_torch.utils.math import matvec
from rome_tpu_torch.variables import Point3, Pose3


# ------------------------------ camera models -------------------------------

@dataclass
class CameraCalibration:
    """Pinhole calibration (CameraModels.CameraCalibration analogue)."""

    height: int = 480
    width: int = 640
    fx: float = 510.0
    fy: float = 510.0
    cx: float = 320.0
    cy: float = 240.0
    skew: float = 0.0
    kc: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)  # radial/tangential distortion

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [
                [self.fx, self.skew, self.cx],
                [0.0, self.fy, self.cy],
                [0.0, 0.0, 1.0],
            ]
        )

    @classmethod
    def from_dict(cls, d: dict):
        """convert(CameraCalibration, dict) analogue
        (RoMECameraModelsExt.jl:18-26)."""
        K = np.asarray(d["K"], dtype=np.float64).reshape(3, 3)
        return cls(
            height=int(d.get("height", 480)),
            width=int(d.get("width", 640)),
            fx=K[0, 0],
            fy=K[1, 1],
            cx=K[0, 2],
            cy=K[1, 2],
            skew=K[0, 1],
            kc=tuple(d.get("kc", (0.0,) * 5)),
        )

    def undistort_point(self, px):
        """Iterative radial/tangential undistortion (identity for kc=0)."""
        px = np.asarray(px, dtype=np.float64).reshape(2)
        if not any(self.kc):
            return px
        k1, k2, p1, p2, k3 = self.kc
        x = (px[0] - self.cx) / self.fx
        y = (px[1] - self.cy) / self.fy
        x0, y0 = x, y
        for _ in range(8):
            r2 = x * x + y * y
            ic = 1.0 / (1 + r2 * (k1 + r2 * (k2 + r2 * k3)))
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x = (x0 - dx) * ic
            y = (y0 - dy) * ic
        return np.array([x * self.fx + self.cx, y * self.fy + self.cy])


# legacy pinhole API (CameraModel.jl:3-48)

@dataclass
class CameraIntrinsic:
    K: np.ndarray = field(
        default_factory=lambda: np.array(
            [[510.0, 0.0, 320.0], [0.0, 510.0, 240.0], [0.0, 0.0, 1.0]]
        )
    )


@dataclass
class CameraExtrinsic:
    """World in camera frame (cRw, ct)."""

    R: np.ndarray = field(default_factory=lambda: np.eye(3))
    t: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class CameraModelFull:
    ci: CameraIntrinsic = field(default_factory=CameraIntrinsic)
    ce: CameraExtrinsic = field(default_factory=CameraExtrinsic)


def project(cm: CameraModelFull, pt) -> np.ndarray:
    """Legacy pinhole projection (CameraModel.jl:22-33)."""
    res = cm.ci.K @ (cm.ce.R @ np.asarray(pt, dtype=np.float64) + cm.ce.t)
    return res[:2] / res[2]


def camera_residual(z, ci: CameraIntrinsic, ce: CameraExtrinsic, pt) -> np.ndarray:
    """cameraResidual! (CameraModel.jl:37-48): z - project(pt)."""
    return np.asarray(z, dtype=np.float64)[:2] - project(
        CameraModelFull(ci, ce), pt
    )


# --------------------------- projection factor ------------------------------

def _project_kernel(Kmat, pose, point):
    """Pixel projection and depth of a world point seen from a Pose3 camera,
    pose = (t[3], q[4]) world-from-camera, c_P = R^T (w_P - t). The depth
    comes back as a width-1 slice (..., 1)."""
    c_P = Q.qrotate(Q.qconj(pose[..., 3:7]), point - pose[..., :3])
    depth = c_P[..., 2:3]
    uvw = matvec(Kmat, c_P)
    w = uvw[..., 2:3]
    px = uvw[..., :2] / torch.where(w.abs() < 1e-9, torch.full_like(w, 1e-9), w)
    return px, depth


def _generic_projection_res(params, pose, point):
    # front-of-camera penalty plus the pixel error
    kappa = 0.001
    px, depth = _project_kernel(params["K"], pose, point)
    return params["z"] - px + kappa * (depth.abs() - depth) ** 2


GENERIC_PROJECTION = register_factor_type(
    FactorType(
        name="GenericProjection",
        variable_types=(Pose3, Point3),
        zdim=2,
        residual=_generic_projection_res,
        coord_types=("e", "e"),
        doc="Pinhole camera reprojection factor Pose3 -> Point3 with "
        "front-of-camera penalty (RoMECameraModelsExt.jl:33-60).",
    )
)


def GenericProjection(cam: CameraCalibration = None, Z: Distribution = None) -> Factor:
    cam = cam or CameraCalibration()
    Z = Z or MvNormal(np.zeros(2), np.eye(2) * 10.0)
    params = gaussian_params(Z.mean(), Z.cov())
    params["K"] = cam.K
    return Factor(ftype=GENERIC_PROJECTION, variables=(), params=params, dists=(Z,))


# ------------------------- multiview triangulation --------------------------

_KAPPA_MULTIVIEW = 1000.0  # the triangulation's front-of-camera penalty weight


def _multiview_terms(Kmat, Rt, t, pixels, x, derivs=True):
    """The triangulation cost of every restart x (B, 3) over the V views
    (camera-from-world rotations ``Rt`` (V, 3, 3), centres ``t`` (V, 3),
    measured ``pixels`` (V, 2)): the summed squared pixel error plus the
    front-of-camera penalty, and with ``derivs`` its exact gradient (B, 3)
    and Hessian (B, 3, 3) in closed form. Per view, c = Rt (x - t), the
    pixel u = (K c)[:2] / w with w = (K c)[2] (|w| clamped to 1e-9 as in
    ``_project_kernel``), r = pixel - u, g_i = du_i/dc = (K_i - u_i K_3) / w
    and d2u_i/dc2 = -(K_3 g_i^T + g_i K_3^T) / w; the penalty is
    kappa (|c_z| - c_z)^2. Returns (cost, grad, hess, least depth)."""
    c = torch.einsum("vij,bvj->bvi", Rt, x[:, None, :] - t)
    uvw = c @ Kmat.T
    w = uvw[..., 2]
    live = w.abs() >= 1e-9
    wc = torch.where(live, w, torch.full_like(w, 1e-9))
    u = uvw[..., :2] / wc[..., None]
    r = pixels - u
    depth = c[..., 2]
    neg = depth.abs() - depth
    cost = (r * r).sum((-1, -2)) + _KAPPA_MULTIVIEW * (neg * neg).sum(-1)
    mindepth = depth.min(dim=-1).values
    if not derivs:
        return cost, None, None, mindepth
    K3 = Kmat[2]
    G = (Kmat[:2] - u[..., None] * (K3 * live[..., None, None])) / wc[..., None, None]
    dsign = torch.sign(depth) - 1.0
    grad_c = -2.0 * torch.einsum("bvi,bvij->bvj", r, G)
    grad_c[..., 2] += 2.0 * _KAPPA_MULTIVIEW * neg * dsign
    rg = torch.einsum("bvi,bvij->bvj", r, G) * (live / wc)[..., None]
    hess_c = 2.0 * torch.einsum("bvij,bvik->bvjk", G, G) + 2.0 * (
        K3[:, None] * rg[..., None, :] + rg[..., :, None] * K3[None, :])
    hess_c[..., 2, 2] += 2.0 * _KAPPA_MULTIVIEW * dsign * dsign
    grad = torch.einsum("vji,bvj->bi", Rt, grad_c)
    hess = torch.einsum("vai,nvab,vbj->nij", Rt, hess_c, Rt)
    return cost, grad, hess, mindepth


def multiview_restarts(Kmat, poses, pixels, inits, iters):
    """Damped Newton from every row of ``inits`` (R, 3) at once: per
    restart, the exact gradient and Hessian of the summed squared pixel
    errors plus a front-of-camera penalty over the V views (``poses`` (V, 7),
    ``pixels`` (V, 2); ``_multiview_terms``), a step accepted only if it
    lowers the cost (damping halved, floor 1e-9) and else damped 4x more.
    Returns (x (R, 3), cost (R,), the least depth over the views (R,))."""
    Rt = Q.qto_matrix(poses[:, 3:7]).transpose(-1, -2)
    t = poses[:, :3]
    x = inits
    lam = torch.full((x.shape[0],), 1e-2, dtype=x.dtype, device=x.device)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        c, g, H, _d = _multiview_terms(Kmat, Rt, t, pixels, x)
        scale = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1).abs() / 3.0 + 1e-6
        step, _info = torch.linalg.solve_ex(H + (lam * scale)[:, None, None] * eye, g)
        x_new = x - step
        better = _multiview_terms(Kmat, Rt, t, pixels, x_new, derivs=False)[0] < c
        x = torch.where(better[:, None], x_new, x)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-9), lam * 4.0)
    c, _g, _H, mindepth = _multiview_terms(Kmat, Rt, t, pixels, x, derivs=False)
    return x, c, mindepth


def solve_multiview_landmark(
    fg,
    lmlb: str,
    cam: CameraCalibration = None,
    retry: int = 100,
    iters: int = 50,
    solve_key: str = "parametric",
    seed: int = 0,
    device="cuda",
):
    """solveMultiviewLandmark! analogue: triangulate a landmark from all its
    GenericProjection sightings. The ``retry`` restarts (the landmark's
    point plus ``retry`` times a standard normal draw from a
    ``torch.Generator`` seeded with ``seed``) run as ONE batched solve on
    ``device`` (:func:`multiview_restarts`) in float32; the depth-feasible
    restart of least cost wins. Writes the result into the landmark's solve
    data and returns it."""
    device = entry_device(device)
    lmlb = str(lmlb)
    cam = cam or CameraCalibration()
    poses, pixels = [], []
    for flb in fg.neighbors(lmlb):
        f = fg.factors[flb]
        if f.ftype.name != "GenericProjection":
            continue
        vl = [v for v in f.variables if v != lmlb][0]
        poses.append(np.asarray(fg.variables[vl].points[solve_key], np.float32))
        pixels.append(cam.undistort_point(f.params["z"]).astype(np.float32))
    if not poses:
        raise ValueError(f"{lmlb} has no GenericProjection factors")
    f32 = dict(dtype=torch.float32, device=device)
    rec = fg.variables[lmlb]
    base = rec.points.get(solve_key)
    base = rec.manifold.identity(torch.float32, device) if base is None else (
        torch.as_tensor(np.asarray(base, np.float32), **f32))
    gen = torch.Generator(device=device).manual_seed(seed)
    inits = base + float(retry) * torch.randn((retry, 3), generator=gen, **f32)
    xs, costs, mindepth = multiview_restarts(
        torch.as_tensor(cam.K, **f32), torch.as_tensor(np.stack(poses), **f32),
        torch.as_tensor(np.stack(pixels), **f32), inits, iters)
    feasible = mindepth > 0
    best = int(torch.argmin(torch.where(feasible, costs, torch.full_like(costs, np.inf))))
    if not bool(feasible[best]):
        raise ValueError("Unable to converge projection solution")
    w_P3 = xs[best].double().cpu().numpy()
    fg.set_point(lmlb, w_P3, solve_key)
    return w_P3


# reference-style alias
solveMultiviewLandmark = solve_multiview_landmark
