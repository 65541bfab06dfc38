"""Scalar-field (DEM) support: terrain mesh graphs and level-set localization
(counterpart of ``rome_tpu/services/scalar_fields.py``).

Reference: ScalarFields.jl:12-64 (_buildGraphScalarField!),
ext/RoMEImageIOExt.jl:22-47 (generateField_CanyonDEM), and the IIF
LevelSetGridNormal + PartialPriorPassThrough usage in
test/testScalarFields.jl:44-56. The DEM is synthesized procedurally (the same
numpy construction as the JAX package's); a real DEM image loads through
``load_dem_image``.
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, MvNormal, _on
from rome_tpu_torch.factors.base import Factor, FactorType, gaussian_params, register_factor_type
from rome_tpu_torch.factors.point3 import Point3Point3
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.utils.device import entry_device
from rome_tpu_torch.variables import Point2, Point3, Pose2


# ------------------------- DEM fixtures / loading ---------------------------

def generate_field_canyon_dem(
    scale: float = 1.0,
    n: int = 100,
    x_is_north: bool = False,
    x_min: float = -9000.0,
    x_max: float = 9000.0,
    y_min: float = -9000.0,
    y_max: float = 9000.0,
    seed: int = 42,
):
    """Synthesize an 18x18 km canyon-like DEM at n x n resolution
    (generateField_CanyonDEM analogue, ext/RoMEImageIOExt.jl:22-47).

    Returns (x, y, img) with img[i, j] the height at (x[i], y[j]).
    """
    x = np.linspace(x_min, x_max, n)
    y = np.linspace(y_min, y_max, n)
    X, Y = np.meshgrid(x, y, indexing="ij")
    # a sinuous valley carved into smooth ridges
    u, v = X / (x_max - x_min), Y / (y_max - y_min)
    canyon = -np.exp(-((v - 0.18 * np.sin(2 * np.pi * u * 1.5)) ** 2) / 0.01)
    ridges = 0.35 * np.sin(2 * np.pi * u * 2.3) * np.cos(2 * np.pi * v * 1.7)
    rng = np.random.default_rng(seed)
    # smooth pseudo-random undulation from a few low-frequency modes
    for _ in range(6):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        ridges += 0.08 * np.sin(2 * np.pi * fx * u + px) * np.sin(2 * np.pi * fy * v + py)
    img = (canyon + ridges) * 400.0 * scale + 600.0
    if x_is_north:
        img = img.T.copy()
    return x, y, img.astype(np.float64)


def load_dem_image(path: str, x_span, y_span):
    """Load a grayscale image as a DEM over the given spans (ImageIO ext
    analogue; PIL is imported only here)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("F"), dtype=np.float64)
    x = np.linspace(x_span[0], x_span[1], img.shape[0])
    y = np.linspace(y_span[0], y_span[1], img.shape[1])
    return x, y, img


def dem_interp(x, y, img, device="cuda"):
    """Bilinear float32 interpolator h(px, py) over the regular grid, on
    ``device``; h takes tensors (or numbers) of any matching shape and
    interpolates elementwise."""
    entry_device(device)
    xj = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    yj = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=device)
    imgj = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device)
    dx = xj[1] - xj[0]
    dy = yj[1] - yj[0]

    def h(px, py):
        px = torch.as_tensor(px, dtype=torch.float32, device=device)
        py = torch.as_tensor(py, dtype=torch.float32, device=device)
        fi = torch.clamp((px - xj[0]) / dx, 0.0, xj.shape[0] - 1.001)
        fj = torch.clamp((py - yj[0]) / dy, 0.0, yj.shape[0] - 1.001)
        i0 = torch.floor(fi).to(torch.int64)
        j0 = torch.floor(fj).to(torch.int64)
        wi = fi - i0
        wj = fj - j0
        v00 = imgj[i0, j0]
        v10 = imgj[i0 + 1, j0]
        v01 = imgj[i0, j0 + 1]
        v11 = imgj[i0 + 1, j0 + 1]
        return (
            v00 * (1 - wi) * (1 - wj)
            + v10 * wi * (1 - wj)
            + v01 * (1 - wi) * wj
            + v11 * wi * wj
        )

    return h


# ------------------------- terrain mesh graph -------------------------------

def build_graph_scalar_field(
    fg: FactorGraph,
    dem: np.ndarray,
    x,
    y,
    solvable: int = 0,
    marginalized: bool = True,
    mesh_edge_sigma=None,
    ref_key: str = "simulated",
):
    """_buildGraphScalarField! analogue (ScalarFields.jl:12-64): grid of
    marginalized Point3 variables linked by relative Point3Point3 mesh
    factors along rows, columns, and diagonals."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    dem = np.asarray(dem, dtype=np.float64)
    sig = np.eye(3) if mesh_edge_sigma is None else np.asarray(mesh_edge_sigma)
    dx, dy = x[1] - x[0], y[1] - y[0]
    for i in range(len(x)):
        for j in range(len(y)):
            s = f"pt{i+1}_{j+1}"  # 1-based like the reference labels
            rec = fg.add_variable(s, Point3, solvable=solvable)
            rec.marginalized = marginalized
            ref = np.array([x[i], y[j], dem[i, j]])
            fg.set_ppe(s, ref, ref_key)
            fg.set_point(s, ref)
            if i > 0:
                dv = dem[i, j] - dem[i - 1, j]
                fg.add_factor(
                    [f"pt{i}_{j+1}", s],
                    Point3Point3(MvNormal([dx, 0, dv], sig)),
                    solvable=solvable,
                    graphinit=False,
                )
            if j > 0:
                dv = dem[i, j] - dem[i, j - 1]
                fg.add_factor(
                    [f"pt{i+1}_{j}", s],
                    Point3Point3(MvNormal([0, dy, dv], sig)),
                    solvable=solvable,
                    graphinit=False,
                )
            if i > 0 and j > 0:
                dv = dem[i, j] - dem[i - 1, j - 1]
                fg.add_factor(
                    [f"pt{i}_{j}", s],
                    Point3Point3(MvNormal([dx, dy, dv], sig)),
                    solvable=solvable,
                    graphinit=False,
                )


# --------------------- level-set localization prior -------------------------

class LevelSetGridNormal(Distribution):
    """Belief over 2D position given a scalar-field level measurement:
    w(x, y) proportional to N(level; img(x, y), sigma * sigma_scale)
    (IIF LevelSetGridNormal analogue used at testScalarFields.jl:52)."""

    def __init__(self, img, grid, level, sigma, sigma_scale: float = 1.0, N: int = 10000):
        self.img = np.asarray(img, dtype=np.float64)
        self.x = np.asarray(grid[0], dtype=np.float64)
        self.y = np.asarray(grid[1], dtype=np.float64)
        self.level = float(level)
        self.sigma = float(sigma)
        self.sigma_scale = float(sigma_scale)
        self.N = int(N)
        self.dim = 2
        s = self.sigma * self.sigma_scale
        w = np.exp(-0.5 * ((self.img - self.level) / s) ** 2)
        w = w / w.sum()
        self._w = w
        X, Y = np.meshgrid(self.x, self.y, indexing="ij")
        self._gridpts = np.stack([X.ravel(), Y.ravel()], axis=-1)
        self._flatw = w.ravel()
        m = self._flatw @ self._gridpts
        d = self._gridpts - m
        self._mean = m
        cell = np.diag([(self.x[1] - self.x[0]) ** 2, (self.y[1] - self.y[0]) ** 2]) / 12.0
        self._cov = (d * self._flatw[:, None]).T @ d + cell

    def mean(self):
        return self._mean.copy()

    def cov(self):
        return self._cov.copy()

    def sample(self, generator, n, device=None, dtype=torch.float32):
        """(n, 2) samples: a grid cell drawn by its weight (Gumbel-max, as
        ``jax.random.categorical``), jittered uniformly within the cell."""
        from rome_tpu_torch.solvers.multimodal.kde import categorical

        device = _on(generator, device)
        logits = torch.log(torch.as_tensor(self._flatw + 1e-30, dtype=torch.float32,
                                           device=device))
        idx = categorical(logits.expand(n, logits.shape[0]), generator)
        pts = torch.as_tensor(self._gridpts, dtype=torch.float32, device=device)[idx]
        cell = torch.tensor([self.x[1] - self.x[0], self.y[1] - self.y[0]],
                            dtype=torch.float32, device=device)
        jit = (torch.rand((n, 2), generator=generator, dtype=torch.float32,
                          device=device) - 0.5) * cell
        return (pts + jit).to(dtype)

    def __repr__(self):
        return f"LevelSetGridNormal(level={self.level}, sigma={self.sigma})"


def _ppt_pose2_res(params, p):
    return params["z"] - p[..., :2]


def _ppt_pose2_init(params, pts):
    # pass the sampled position through; keep the particle's own heading
    return torch.cat([params["z"], pts[0][..., 2:3]], dim=-1)


PARTIAL_PRIOR_PASSTHROUGH_POSE2 = register_factor_type(
    FactorType(
        name="PartialPriorPassThroughPose2",
        variable_types=(Pose2,),
        zdim=2,
        residual=_ppt_pose2_res,
        initializers={0: _ppt_pose2_init},
        coord_types=("e", "e"),
        partial=(0, 1),
        doc="Partial prior on Pose2 position whose belief passes through "
        "unmodified — the DEM level-set localization prior "
        "(testScalarFields.jl:52-55 PartialPriorPassThrough).",
    )
)


def _ppt_point2_res(params, p):
    return params["z"] - p


PARTIAL_PRIOR_PASSTHROUGH_POINT2 = register_factor_type(
    FactorType(
        name="PartialPriorPassThroughPoint2",
        variable_types=(Point2,),
        zdim=2,
        residual=_ppt_point2_res,
        initializers={0: lambda params, pts: params["z"]},
        coord_types=("e", "e"),
        doc="Point2 variant of the pass-through prior.",
    )
)


def PartialPriorPassThrough(belief: Distribution, partial=(1, 2), vtype="Pose2") -> Factor:
    """Prior that passes the belief's samples straight into the selected
    position dims. ``partial`` uses the reference's 1-based dims (1,2)."""
    if tuple(partial) != (1, 2):
        raise NotImplementedError("only position dims (1,2) are supported")
    ftype = (
        PARTIAL_PRIOR_PASSTHROUGH_POSE2
        if str(vtype) == "Pose2"
        else PARTIAL_PRIOR_PASSTHROUGH_POINT2
    )
    params = gaussian_params(belief.mean(), belief.cov())
    return Factor(ftype=ftype, variables=(), params=params, dists=(belief,))
