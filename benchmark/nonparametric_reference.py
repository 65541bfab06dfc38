"""Plain float64 reference of the nonparametric (multimodal) solve of the
beehive graph: what ``rome_tpu_torch.solve_graph_nonparametric(fg,
engine="batched", init="points")`` computes, written straight from the
semantics in plain PyTorch, without kernels, caches, or batches of factors
of one type. It imports neither JAX nor ``rome_tpu`` nor ``rome_tpu_torch``.

The solve (IncrementalInference.jl's belief propagation over kernel
densities, as the port runs it):

1. the graph: ``beehive``, a numpy copy of RoME.jl's
   ``generateGraph_Beehive!`` (GenerateBeehive.jl:20-72; the port's
   ``canonical/patterns.generate_graph_beehive``), drawing from
   ``np.random.default_rng(seed)`` in the same order;
2. the seed beliefs: every variable's closed-form initial point (factors in
   creation order, each initializer run once its other variables are set)
   ⊞ N particles of kernel noise of std ``0.1 * inflation`` (5.0) per dof;
3. ``sweeps`` Jacobi sweeps. In each, every factor sends a message toward
   each of its variables from the beliefs at the sweep's start: N
   measurement samples z ~ N(mean, cov), each paired with particle n of the
   factor's other variables; the target starts at the factor's closed-form
   initializer of that slot where it has one, else at its own belief ⊞
   noise of std ``inflation * max(silverman, 1e-2)``; then 10 iterations of
   damped Gauss-Newton on the target's tangent (damping ``1e-3 * trace(H) /
   dof + 1e-6``) on the whitened residual. Then every variable's belief is
   the product of its messages' kernel densities (Silverman bandwidths,
   floored at 1e-5): labels drawn uniformly, ``gibbs_sweeps`` passes over
   the messages in which each message's label is drawn from the softmax of
   the Gaussian-product log-weights given the others' selected kernels
   (by inverse CDF), then the product mean of the selected kernels,
   linearized at the first message's kernel, plus noise of the product's
   std. A variable with one message samples its kernel density. A
   variable's messages are multiplied in the order the engine forms them:
   by factor type (types in the order of their first factor), then slot,
   then creation; the order moves the product's result (the first
   message's kernel is where the product is linearized, and a few Gibbs
   passes do not forget where they started).

Departures from the port and from the published description, on purpose:

- The draws are this file's own (one ``torch.Generator`` per solve, in its
  own order; the labels by inverse CDF, the port's by Gumbel-max), so a
  solve here equals the port's in distribution, never in value.
- Jacobians are central differences (step 1e-6) in float64; the port's are
  forward-mode AD in float32.
- Solves of different seeds may run side by side along a leading axis
  (``solve(seeds=[...])``): each keeps its own generator and nothing
  crosses the axis.
- Only what the beehive graph holds: PriorPose2, Pose2Pose2 and
  Pose2Point2BearingRange with Gaussian measurements; no nullhypo, no
  multihypo, no frozen variables.
- ``round_to`` (the control) rounds every input and every state the solve
  keeps (seed beliefs, measurement samples, each Gauss-Newton iterate,
  messages, bandwidths, products) to a lower precision.

    python tools/nonparametric_reference.py --poses 100 --N 100 --seeds 1 2
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch

DTYPE = torch.float64
INFLATION = 5.0
GN_ITERS, GN_DAMPING, JAC_STEP = 10, 1e-6, 1e-6
BW_FLOOR_MSG, BW_FLOOR_PRODUCT = 1e-2, 1e-5


# ---------------------------------------------------------------- the graph --

@dataclass
class Factor:
    kind: str            # "PriorPose2", "Pose2Pose2", "Pose2Point2BearingRange"
    labels: tuple        # variable labels, in slot order
    mean: np.ndarray     # (zdim,) measurement mean
    cov: np.ndarray      # (zdim, zdim) measurement covariance


@dataclass
class Graph:
    kinds: dict = field(default_factory=dict)       # label -> "Pose2" | "Point2", creation order
    factors: list = field(default_factory=list)     # Factor, creation order
    simulated: dict = field(default_factory=dict)   # label -> ground-truth point

    @property
    def labels(self):
        return list(self.kinds)


def _wrap_np(a):
    return np.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def _compose_np(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     _wrap_np(a[2] + b[2])])


def beehive(pose_count_target=100, seed=0, locality=1.0, atol=1.0):
    """generateGraph_Beehive!: x0 with a PriorPose2 at (0, 0, yaw0), yaw0 drawn
    from {0, -2pi/3, 2pi/3}; then legs of 10 m turning +-pi/3 (the direction
    switching with probability 1 / (1 + locality) before each leg), each new
    pose sighting a landmark at bearing 0, range 20 (sigmas 0.03 rad, 0.5 m);
    a sighting within ``atol`` of an existing landmark's true position is a
    re-sighting of it. Odometry sigmas 0.1 on each dof."""
    rng = np.random.default_rng(seed)
    g = Graph()
    yaw0 = float(rng.choice([0.0, -2 * np.pi / 3, 2 * np.pi / 3]))
    g.kinds["x0"] = "Pose2"
    g.factors.append(Factor("PriorPose2", ("x0",), np.array([0.0, 0.0, yaw0]),
                            np.diag(0.01 * np.ones(3))))
    g.simulated["x0"] = np.array([0.0, 0.0, _wrap_np(yaw0)])

    def sight(pose):
        p = g.simulated[pose]
        sim = p[:2] + 20.0 * np.array([math.cos(p[2]), math.sin(p[2])])
        label = None
        for lm, kind in g.kinds.items():
            if kind == "Point2" and np.linalg.norm(g.simulated[lm] - sim) < atol:
                label = lm
                break
        if label is None:
            label = "l" + pose[1:]
            g.kinds[label] = "Point2"
            g.simulated[label] = sim
        g.factors.append(Factor("Pose2Point2BearingRange", (pose, label),
                                np.array([0.0, 20.0]), np.diag([0.03 ** 2, 0.5 ** 2])))

    sight("x0")
    posecount = 0
    direction = "left" if rng.integers(1, 3) == 1 else "right"
    p_switch = 1.0 / (1.0 + locality)
    while posecount < pose_count_target:
        if rng.random() < p_switch:
            direction = "right" if direction == "left" else "left"
        z = np.array([10.0, 0.0, (1.0 if direction == "left" else -1.0) * np.pi / 3])
        prev, posecount = f"x{posecount}", posecount + 1
        new = f"x{posecount}"
        g.kinds[new] = "Pose2"
        g.factors.append(Factor("Pose2Pose2", (prev, new), z, np.diag([0.1, 0.1, 0.1]) ** 2))
        g.simulated[new] = _compose_np(g.simulated[prev], z)
        sight(new)
    return g


# --------------------------------------------------------------- manifolds --

def wrap(a):
    """Angles onto [-pi, pi)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


class SE2:
    """(x, y, theta); tangent (vx, vy, w) in the body frame:
    p ⊞ xi = (t + R(theta) v, theta + w); local(p, q) = (R(-theta_p)(t_q -
    t_p), wrap(theta_q - theta_p))."""

    dof = point_dim = 3

    @staticmethod
    def boxplus(p, xi):
        c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
        return torch.stack([p[..., 0] + c * xi[..., 0] - s * xi[..., 1],
                            p[..., 1] + s * xi[..., 0] + c * xi[..., 1],
                            wrap(p[..., 2] + xi[..., 2])], dim=-1)

    @staticmethod
    def local(p, q):
        c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
        dx, dy = q[..., 0] - p[..., 0], q[..., 1] - p[..., 1]
        return torch.stack([c * dx + s * dy, c * dy - s * dx, wrap(q[..., 2] - p[..., 2])],
                           dim=-1)

    @staticmethod
    def inverse(p):
        c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
        return torch.stack([-(c * p[..., 0] + s * p[..., 1]), s * p[..., 0] - c * p[..., 1],
                            wrap(-p[..., 2])], dim=-1)

    @staticmethod
    def normalize(p):
        return torch.cat([p[..., :2], wrap(p[..., 2:3])], dim=-1)


class Point2:
    dof = point_dim = 2

    @staticmethod
    def boxplus(p, xi):
        return p + xi

    @staticmethod
    def local(p, q):
        return q - p

    @staticmethod
    def normalize(p):
        return p


MANIFOLDS = {"Pose2": SE2, "Point2": Point2}


def manifold_mean(man, pts, iters=3):
    """Mean over the particle axis (-2): from the first particle, ``iters``
    steps of mu <- mu ⊞ mean(local(mu, p))."""
    mu = pts[..., 0, :]
    for _ in range(iters):
        mu = man.normalize(man.boxplus(mu, man.local(mu[..., None, :], pts).mean(dim=-2)))
    return mu


def silverman(man, pts):
    """Per-dof kernel std of a particle set (..., n, point_dim): the
    population std of the tangent spread about the mean, + 1e-6, times
    (4 / (dof + 2) / n) ** (1 / (dof + 4))."""
    n = pts.shape[-2]
    loc = man.local(manifold_mean(man, pts)[..., None, :], pts)
    std = torch.std(loc, dim=-2, correction=0) + 1e-6
    return std * (4.0 / (man.dof + 2.0) / max(n, 2)) ** (1.0 / (man.dof + 4.0))


# ----------------------------------------------------------------- factors --

def _exp_se2(z):
    return torch.cat([z[..., :2], wrap(z[..., 2:3])], dim=-1)


def residual(kind, z, pts):
    """The unwhitened residual of a factor at measurement z and its
    variables' points ``pts`` (slot order)."""
    if kind == "PriorPose2":
        return SE2.local(pts[0], _exp_se2(z))
    if kind == "Pose2Pose2":
        return SE2.local(pts[1], SE2.boxplus(pts[0], z))
    if kind == "Pose2Point2BearingRange":
        p, l = pts
        c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
        dx, dy = l[..., 0] - p[..., 0], l[..., 1] - p[..., 1]
        bx, by = c * dx + s * dy, c * dy - s * dx
        return torch.stack([wrap(z[..., 0] - torch.atan2(by, bx)),
                            z[..., 1] - torch.sqrt(bx * bx + by * by)], dim=-1)
    raise ValueError(f"no residual for {kind}")


def initializer(kind, slot, z, pts):
    """The closed-form value of slot ``slot`` from the other slots, or None."""
    if kind == "PriorPose2":
        return _exp_se2(z)
    if kind == "Pose2Pose2":
        if slot == 1:
            return SE2.boxplus(pts[0], z)
        return SE2.boxplus(pts[1], SE2.inverse(_exp_se2(z)))
    if kind == "Pose2Point2BearingRange" and slot == 1:
        p = pts[0]
        th = p[..., 2] + z[..., 0]
        return torch.stack([p[..., 0] + z[..., 1] * torch.cos(th),
                            p[..., 1] + z[..., 1] * torch.sin(th)], dim=-1)
    return None


def closed_form_init(g: Graph):
    """Every variable's initial point (float64 numpy): factors in creation
    order, each initializer run once its other variables are set, until no
    factor sets another; any left over at the identity."""
    pts = {}
    progress = True
    while progress and len(pts) < len(g.kinds):
        progress = False
        for f in g.factors:
            for slot, label in enumerate(f.labels):
                others = [v for k, v in enumerate(f.labels) if k != slot]
                if label in pts or not all(v in pts for v in others):
                    continue
                ins = [torch.as_tensor(pts.get(v, np.zeros(MANIFOLDS[g.kinds[v]].point_dim)))
                       for v in f.labels]
                x = initializer(f.kind, slot, torch.as_tensor(f.mean), ins)
                if x is not None:
                    pts[label] = MANIFOLDS[g.kinds[label]].normalize(x).numpy()
                    progress = True
    for label, kind in g.kinds.items():
        pts.setdefault(label, np.zeros(MANIFOLDS[kind].point_dim))
    return pts


# ----------------------------------------------------------- random draws --

class Draws:
    """One torch.Generator per solve; every draw is made for each solve from
    its own generator and stacked on a leading axis."""

    def __init__(self, seeds, device):
        self.gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
        self.device = device

    def normal(self, *shape):
        return torch.stack([torch.randn(shape, generator=g, dtype=DTYPE, device=self.device)
                            for g in self.gens])

    def uniform(self, *shape):
        return torch.stack([torch.rand(shape, generator=g, dtype=DTYPE, device=self.device)
                            for g in self.gens])

    def labels(self, n, count):
        return torch.stack([torch.randint(0, n, (count,), generator=g, device=self.device)
                            for g in self.gens])


# ------------------------------------------------------------------- solve --

def _whitener(cov):
    """S with S^T S = cov^-1 (the inverse Cholesky factor), and the factor
    L = chol(cov) that colours standard normal draws."""
    L = np.linalg.cholesky(0.5 * (cov + cov.T) + 1e-14 * np.eye(cov.shape[0]))
    return np.linalg.inv(L), L


def gauss_newton(kind, slot, man, z, S, pts, x, round_to):
    """10 iterations of damped Gauss-Newton on slot ``slot``'s tangent:
    z (B, N, zdim), pts the slots' (B, N, point_dim) points, x the start."""
    dof = man.dof
    steps = torch.cat([torch.zeros((1, dof), dtype=DTYPE, device=x.device),
                       JAC_STEP * torch.eye(dof, dtype=DTYPE, device=x.device),
                       -JAC_STEP * torch.eye(dof, dtype=DTYPE, device=x.device)])  # (E, dof)
    others = [p[..., None, :] for p in pts]
    eye = torch.eye(dof, dtype=DTYPE, device=x.device)
    for _ in range(GN_ITERS):
        xs = man.boxplus(x[..., None, :], steps)                           # (B, N, E, pdim)
        args = [xs if k == slot else o for k, o in enumerate(others)]
        r = torch.einsum("ij,...j->...i", S, residual(kind, z[..., None, :], args))
        r0, rp, rm = r[..., 0, :], r[..., 1:dof + 1, :], r[..., dof + 1:, :]
        J = ((rp - rm) / (2.0 * JAC_STEP)).transpose(-1, -2)              # (B, N, zdim, dof)
        H = J.transpose(-1, -2) @ J
        mu = 1e-3 * torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / dof + GN_DAMPING
        d = torch.linalg.solve(H + mu[..., None, None] * eye,
                               (J.transpose(-1, -2) @ r0[..., None])[..., 0])
        x = round_to(man.normalize(man.boxplus(x, -d)))
    return x


def message(f, slot, kinds, beliefs, draws, round_to):
    """The message of factor ``f`` toward its slot ``slot``: (B, N, point_dim)."""
    target = f.labels[slot]
    man = MANIFOLDS[kinds[target]]
    B, N, _ = beliefs[target].shape
    dev = beliefs[target].device
    pts = [beliefs[v] for v in f.labels]
    bw = silverman(man, pts[slot]).clamp_min(BW_FLOOR_MSG) * INFLATION            # (B, dof)
    x_infl = man.normalize(man.boxplus(pts[slot], draws.normal(N, man.dof) * bw[:, None, :]))
    S, L = (torch.as_tensor(a, dtype=DTYPE, device=dev) for a in _whitener(f.cov))
    z = round_to(torch.as_tensor(f.mean, dtype=DTYPE, device=dev)
                 + torch.einsum("ij,...j->...i", L, draws.normal(N, len(f.mean))))
    start = initializer(f.kind, slot, z, pts)
    x = round_to(x_infl if start is None else man.normalize(start))
    return gauss_newton(f.kind, slot, man, z, S, pts, x, round_to)


def log_weights(man, ref, mu, pts, var):
    """The Gibbs label scores of one density's kernels ``pts`` (B, Nj,
    point_dim), of variance ``var`` (B, dof) with the product of the others
    (mean ``mu`` (B, N, dof) in the tangent at ``ref`` (B, N, point_dim)):
    logw[b, n, j] = -0.5 * sum_d (local(ref[b, n], pts[b, j])_d - mu[b, n, d])^2
    / var[b, d]."""
    c = man.local(ref[:, :, None, :], pts[:, None, :, :])                        # (B, N, Nj, dof)
    return -0.5 * torch.sum((c - mu[:, :, None, :]) ** 2 / var[:, None, None, :], dim=-1)


def product(man, msgs, gibbs_sweeps, draws, round_to):
    """The Gibbs product of a variable's K messages, each (B, N, point_dim)."""
    K = len(msgs)
    B, N, _ = msgs[0].shape
    bws = [round_to(silverman(man, m).clamp_min(BW_FLOOR_PRODUCT)) for m in msgs]   # (B, dof)
    lam = [1.0 / (bw * bw) for bw in bws]
    labels = [draws.labels(N, N) for _ in msgs]                                  # (B, N) each
    rows = torch.arange(B, device=msgs[0].device)[:, None]

    def selected(k):
        return msgs[k][rows, labels[k]]                                          # (B, N, pdim)

    def estimate(include):
        ref = selected(include[0])
        num = sum(lam[k][:, None, :] * man.local(ref, selected(k)) for k in include)
        den = sum(lam[k] for k in include)
        return ref, num / den[:, None, :], den

    if K > 1:
        for _ in range(gibbs_sweeps):
            for j in range(K):
                ref, mu, prec = estimate([k for k in range(K) if k != j])
                logw = log_weights(man, ref, mu, msgs[j], 1.0 / prec + bws[j] * bws[j])
                cdf = torch.cumsum(torch.softmax(logw, dim=-1), dim=-1)
                u = draws.uniform(N, 1)
                labels[j] = torch.searchsorted(cdf, u * cdf[..., -1:])[..., 0].clamp_max(N - 1)
    ref, mu, prec = estimate(list(range(K)))
    noise = draws.normal(N, man.dof) * torch.sqrt(1.0 / prec)[:, None, :]
    return round_to(man.normalize(man.boxplus(ref, mu + noise)))


def message_order(g: Graph):
    """(factor, slot) of every message in the order a variable multiplies
    them: by factor type (types in the order of their first factor), then
    slot, then the factors' creation."""
    out = []
    for kind in dict.fromkeys(f.kind for f in g.factors):
        fs = [f for f in g.factors if f.kind == kind]
        out += [(f, slot) for slot in range(len(fs[0].labels)) for f in fs]
    return out


def _identity(a):
    return a


@contextlib.contextmanager
def _full_precision_matmuls():
    """TF32 off for the reference's float matrix products (restored after)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def solve(g: Graph, seeds, N=100, sweeps=3, gibbs_sweeps=3, device="cpu", round_to=None):
    """One solve per seed, side by side: {label: (len(seeds), N, point_dim)
    float64 beliefs} after ``sweeps`` Jacobi sweeps from the seeded
    closed-form init. ``round_to`` maps a float64 tensor to its value in a
    lower precision (the control); None keeps float64."""
    rt = round_to or _identity
    draws = Draws(seeds, device)
    B = len(seeds)
    with _full_precision_matmuls():
        init = closed_form_init(g)
        beliefs = {}
        for label, kind in g.kinds.items():      # in creation order, one draw each
            man = MANIFOLDS[kind]
            p = torch.as_tensor(init[label], dtype=DTYPE, device=device).expand(B, N, man.dof)
            eps = draws.normal(N, man.dof) * (0.1 * INFLATION)
            beliefs[label] = rt(man.normalize(man.boxplus(p, eps)))
        order = message_order(g)
        for _ in range(sweeps):
            msgs = {label: [] for label in g.kinds}
            for f, slot in order:
                msgs[f.labels[slot]].append(message(f, slot, g.kinds, beliefs, draws, rt))
            beliefs = {label: product(MANIFOLDS[g.kinds[label]], m, gibbs_sweeps, draws, rt)
                       if m else beliefs[label] for label, m in msgs.items()}
    return beliefs


def parametric_optimum(g: Graph, iters=10, tol=1e-9):
    """The float64 least-squares optimum of the graph's measurement means
    (Gauss-Newton from the closed-form init on the dense normal equations,
    central-difference Jacobians, until a step moves no coordinate by
    ``tol``): {label: point}."""
    init = closed_form_init(g)
    labels = g.labels
    offs, at = {}, 0
    for label in labels:
        offs[label] = at
        at += MANIFOLDS[g.kinds[label]].dof
    x = {label: torch.as_tensor(init[label], dtype=DTYPE) for label in labels}
    for _ in range(iters):
        Js, rs = [], []
        for f in g.factors:
            S = torch.as_tensor(_whitener(f.cov)[0], dtype=DTYPE)
            z = torch.as_tensor(f.mean, dtype=DTYPE)
            pts = [x[v] for v in f.labels]
            r0 = S @ residual(f.kind, z, pts)
            J = torch.zeros((len(r0), at), dtype=DTYPE)
            for slot, v in enumerate(f.labels):
                man = MANIFOLDS[g.kinds[v]]
                for d in range(man.dof):
                    e = torch.zeros(man.dof, dtype=DTYPE)
                    e[d] = JAC_STEP
                    rp = S @ residual(f.kind, z, [man.boxplus(p, e) if k == slot else p
                                                  for k, p in enumerate(pts)])
                    rm = S @ residual(f.kind, z, [man.boxplus(p, -e) if k == slot else p
                                                  for k, p in enumerate(pts)])
                    J[:, offs[v] + d] = (rp - rm) / (2.0 * JAC_STEP)
            Js.append(J)
            rs.append(r0)
        J, r = torch.cat(Js), torch.cat(rs)
        d = torch.linalg.solve(J.T @ J, J.T @ r)
        for label in labels:
            man = MANIFOLDS[g.kinds[label]]
            x[label] = man.normalize(man.boxplus(x[label], -d[offs[label]:offs[label] + man.dof]))
        if float(d.abs().max()) < tol:
            break
    return {label: p.numpy() for label, p in x.items()}


def bf16(t):
    """``t`` rounded to bfloat16 (nearest even), back in float64."""
    return t.to(torch.bfloat16).to(DTYPE)


if __name__ == "__main__":
    import argparse
    import time

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=100)
    ap.add_argument("--N", type=int, default=100)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    graph = beehive(pose_count_target=args.poses)
    t0 = time.perf_counter()
    out = solve(graph, args.seeds, N=args.N, device=args.device)
    opt = parametric_optimum(graph)
    err = np.mean([np.linalg.norm(out[v][:, :, :2].mean(dim=1).cpu().numpy() - opt[v][:2], axis=1)
                   for v in graph.labels if graph.kinds[v] == "Pose2"], axis=0)
    print(f"{len(graph.kinds)} variables, {len(graph.factors)} factors, "
          f"{time.perf_counter() - t0:.2f} s; mean pose error per seed {err.tolist()}")
