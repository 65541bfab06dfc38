"""Batched nonparametric solve — the belief-propagation sweep over factor
batches (counterpart of ``rome_tpu/solvers/multimodal/batched.py``; its
Jacobi sweep with the points init).

One sweep is two batched stages over the same structure-of-arrays batches
the parametric path uses (graph/lower.py):

1. **Messages**: for every (factor batch, target slot) pair, sample a
   measurement per (factor, particle), seed the target from the factor's
   closed-form initializer or its inflated belief, and solve residual = 0
   by damped Gauss-Newton — one batch of n_factors * N particle solves.
2. **Products**: messages scatter into a padded (V, K_max, N, point_dim)
   tensor per variable type; a masked parallel-Gibbs KDE product runs over
   all V variables of the type at once, its pairwise scores in the CUDA
   kernels K2 (SE(2)) and K3 (per-dim manifolds), one launch per Gibbs
   label update.

Sweeps are Jacobi (all messages from the previous sweep's beliefs). Beliefs
and the lowering are float32 on the solver's device; random draws come from
one ``torch.Generator`` seeded by the solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rome_tpu_torch.distributions import MvNormal, Normal
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.graph.lower import GraphArrays, lower
from rome_tpu_torch.solvers.multimodal.convolve import _gn_solve_target
from rome_tpu_torch.solvers.multimodal.kde import (
    categorical,
    manifold_mean,
    pairwise_logw,
    silverman_bandwidth,
)
from rome_tpu_torch.utils.math import einsum


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP slice C)")


def _batch_is_gaussian(fg: FactorGraph, batch) -> bool:
    """A batch is SoA-sampleable when every factor's measurement is (a stack
    of) Gaussians whose joint covariance matches params['sqrt_info']."""
    if "sqrt_info" not in batch.params or "z" not in batch.params:
        return False
    zdim = batch.params["z"].shape[-1]
    if tuple(batch.params["sqrt_info"].shape[-2:]) != (zdim, zdim):
        return False
    return all(
        isinstance(d, (Normal, MvNormal))
        for lbl in batch.labels
        for d in fg.factors[lbl].dists
    )


@dataclass
class _Source:
    """One message stream: factor batch `b`, target slot `s`."""

    b: int
    s: int
    ttype: str                 # target variable type name
    dest_var: np.ndarray       # (n,) variable slot per factor row
    dest_k: np.ndarray         # (n,) position among the variable's messages
    dest_var_t: torch.Tensor   # the same two on the device
    dest_k_t: torch.Tensor


@dataclass
class BeliefPropagator:
    """Routing of one graph structure on one device (no compiled programs:
    PyTorch runs eagerly)."""

    N: int
    gibbs_sweeps: int
    sources: list
    kmax: dict                 # type -> K_max
    has_msg: dict              # type -> (V,) bool — any incoming message
    msg_factor: dict           # type -> (V, K) object array of factor labels ('' = none)
    has_msg_t: dict            # type -> (V,) float has_msg on the device


def _structure_signature(ga: GraphArrays, N: int, gibbs_sweeps: int):
    """Hashable key of everything the routing depends on: batch shapes,
    index routing, free masks and the device."""
    parts = [N, gibbs_sweeps, str(ga.device), tuple(ga.type_names)]
    for t in ga.type_names:
        parts.append((t, ga.counts[t], ga.free[t].cpu().numpy().tobytes()))
    for b in ga.batches:
        parts.append((
            b.ftype.name, b.n, b.vtypes, b.vslots.cpu().numpy().tobytes(),
            tuple(sorted(b.params)), tuple(b.labels),
        ))
    parts.append(tuple(ga.excluded_factors))
    return tuple(parts)


_PROPAGATOR_CACHE: dict = {}
_CACHE_LIMIT = 16


def get_propagator(fg: FactorGraph, ga: GraphArrays, N: int, gibbs_sweeps: int = 3):
    """Structure-cached propagator: graphs with identical lowered structure
    share one routing."""
    sig = _structure_signature(ga, N, gibbs_sweeps)
    bp = _PROPAGATOR_CACHE.get(sig)
    if bp is None:
        if len(_PROPAGATOR_CACHE) >= _CACHE_LIMIT:
            _PROPAGATOR_CACHE.clear()
        bp = _PROPAGATOR_CACHE[sig] = build_propagator(fg, ga, N, gibbs_sweeps)
    return bp


def build_propagator(fg: FactorGraph, ga: GraphArrays, N: int, gibbs_sweeps: int = 3):
    """Host-side routing: assign every factor→variable message a (variable,
    k) slot in the per-type padded product tensor."""
    if ga.excluded_factors or not all(_batch_is_gaussian(fg, b) for b in ga.batches):
        _not_ported("the per-factor fallback for multihypo and non-Gaussian factors")
    counters = {t: np.zeros(ga.counts[t], dtype=np.int64) for t in ga.type_names}
    sources = []
    for bi, b in enumerate(ga.batches):
        vsl = b.vslots.cpu().numpy()
        for s, t in enumerate(b.vtypes):
            dest_var = vsl[:, s].astype(np.int64)
            dest_k = np.empty_like(dest_var)
            for i, v in enumerate(dest_var):
                dest_k[i] = counters[t][v]
                counters[t][v] += 1
            sources.append(_Source(
                bi, s, t, dest_var, dest_k,
                torch.as_tensor(dest_var, device=ga.device),
                torch.as_tensor(dest_k, device=ga.device),
            ))

    kmax = {t: max(1, int(c.max()) if len(c) else 1) for t, c in counters.items()}
    has_msg = {t: counters[t] > 0 for t in ga.type_names}
    msg_factor = {
        t: np.full((ga.counts[t], kmax[t]), "", dtype=object) for t in ga.type_names
    }
    for src in sources:
        b = ga.batches[src.b]
        for i in range(b.n):
            lbl = b.labels[i] if i < len(b.labels) else None
            if lbl:
                msg_factor[src.ttype][src.dest_var[i], src.dest_k[i]] = lbl
    return BeliefPropagator(
        N=N, gibbs_sweeps=gibbs_sweeps, sources=sources, kmax=kmax,
        has_msg=has_msg, msg_factor=msg_factor,
        has_msg_t={
            t: torch.as_tensor(h, dtype=ga.dtype, device=ga.device)
            for t, h in has_msg.items()
        },
    )


def _pad_messages(bp: BeliefPropagator, ga: GraphArrays, beliefs, msgs):
    """Scatter the message streams into the per-type padded product tensors
    (a set, not an add). Padding rows hold the manifold identity, a valid
    point, so masked densities still evaluate finitely."""
    padded, masks = {}, {}
    for t in ga.type_names:
        if not bp.has_msg[t].any():
            continue
        man = ga.manifolds[t]
        pdim = beliefs[t].shape[-1]
        ident = man.identity(ga.dtype, ga.device)
        padded[t] = ident.expand(ga.counts[t], bp.kmax[t], bp.N, pdim).clone()
        masks[t] = torch.zeros((ga.counts[t], bp.kmax[t]), dtype=ga.dtype, device=ga.device)
    for src, m in zip(bp.sources, msgs):
        t = src.ttype
        padded[t][src.dest_var_t, src.dest_k_t] = m
        masks[t][src.dest_var_t, src.dest_k_t] = 1.0
    return padded, masks


def _sample_z(params, L, eps):
    """(n, N, zdim) Gaussian measurement samples z + L @ eps, for
    eps (n, N, zdim) standard normal and L = inv(sqrt_info) (cov = L L^T)."""
    return params["z"][:, None, :] + einsum("nij,nkj->nki", L, eps)


def _messages(bp: BeliefPropagator, ga: GraphArrays, beliefs, params_all, gen):
    """Every message stream of one sweep: a list of (n, N, point_dim)."""
    N, out = bp.N, []
    for src in bp.sources:
        b = ga.batches[src.b]
        params = params_all[src.b]
        mans = [ga.manifolds[vt] for vt in b.vtypes]
        tman = mans[src.s]
        pts = [beliefs[vt][b.vslots[:, k]] for k, vt in enumerate(b.vtypes)]  # (n, N, pdim)
        x0 = pts[src.s]
        # inflation noise around the current target belief
        bw = silverman_bandwidth(tman, x0)  # (n, dof)
        scale = bw.clamp_min(1e-2) * params["__inflation"][:, None]
        noise = torch.randn(
            (b.n, N, tman.dof), generator=gen, dtype=x0.dtype, device=x0.device
        ) * scale[:, None, :]
        x0_infl = tman.normalize(tman.boxplus(x0, noise))

        zdim = params["z"].shape[-1]
        eps = torch.randn((b.n, N, zdim), generator=gen, dtype=x0.dtype, device=x0.device)
        z = _sample_z(params, params["__L"], eps)

        # one batch of n * N particle solves
        M = b.n * N
        core = {
            k: v[:, None].expand(b.n, N, *v.shape[1:]).reshape(M, *v.shape[1:])
            for k, v in params.items() if not k.startswith("__")
        }
        z_f = z.reshape(M, zdim)
        pts_f = [p.reshape(M, p.shape[-1]) for p in pts]
        init_fn = b.ftype.initializers.get(src.s)
        if init_fn is not None:
            x_init = init_fn({**core, "z": z_f}, pts_f)
        else:
            x_init = x0_infl.reshape(M, -1)
        solved = _gn_solve_target(
            b.ftype, src.s, mans, z_f, core, pts_f, x_init
        ).reshape(b.n, N, -1)
        # nullhypo: a particle keeps its inflated prior with probability eta
        keep = torch.rand((b.n, N), generator=gen, dtype=x0.dtype, device=x0.device) \
            < params["__nullhypo"][:, None]
        solved = torch.where(keep[..., None], x0_infl, solved)
        out.append(tman.normalize(solved))
    return out


def _masked_gibbs(man, msgs, mask, gibbs_sweeps, gen):
    """Product of up to K kernel densities for each of V variables at once:
    msgs (V, K, N, pdim), mask (V, K) -> (V, N, pdim). Padded densities
    (mask 0) keep their labels and carry no weight."""
    V, K, N, pdim = msgs.shape
    dev = msgs.device
    bw = silverman_bandwidth(man, msgs).clamp_min(1e-5)   # (V, K, dof)
    lam = mask[..., None] / (bw * bw)                     # (V, K, dof) masked precisions
    labels = torch.randint(0, N, (V, K, N), generator=gen, device=dev)
    vidx = torch.arange(V, device=dev)
    logw_fn = pairwise_logw(man)

    def selected(labels):
        # (V, K, N, pdim): each density's chosen kernel per output particle
        return torch.gather(msgs, 2, labels[..., None].expand(V, K, N, pdim))

    def estimate(sel, inc):
        """Precision-weighted tangent mean of the included selections,
        linearized at the first included density's selection."""
        ref = sel[vidx, torch.argmax(inc, dim=1)]         # (V, N, pdim)
        c = man.local(ref[:, None], sel)                   # (V, K, N, dof)
        w = inc[..., None] * lam                           # (V, K, dof)
        num = torch.sum(w[:, :, None, :] * c, dim=1)       # (V, N, dof)
        den = torch.sum(w, dim=1)                          # (V, dof)
        return ref, num / den.clamp_min(1e-12)[:, None, :], den

    if K > 1:
        for i in range(gibbs_sweeps * K):
            j = i % K
            sel = selected(labels)
            inc = mask.clone()
            inc[:, j] = 0.0  # exclude j from the reference choice too
            ref, mu_c, prec = estimate(sel, inc)
            var = 1.0 / prec.clamp_min(1e-12) + bw[:, j] * bw[:, j]
            logw = logw_fn(
                ref.contiguous(), mu_c.contiguous(), msgs[:, j].contiguous(),
                (1.0 / var).contiguous(),
            )                                              # (V, N, Nj)
            new_j = categorical(logw, gen)
            labels[:, j] = torch.where(mask[:, j, None] > 0, new_j, labels[:, j])

    ref, mu_c, prec = estimate(selected(labels), mask)
    std = torch.sqrt(1.0 / prec.clamp_min(1e-12))
    eps = torch.randn(mu_c.shape, generator=gen, dtype=msgs.dtype, device=dev)
    return man.normalize(man.boxplus(ref, mu_c + eps * std[:, None, :]))


def _products(bp: BeliefPropagator, ga: GraphArrays, beliefs, padded, masks, gen):
    new_beliefs = dict(beliefs)
    for t in ga.type_names:
        if t not in padded:
            continue
        out = _masked_gibbs(ga.manifolds[t], padded[t], masks[t], bp.gibbs_sweeps, gen)
        # a variable updates only when it has >= 1 unmasked message and is
        # free; otherwise its belief passes through bit-identical
        upd = masks[t].amax(dim=1) * bp.has_msg_t[t] * ga.free[t]
        new_beliefs[t] = torch.where(upd[:, None, None] > 0, out, beliefs[t])
    return new_beliefs


class BatchedNonparametricSolver:
    """The batched Jacobi-sweep solve of one graph on one device."""

    def __init__(self, fg: FactorGraph, solve_key: str = "default", N=None,
                 gibbs_sweeps: int = 3, device="cpu"):
        self.fg = fg
        self.solve_key = solve_key
        self.N = N or fg.params.N
        self.ga = lower(fg, solve_key, device=device)
        self.bp = get_propagator(fg, self.ga, self.N, gibbs_sweeps)
        # per-batch params: core params + L = inv(sqrt_info) + per-factor data
        self._params_all = []
        for b in self.ga.batches:
            p = dict(b.params)
            p["__L"] = torch.linalg.inv(b.params["sqrt_info"])
            p["__nullhypo"] = b.nullhypo
            p["__inflation"] = b.inflation
            self._params_all.append(p)

    # -- beliefs <-> dense tensors -------------------------------------------
    def gather_beliefs(self):
        """{type: (V, N, point_dim)} on the device, from the records' beliefs
        (resized to N particles), else their points, else the identity."""
        out = {}
        for t in self.ga.type_names:
            man = self.ga.manifolds[t]
            pdim = man.point_dim
            buf = np.zeros((self.ga.counts[t], self.N, pdim), dtype=np.float64)
            for slot, lbl in enumerate(self.ga.var_labels[t]):
                rec = self.fg.variables[lbl]
                pts = rec.beliefs.get(self.solve_key)
                if pts is None:
                    p = rec.points.get(self.solve_key, rec.points.get("parametric"))
                    base = man.identity().numpy() if p is None else np.asarray(p, dtype=np.float64)
                    buf[slot] = np.broadcast_to(base, (self.N, pdim))
                else:
                    pts = np.asarray(pts, dtype=np.float64)
                    if pts.shape[0] != self.N:
                        pts = pts[np.resize(np.arange(pts.shape[0]), self.N)]
                    buf[slot] = pts
            out[t] = torch.as_tensor(buf).to(device=self.ga.device, dtype=self.ga.dtype)
        return out

    def scatter_beliefs(self, beliefs):
        for t in self.ga.type_names:
            arr = beliefs[t].cpu().numpy()  # one device fetch per type
            free = self.ga.free[t].cpu().numpy()
            for slot, lbl in enumerate(self.ga.var_labels[t]):
                if free[slot] == 0.0:
                    continue  # fixed-lag freeze: beliefs stay bit-identical
                rec = self.fg.variables[lbl]
                rec.beliefs[self.solve_key] = arr[slot]
                rec.initialized[self.solve_key] = True

    # -- one Jacobi sweep ----------------------------------------------------
    def sweep(self, beliefs, gen):
        """One belief-propagation sweep: messages, padding, Gibbs products."""
        msgs = _messages(self.bp, self.ga, beliefs, self._params_all, gen)
        padded, masks = _pad_messages(self.bp, self.ga, beliefs, msgs)
        return _products(self.bp, self.ga, beliefs, padded, masks, gen)

    def init_beliefs_from_points(self, gen, sigma: float = None):
        """Seed every belief as its point estimate ⊞ kernel noise, from the
        closed-form graph init (``init_all``)."""
        self.fg.init_all(self.solve_key)
        ga = self.ga
        sigma = float(sigma if sigma is not None else self.fg.params.inflation * 0.1)
        for t in ga.type_names:
            man = ga.manifolds[t]
            buf = np.stack([
                np.asarray(
                    self.fg.variables[lbl].points.get(self.solve_key, man.identity().numpy()),
                    dtype=np.float64,
                )
                for lbl in ga.var_labels[t]
            ])
            pts = torch.as_tensor(buf).to(device=ga.device, dtype=ga.dtype)  # (V, pdim)
            scale = torch.as_tensor(man.random_tangent_scale(), dtype=ga.dtype, device=ga.device)
            eps = torch.randn(
                (ga.counts[t], self.N, man.dof), generator=gen, dtype=ga.dtype, device=ga.device
            ) * sigma * scale
            arr = man.normalize(man.boxplus(pts[:, None, :], eps)).cpu().numpy()
            for slot, lbl in enumerate(ga.var_labels[t]):
                rec = self.fg.variables[lbl]
                rec.beliefs[self.solve_key] = arr[slot]
                rec.initialized[self.solve_key] = True

    def solve(self, sweeps: int = 3, seed: int = 2024, init=True):
        """``init``: "points" (seed from the graph init), or False (start from
        the beliefs on the records). ``init=True``, the particle graph init
        with Gauss-Seidel passes, is not ported yet."""
        if init is True:
            _not_ported("init=True (particle graph init and the Gauss-Seidel passes)")
        if init not in ("points", False):
            raise ValueError(f"unknown init {init!r}")
        gen = torch.Generator(device=self.ga.device)
        gen.manual_seed(int(seed))
        if init == "points":
            self.init_beliefs_from_points(gen)
        beliefs = self.gather_beliefs()
        for _ in range(sweeps):
            beliefs = self.sweep(beliefs, gen)
        self.scatter_beliefs(beliefs)
        # surface means as point estimates for PPE queries
        for t in self.ga.type_names:
            mus = manifold_mean(self.ga.manifolds[t], beliefs[t]).to(torch.float64).cpu().numpy()
            free = self.ga.free[t].cpu().numpy()
            for slot, lbl in enumerate(self.ga.var_labels[t]):
                if free[slot] == 0.0:
                    continue
                rec = self.fg.variables[lbl]
                rec.points[self.solve_key] = mus[slot]
                rec.initialized[self.solve_key] = True
        return self.fg
