"""Batched nonparametric solve — belief propagation over factor batches
(counterpart of ``rome_tpu/solvers/multimodal/batched.py``).

One Jacobi sweep is two batched stages over the same structure-of-arrays
batches the parametric path uses (graph/lower.py):

1. **Messages**: for every (factor batch, target slot) pair, sample a
   measurement per (factor, particle), seed the target from the factor's
   closed-form initializer or its inflated belief, and solve residual = 0
   by damped Gauss-Newton — one batch of n_factors * N particle solves.
   Factors the lowering cannot batch (multihypo data association,
   non-Gaussian measurements) take the per-factor ``approx_conv`` fallback,
   spliced into the same product tensors.
2. **Products**: messages scatter into a padded (V, K_max, N, point_dim)
   tensor per variable type; a masked parallel-Gibbs KDE product runs over
   all V variables of the type at once, its pairwise scores and Gumbel-max
   label draws in the CUDA kernels K2 (SE(2)) and K3 (per-dim manifolds and
   their products), one launch of the draw epilogue per Gibbs label update;
   the manifolds no kernel covers (SO(3), SE(3), ...) take the generic score
   in torch ops and the same draw.

The default schedule (``init=True``) first runs the particle graph init and
three sequential Gauss-Seidel passes over the chronological variable order
(``gs_pass``), so loop-closure corrections cross the whole graph before the
Jacobi sweeps, which move information one hop each. Beliefs and the
lowering are float32 on the solver's device; random draws come from one
``torch.Generator`` seeded by the solve. Each stage is a span of
``utils/profiling`` (``np.init``, ``np.sweep`` > ``np.messages`` and
``np.products``, ``np.write_back``); each batched particle solve counts
``np.gn_solves``, ``np.gn_rows`` and a ``np.gn_program.hit`` or ``.miss``
(``convolve.conv_particles``: one device program per message's shapes,
captured at its first call and replayed).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rome_tpu_torch.distributions import MvNormal, Normal
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.graph.lower import GraphArrays, lower, slots_of
from rome_tpu_torch.solvers.multimodal.convolve import approx_conv, conv_particles
from rome_tpu_torch.solvers.multimodal.kde import (
    manifold_mean,
    pairwise_draw,
    silverman_bandwidth,
)
from rome_tpu_torch.utils.device import entry_device
from rome_tpu_torch.utils.math import einsum
from rome_tpu_torch.utils.profiling import annotate
from rome_tpu_torch.utils.store import Store


def set_points_from_beliefs(fg: FactorGraph, labels, solve_key: str, device="cuda",
                            beliefs=None):
    """Surface each belief's manifold mean as the variable's point estimate.
    ``beliefs``: the labels' beliefs as one (V, N, point_dim) tensor of one
    variable type, rows in label order, whose means are taken in one call;
    otherwise each label's belief is read from its record."""
    if beliefs is None:
        entry_device(device)
        for label in labels:
            bel = torch.as_tensor(np.asarray(fg.variables[label].beliefs[solve_key]),
                                  device=device)
            set_points_from_beliefs(fg, [label], solve_key, beliefs=bel[None])
        return
    man = fg.variables[labels[0]].manifold
    mus = manifold_mean(man, beliefs).to(torch.float64).cpu().numpy()
    for label, mu in zip(labels, mus):
        rec = fg.variables[label]
        rec.points[solve_key] = mu
        rec.initialized[solve_key] = True


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
    fallback: list             # (factor_label, var_label, ttype, dest_var, dest_k)
    kmax: dict                 # type -> K_max
    has_msg: dict              # type -> (V,) bool — any incoming message
    msg_factor: dict           # type -> (V, K) object array of factor labels ('' = none)
    has_msg_t: dict            # type -> (V,) float has_msg on the device
    gs_routing: object = None  # Gauss-Seidel routing (lazy; False = n/a)


def _structure_signature(ga: GraphArrays, N: int, gibbs_sweeps: int):
    """Hashable key of everything the routing depends on: the connectivity
    (``GraphArrays.key``), the free masks, the batches' param names and
    labels, the excluded factors and the device."""
    return (N, gibbs_sweeps, str(ga.device), ga.key,
            tuple(ga.free[t].cpu().numpy().tobytes() for t in ga.type_names),
            tuple((tuple(sorted(b.params)), tuple(b.labels)) for b in ga.batches),
            tuple(ga.excluded_factors))


# structure signature -> BeliefPropagator
_PROPAGATOR_CACHE = Store("propagator", 16)


def get_propagator(fg: FactorGraph, ga: GraphArrays, N: int, gibbs_sweeps: int = 3):
    """Structure-cached propagator: graphs with identical lowered structure
    share one routing (at most 16 kept, ``_PROPAGATOR_CACHE``)."""
    return _PROPAGATOR_CACHE.get(_structure_signature(ga, N, gibbs_sweeps),
                                 lambda: build_propagator(fg, ga, N, gibbs_sweeps))


def build_propagator(fg: FactorGraph, ga: GraphArrays, N: int, gibbs_sweeps: int = 3):
    """Host-side routing: assign every factor→variable message a (variable,
    k) slot in the per-type padded product tensor."""
    counters = {t: np.zeros(ga.counts[t], dtype=np.int64) for t in ga.type_names}
    sources, fallback = [], []
    batchable = [_batch_is_gaussian(fg, b) for b in ga.batches]
    for bi, b in enumerate(ga.batches):
        if not batchable[bi]:
            continue
        vsl = slots_of(b.key)
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

    # per-factor fallback messages (multihypo / non-Gaussian batches)
    fb_factors = list(ga.excluded_factors) + [
        lbl for b, ok in zip(ga.batches, batchable) if not ok for lbl in b.labels
    ]
    for lbl in fb_factors:
        for v in fg.factors[lbl].variables:
            rec = fg.variables[v]
            t = rec.vtype.name
            k = counters[t][rec.slot]
            counters[t][rec.slot] += 1
            fallback.append((lbl, v, t, rec.slot, int(k)))

    kmax = {t: max(1, int(c.max()) if len(c) else 1) for t, c in counters.items()}
    has_msg = {t: counters[t] > 0 for t in ga.type_names}
    # (var, k) -> factor label, so tree schedules can mask message subsets
    msg_factor = {
        t: np.full((ga.counts[t], kmax[t]), "", dtype=object) for t in ga.type_names
    }
    for src in sources:
        b = ga.batches[src.b]
        for i in range(b.n):
            lbl = b.labels[i] if i < len(b.labels) else None
            if lbl:
                msg_factor[src.ttype][src.dest_var[i], src.dest_k[i]] = lbl
    for lbl, _v, t, vslot, k in fallback:
        msg_factor[t][vslot, k] = lbl
    return BeliefPropagator(
        N=N, gibbs_sweeps=gibbs_sweeps, sources=sources, fallback=fallback, kmax=kmax,
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


def _source_messages(bp: BeliefPropagator, ga: GraphArrays, src: _Source, beliefs, params,
                     gen, rows=None):
    """The messages of one stream, (n, N, point_dim): every factor row of the
    source's batch, or only ``rows`` (an int64 tensor of row indices)."""
    N = bp.N
    b = ga.batches[src.b]
    vslots = b.vslots
    if rows is not None:
        vslots = vslots[rows]
        params = {k: v[rows] for k, v in params.items()}
    n = vslots.shape[0]
    mans = [ga.manifolds[vt] for vt in b.vtypes]
    tman = mans[src.s]
    pts = [beliefs[vt][vslots[:, k]] for k, vt in enumerate(b.vtypes)]  # (n, N, pdim)
    x0 = pts[src.s]
    # inflation noise around the current target belief
    bw = silverman_bandwidth(tman, x0)  # (n, dof)
    scale = bw.clamp_min(1e-2) * params["__inflation"][:, None]
    noise = torch.randn(
        (n, N, tman.dof), generator=gen, dtype=x0.dtype, device=x0.device
    ) * scale[:, None, :]
    x0_infl = tman.normalize(tman.boxplus(x0, noise))

    zdim = params["z"].shape[-1]
    eps = torch.randn((n, N, zdim), generator=gen, dtype=x0.dtype, device=x0.device)
    z = _sample_z(params, params["__L"], eps)

    # one batch of n * N particle solves
    M = n * N
    core = {
        k: v[:, None].expand(n, N, *v.shape[1:]).reshape(M, *v.shape[1:])
        for k, v in params.items() if not k.startswith("__")
    }
    solved = conv_particles(
        b.ftype, src.s, mans, core, z.reshape(M, zdim), x0_infl.reshape(M, -1),
        [p.reshape(M, p.shape[-1]) for p in pts],
    ).reshape(n, N, -1)
    # nullhypo: a particle keeps its inflated prior with probability eta
    keep = torch.rand((n, N), generator=gen, dtype=x0.dtype, device=x0.device) \
        < params["__nullhypo"][:, None]
    solved = torch.where(keep[..., None], x0_infl, solved)
    return tman.normalize(solved)


def _messages(bp: BeliefPropagator, ga: GraphArrays, beliefs, params_all, gen):
    """Every batched message stream of one sweep: a list of (n, N, point_dim)."""
    return [_source_messages(bp, ga, src, beliefs, params_all[src.b], gen)
            for src in bp.sources]


def _masked_gibbs(man, msgs, mask, gibbs_sweeps, gen, rows=None):
    """Product of up to K kernel densities for each of V variables at once:
    msgs (V, K, N, pdim), mask (V, K) -> (V, N, pdim). Padded densities
    (mask 0) keep their labels and carry no weight.

    ``rows`` = (lo, V_all): the V variables are rows lo..lo+V-1 of V_all;
    every random draw is made for all V_all rows and these rows taken, so a
    variable's draws do not depend on how the rows are split."""
    V, K, N, pdim = msgs.shape
    lo, V_all = (0, V) if rows is None else rows
    dev = msgs.device

    def mine(x):
        return x[lo: lo + V]

    # (V, K, dof); with no rows (a rank holding none of the type) the draws
    # below are still made, so a shared stream stays in step
    bw = (silverman_bandwidth(man, msgs).clamp_min(1e-5) if V
          else msgs.new_zeros((0, K, man.dof)))
    lam = mask[..., None] / (bw * bw)                     # (V, K, dof) masked precisions
    labels = mine(torch.randint(0, N, (V_all, K, N), generator=gen, device=dev))
    vidx = torch.arange(V, device=dev)
    draw_fn = pairwise_draw(man)

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
            # the uniforms categorical() would draw for the (V, N, Nj) scores
            u = mine(torch.rand((V_all, N, N), generator=gen, dtype=torch.float32, device=dev))
            new_j = draw_fn(
                ref.contiguous(), mu_c.contiguous(), msgs[:, j].contiguous(),
                (1.0 / var).contiguous(), u,
            )                                              # (V, N)
            labels[:, j] = torch.where(mask[:, j, None] > 0, new_j, labels[:, j])

    ref, mu_c, prec = estimate(selected(labels), mask)
    std = torch.sqrt(1.0 / prec.clamp_min(1e-12))
    eps = mine(torch.randn((V_all,) + tuple(mu_c.shape[1:]), generator=gen, dtype=msgs.dtype,
                           device=dev))
    return man.normalize(man.boxplus(ref, mu_c + eps * std[:, None, :]))


def _products(bp: BeliefPropagator, ga: GraphArrays, beliefs, padded, masks, var_masks, gen):
    new_beliefs = dict(beliefs)
    for t in ga.type_names:
        if t not in padded:
            continue
        out = _masked_gibbs(ga.manifolds[t], padded[t], masks[t], bp.gibbs_sweeps, gen)
        # a variable updates only when it has >= 1 unmasked message, is free
        # and is selected by the schedule's var mask; otherwise its belief
        # passes through bit-identical (the tree's recycling contract)
        upd = masks[t].amax(dim=1) * bp.has_msg_t[t] * ga.free[t] * var_masks[t]
        new_beliefs[t] = torch.where(upd[:, None, None] > 0, out, beliefs[t])
    return new_beliefs


# ---------------- sequential (Gauss-Seidel) passes ---------------------------
# The reference's solveTree! is clique-by-clique belief propagation in
# elimination order (up) and back-substitution (down), so loop-closure
# information crosses the whole graph in one round trip; a Jacobi sweep
# moves it one hop. A Gauss-Seidel pass is the chain-ordered flattening of
# that up/down pass: the variables are visited one at a time in creation
# order (reversed for a backward pass), each re-producting its messages from
# the beliefs as they stand at that step. ``up_only`` keeps only messages
# whose other variables are all chronologically earlier (filtering).


def _build_gs_routing(bp: BeliefPropagator, fg: FactorGraph, ga: GraphArrays):
    """Host routing of a Gauss-Seidel pass: the global chronological order
    of (type id, slot) and per-type (V, K) maps from product slot k to the
    (type-local source index, row) that sends it, with the up-message mask.
    None when the graph has fallback factors (their messages are spliced per
    factor) or no batched source."""
    if bp.fallback or not bp.sources:
        return None
    tid_of = {t: i for i, t in enumerate(ga.type_names)}
    created = {lbl: i for i, lbl in enumerate(fg._var_order)}
    gidx = {t: np.zeros(ga.counts[t], np.int64) for t in ga.type_names}
    entries = []
    for t in ga.type_names:
        for slot, lbl in enumerate(ga.var_labels[t]):
            c = created.get(lbl)
            if c is None:
                return None
            gidx[t][slot] = c
            entries.append((c, tid_of[t], slot))
    entries.sort()
    order = np.array([(tid, slot) for _c, tid, slot in entries], np.int32)

    S = {t: [] for t in ga.type_names}      # per-type global source indices
    src_of = {t: np.full((ga.counts[t], bp.kmax[t]), -1, np.int32) for t in ga.type_names}
    row_of = {t: np.zeros((ga.counts[t], bp.kmax[t]), np.int32) for t in ga.type_names}
    up_of = {t: np.zeros((ga.counts[t], bp.kmax[t]), np.float32) for t in ga.type_names}
    for si_g, src in enumerate(bp.sources):
        t = src.ttype
        sidx = len(S[t])
        S[t].append(si_g)
        b = ga.batches[src.b]
        vsl = slots_of(b.key)
        for i in range(b.n):
            v, k = int(src.dest_var[i]), int(src.dest_k[i])
            src_of[t][v, k] = sidx
            row_of[t][v, k] = i
            tg = gidx[t][v]
            up = all(
                gidx[b.vtypes[s2]][vsl[i, s2]] < tg
                for s2 in range(len(b.vtypes))
                if s2 != src.s
            )
            up_of[t][v, k] = 1.0 if up else 0.0
    return dict(order=order, S=S, src_of=src_of, row_of=row_of, up_of=up_of)


class BatchedNonparametricSolver:
    """The batched belief-propagation solve of one graph on one device."""

    def __init__(self, fg: FactorGraph, solve_key: str = "default", N=None,
                 gibbs_sweeps: int = 3, device="cuda"):
        self.fg = fg
        self.solve_key = solve_key
        self.N = N or fg.params.N
        self.ga = lower(fg, solve_key, device=device)
        self.bp = get_propagator(fg, self.ga, self.N, gibbs_sweeps)
        # per-batch params: core params + L = inv(sqrt_info) + per-factor data
        self._params_all = []
        for b in self.ga.batches:
            p = dict(b.params)
            if "sqrt_info" in b.params:
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
    def sweep(self, beliefs, gen, var_masks=None, msg_masks=None):
        """One belief-propagation sweep: messages, padding, the per-factor
        fallback messages, Gibbs products. ``var_masks`` / ``msg_masks``
        (optional {type: (V,)} / {type: (V, K)} arrays) let a tree schedule
        update only selected variables from a restricted message set."""
        bp, ga = self.bp, self.ga
        with annotate("np.messages"):
            msgs = _messages(bp, ga, beliefs, self._params_all, gen)
            padded, masks = _pad_messages(bp, ga, beliefs, msgs)
            if bp.fallback:
                self.scatter_beliefs(beliefs)  # the fallback reads the records
                for flbl, vlbl, t, vslot, k in bp.fallback:
                    m = approx_conv(self.fg, flbl, vlbl, self.solve_key, gen=gen, N=self.N,
                                    device=ga.device)
                    padded[t][vslot, k] = m.to(ga.dtype)
                    masks[t][vslot, k] = 1.0
        if msg_masks is not None:
            masks = {t: masks[t] * self._tensor(msg_masks[t]) for t in masks}
        var_masks = {
            t: self._tensor(var_masks[t]) if var_masks is not None
            else torch.ones((ga.counts[t],), dtype=ga.dtype, device=ga.device)
            for t in padded
        }
        with annotate("np.products"):
            return _products(bp, ga, beliefs, padded, masks, var_masks, gen)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.ga.device).to(self.ga.dtype)

    # -- Gauss-Seidel passes (the up/down analogue) --------------------------
    def gs_routing(self):
        """The structure-cached Gauss-Seidel routing, or None when the graph
        cannot take a pass (fallback factors present)."""
        bp = self.bp
        if bp.gs_routing is None:
            routing = _build_gs_routing(bp, self.fg, self.ga)
            bp.gs_routing = routing if routing is not None else False
        return bp.gs_routing or None

    def gs_pass(self, beliefs, gen, up_only: bool = False, reverse: bool = False):
        """One sequential Gauss-Seidel pass over the chronological variable
        order (reversed when ``reverse``): each variable in turn takes the
        Gibbs product of its incoming messages, computed from the beliefs as
        they stand at its step; ``up_only`` keeps only messages from
        chronologically earlier variables (filtering). Returns the new
        beliefs, or None if the graph cannot take a pass.

        A step computes the messages of the rows that share a source stream
        in one batched particle solve, and its product through
        ``_masked_gibbs`` with V = 1 (K2/K3 launch once per label update)."""
        routing = self.gs_routing()
        if routing is None:
            return None
        bp, ga, dev = self.bp, self.ga, self.ga.device
        order = routing["order"][::-1] if reverse else routing["order"]
        free = {t: ga.free[t].cpu().numpy() for t in ga.type_names}
        beliefs = {t: b.clone() for t, b in beliefs.items()}
        for tid, v in order.tolist():
            t = ga.type_names[tid]
            src_of, row_of = routing["src_of"][t][v], routing["row_of"][t][v]
            ks = [k for k in range(bp.kmax[t]) if src_of[k] >= 0
                  and (not up_only or routing["up_of"][t][v, k] > 0)]
            if not ks or free[t][v] <= 0:
                continue  # no message: the belief passes through
            # slots k were numbered in source order (build_propagator), so
            # the source groups concatenate in slot order
            msgs = []
            for sidx in sorted({int(src_of[k]) for k in ks}):
                src = bp.sources[routing["S"][t][sidx]]
                rows = torch.as_tensor(
                    [int(row_of[k]) for k in ks if src_of[k] == sidx], device=dev
                )
                msgs.append(_source_messages(bp, ga, src, beliefs, self._params_all[src.b],
                                             gen, rows))
            msgs = torch.cat(msgs)[None]                       # (1, K, N, pdim)
            mask = torch.ones((1, msgs.shape[1]), dtype=ga.dtype, device=dev)
            beliefs[t][v] = _masked_gibbs(ga.manifolds[t], msgs, mask, bp.gibbs_sweeps, gen)[0]
        return beliefs

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

    def write_back(self, beliefs, slots=None):
        """Store the beliefs on the records and surface their means as point
        estimates, for the free variables (of ``slots`` {type: indices} when
        given); frozen ones keep theirs bit-identical."""
        self.scatter_beliefs(beliefs)
        for t in self.ga.type_names:
            idx = np.nonzero(self.ga.free[t].cpu().numpy())[0]
            if slots is not None:
                idx = np.intersect1d(idx, slots.get(t, []))
            if len(idx) == 0:
                continue
            set_points_from_beliefs(
                self.fg, [self.ga.var_labels[t][int(slot)] for slot in idx], self.solve_key,
                beliefs=beliefs[t][torch.as_tensor(idx, device=self.ga.device)],
            )

    def solve(self, sweeps: int = 3, seed: int = 2024, init=True):
        """``init``: True (the particle graph init, then Gauss-Seidel passes
        forward, reverse, forward), "points" (seed from the closed-form graph
        init), or False (start from the beliefs on the records); then
        ``sweeps`` Jacobi sweeps."""
        if init not in (True, False, "points"):
            raise ValueError(f"unknown init {init!r}")
        gen = torch.Generator(device=self.ga.device)
        gen.manual_seed(int(seed))
        with annotate("np.init"):
            if init == "points":
                self.init_beliefs_from_points(gen)
            elif init:
                from rome_tpu_torch.solvers.multimodal.solve import init_all_beliefs

                init_all_beliefs(self.fg, self.solve_key, N=self.N, gen=gen,
                                 device=self.ga.device)
            beliefs = self.gather_beliefs()
        if init is True:
            # the particle init carries accumulated odometry drift: smoothing
            # passes carry loop-closure corrections across the whole graph
            # before the Jacobi sweeps, which move information one hop each
            for rev in (False, True, False):
                out = self.gs_pass(beliefs, gen, reverse=rev)
                if out is None:
                    break
                beliefs = out
        for _ in range(sweeps):
            with annotate("np.sweep"):
                beliefs = self.sweep(beliefs, gen)
        with annotate("np.write_back"):
            self.write_back(beliefs)
        return self.fg
