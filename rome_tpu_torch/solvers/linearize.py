"""Batched residual / Jacobian evaluation (counterpart of
``rome_tpu/solvers/linearize.py``).

Every factor type linearizes over its dense batch: gathers from per-type
variable tensors, per-factor Jacobians wrt local tangent deltas, sums back
into per-type tangent tensors in an order fixed by the structure
(``TangentScatter``, no atomics). Pose2Pose2 batches go
through the hand kernel K1 (ops/linearize_cuda.py); every other type through
``torch.func.vmap(jacfwd)`` of its residual. ``lins`` entries are
``(batch, r0, Js, vslots)``; ``rt`` (``runtime_state``) carries the batch
data so a caller can hand in a different graph's values.

The ndchol LM path (``linearize_all_mixed_j``) sends each Pose2Pose2 batch
through K1's ``normal`` epilogue instead, which also writes the batch's JᵀJ
entry values and Jᵀr contributions (``NormalParts``); the entry-value and
gradient functions below take those instead of recomputing them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jacfwd, vmap

from rome_tpu_torch.graph.lower import FactorBatch, GraphArrays
from rome_tpu_torch.ops.linearize_cuda import FUSED_LINEARIZE, FUSED_NORMAL
from rome_tpu_torch.ops.segment_sum import SegmentPlan
from rome_tpu_torch.utils.math import einsum, matvec


def runtime_state(ga: GraphArrays):
    """The value half of a lowered graph: params, slots, weights, free masks."""
    return {
        "params": tuple(dict(b.params) for b in ga.batches),
        "vslots": tuple(b.vslots for b in ga.batches),
        "weight": tuple(b.weight.to(ga.dtype) for b in ga.batches),
        "free": {t: ga.free[t].to(ga.dtype) for t in ga.type_names},
    }


def structure_signature(ga: GraphArrays):
    """Hashable key of what a solver binds to (dtype, device, variable
    counts, batch types and shapes); ``runtime_state`` carries the rest."""
    return (
        str(ga.dtype),
        str(ga.device),
        tuple((t, ga.counts[t]) for t in ga.type_names),
        tuple((b.ftype.name, b.n, b.vtypes, tuple(sorted(b.params))) for b in ga.batches),
    )


def _whitened_residual_fn(ga: GraphArrays, batch: FactorBatch):
    mans = [ga.manifolds[t] for t in batch.vtypes]
    resid = batch.ftype.residual

    def f(deltas, params, pts):
        newpts = tuple(m.boxplus(p, d) for m, p, d in zip(mans, pts, deltas))
        raw = resid(params, *newpts)
        return matvec(params["sqrt_info"], raw)

    return f


def _gather_points(values, batch: FactorBatch, vslots):
    return tuple(values[t][vslots[:, k]] for k, t in enumerate(batch.vtypes))


def _zero_deltas(ga: GraphArrays, batch: FactorBatch):
    return tuple(
        torch.zeros((batch.n, ga.manifolds[t].dof), dtype=ga.dtype, device=ga.device)
        for t in batch.vtypes
    )


def batch_residual(ga: GraphArrays, batch: FactorBatch, values,
                   params=None, vslots=None, weight=None):
    """Whitened residuals at the current values: (n, zdim)."""
    params = batch.params if params is None else params
    vslots = batch.vslots if vslots is None else vslots
    weight = batch.weight if weight is None else weight
    f = _whitened_residual_fn(ga, batch)
    r = f(_zero_deltas(ga, batch), params, _gather_points(values, batch, vslots))
    return r * weight[:, None]


def batch_linearize(ga: GraphArrays, batch: FactorBatch, values,
                    params=None, vslots=None, weight=None, fused=True):
    """Weighted whitened residuals and per-slot Jacobians wrt local tangent
    deltas. Returns (r0 (n, zdim), Js tuple of (n, zdim, dof_k))."""
    params = batch.params if params is None else params
    vslots = batch.vslots if vslots is None else vslots
    weight = batch.weight if weight is None else weight
    pts = _gather_points(values, batch, vslots)

    kern = FUSED_LINEARIZE.get(batch.ftype.name) if fused else None
    if kern is not None:
        # closed-form kernel, weight applied inside; inputs share one dtype
        dt = pts[0].dtype
        for a in (pts[1], params["z"], params["sqrt_info"], weight):
            dt = torch.promote_types(dt, a.dtype)
        p, q = (x.to(dt).contiguous() for x in pts)
        return kern(
            p, q, params["z"].to(dt).contiguous(),
            params["sqrt_info"].to(dt).contiguous(), weight.to(dt).contiguous(),
        )
    f = _whitened_residual_fn(ga, batch)

    def f_and_jac(deltas, params, p):
        return f(deltas, params, p), jacfwd(f, argnums=0)(deltas, params, p)

    r0, Js = vmap(f_and_jac)(_zero_deltas(ga, batch), params, pts)
    r0 = r0 * weight[:, None]
    Js = tuple(J * weight[:, None, None] for J in Js)
    return r0, Js


def linearize_all(ga: GraphArrays, values, rt=None):
    """Linearize every batch. Returns list of (batch, r0, Js, vslots)."""
    out = []
    for i, b in enumerate(ga.batches):
        if rt is None:
            r0, Js = batch_linearize(ga, b, values)
            out.append((b, r0, Js, b.vslots))
        else:
            r0, Js = batch_linearize(
                ga, b, values, rt["params"][i], rt["vslots"][i], rt["weight"][i]
            )
            out.append((b, r0, Js, rt["vslots"][i]))
    return out


@dataclass
class NormalParts:
    """What the normal epilogue wrote for the batches it served.

    ``vals``: the float32 JᵀJ entry vector of every batch in the symbolic
    phase's order (``normal_eq_entry_values``), each batch's block starting
    at ``offsets[i]``; the served batches' blocks are filled. ``jtr``: batch
    index -> (arity, n, dof) float64 Jᵀr contributions of a served batch.
    """

    vals: torch.Tensor
    offsets: tuple
    jtr: dict


class NormalEqWorkspace:
    """Buffers the ndchol LM path keeps across iterations of one graph: the
    entry vector and, per Pose2Pose2 batch, K1's normal-epilogue plan (its
    inputs checked once, its outputs in one allocation). A call of
    ``linearize_all_mixed_j`` with a workspace overwrites what the previous
    call with it returned."""

    def __init__(self, ga: GraphArrays):
        offsets, o = [], 0
        for b in ga.batches:
            offsets.append(o)
            dofs = [ga.manifolds[t].dof for t in b.vtypes]
            o += b.n * sum(dk * dl for dk in dofs for dl in dofs)
        self.offsets = tuple(offsets)
        self.vals = torch.empty(o, dtype=torch.float32, device=ga.device)
        self._plans = {}

    def normal(self, i, plan_type, vslots, z, S, w, count):
        """Batch ``i``'s plan for these inputs, made on first use."""
        plan = self._plans.get(i)
        if plan is None or not plan.serves(vslots, z, S, w) or plan.count != count:
            o = self.offsets[i]
            plan = plan_type(vslots, z, S, w, count, self.vals[o: o + 36 * vslots.shape[0]])
            self._plans[i] = plan
        return plan


def linearize_all_mixed_j(ga64, ga32, values, rt, ws=None):
    """f64 residuals + f32 Jacobians, per batch: only the residual feeds the
    f64-critical quantities (cost, gradient); every consumer of J in the
    ndchol path works in f32.

    Pose2Pose2 batches go through K1's normal epilogue, which also writes
    their f32 JᵀJ entry values and f64 Jᵀr contributions; every other batch
    is linearized generically. Returns ``(lins, NormalParts)``; the served
    batches' outputs live in ``ws`` (a fresh ``NormalEqWorkspace`` when not
    given) until its next call.
    """
    ws = ws if ws is not None else NormalEqWorkspace(ga64)
    v32 = None
    out, jtr = [], {}
    for i, b in enumerate(ga64.batches):
        p, vs, w = rt["params"][i], rt["vslots"][i], rt["weight"][i]
        plan_type = FUSED_NORMAL.get(b.ftype.name)
        if plan_type is not None:
            table = values[b.vtypes[0]]
            plan = ws.normal(i, plan_type, vs, p["z"], p["sqrt_info"], w, table.shape[0])
            r64, Js32, jtr[i] = plan(table)
            out.append((b, r64, Js32, vs))
            continue
        if v32 is None:
            v32 = {t: v.to(torch.float32) for t, v in values.items()}
        r64 = batch_residual(ga64, b, values, p, vs, w)
        p32 = {k: v.to(torch.float32) for k, v in p.items()}
        _r32, Js32 = batch_linearize(ga32, b, v32, p32, vs, w.to(torch.float32))
        out.append((b, r64, Js32, vs))
    return out, NormalParts(ws.vals, ws.offsets, jtr)


def cost_at(ga: GraphArrays, values, rt=None, accum_dtype=None):
    """0.5 * sum of squared whitened residuals, accumulated in
    ``accum_dtype`` (default ``ga.dtype``). Returns a 0-dim tensor."""
    adt = accum_dtype or ga.dtype
    c = torch.zeros((), dtype=adt, device=ga.device)
    for i, b in enumerate(ga.batches):
        if rt is None:
            r = batch_residual(ga, b, values)
        else:
            r = batch_residual(
                ga, b, values, rt["params"][i], rt["vslots"][i], rt["weight"][i]
            )
        r = r.to(adt)
        c = c + 0.5 * torch.sum(r * r)
    return c


def _free_of(ga: GraphArrays, rt):
    return ga.free if rt is None else rt["free"]


class TangentScatter:
    """Per variable type, one fixed-order sum of every (batch, slot)
    contribution into that type's rows. A variable's contributions are
    summed by batch, then slot, then the contributing factor's variable
    slots: the order follows the graph's structure, not its batches' row
    order (only factors on the same variables in the same batch keep their
    row order). Made once per connectivity on the host."""

    def __init__(self, type_names, specs, device):
        """``specs``: per batch, (vtypes, vslots as an (n, arity) numpy
        array)."""
        width = max((vs.shape[1] for _vt, vs in specs), default=0)
        self.parts, self.plans = {}, {}
        for t in type_names:
            parts = [(i, k) for i, (vt, _vs) in enumerate(specs)
                     for k, tk in enumerate(vt) if tk == t]
            dst, keys = [], []
            for i, k in parts:
                vs = np.asarray(specs[i][1], dtype=np.int64)
                n = vs.shape[0]
                row = np.full((n, width), -1, dtype=np.int64)
                row[:, : vs.shape[1]] = vs
                dst.append(vs[:, k])
                keys.append(np.concatenate([np.full((n, 2), (i, k)), row], axis=1))
            self.parts[t] = parts
            if parts:
                self.plans[t] = SegmentPlan(np.concatenate(dst), keys=(np.concatenate(keys),),
                                            device=device)

    @classmethod
    def of(cls, ga: GraphArrays, vslots):
        """The plan of ``ga``'s types over the per-batch ``vslots``."""
        specs = [(b.vtypes, v.cpu().numpy()) for b, v in zip(ga.batches, vslots)]
        return cls(ga.type_names, specs, ga.device)

    def sum(self, ga: GraphArrays, contribs, block=False):
        """``contribs[i][k]``: batch i's (n, dof) contributions at slot k,
        (n, dof, dof) with ``block``. Returns type -> (count, dof) sums, or
        (count, dof, dof), in ``ga.dtype``."""
        out = {}
        for t in ga.type_names:
            d = ga.manifolds[t].dof
            o = torch.zeros((ga.counts[t], d, d) if block else (ga.counts[t], d),
                            dtype=ga.dtype, device=ga.device)
            if self.parts[t]:
                self.plans[t].add_(o, torch.cat([contribs[i][k].to(o.dtype)
                                                 for i, k in self.parts[t]]))
            out[t] = o
        return out


def tangent_scatter(ga: GraphArrays, lins, rt=None):
    """``rt``'s plan (the solvers put one there), else one made for
    ``lins``' slots."""
    if rt is not None and "scatter" in rt:
        return rt["scatter"]
    return TangentScatter.of(ga, [vs for _b, _r0, _Js, vs in lins])


def gradient_from_lins(ga: GraphArrays, lins, rt=None, parts=None):
    """g = J^T r as a per-type tangent dict, masked by free. ``parts``
    (``NormalParts``) supplies the contributions of the batches the normal
    epilogue served."""
    free = _free_of(ga, rt)
    contribs = []
    for i, (batch, r0, Js, _vs) in enumerate(lins):
        pre = None if parts is None else parts.jtr.get(i)
        contribs.append([einsum("nij,ni->nj", Js[k], r0) if pre is None else pre[k]
                         for k in range(len(batch.vtypes))])
    g = tangent_scatter(ga, lins, rt).sum(ga, contribs)
    return {t: g[t] * free[t][:, None] for t in g}


def hvp_from_lins(ga: GraphArrays, lins, v, rt=None):
    """(J^T J) v as a tangent dict (Gauss-Newton Hessian-vector product)."""
    free = _free_of(ga, rt)
    contribs = []
    for batch, _r0, Js, vslots in lins:
        u = torch.zeros((batch.n, batch.ftype.zdim), dtype=ga.dtype, device=ga.device)
        for k, t in enumerate(batch.vtypes):
            vk = v[t][vslots[:, k]] * free[t][vslots[:, k], None]
            u = u + einsum("nij,nj->ni", Js[k], vk)
        contribs.append([einsum("nij,ni->nj", Js[k], u) for k in range(len(batch.vtypes))])
    out = tangent_scatter(ga, lins, rt).sum(ga, contribs)
    return {t: out[t] * free[t][:, None] for t in out}


def block_diag_from_lins(ga: GraphArrays, lins, rt=None):
    """Per-variable dof x dof diagonal blocks of J^T J (block-Jacobi)."""
    contribs = [[einsum("nij,nik->njk", Js[k], Js[k]) for k in range(len(batch.vtypes))]
                for batch, _r0, Js, _vs in lins]
    return tangent_scatter(ga, lins, rt).sum(ga, contribs, block=True)


# ---------------------------------------------------------------------------
# dense assembly (small graphs) and flat tangent layout
# ---------------------------------------------------------------------------

def tangent_offsets(ga: GraphArrays):
    """Global dense offsets: type -> base offset; total dof D."""
    base, off = {}, 0
    for t in ga.type_names:
        base[t] = off
        off += ga.counts[t] * ga.manifolds[t].dof
    return base, off


def flatten_tangent(ga: GraphArrays, v):
    return torch.cat([v[t].reshape(-1) for t in ga.type_names])


def unflatten_tangent(ga: GraphArrays, x):
    out, off = {}, 0
    for t in ga.type_names:
        n, d = ga.counts[t], ga.manifolds[t].dof
        out[t] = x[off : off + n * d].reshape(n, d)
        off += n * d
    return out


def free_vector(ga: GraphArrays, rt=None):
    free = _free_of(ga, rt)
    return torch.cat(
        [torch.repeat_interleave(free[t], ga.manifolds[t].dof) for t in ga.type_names]
    )


def _entry_blocks(batch: FactorBatch, Js, dtype):
    Jd = tuple(J.to(dtype) for J in Js)
    return [einsum("nij,nik->njk", Jd[k], Jd[l]).reshape(-1)
            for k in range(len(batch.vtypes)) for l in range(len(batch.vtypes))]


def normal_eq_entry_values(ga: GraphArrays, lins, dtype=None, parts=None):
    """Flat vector of every J^T J entry contribution, in the fixed order the
    sparse symbolic phase indexes (sparse/symbolic.py entry_coords): per
    batch, per (k, l) slot pair, the (n, dk, dl) block row-major.

    With ``parts`` (``NormalParts``) the blocks of the batches the normal
    epilogue did not serve are written into ``parts.vals``, which is
    returned."""
    dtype = dtype or ga.dtype
    if parts is None:
        return torch.cat([v for batch, _r0, Js, _vs in lins
                          for v in _entry_blocks(batch, Js, dtype)])
    if parts.vals.dtype != dtype:
        raise TypeError(f"the entry vector is {parts.vals.dtype}, asked for {dtype}")
    for i, (batch, _r0, Js, _vs) in enumerate(lins):
        if i not in parts.jtr:
            blocks = _entry_blocks(batch, Js, dtype)
            o = parts.offsets[i]
            torch.cat(blocks, out=parts.vals[o: o + sum(v.numel() for v in blocks)])
    return parts.vals


def dense_normal_eqs(ga: GraphArrays, lins, dtype=None, rt=None):
    """Dense H = J^T J and g = J^T r over the global tangent, in ``dtype``.

    Frozen (free=0) dims get an identity row/col so H stays invertible and
    their update is exactly zero. All block contributions go into ONE
    accumulating scatter per output; the free mask is applied to H in place
    (a 0/1 mask, so the products are exact), so H is the only D x D buffer.
    """
    dtype = dtype or ga.dtype
    dev = ga.device
    base, D = tangent_offsets(ga)
    rows_all, cols_all, vals_all = [], [], []
    g_idx_all, g_val_all = [], []
    for batch, r0, Js, vslots in lins:
        r0 = r0.to(dtype)
        Js = tuple(J.to(dtype) for J in Js)
        offs = []
        for k, t in enumerate(batch.vtypes):
            d = ga.manifolds[t].dof
            o = base[t] + vslots[:, k] * d
            offs.append(o[:, None] + torch.arange(d, device=dev)[None, :])
        for k in range(len(batch.vtypes)):
            g_idx_all.append(offs[k].reshape(-1))
            g_val_all.append(einsum("nij,ni->nj", Js[k], r0).reshape(-1))
            for l in range(len(batch.vtypes)):
                blk = einsum("nij,nik->njk", Js[k], Js[l])
                shp = blk.shape
                rows_all.append(offs[k][:, :, None].expand(shp).reshape(-1))
                cols_all.append(offs[l][:, None, :].expand(shp).reshape(-1))
                vals_all.append(blk.reshape(-1))
    H = torch.zeros((D, D), dtype=dtype, device=dev)
    H.index_put_(
        (torch.cat(rows_all), torch.cat(cols_all)), torch.cat(vals_all), accumulate=True
    )
    g = torch.zeros((D,), dtype=dtype, device=dev)
    g.index_add_(0, torch.cat(g_idx_all), torch.cat(g_val_all))
    f = free_vector(ga, rt).to(dtype)
    H.mul_(f[:, None]).mul_(f[None, :])
    H.diagonal().add_(1.0 - f)
    g = g * f
    return H, g
