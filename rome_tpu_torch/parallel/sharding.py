"""Factor-sharded distributed solving over torch.distributed ranks
(counterpart of ``rome_tpu/parallel/sharding.py``).

Every rank owns a contiguous slice of each factor batch and computes its
local residuals and Jacobians (a Pose2Pose2 slice through K1's ``lin``
epilogue, as every linearize of the port); the global gradient, Hessian-
vector products, block diagonal and cost are formed by local scatter-adds
(in the fixed order of ``TangentScatter``: one value per input) and one
``all_reduce`` each. Variable state is replicated: every rank holds all
values and runs the same block-Jacobi PCG and LM decisions on the reduced
(hence identical) quantities.

Every reduction is accumulated in float64 and summed across the ranks in
float64, then cast to the graph dtype, as the JAX package does under x64
(``_psum_f64``, ``cost_of``): a float32 sum's order differs between world
sizes, and a ~1e-7 relative perturbation is enough to flip an LM accept
decision. The JAX package runs the LM loop on the device (``lax.while_loop``
inside ``shard_map``); here it is a host loop over these collectives.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rome_tpu_torch.graph.lower import FactorBatch, GraphArrays, batch_key, slots_of
from rome_tpu_torch.parallel.distributed import Mesh, mesh_for
from rome_tpu_torch.solvers.gauss_newton import ParametricSolver
from rome_tpu_torch.solvers.linearize import TangentScatter, linearize_all
from rome_tpu_torch.utils.math import einsum

F64 = torch.float64


def pad_batches_for_mesh(ga: GraphArrays, n_shards: int) -> GraphArrays:
    """Pad every factor batch to a multiple of ``n_shards`` with weight-0
    rows (vslots 0, zero params, identity sqrt_info)."""
    new_batches = []
    for b in ga.batches:
        pad = (-b.n) % n_shards
        if pad == 0:
            new_batches.append(b)
            continue
        vslots = torch.cat([b.vslots, b.vslots.new_zeros((pad, b.vslots.shape[1]))])
        params = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
                  for k, v in b.params.items()}
        # padded rows need a usable sqrt_info for linearization; identity is
        # harmless because weight=0 zeroes the contribution
        if "sqrt_info" in params:
            S = params["sqrt_info"]
            S[b.n:] = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
        weight = torch.cat([b.weight, b.weight.new_zeros(pad)])
        host = np.concatenate([slots_of(b.key), np.zeros((pad, len(b.vtypes)), np.int64)])
        new_batches.append(FactorBatch(
            ftype=b.ftype, n=b.n + pad, vtypes=b.vtypes, vslots=vslots, params=params,
            weight=weight, labels=list(b.labels),
            key=batch_key(b.ftype.name, b.vtypes, host),
        ))
    return dataclasses.replace(ga, batches=new_batches)


def _local_arrays(ga: GraphArrays, mesh: Mesh) -> GraphArrays:
    """This rank's contiguous block of every (padded) batch, as
    ``PartitionSpec(axis)`` splits an array, and the replicated values and
    free masks, on the rank's device."""
    dev = mesh.device
    batches = []
    for b in ga.batches:
        m = b.n // mesh.world
        sl = slice(mesh.rank * m, (mesh.rank + 1) * m)
        batches.append(FactorBatch(
            ftype=b.ftype, n=sl.stop - sl.start, vtypes=b.vtypes,
            vslots=b.vslots[sl].to(dev),
            params={k: v[sl].to(dev).contiguous() for k, v in b.params.items()},
            weight=b.weight[sl].to(dev),
            key=batch_key(b.ftype.name, b.vtypes, slots_of(b.key)[sl]),
        ))
    return dataclasses.replace(
        ga, batches=batches, device=dev,
        values0={t: v.to(dev) for t, v in ga.values0.items()},
        free={t: v.to(dev).to(ga.dtype) for t, v in ga.free.items()},
    )


def _tdot(a, b):
    return sum(torch.dot(a[t].reshape(-1), b[t].reshape(-1)) for t in a)


def lm_loop(step_fn, state, lam0, max_iters, ftol, gtol, ct):
    """The LM loop of both distributed solvers (the JAX package's fused
    loop): the Marquardt schedule and its reason codes, 1 gtol, 3 ftol (also
    on two consecutive rejected trials within ftol of the plateau), 4 step
    floor, 5 stalled. ``step_fn(state, lam)`` -> (state, cost0, cost1,
    gnorm, dnorm, accepted), from all-reduced values only, so that every
    rank takes the same branches; ``ct`` is the graph dtype's numpy scalar
    type. Returns (state, iterations, code)."""
    lam = ct(lam0)
    it, n_rej, code = 0, 0, 0
    cost_prev = ct(np.inf)
    while it < max_iters and code == 0:
        state, _c0, c1, gn, dn, ok = step_fn(state, lam)
        c1 = ct(c1)
        lam = max(lam * ct(0.25), ct(1e-12)) if ok else min(lam * ct(8.0), ct(1e8))
        # False for a non-finite trial cost
        near = np.isfinite(cost_prev) and bool(
            abs(cost_prev - c1) <= ct(ftol) * max(ct(1.0), abs(cost_prev)))
        n_rej = 0 if ok else n_rej + 1
        if ok:
            code = 1 if gn < ct(gtol) else (3 if near else 0)
            cost_prev = c1
        elif n_rej >= 2 and near:
            code = 3
        else:
            code = 4 if dn < ct(1e-4) else (5 if n_rej >= 8 else 0)
        it += 1
    return state, it, code


def make_sharded_gn_step(
    ga: GraphArrays,
    mesh: Mesh = None,
    axis: str = "f",
    pcg_iters: int = 100,
    pcg_tol: float = 1e-8,
    device="cuda",
):
    """Build the distributed damped-GN step of this rank: ``step(values,
    lam)`` -> (new_values, cost0, cost1, gnorm, accepted), and
    ``step.solve(values, lam, max_iters=100)`` -> (values, iters, code,
    final_cost), the LM loop with the JAX package's reason codes. Factor
    batches are sharded along the factor axis; variables are replicated.
    Returns ``(step, padded ga)``; every rank builds it from the same graph.
    """
    mesh = mesh_for(mesh, axis, device)
    ga = pad_batches_for_mesh(ga, mesh.world)
    loc = _local_arrays(ga, mesh)
    dev, dtype = mesh.device, ga.dtype
    tn, manifolds = ga.type_names, ga.manifolds
    free = loc.free
    # this rank's sums into the variables' rows, in a fixed order
    scatter = TangentScatter.of(loc, loc.key)
    ct = np.float32 if dtype == torch.float32 else np.float64

    def dof(t):
        return manifolds[t].dof

    def cost_of(values):
        """(cost in the graph dtype, the local linearization)."""
        lins = linearize_all(loc, values)
        c = sum(0.5 * torch.sum(r0.to(F64) * r0.to(F64)) for _b, r0, _J, _v in lins)
        return mesh.all_reduce(c.reshape(1))[0].to(dtype), lins

    def cost_grad_diag(lins):
        """The cost, the masked gradient and the JᵀJ block diagonal at the
        linearization point, with one all_reduce."""
        c = torch.zeros((1,), dtype=F64, device=dev)
        for _b, r0, _Js, _vs in lins:
            c += 0.5 * torch.sum(r0.to(F64) * r0.to(F64))
        g = scatter.sum(loc, [[einsum("nij,ni->nj", J, r0) for J in Js]
                              for _b, r0, Js, _vs in lins], dtype=F64)
        D = scatter.sum(loc, [[einsum("nij,nik->njk", J, J) for J in Js]
                              for _b, _r0, Js, _vs in lins], block=True, dtype=F64)
        red = mesh.all_reduce_dict({"c": c, **{("g", t): g[t] for t in tn},
                                    **{("D", t): D[t] for t in tn}})
        return (red["c"][0].to(dtype),
                {t: red[("g", t)].to(dtype) * free[t][:, None] for t in tn},
                {t: red[("D", t)].to(dtype) for t in tn})

    def hvp_of(lins, v):
        contribs = []
        for b, _r0, Js, vs in lins:
            u = None
            for k, t in enumerate(b.vtypes):
                vk = v[t][vs[:, k]] * free[t][vs[:, k], None]
                uk = einsum("nij,nj->ni", Js[k], vk)
                u = uk if u is None else u + uk
            contribs.append([einsum("nij,ni->nj", J, u) for J in Js])
        out = mesh.all_reduce_dict(scatter.sum(loc, contribs, dtype=F64))
        return {t: out[t].to(dtype) * free[t][:, None] for t in tn}

    def boxplus_all(values, delta):
        return {t: manifolds[t].normalize(
            manifolds[t].boxplus(values[t], delta[t] * free[t][:, None])) for t in tn}

    def step_core(values, lam):
        lins = linearize_all(loc, values)
        cost0t, g, D = cost_grad_diag(lins)
        lamt = torch.tensor(lam, dtype=dtype, device=dev)
        Pinv, dd = {}, {}
        for t in tn:
            eye = torch.eye(dof(t), dtype=dtype, device=dev)
            dd[t] = torch.clamp(torch.diagonal(D[t], dim1=-2, dim2=-1), min=1e-8)
            blk = D[t] + lamt * dd[t][..., None] * eye + 1e-8 * eye
            fm = free[t][:, None, None]
            Pinv[t] = torch.linalg.inv(blk * fm + eye * (1.0 - fm))

        def precond(r):
            return {t: einsum("nij,nj->ni", Pinv[t], r[t]) * free[t][:, None] for t in r}

        def hvp_damped(v):
            out = hvp_of(lins, v)
            return {t: (out[t] + lamt * dd[t] * v[t]) * free[t][:, None] for t in out}

        b = {t: -g[t] for t in g}
        x = {t: torch.zeros_like(b[t]) for t in b}
        r = b
        z = precond(b)
        p = z
        rz = _tdot(b, z)
        bnorm = torch.sqrt(_tdot(b, b)) + 1e-30
        k = 0
        while k < pcg_iters and bool(torch.sqrt(_tdot(r, r)) > pcg_tol * bnorm):
            Hp = hvp_damped(p)
            alpha = rz / torch.clamp(_tdot(p, Hp), min=1e-30)
            x = {t: x[t] + alpha * p[t] for t in x}
            r = {t: r[t] - alpha * Hp[t] for t in r}
            z = precond(r)
            rz2 = _tdot(r, z)
            beta = rz2 / torch.clamp(rz, min=1e-30)
            p = {t: z[t] + beta * p[t] for t in p}
            rz = rz2
            k += 1
        trial = boxplus_all(values, x)
        cost1t, _ = cost_of(trial)
        c0, c1, gn, dn = torch.stack([
            cost0t, cost1t, torch.sqrt(_tdot(g, g)), torch.sqrt(_tdot(x, x))]).tolist()
        ok = math.isfinite(c1) and c1 < c0
        return (trial if ok else values), c0, c1, gn, dn, ok

    def step(values, lam):
        values = {t: v.to(dev, dtype) for t, v in values.items()}
        nv, c0, c1, gn, _dn, ok = step_core(values, lam)
        return nv, c0, c1, gn, ok

    def solve(values, lam, max_iters: int = 100):
        """The LM loop (``lm_loop``, tolerances 1e-8) -> (values, iters,
        code, final_cost)."""
        values = {t: v.to(dev, dtype) for t, v in values.items()}
        values, it, code = lm_loop(step_core, values, lam, max_iters, 1e-8, 1e-8, ct)
        final_cost, _ = cost_of(values)
        return values, it, code, float(final_cost)

    step.solve = solve
    step.mesh = mesh
    return step, ga


def solve_distributed(ga: GraphArrays, mesh: Mesh = None, max_iters: int = 100,
                      lam0: float = 1e-4, values=None, device="cuda", **kw):
    """Distributed LM solve on this rank (the JAX package's fused loop).
    Returns (values, stats dict). ``stats["collectives"]``: the all-reduces
    the solve made."""
    step, ga = make_sharded_gn_step(ga, mesh, device=device, **kw)
    values = values if values is not None else ga.values0
    before = step.mesh.collectives
    values, it, code, final_cost = step.solve(values, lam0, max_iters)
    stats = dict(
        iterations=it,
        reason=ParametricSolver._REASONS.get(code, "?"),
        converged=code in (1, 3, 4) or (code == 5 and it > 3),
        final_cost=final_cost,
        collectives=step.mesh.collectives - before,
    )
    return values, stats
