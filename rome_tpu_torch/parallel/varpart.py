"""Variable-partitioned distributed solve: owner-computes + separator exchange
(counterpart of ``rome_tpu/parallel/varpart.py``).

- every rank OWNS a contiguous block of each variable type (for
  trajectory-ordered SLAM graphs contiguous blocks are a near-minimal cut);
- each factor is assigned to the rank owning its first variable;
- variables referenced by a factor on a non-owner rank are SEPARATORS; only
  those cross the ranks. The value exchange: owners write their separator
  values into a (n_sep, dim) buffer and one ``all_reduce`` replicates it
  (the owner is the only writer, so the sum IS the value).

Each LM step is an exact Schur-complement solve: every rank eliminates its
interior variables with a local dense Cholesky (interiors touch only local
factors by construction), forms its contribution to the Schur complement on
the global separator set, and ONE ``all_reduce`` sums the pack
[S_d | reduced rhs | separator gradient | interior |g|²]; every rank then
solves the small replicated separator system and back-substitutes its
interiors. The pack and the cost are reduced in float64, so the LM decisions
do not depend on the world size.

The local linearize is the port's ``batch_linearize`` (a Pose2Pose2 batch
through K1's ``lin`` epilogue). The Schur step is assembled and factored in
float64 whatever the graph dtype (the JAX package uses the graph dtype):
at a rank's D_own + D_sep dof the dense system costs 8 (D_own + D_sep)² bytes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rome_tpu_torch.graph.lower import FactorBatch, GraphArrays
from rome_tpu_torch.parallel.distributed import Mesh, mesh_for
from rome_tpu_torch.parallel.sharding import lm_loop
from rome_tpu_torch.solvers.gauss_newton import ParametricSolver
from rome_tpu_torch.ops.segment_sum import SegmentPlan
from rome_tpu_torch.solvers.linearize import DenseScatter, TangentScatter, batch_linearize

F64 = torch.float64
# added to the diagonal of the Jacobi-scaled interior and separator systems
# (the JAX package's 1e-6). It damps every step, so the LM loop takes more
# iterations than the single-device solve on long chains (50-51 against 16
# on a 10,000-pose corridor chain, in both packages: ridge_study in
# tests/test_torch_varpart.py)
SCHUR_RIDGE = 1e-6


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# host-side partition planning (numpy)
# --------------------------------------------------------------------------

class VarPartitionPlan:
    """Static routing tables for an owner-computes partition.

    All arrays are stacked along a leading rank axis; rank d reads row d.
    """

    def __init__(self, ga: GraphArrays, ndev: int):
        self.ga = ga
        self.ndev = ndev
        tn = ga.type_names

        # ---- contiguous variable blocks per type --------------------------
        self.bounds = {}      # t -> (ndev+1,) block boundaries
        self.owner = {}       # t -> (n,) owning rank
        self.n_loc = {}       # t -> padded own-block size
        for t in tn:
            n = ga.counts[t]
            b = np.round(np.linspace(0, n, ndev + 1)).astype(np.int64)
            self.bounds[t] = b
            ow = np.zeros(n, np.int64)
            for d in range(ndev):
                ow[b[d]:b[d + 1]] = d
            self.owner[t] = ow
            self.n_loc[t] = int(max(1, (b[1:] - b[:-1]).max()))

        # ---- factor -> rank assignment ------------------------------------
        self.fdev = [self.owner[bt.vtypes[0]][_np(bt.vslots)[:, 0]] for bt in ga.batches]

        # ---- separator detection -------------------------------------------
        sep_mask = {t: np.zeros(ga.counts[t], bool) for t in tn}
        for bt, dv in zip(ga.batches, self.fdev):
            vs = _np(bt.vslots)
            for k, t in enumerate(bt.vtypes):
                cross = self.owner[t][vs[:, k]] != dv
                sep_mask[t][vs[cross, k]] = True
        self.sep_ids = {}   # t -> (n_sep,) global ids (>=1 row, padded)
        self.n_sep = {}
        sep_pos = {}        # t -> (n,) global id -> sep slot (or 0)
        for t in tn:
            ids = np.nonzero(sep_mask[t])[0]
            if ids.size == 0:
                ids = np.array([0], np.int64)  # dummy row, masked out
            self.sep_ids[t] = ids
            self.n_sep[t] = len(ids)
            sp = np.zeros(ga.counts[t], np.int64)
            sp[ids] = np.arange(len(ids))
            sep_pos[t] = sp
        self.sep_real = {
            t: sep_mask[t][self.sep_ids[t]].astype(np.float32) for t in tn
        }

        # ---- separator routing: owner's local position + ownership mask ---
        # sep_src[t]: (ndev, n_sep) own-block position of each separator on
        # its owner (0 elsewhere); sep_own[t]: (ndev, n_sep) 1 iff owned.
        self.sep_src = {}
        self.sep_own = {}
        for t in tn:
            ids = self.sep_ids[t]
            src = np.zeros((ndev, len(ids)), np.int64)
            own = np.zeros((ndev, len(ids)), np.float32)
            for d in range(ndev):
                m = (self.owner[t][ids] == d) & (self.sep_real[t] > 0)
                src[d, m] = ids[m] - self.bounds[t][d]
                own[d, m] = 1.0
            self.sep_src[t] = src
            self.sep_own[t] = own
        # inverse map for the Schur solve: own-block position -> separator
        # slot (-1 = interior)
        self.own2sep = {}
        for t in tn:
            o2s = np.full((ndev, self.n_loc[t]), -1, np.int64)
            for d in range(ndev):
                m = self.sep_own[t][d] > 0
                o2s[d, self.sep_src[t][d, m]] = np.nonzero(m)[0]
            self.own2sep[t] = o2s

        # ---- own-block stacking (values / free / valid) --------------------
        # own_gids[t]: (ndev, n_loc) global variable id feeding each own row
        # (clamped for pads); own_valid marks real rows.
        self.own_gids = {}
        self.own_valid = {}
        for t in tn:
            g = np.zeros((ndev, self.n_loc[t]), np.int64)
            v = np.zeros((ndev, self.n_loc[t]), np.float32)
            for d in range(ndev):
                lo, hi = self.bounds[t][d], self.bounds[t][d + 1]
                g[d, : hi - lo] = np.arange(lo, hi)
                v[d, : hi - lo] = 1.0
            self.own_gids[t] = g
            self.own_valid[t] = v

        # ---- per-rank factor subsets with LOCAL index remap ----------------
        # local index: own position (owner) or n_loc + sep slot (remote)
        self.fb_local = []  # per batch: dict of stacked (ndev, m_loc, ...)
        for bt, dv in zip(ga.batches, self.fdev):
            vs = _np(bt.vslots)
            w = _np(bt.weight)
            m_loc = int(max(1, np.bincount(dv, minlength=ndev).max()))
            arity = vs.shape[1]
            vsl = np.zeros((ndev, m_loc, arity), np.int64)
            wl = np.zeros((ndev, m_loc), np.float64)
            rows = np.zeros((ndev, m_loc), np.int64)  # source row (for params)
            for d in range(ndev):
                ridx = np.nonzero(dv == d)[0]
                mr = len(ridx)
                rows[d, :mr] = ridx
                wl[d, :mr] = w[ridx]
                for k, t in enumerate(bt.vtypes):
                    v_ids = vs[ridx, k]
                    is_own = self.owner[t][v_ids] == d
                    li = np.where(
                        is_own,
                        v_ids - self.bounds[t][d],
                        self.n_loc[t] + sep_pos[t][v_ids],
                    )
                    vsl[d, :mr, k] = li
            params = {k: _np(p)[rows] for k, p in bt.params.items()}  # (ndev, m_loc, ...)
            if "sqrt_info" in params:
                # padded rows need a usable sqrt_info; weight 0 hides them
                eye = np.eye(params["sqrt_info"].shape[-1])
                pad = wl == 0.0
                params["sqrt_info"] = np.where(
                    pad[..., None, None], eye, params["sqrt_info"]
                )
            self.fb_local.append(
                dict(vslots=vsl, weight=wl, params=params, vtypes=bt.vtypes,
                     ftype=bt.ftype)
            )

    # ---- value scatter / gather -------------------------------------------
    def scatter_values(self, values):
        """Global per-type values -> stacked own blocks (ndev, n_loc, dim)."""
        return {t: _np(values[t])[self.own_gids[t]] for t in self.ga.type_names}

    def gather_values(self, own_stacked):
        """Stacked own blocks -> global per-type arrays."""
        out = {}
        for t in self.ga.type_names:
            own = _np(own_stacked[t])
            arr = np.zeros((self.ga.counts[t],) + own.shape[2:], own.dtype)
            for d in range(self.ndev):
                lo, hi = self.bounds[t][d], self.bounds[t][d + 1]
                arr[lo:hi] = own[d, : hi - lo]
            out[t] = arr
        return out

    def comms_note(self):
        """Bytes per exchange: separator payload vs replicated-path payload."""
        itemsize = np.dtype(np.float32).itemsize
        sep = sum(
            int(self.sep_real[t].sum()) * self.ga.manifolds[t].dof
            for t in self.ga.type_names
        )
        full = sum(
            self.ga.counts[t] * self.ga.manifolds[t].dof
            for t in self.ga.type_names
        )
        return dict(
            separator_dofs=sep,
            replicated_dofs=full,
            payload_ratio=round(full / max(sep, 1), 2),
            bytes_per_exchange=sep * itemsize,
        )


# --------------------------------------------------------------------------
# the partitioned solver
# --------------------------------------------------------------------------

def make_varpart_solver(ga: GraphArrays, mesh: Mesh = None, axis: str = "v",
                        pcg_iters: int = 100, pcg_tol: float = 1e-8,
                        max_iters: int = 100, ftol: float = 1e-8,
                        gtol: float = 1e-8, device="cuda"):
    """Build this rank's owner-computes LM solve over ``mesh``.

    Returns ``(solve, plan)`` where ``solve(values=None, lam0=1e-4)`` maps
    global values -> (global values on every rank, stats). ``pcg_iters`` and
    ``pcg_tol`` are accepted for the JAX package's signature; the Schur step
    solves exactly and uses neither. Every rank builds it from the same
    graph.
    """
    mesh = mesh_for(mesh, axis, device)
    plan = VarPartitionPlan(ga, mesh.world)
    tn = ga.type_names
    manifolds = ga.manifolds
    dtype = ga.dtype
    dev = mesh.device
    d = mesh.rank
    n_loc, n_sep = plan.n_loc, plan.n_sep
    ct = np.float32 if dtype == torch.float32 else np.float64

    def row(x, dt=None):
        """Rank d's row of a stacked table, on the device."""
        t = torch.as_tensor(np.ascontiguousarray(x[d]), device=dev)
        return t if dt is None else t.to(dt)

    free_np = {t: _np(ga.free[t]) for t in tn}
    sep_src = {t: row(plan.sep_src[t]) for t in tn}
    sep_own = {t: row(plan.sep_own[t], dtype) for t in tn}
    own2sep = {t: row(plan.own2sep[t]) for t in tn}
    valid = {t: row(plan.own_valid[t], dtype) for t in tn}
    # free mask over own rows (frozen vars + padding pinned)
    free_own = {t: row(free_np[t][plan.own_gids[t]] * plan.own_valid[t], dtype) for t in tn}
    # free mask over separator slots (replicated)
    free_sep = {
        t: torch.as_tensor(free_np[t][plan.sep_ids[t]] * plan.sep_real[t], device=dev).to(dtype)
        for t in tn
    }
    batches = [
        FactorBatch(
            ftype=fb["ftype"], n=fb["vslots"].shape[1], vtypes=fb["vtypes"],
            vslots=row(fb["vslots"]),
            params={k: row(v, dtype if np.issubdtype(v.dtype, np.floating) else None)
                    for k, v in fb["params"].items()},
            weight=row(fb["weight"], dtype),
        )
        for fb in plan.fb_local
    ]
    # the rank's local arrays: own rows, then the separator rows
    loc = GraphArrays(
        type_names=tn, manifolds=manifolds,
        counts={t: n_loc[t] + n_sep[t] for t in tn},
        values0={}, free={}, batches=batches, var_labels={}, dtype=dtype, device=dev,
    )

    # static own-block scalar layout, then the separator layout (global,
    # replicated); DT is the dump row of frozen / padded / absent slots
    base_own, D_own = {}, 0
    for t in tn:
        base_own[t] = D_own
        D_own += n_loc[t] * manifolds[t].dof
    base_sep, D_sep = {}, 0
    for t in tn:
        base_sep[t] = D_sep
        D_sep += n_sep[t] * manifolds[t].dof
    DT = D_own + D_sep

    def sep_exchange(own):
        """(n_loc, dim) per type -> replicated (n_sep, dim): one owner-writes
        all_reduce per type."""
        return {t: mesh.all_reduce(own[t][sep_src[t]] * sep_own[t][:, None]) for t in tn}

    def with_sep(own, sep):
        return {t: torch.cat([own[t], sep[t]]) for t in tn}

    def linearize_local(vloc):
        return [(b, *batch_linearize(loc, b, vloc), b.vslots) for b in batches]

    def cost_of(vloc):
        """(cost in the graph dtype, the local linearization): the squares
        summed and reduced in float64."""
        lins = linearize_local(vloc)
        c = sum(0.5 * torch.sum(r0.to(F64) * r0.to(F64)) for _b, r0, _J, _v in lins)
        return mesh.all_reduce(c.reshape(1))[0].to(dtype), lins

    def reduce_to_own(gloc):
        """Scattered (n_loc + n_sep, dof) -> owner blocks (n_loc, dof): the
        separator tail (cross-rank contributions) is summed over the ranks
        in float64 and folded into the owner's rows."""
        out = {}
        for t in tn:
            tail = mesh.all_reduce(gloc[t][n_loc[t]:].to(F64)).to(dtype)
            own_part = sep_sum[t].add_(gloc[t][: n_loc[t]].clone(), tail * sep_own[t][:, None])
            out[t] = own_part * free_own[t][:, None]
        return out

    def grad_of(lins):
        return reduce_to_own(scatter.sum(loc, [[torch.einsum("nij,ni->nj", J, r0) for J in Js]
                                               for _b, r0, Js, _vsl in lins]))

    def boxplus_own(own, delta):
        out = {}
        for t in tn:
            man = manifolds[t]
            new = man.normalize(man.boxplus(own[t], delta[t] * free_own[t][:, None]))
            # padded rows stay bit-identical (normalize may perturb)
            out[t] = torch.where(valid[t][:, None] > 0, new, own[t])
        return out

    def slot_offsets(vsl_k, t):
        """Local slot column -> scalar offsets (n, dof) into the
        [interior | separator] layout; frozen / pad rows -> the dump DT."""
        dof = manifolds[t].dof
        s = vsl_k
        idx = torch.clamp(s, max=n_loc[t] - 1)
        is_rem = s >= n_loc[t]
        sidx = torch.where(is_rem, s - n_loc[t], own2sep[t][idx])
        is_sep = sidx >= 0
        o_int = base_own[t] + idx * dof
        o_sep = D_own + base_sep[t] + torch.clamp(sidx, min=0) * dof
        o = torch.where(is_sep, o_sep, o_int)
        act = torch.where(is_rem, free_sep[t][torch.clamp(sidx, min=0)], free_own[t][idx])
        return torch.where((act > 0)[:, None], o[:, None] + torch.arange(dof, device=dev),
                           torch.full_like(o[:, None], DT))

    # the rank's sums in a fixed order, planned once: the gradient into the
    # local rows, the owners' separator tails, and the local dense system
    # [interior | separator | dump DT]
    scatter = TangentScatter.of(loc, [b.vslots for b in batches])
    sep_sum = {t: SegmentPlan(sep_src[t], device=dev) for t in tn}
    dense = DenseScatter([[slot_offsets(b.vslots[:, k], t) for k, t in enumerate(b.vtypes)]
                          for b in batches], [b.vslots for b in batches], DT + 1)

    def schur_solve(lins, lam, skip_psum=False, skip_sep=False):
        """EXACT damped-normal-equations step with ONE all_reduce: local
        elimination of the interiors (dense Cholesky), the Schur complement
        on the global separator set summed over the ranks, the replicated
        separator solve, local back-substitution. Float64 throughout."""
        M, gl = dense.sum(lins, F64)
        M, gl = M[:DT, :DT], gl[:DT]
        # activity from the raw diagonal (inactive = dumped: frozen /
        # padding / not present on this rank)
        diag0 = torch.diagonal(M).clone()
        int_act = (diag0[:D_own] > 0).to(F64)
        # damping on the LOCAL diagonal: interiors are fully local (=
        # global); separator shares sum to the global diagonal through the
        # same all_reduce that sums S_d
        M.diagonal().add_(float(lam) * diag0)
        A_II = M[:D_own, :D_own]          # scaled in place: only factored
        A_II.diagonal().add_(1.0 - int_act)
        dI = torch.rsqrt(torch.clamp(torch.diagonal(A_II), min=1e-12))
        A_II.mul_(dI[:, None]).mul_(dI[None, :])
        A_II.diagonal().add_(SCHUR_RIDGE)
        L = _factor(A_II)
        A_IS = M[:D_own, D_own:]
        U = dI[:, None] * A_IS                       # (D_own, D_sep)
        Y = torch.cholesky_solve(U, L)
        b_I = -gl[:D_own] * int_act
        b_S = -gl[D_own:]
        v = torch.cholesky_solve((dI * b_I)[:, None], L)[:, 0]
        S_d = M[D_own:, D_own:] - U.T @ Y            # (D_sep, D_sep)
        r_d = b_S - U.T @ v
        gI_sq = torch.sum((gl[:D_own] * int_act) ** 2)
        # ---- the one collective: the fused Schur reduction ----
        pack = torch.cat([S_d.reshape(-1), r_d, gl[D_own:], gI_sq[None]])
        if not skip_psum:
            mesh.all_reduce(pack)
        S = pack[: D_sep * D_sep].reshape(D_sep, D_sep)
        r_S = pack[D_sep * D_sep: D_sep * D_sep + D_sep]
        g_S = pack[D_sep * D_sep + D_sep: -1]
        gnorm = torch.sqrt(pack[-1] + torch.sum(g_S ** 2))
        # replicated separator solve (identical on every rank)
        if skip_sep:
            x_S = torch.zeros((D_sep,), dtype=F64, device=dev)
        else:
            sep_act = (torch.abs(torch.diagonal(S)) > 0).to(F64)
            S = S + torch.diag(1.0 - sep_act)
            dS = torch.rsqrt(torch.clamp(torch.diagonal(S), min=1e-12))
            Ss = (S * dS[:, None] * dS[None, :]
                  + SCHUR_RIDGE * torch.eye(D_sep, dtype=F64, device=dev))
            x_S = dS * torch.cholesky_solve((dS * r_S)[:, None], _factor(Ss))[:, 0] * sep_act
        # back-substitute the interiors (local)
        x_I = dI * torch.cholesky_solve((dI * (b_I - A_IS @ x_S))[:, None], L)[:, 0] * int_act
        delta = {}
        for t in tn:
            dof = manifolds[t].dof
            xi = x_I[base_own[t]: base_own[t] + n_loc[t] * dof].reshape(n_loc[t], dof)
            o2s = own2sep[t]
            gidx = (base_sep[t] + torch.clamp(o2s, min=0)[:, None] * dof
                    + torch.arange(dof, device=dev)[None, :])
            xs = torch.where((o2s >= 0)[:, None], x_S[gidx], torch.zeros((), dtype=F64,
                                                                          device=dev))
            delta[t] = ((xi + xs) * free_own[t][:, None]).to(dtype)
        return delta, gnorm

    def gn_step(own, lam):
        c0t, lins = cost_of(with_sep(own, sep_exchange(own)))
        delta, gnorm = schur_solve(lins, lam)
        trial = boxplus_own(own, delta)
        c1t, _ = cost_of(with_sep(trial, sep_exchange(trial)))
        dsq = sum(torch.sum((delta[t].to(F64) ** 2) * free_own[t][:, None]) for t in tn)
        dnorm = torch.sqrt(mesh.all_reduce(dsq.reshape(1))[0])
        c0, c1, gn, dn = torch.stack(
            [c0t.to(F64), c1t.to(F64), gnorm.to(dtype).to(F64), dnorm]).tolist()
        ok = math.isfinite(c1) and c1 < c0
        return (trial if ok else own), c0, c1, gn, dn, ok

    def own_of(values):
        """This rank's own block of the global values, on the device."""
        return {t: row(plan.scatter_values(values)[t], dtype) for t in tn}

    def gather(own):
        """Every rank's own block -> the global values on every rank (one
        owner-writes all_reduce per type)."""
        out = {}
        for t in tn:
            lo, hi = plan.bounds[t][d], plan.bounds[t][d + 1]
            buf = torch.zeros((ga.counts[t],) + tuple(own[t].shape[1:]), dtype=dtype,
                              device=dev)
            buf[lo:hi] = own[t][: hi - lo]
            out[t] = mesh.all_reduce(buf)
        return out

    def probe(name, values=None, lam0=1e-4):
        """One phase probe on this rank (the JAX package's scaling
        decomposition): "lin_cost" (separator exchange + linearize + cost
        reduction), "schur_full" (one full Schur step), "schur_nopsum" (the
        same without the fused reduction), "schur_nosep" (without the
        replicated separator solve); each returns a (1,) tensor. "grad":
        the owner blocks of the gradient through the separator-tail
        reduction, {type: (n_loc, dof)}."""
        values = values if values is not None else ga.values0
        own = own_of(values)
        cth, lins = cost_of(with_sep(own, sep_exchange(own)))
        if name == "lin_cost":
            return cth.reshape(1)
        if name == "grad":
            return grad_of(lins)
        if name not in ("schur_full", "schur_nopsum", "schur_nosep"):
            raise ValueError(f"unknown probe {name!r}")
        delta, gn = schur_solve(lins, lam0, skip_psum=name == "schur_nopsum",
                                skip_sep=name == "schur_nosep")
        return (gn + 0.0 * sum(torch.sum(delta[t]) for t in tn) + 0.0 * cth).reshape(1)

    def solve(values=None, lam0=1e-4):
        values = values if values is not None else ga.values0
        before = mesh.collectives
        own, it, code = lm_loop(gn_step, own_of(values), lam0, max_iters, ftol, gtol, ct)
        fc, _ = cost_of(with_sep(own, sep_exchange(own)))
        out = gather(own)
        stats = dict(
            iterations=it,
            reason=ParametricSolver._REASONS.get(code, "?"),
            converged=code in (1, 3, 4) or (code == 5 and it > 3),
            final_cost=float(fc),
            schur_solves=it,
            # per LM iteration: the separator exchange (one per type), the
            # cost, ONE fused Schur pack, the trial's exchange and cost, the
            # step norm; then the final cost (1 + types) and the gather
            # (types)
            collectives=mesh.collectives - before,
            comms=plan.comms_note(),
        )
        return out, stats

    solve.probe = probe
    return solve, plan


def _factor(A):
    """Lower Cholesky factor of ``A``; all NaN when the factorization fails,
    so the trial cost is non-finite and LM rejects the step."""
    L, info = torch.linalg.cholesky_ex(A)
    if bool(info != 0):
        L.fill_(math.nan)
    return L
