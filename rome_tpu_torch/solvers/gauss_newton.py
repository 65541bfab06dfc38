"""Batched Levenberg-Marquardt over factor batches (counterpart of
``rome_tpu/solvers/gauss_newton.py``).

PyTorch runs eagerly, so the solve is one Python loop with the semantics of
the JAX package's host-scheduled loop (``ParametricSolver.solve_host``): one
LM step per iteration, the accept / Marquardt decisions on the host from one
transfer of the step's scalars.

Linear solvers ported so far:
  - ``dense``: f64 normal equations, Jacobi scaling, f32 Cholesky, two
    rounds of safeguarded f64 iterative refinement (small graphs);
  - ``ndchol``: the nested-dissection multifrontal f32 Cholesky
    (solvers/sparse) as the preconditioner of a short matrix-free f64 CG.
``dense32``, ``pcg`` and ``mixed`` are not ported yet (ROADMAP slice B2).

Precision split of the ndchol path: values, residuals, cost, gradient and CG
in f64; Jacobians, normal-equation entries and the front factorization in
f32; the Hvp in f32 only where the JAX package allows it (loose polish
tolerance and a metric scale <= 3). A Pose2Pose2 batch's f64 residual, f32
Jacobians, entry values and Jᵀr contributions come from one launch of the
hand kernel K1's normal epilogue per iteration.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rome_tpu_torch.graph.lower import GraphArrays
from rome_tpu_torch.solvers.linearize import (
    NormalEqWorkspace,
    cost_at,
    dense_normal_eqs,
    flatten_tangent,
    free_vector,
    gradient_from_lins,
    hvp_from_lins,
    linearize_all,
    linearize_all_mixed_j,
    normal_eq_entry_values,
    runtime_state,
    unflatten_tangent,
)

F32, F64 = torch.float32, torch.float64
_NOT_PORTED = ("dense32", "pcg", "mixed")


def _tdot(a, b):
    return sum(torch.dot(a[t].reshape(-1), b[t].reshape(-1)) for t in a)


def _safe(x):
    """Denominator guard: |x| < 1e-300 -> 1e-300."""
    return torch.where(torch.abs(x) < 1e-300, torch.full_like(x, 1e-300), x)


@dataclass
class GNOptions:
    """LM options: the JAX package's fields and defaults for the ported
    solvers.

    ``ftol=None`` -> dtype-aware: 1e-10 when values are carried in f64,
    3e-7 when they are f32. ``dtol_auto`` reads ``dtol`` as a per-dof RMS
    threshold in units of the median odometry edge length.
    ``fused_chordal`` is accepted so the JAX package's option sets apply
    unchanged; the solve always runs the chordal init as its own stage and
    then the one host-scheduled loop.
    """

    max_iters: int = 100
    lam0: float = 1e-6
    lam_min: float = 1e-12
    lam_max: float = 1e8
    lam_down: float = 0.25
    lam_up: float = 8.0
    gtol: float = 1e-8
    ftol: Optional[float] = None
    xtol: float = 1e-10
    linear: str = "auto"  # "dense"|"ndchol"|"auto" ("dense32"|"pcg"|"mixed" not ported)
    dense_threshold: int = 3000
    ir_rounds: int = 2
    polish_tol: float = 1e-6
    polish_iters: int = 40
    dtol: float = 0.0
    dtol_auto: bool = False
    chol_jitter: float = 3e-7
    nd_leaf: int = 16
    fused_chordal: bool = False
    mixed_jacobians: bool = True
    verbose: bool = False


@dataclass
class SolveStats:
    iterations: int
    final_cost: float
    gnorm: float
    converged: bool
    history: list
    linear: str
    reason: str = ""


def _symbolic_plan(ga: GraphArrays, leaf: int):
    """ndchol symbolic factorization of this graph's connectivity (cached
    on the host per connectivity, with its index tensors per device)."""
    from rome_tpu_torch.solvers.sparse import cached_symbolic, symbolic_factor

    vs = [b.vslots.cpu().numpy() for b in ga.batches]
    key = (
        "lm",
        tuple(ga.type_names),
        tuple(ga.counts[t] for t in ga.type_names),
        leaf,
        tuple((b.vtypes, v.tobytes()) for b, v in zip(ga.batches, vs)),
    )

    def build():
        dofs = {t: ga.manifolds[t].dof for t in ga.type_names}
        specs = [(b.vtypes, v) for b, v in zip(ga.batches, vs)]
        return symbolic_factor(ga.type_names, ga.counts, dofs, specs, leaf=leaf)

    return cached_symbolic(key, build, ga.device)


class ParametricSolver:
    """LM solver bound to one lowered graph."""

    _REASONS = {
        0: "max_iters",
        1: "gtol",
        2: "xtol",
        3: "ftol",
        4: "step_floor",
        5: "stalled",
        6: "dtol",
    }

    def __init__(self, ga: GraphArrays, opts: GNOptions = None):
        self.ga = ga
        self.opts = opts = opts or GNOptions()
        linear = opts.linear
        if linear == "auto":
            # above the dense threshold the JAX package picks dense32
            linear = "dense" if ga.total_dof <= opts.dense_threshold else "dense32"
        if linear in _NOT_PORTED:
            raise NotImplementedError(
                f"linear={linear!r} is not ported yet (ROADMAP slice B2); "
                "use 'ndchol' or 'dense'"
            )
        if linear not in ("dense", "ndchol"):
            raise ValueError(f"unknown linear solver {linear!r}")
        self.linear = linear
        # ndchol carries values in f64 (only the factorization drops to f32)
        self._use64 = linear == "ndchol" and ga.dtype == F32
        self._ga64 = copy.copy(ga)
        self._ga64.dtype = F64
        self._gaW = self._ga64 if self._use64 else ga
        self._ftol = (
            opts.ftol if opts.ftol is not None
            else (1e-10 if (self._use64 or ga.dtype == F64) else 3e-7)
        )
        # dataset metric scale: median pairwise-odometry edge length
        norms = []
        for b in ga.batches:
            if b.ftype.arity == 2 and "z" in b.params:
                z = b.params["z"].cpu().numpy()
                if z.ndim == 2 and z.shape[1] >= 2:
                    norms.append(np.linalg.norm(z[:, : min(3, z.shape[1] - 1)], axis=1))
        scale = float(np.median(np.concatenate(norms))) if norms else 1.0
        self._edge_scale = scale or 1.0
        if opts.dtol_auto and opts.dtol > 0:
            self._dtol = opts.dtol * self._edge_scale * float(np.sqrt(max(ga.total_dof, 1)))
        else:
            self._dtol = opts.dtol
        self._rt0 = runtime_state(ga)
        self._sym, self._nd = (
            _symbolic_plan(ga, opts.nd_leaf) if linear == "ndchol" else (None, None)
        )
        # cost accumulation dtype: always f64
        self._cdt = F64
        self._mixed_j = linear == "ndchol" and opts.mixed_jacobians and self._use64
        # the mixed path's entry vector and K1 normal-epilogue plans, reused
        # by every iteration
        self._ws = NormalEqWorkspace(self._gaW) if self._mixed_j else None

    # -- building blocks ---------------------------------------------------------
    def _linearize(self, values, rt):
        """(lins, NormalParts or None)."""
        if self._mixed_j:
            return linearize_all_mixed_j(self._gaW, self.ga, values, rt, self._ws)
        return linearize_all(self._gaW, values, rt), None

    def _boxplus_all(self, values, delta, rt):
        out = {}
        for t in self._gaW.type_names:
            man = self._gaW.manifolds[t]
            d = delta[t] * rt["free"][t][:, None]
            out[t] = man.normalize(man.boxplus(values[t], d))
        return out

    def _cg_polish(self, minv, hD, b, tol):
        """CG on the true damped system, preconditioned by the fresh f32
        factorization. Returns (x, residual, iterations)."""
        bn = float(torch.linalg.norm(b)) + 1e-300
        x = torch.zeros_like(b)
        r = b
        p = torch.zeros_like(b)
        rz = torch.zeros((), dtype=b.dtype, device=b.device)
        k = 0
        while k < self.opts.polish_iters and float(torch.linalg.norm(r)) > tol * bn:
            z = minv(r)
            rz2 = torch.dot(r, z)
            beta = rz2 / _safe(rz) if k else torch.zeros_like(rz2)
            p = z + beta * p
            Ap = hD(p)
            alpha = rz2 / _safe(torch.dot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            rz = rz2
            k += 1
        return x, r, k

    def _solve_dense(self, lins, lam, rt, _parts=None):
        """f64 assembly, Jacobi scaling, f32 Cholesky, safeguarded f64
        iterative refinement."""
        ga, opts = self.ga, self.opts
        use64 = opts.ir_rounds > 0
        hdt = F64 if use64 else ga.dtype
        H, g = dense_normal_eqs(ga, lins, dtype=hdt, rt=rt)
        diag = torch.clamp(torch.diagonal(H), min=1e-8)
        Hd = H + torch.tensor(lam, dtype=ga.dtype, device=ga.device).to(hdt) * torch.diag(diag)
        d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-12))
        Hs = Hd * d[:, None] * d[None, :]
        bs = -g * d
        L, info = torch.linalg.cholesky_ex(Hs.to(ga.dtype))
        if int(info) != 0:
            L = torch.full_like(L, math.nan)

        def cho_solve(v):
            return torch.cholesky_solve(v.to(ga.dtype)[:, None], L)[:, 0].to(hdt)

        y = cho_solve(bs)
        if use64:
            # safeguarded refinement: keep the iterate with the smallest f64
            # residual
            y_best, rn_best = y, math.inf
            for _ in range(opts.ir_rounds):
                r = bs - Hs @ y
                rn = float(torch.linalg.norm(r))
                if rn < rn_best:
                    y_best, rn_best = y, rn
                y = y + cho_solve(r)
            if not float(torch.linalg.norm(bs - Hs @ y)) < rn_best:
                y = y_best
        x = ((y * d) * free_vector(ga, rt).to(hdt)).to(ga.dtype)
        return unflatten_tangent(ga, x), g.to(ga.dtype), True, {}

    def _solve_ndchol(self, lins, lam, rt, parts=None):
        """ND multifrontal f32 Cholesky preconditioning a short matrix-free
        CG on the true damped system (f64 RHS, Hvp as gated below). ``parts``
        carries the entry values and Jᵀr contributions of the batches the
        normal epilogue served."""
        from rome_tpu_torch.solvers.sparse import (
            ndchol_assemble, ndchol_factorize, ndchol_solve,
        )

        ga, gaW, opts = self.ga, self._gaW, self.opts
        sym, nd = self._sym, self._nd
        wdt = gaW.dtype
        jitter, ptol = opts.chol_jitter, opts.polish_tol
        vals = normal_eq_entry_values(gaW, lins, dtype=F32, parts=parts)
        fvec32 = free_vector(gaW, rt).to(F32)
        lam32 = torch.tensor(lam, dtype=F32, device=ga.device)
        diag_H = torch.zeros(sym.D, dtype=F32, device=ga.device).index_add_(
            0, nd["diag_dst"], vals[nd["diag_src"]] * fvec32[nd["diag_dst"]] ** 2
        )
        dv = torch.rsqrt(torch.clamp(diag_H * (1.0 + lam32), min=1e-12))
        df = dv * fvec32
        diag_add = fvec32 * (lam32 / (1.0 + lam32) + jitter) + (1.0 - fvec32)
        Ws = ndchol_assemble(sym, nd, vals, df, diag_add)
        Linvs, L21s, _L11s = ndchol_factorize(sym, nd, Ws)

        def minv(r):
            y = ndchol_solve(sym, nd, Linvs, L21s, r.to(F32) * df)
            return (y * df).to(wdt)

        g = gradient_from_lins(gaW, lins, rt, parts=parts)
        fvecW = free_vector(gaW, rt).to(wdt)
        diagW = diag_H.to(wdt)
        lamW = lam32.to(wdt)

        # the loose polish tolerates an f32 Hvp, except on large metric
        # scales: on the 10 m city grid the f32 Hvp's rounding stalls LM
        # (+12.7% cost in the JAX package), so there the f64 Hvp is kept
        if opts.polish_tol >= 1e-3 and wdt != F32 and self._edge_scale <= 3.0:
            lins32 = [
                (bb, r0.to(F32), tuple(J.to(F32) for J in Js), vs)
                for bb, r0, Js, vs in lins
            ]

            def hD(x):
                x32 = x.to(F32)
                out = hvp_from_lins(ga, lins32, unflatten_tangent(ga, x32), rt)
                return ((flatten_tangent(ga, out) + lam32 * diag_H * x32) * fvec32).to(wdt)
        else:
            def hD(x):
                out = hvp_from_lins(gaW, lins, unflatten_tangent(gaW, x), rt)
                return (flatten_tangent(gaW, out) + lamW * diagW * x) * fvecW

        b = -flatten_tangent(gaW, g)
        x, r, k = self._cg_polish(minv, hD, b, tol=ptol)
        delta = unflatten_tangent(gaW, x)
        bn = torch.linalg.norm(b) + 1e-300
        exact = torch.linalg.norm(r) <= ptol * bn
        pred = 0.5 * (torch.dot(b, x) + torch.dot(x, r))
        return delta, g, exact, {"pred": pred, "cg_iters": k}

    def step(self, values, lam, rt):
        """One LM iteration at ``values`` with damping ``lam`` (np.float32).

        Returns (trial values, cost0, cost1, gnorm, dnorm, exact, pred,
        cg_iters) with the scalars as host floats."""
        gaW = self._gaW
        lins, parts = self._linearize(values, rt)
        cost0 = sum(0.5 * torch.sum(r0.to(self._cdt) ** 2) for _b, r0, _J, _v in lins)
        solve = self._solve_ndchol if self.linear == "ndchol" else self._solve_dense
        delta, g, exact, extras = solve(lins, lam, rt, parts)
        gvec = g if isinstance(g, dict) else unflatten_tangent(gaW, g)
        gnorm = torch.sqrt(_tdot(gvec, gvec))
        dnorm = torch.sqrt(_tdot(delta, delta))
        trial = self._boxplus_all(values, delta, rt)
        cost1 = cost_at(gaW, trial, rt, accum_dtype=self._cdt)
        if "pred" in extras:
            pred = extras["pred"].to(self._cdt)
        else:
            Hd = hvp_from_lins(gaW, lins, delta, rt)
            pred = (-(_tdot(gvec, delta) + 0.5 * _tdot(delta, Hd))).to(self._cdt)
        exact_t = torch.as_tensor(exact, device=pred.device).to(self._cdt)
        # ONE device-to-host transfer for every scalar the host loop needs
        c0, c1, gn, dn, pr, ex = torch.stack([
            cost0.to(self._cdt), cost1, gnorm.to(self._cdt), dnorm.to(self._cdt),
            pred, exact_t,
        ]).tolist()
        return trial, c0, c1, gn, dn, bool(ex), pr, int(extras.get("cg_iters", 0))

    # -- the host-scheduled LM loop -------------------------------------------------
    def solve(self, values=None, rt=None):
        """LM with the Marquardt schedule on the host (the JAX package's
        ``solve_host`` semantics)."""
        ga, opts = self.ga, self.opts
        values = values or ga.values0
        if self._use64:
            values = {t: v.to(F64) for t, v in values.items()}
        rt = rt if rt is not None else self._rt0
        lam = np.float32(opts.lam0)
        step_floor = 1e-4 if ga.dtype == F32 else 1e-9
        hist = []
        cost_prev = math.inf
        n_rej = 0
        code = 0
        gnorm = math.nan
        for it in range(int(opts.max_iters)):
            trial, c0, c1, gn, dn, exact, pred, cg_k = self.step(values, lam, rt)
            rho = (c0 - c1) / (pred if pred > 1e-30 else 1e-30)
            okb = math.isfinite(c1) and c1 < c0
            # Marquardt schedule in f32, as the JAX package's f32 lam
            grow = np.minimum(lam * np.float32(opts.lam_up), np.float32(opts.lam_max))
            shrink = np.maximum(lam * np.float32(opts.lam_down), np.float32(opts.lam_min))
            if not okb or rho < 0.25:
                lam = grow
            elif rho > 0.7:
                lam = shrink
            gnorm = gn
            hist.append(
                dict(iter=it, cost0=c0, cost1=c1, gnorm=gn, dnorm=dn,
                     accepted=okb, lam=float(lam), cg=cg_k)
            )
            if opts.verbose:
                print(
                    f"  LM it={it} cost={c0:.6g}->{c1:.6g} |g|={gn:.3g} "
                    f"|dx|={dn:.3g} ok={okb} lam={float(lam):.1e} cg={cg_k}"
                )
            if okb:
                values = trial
                # ftol/xtol only trusted on an exact (non-truncated) solve
                if gn < opts.gtol:
                    code = 1
                elif exact and dn < opts.xtol:
                    code = 2
                elif exact and math.isfinite(cost_prev) and abs(cost_prev - c1) <= (
                    self._ftol * max(1.0, abs(cost_prev))
                ):
                    code = 3
                elif self._dtol > 0 and dn < self._dtol and float(lam) <= opts.lam0:
                    code = 6
                cost_prev = c1
                n_rej = 0
            else:
                n_rej += 1
                if dn < step_floor:
                    code = 4
                elif n_rej >= 8 or float(lam) >= opts.lam_max:
                    code = 5
            if code:
                break
        it_total = len(hist)
        converged = code in (1, 2, 3, 4, 6) or (code == 5 and n_rej >= 8 and it_total > 3)
        # final cost accumulated in the graph dtype, as the JAX package's
        final_cost = float(cost_at(ga, values, rt))
        stats = SolveStats(
            iterations=it_total,
            final_cost=final_cost,
            gnorm=gnorm,
            converged=bool(converged),
            history=hist,
            linear=self.linear,
            reason=self._REASONS.get(code, "max_iters"),
        )
        return values, stats
