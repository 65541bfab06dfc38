"""Batched Levenberg-Marquardt over factor batches (counterpart of
``rome_tpu/solvers/gauss_newton.py``).

PyTorch runs eagerly, so each LM loop is a Python loop that makes the accept
and Marquardt decisions on the host from one transfer of an iteration's
scalars. Two loops, as in the JAX package:
  - ``ParametricSolver.solve_host``: one LM step per iteration, the trial
    cost from a separate residual pass (``cost_at``);
  - ``ParametricSolver.solve``: for ``linear="ndchol"`` with
    ``GNOptions.speculative`` (the default), the speculative-accept loop,
    which linearizes at the trial point: its residuals are the trial cost,
    and an accepted step hands its linearization to the next iteration. For
    every other solver ``solve`` is ``solve_host``.

Linear solvers (``GNOptions.linear``):
  - ``dense``: f64 normal equations, Jacobi scaling, f32 Cholesky, two
    rounds of safeguarded f64 iterative refinement (small graphs);
  - ``dense32``: f32 dense normal equations, one f32 Cholesky per iteration
    preconditioning a short matrix-free CG on the true damped system;
  - ``ndchol``: the nested-dissection multifrontal f32 Cholesky
    (solvers/sparse) as the preconditioner of that CG, optionally reused
    across iterations (``precond_reuse``);
  - ``pcg``: block-Jacobi preconditioned CG on the matrix-free Hvp;
  - ``mixed``: a lazily refreshed explicit f32 inverse preconditioning an
    f64 matrix-free CG;
  - ``auto``: ``dense`` up to ``dense_threshold`` total dof, else
    ``dense32``.

Precision split of the dense32 and ndchol paths: values, residuals, cost,
gradient and CG in f64; the factorization in f32 (ndchol: also the
Jacobians and normal-equation entries, and the Hvp where the JAX package
allows it: loose polish tolerance and a metric scale <= 3). A Pose2Pose2
batch's f64 residual, f32 Jacobians, entry values and Jᵀr contributions come
from one launch of the hand kernel K1's normal epilogue per linearize.

Marginal covariances (``marginal_covariances``): the dense inverse of the
undamped information matrix, or the Takahashi selected inverse along the
nested-dissection elimination tree.
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
    block_diag_from_lins,
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
    structure_signature,
    tangent_offsets,
    TangentScatter,
    unflatten_tangent,
)
from rome_tpu_torch.utils.math import einsum

F32, F64 = torch.float32, torch.float64
_LINEAR = ("dense", "dense32", "ndchol", "pcg", "mixed")


def _tdot(a, b):
    return sum(torch.dot(a[t].reshape(-1), b[t].reshape(-1)) for t in a)


def _safe(x, eps=1e-300):
    """Denominator guard: |x| < eps -> eps."""
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def _nan_if_failed(L, info):
    """A Cholesky factor that did not complete is all NaN: the LM loop sees a
    non-finite trial cost and rejects the step (one host sync)."""
    if bool((info != 0).any()):
        L.fill_(math.nan)
    return L


def pcg(hvp, b, precond, tol, maxiter):
    """Solve H x = b with preconditioned conjugate gradients over tangent
    dicts. Returns ``(x, iters, converged)``; ``converged`` is the explicit
    residual test |r| <= tol |b|, which gates ftol/xtol in the LM loop and
    refreshes the mixed solver's preconditioner."""
    x = {t: torch.zeros_like(b[t]) for t in b}
    r = b
    z = precond(r)
    p = z
    rz = _tdot(r, z)
    bnorm = torch.sqrt(_tdot(b, b)) + 1e-30
    k = 0
    while k < maxiter and bool(torch.sqrt(_tdot(r, r)) > tol * bnorm):
        Hp = hvp(p)
        alpha = rz / _safe(_tdot(p, Hp), 1e-30)
        x = {t: x[t] + alpha * p[t] for t in x}
        r = {t: r[t] - alpha * Hp[t] for t in r}
        z = precond(r)
        rz_new = _tdot(r, z)
        beta = rz_new / _safe(rz, 1e-30)
        p = {t: z[t] + beta * p[t] for t in p}
        rz = rz_new
        k += 1
    return x, k, bool(torch.sqrt(_tdot(r, r)) <= tol * bnorm)


@dataclass
class GNOptions:
    """LM options: the JAX package's fields and defaults.

    ``ftol=None`` -> dtype-aware: 1e-10 when values are carried in f64,
    3e-7 when they are f32. ``dtol_auto`` reads ``dtol`` as a per-dof RMS
    threshold in units of the median odometry edge length.
    ``fused_chordal`` is accepted so the JAX package's option sets apply
    unchanged; the chordal init always runs as its own stage before LM.
    ``speculative``: the ndchol speculative-accept loop in ``solve``.
    ``precond_reuse``: ndchol reuses its factorization until a CG runs to
    ``precond_cg_cap`` iterations (or a step is rejected in the speculative
    loop).
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
    linear: str = "auto"  # "dense"|"dense32"|"ndchol"|"pcg"|"mixed"|"auto"
    dense_threshold: int = 3000   # total dof up to which auto picks dense
    pcg_iters: int = 250
    pcg_tol: float = 1e-8
    ir_rounds: int = 2            # f64 iterative-refinement rounds (dense)
    mixed_cg_iters: int = 50      # f64 CG iterations (mixed)
    polish_tol: float = 1e-6      # dense32/ndchol CG relative residual tol
    polish_iters: int = 40        # dense32/ndchol CG iteration cap
    dtol: float = 0.0
    dtol_auto: bool = False
    chol_jitter: float = 3e-7
    nd_leaf: int = 16
    fused_chordal: bool = False
    mixed_jacobians: bool = True
    speculative: bool = True
    precond_reuse: bool = False
    precond_cg_cap: int = 15
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


def _symbolic_plan(ga: GraphArrays, leaf: int, vslots=None):
    """ndchol symbolic factorization of a connectivity (``vslots`` per batch,
    default the graph's own), cached on the host per connectivity bytes,
    with its index tensors per device."""
    from rome_tpu_torch.solvers.sparse import cached_symbolic, symbolic_factor
    from rome_tpu_torch.solvers.sparse.symbolic import entry_keys

    vslots = [b.vslots for b in ga.batches] if vslots is None else vslots
    vs = [v.cpu().numpy() for v in vslots]
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
        sym = symbolic_factor(ga.type_names, ga.counts, dofs, specs, leaf=leaf)
        sym.entry_key = entry_keys(dofs, specs)
        return sym

    return cached_symbolic(key, build, ga.device)


def _cast_floats(tree, src, dst):
    """``tree`` (dicts, tuples, tensors) with every ``src`` tensor in ``dst``."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, src, dst) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_cast_floats(v, src, dst) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == src:
        return tree.to(dst)
    return tree


def _row_blocked_tri_inv(L, blk=1024):
    """L^-1 of a lower-triangular (n, n) ``L``, solved for blocks of ``blk``
    rows (x L = rows of the identity), so the working set stays one block of
    right-hand sides besides the result."""
    n = L.shape[0]
    Linv = torch.empty_like(L)
    for s in range(0, n, blk):
        e = min(s + blk, n)
        c = L.new_zeros((e - s, n))
        torch.diagonal(c, offset=s).fill_(1.0)
        Linv[s:e] = torch.linalg.solve_triangular(L, c, upper=False, left=False)
    return Linv


_SOLVER_CACHE: dict = {}
_SOLVER_CACHE_MAX = 8


class ParametricSolver:
    """LM solver bound to one lowered graph STRUCTURE; the graph's data rides
    in through ``rt`` (``runtime_state``), so :meth:`cached` can hand one
    solver graphs of the same structure."""

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
            linear = "dense" if ga.total_dof <= opts.dense_threshold else "dense32"
        if linear not in _LINEAR:
            raise ValueError(f"unknown linear solver {linear!r}")
        self.linear = linear
        # dense32/ndchol carry values in f64 (only the factorization drops to f32)
        self._use64 = linear in ("dense32", "ndchol") and ga.dtype == F32
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
        self._scatter = TangentScatter.of(ga, self._rt0["vslots"])
        self._sym, self._nd = (
            _symbolic_plan(ga, opts.nd_leaf) if linear == "ndchol" else (None, None)
        )
        # cost accumulation dtype: always f64; the damping in the graph dtype
        self._cdt = F64
        self._lam_type = np.float32 if ga.dtype == F32 else np.float64
        self._mixed_j = linear == "ndchol" and opts.mixed_jacobians and self._use64
        self._speculative = linear == "ndchol" and opts.speculative
        # the mixed path's entry vector and K1 normal-epilogue plans, reused by
        # every iteration; the speculative loop keeps a second set for the
        # trial point (the current point's linearization must survive it)
        self._ws = NormalEqWorkspace(self._gaW) if self._mixed_j else None
        self._ws_trial = (
            NormalEqWorkspace(self._gaW) if self._mixed_j and self._speculative else None
        )

    @classmethod
    def cached(cls, ga: GraphArrays, opts: GNOptions = None):
        """Structure-keyed solver reuse: the same structure signature and
        options give the same solver (pass the new graph's runtime_state and
        values to :meth:`solve`). At most ``_SOLVER_CACHE_MAX`` solvers are
        kept: a full cache is cleared."""
        opts = opts or GNOptions()
        key = (structure_signature(ga), tuple(sorted(vars(opts).items())))
        solver = _SOLVER_CACHE.get(key)
        if solver is None:
            if len(_SOLVER_CACHE) >= _SOLVER_CACHE_MAX:
                _SOLVER_CACHE.clear()
            solver = _SOLVER_CACHE[key] = cls(ga, opts)
        return solver

    # -- building blocks ---------------------------------------------------------
    def _plan_for(self, rt):
        """The ndchol (plan, index tensors) of the connectivity ``rt`` holds:
        this graph's own, or one re-derived (and cached) for another's."""
        vs, own = rt["vslots"], self._rt0["vslots"]
        if len(vs) == len(own) and all(a is b for a, b in zip(vs, own)):
            return self._sym, self._nd
        return _symbolic_plan(self.ga, self.opts.nd_leaf, vs)

    def _scatter_for(self, rt):
        """The tangent sums' plan (``TangentScatter``) of ``rt``'s
        connectivity: this graph's own, or one made for another's."""
        vs, own = rt["vslots"], self._rt0["vslots"]
        if len(vs) == len(own) and all(a is b for a, b in zip(vs, own)):
            return self._scatter
        return TangentScatter.of(self.ga, vs)

    def _start(self, values, rt):
        """(values in the working dtype, rt with the ndchol plan and the
        tangent sums' plan)."""
        values = values or self.ga.values0
        if self._use64:
            values = {t: v.to(F64) for t, v in values.items()}
        rt = rt if rt is not None else self._rt0
        if self.linear == "ndchol" and "ndchol" not in rt:
            rt = {**rt, "ndchol": self._plan_for(rt)}
        if "scatter" not in rt:
            rt = {**rt, "scatter": self._scatter_for(rt)}
        return values, rt

    def _pstate0(self):
        """Initial lazy-preconditioner state: stale, so the first iteration
        factorizes."""
        if self.linear == "mixed" or (self.linear == "ndchol" and self.opts.precond_reuse):
            return {"stale": True}
        return {}

    def _linearize(self, values, rt, ws=None):
        """(lins, NormalParts or None); ``ws`` defaults to the solver's own
        workspace."""
        if self._mixed_j:
            ws = self._ws if ws is None else ws
            return linearize_all_mixed_j(self._gaW, self.ga, values, rt, ws)
        return linearize_all(self._gaW, values, rt), None

    def _sumsq(self, lins):
        return sum(0.5 * torch.sum(r0.to(self._cdt) ** 2) for _b, r0, _J, _v in lins)

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

    def _polish_result(self, gaW, g, x, r, k, tol):
        """(delta, g, exact, extras) of a CG polish: ``exact`` is the residual
        test, ``pred`` the model reduction from the CG state (H x = b - r and
        b = -g, so pred = 0.5 b.x + 0.5 x.r)."""
        b = -flatten_tangent(gaW, g)
        exact = torch.linalg.norm(r) <= tol * (torch.linalg.norm(b) + 1e-300)
        pred = 0.5 * (torch.dot(b, x) + torch.dot(x, r))
        return unflatten_tangent(gaW, x), g, exact, {"pred": pred, "cg_iters": k}

    def _linear_solve(self, lins, lam, rt, parts, pstate):
        """(delta, g, exact, extras) of this solver's linear solve; extras may
        carry "pred", "cg_iters" and the next "pstate"."""
        return getattr(self, f"_solve_{self.linear}")(lins, lam, rt, parts, pstate)

    # -- linear solvers ---------------------------------------------------------
    def _solve_dense(self, lins, lam, rt, parts=None, pstate=None):
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
        L = _nan_if_failed(L, info)

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

    def _solve_dense32(self, lins, lam, rt, parts=None, pstate=None):
        """f32 dense normal equations with Jacobi scaling and ``chol_jitter``,
        ONE f32 Cholesky as the preconditioner of a short CG on the true
        damped system with the matrix-free Hvp in the working dtype. H is
        damped, scaled and factored in place: H and L are the only D x D
        buffers."""
        gaW, opts = self._gaW, self.opts
        wdt = gaW.dtype
        lam32 = torch.tensor(lam, dtype=F32, device=gaW.device)
        H, _g32 = dense_normal_eqs(gaW, lins, dtype=F32, rt=rt)
        diag = torch.clamp(torch.diagonal(H), min=1e-8)
        H.diagonal().add_(lam32 * diag)                 # Hd
        d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
        H.mul_(d[:, None]).mul_(d[None, :])             # Hs = D Hd D
        H.diagonal().add_(opts.chol_jitter)
        L = _nan_if_failed(*torch.linalg.cholesky_ex(H))
        del H
        fvec = free_vector(gaW, rt).to(wdt)

        def minv(r):
            y = torch.cholesky_solve((r.to(F32) * d)[:, None], L)[:, 0]
            return (y * d).to(wdt) * fvec

        g = gradient_from_lins(gaW, lins, rt, parts=parts)
        diagW, lamW = diag.to(wdt), lam32.to(wdt)

        def hD(x):
            out = hvp_from_lins(gaW, lins, unflatten_tangent(gaW, x), rt)
            return (flatten_tangent(gaW, out) + lamW * diagW * x) * fvec

        x, r, k = self._cg_polish(minv, hD, -flatten_tangent(gaW, g), tol=opts.polish_tol)
        return self._polish_result(gaW, g, x, r, k, opts.polish_tol)

    def _solve_ndchol(self, lins, lam, rt, parts=None, pstate=None):
        """ND multifrontal f32 Cholesky preconditioning a short matrix-free
        CG on the true damped system (f64 RHS, Hvp as gated below). ``parts``
        carries the entry values and Jᵀr contributions of the batches the
        normal epilogue served. With ``precond_reuse`` the factorization of
        ``pstate`` serves until it is stale."""
        from rome_tpu_torch.solvers.sparse import (
            ndchol_assemble, ndchol_factorize, ndchol_solve,
        )

        ga, gaW, opts = self.ga, self._gaW, self.opts
        sym, nd = rt["ndchol"] if "ndchol" in rt else self._plan_for(rt)
        wdt = gaW.dtype
        jitter, ptol = opts.chol_jitter, opts.polish_tol
        vals = normal_eq_entry_values(gaW, lins, dtype=F32, parts=parts)
        fvec32 = free_vector(gaW, rt).to(F32)
        lam32 = torch.tensor(lam, dtype=F32, device=ga.device)
        # the free mask is 0/1, so it applies after the sum exactly
        diag_H = nd["sum_diag"].add_(torch.zeros(sym.D, dtype=F32, device=ga.device),
                                     vals) * fvec32
        dv = torch.rsqrt(torch.clamp(diag_H * (1.0 + lam32), min=1e-12))
        df = dv * fvec32
        if opts.precond_reuse and not (pstate or {}).get("stale", True):
            Linvs, L21s, dfp = pstate["Linvs"], pstate["L21s"], pstate["df"]
        else:
            diag_add = fvec32 * (lam32 / (1.0 + lam32) + jitter) + (1.0 - fvec32)
            Ws = ndchol_assemble(sym, nd, vals, df, diag_add)
            Linvs, L21s, _L11s = ndchol_factorize(sym, nd, Ws)
            dfp = df

        def minv(r):
            y = ndchol_solve(sym, nd, Linvs, L21s, r.to(F32) * dfp)
            return (y * dfp).to(wdt)

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

        x, r, k = self._cg_polish(minv, hD, -flatten_tangent(gaW, g), tol=ptol)
        out = self._polish_result(gaW, g, x, r, k, ptol)
        if opts.precond_reuse:
            # refresh signal: the CG needed enough iterations that the reused
            # factor stopped paying for itself
            out[3]["pstate"] = {"Linvs": Linvs, "L21s": L21s, "df": dfp,
                                "stale": k >= opts.precond_cg_cap}
        return out

    def _solve_pcg(self, lins, lam, rt, parts=None, pstate=None):
        """Block-Jacobi preconditioned CG on the matrix-free damped Hvp, in
        the graph dtype."""
        ga, opts = self.ga, self.opts
        free = rt["free"]
        gvec = gradient_from_lins(ga, lins, rt)
        D = block_diag_from_lins(ga, lins, rt)
        lamt = torch.tensor(lam, dtype=ga.dtype, device=ga.device)
        dd, Pinv = {}, {}
        for t in ga.type_names:
            eye = torch.eye(ga.manifolds[t].dof, dtype=ga.dtype, device=ga.device)
            # Marquardt damping on the diagonal of JᵀJ
            dd[t] = torch.clamp(torch.diagonal(D[t], dim1=-2, dim2=-1), min=1e-8)
            blk = D[t] + lamt * dd[t][..., None] * eye + 1e-8 * eye
            fmask = free[t][:, None, None]
            Pinv[t] = torch.linalg.inv_ex(blk * fmask + eye * (1.0 - fmask))[0]

        def hvp(v):
            out = hvp_from_lins(ga, lins, v, rt)
            return {t: (out[t] + lamt * dd[t] * v[t]) * free[t][:, None] for t in out}

        def precond(r):
            return {t: einsum("nij,nj->ni", Pinv[t], r[t]) * free[t][:, None] for t in r}

        x, _k, cg_ok = pcg(hvp, {t: -gvec[t] for t in gvec}, precond, opts.pcg_tol,
                           opts.pcg_iters)
        return x, gvec, cg_ok, {}

    def _mixed_refresh(self, lins, lamt, rt):
        """The mixed solver's preconditioner: the damped, Jacobi-scaled H in
        the graph dtype (+1e-6 on the unit diagonal), one Cholesky and the
        explicit inverse factor L^-1 by row blocks of 1,024. Returns
        (L^-1, the scaling vector)."""
        ga = self.ga
        H, _g = dense_normal_eqs(ga, lins, dtype=ga.dtype, rt=rt)
        diag = torch.clamp(torch.diagonal(H), min=1e-8)
        H.diagonal().add_(lamt * diag)                  # Hd
        dvec = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
        H.mul_(dvec[:, None]).mul_(dvec[None, :])       # Hs
        H.diagonal().add_(1e-6)
        L = _nan_if_failed(*torch.linalg.cholesky_ex(H))
        del H
        return _row_blocked_tri_inv(L), dvec

    def _solve_mixed(self, lins, lam, rt, parts=None, pstate=None):
        """Exact f64 Gauss-Newton steps: an f64 matrix-free CG on the true
        damped system, preconditioned by an explicit f32 inverse that is
        refreshed lazily: only when the previous CG missed its tolerance
        (``stale``)."""
        ga, ga64, opts = self.ga, self._ga64, self.opts
        lamt = torch.tensor(lam, dtype=ga.dtype, device=ga.device)
        if (pstate or {}).get("stale", True):
            Linv, dvec = self._mixed_refresh(lins, lamt, rt)
        else:
            Linv, dvec = pstate["Linv"], pstate["dvec"]
        fvec = free_vector(ga, rt).to(F64)

        def precond(r):
            # Hs^-1 = L^-T L^-1: two matvecs per apply
            x = flatten_tangent(ga, r).to(ga.dtype)
            x = Linv.T @ (Linv @ (x * dvec))
            return unflatten_tangent(ga64, (x * dvec).to(F64) * fvec)

        lins64 = [(b, r0.to(F64), tuple(J.to(F64) for J in Js), vs) for b, r0, Js, vs in lins]
        rt64 = _cast_floats(rt, ga.dtype, F64)
        g64 = gradient_from_lins(ga64, lins64, rt64)
        D64 = block_diag_from_lins(ga64, lins64, rt64)
        lam64 = lamt.to(F64)
        dd = {t: torch.clamp(torch.diagonal(D64[t], dim1=-2, dim2=-1), min=1e-8) for t in D64}

        def hvp(v):
            out = hvp_from_lins(ga64, lins64, v, rt64)
            return {t: (out[t] + lam64 * dd[t] * v[t]) * rt64["free"][t][:, None] for t in out}

        x, _k, cg_ok = pcg(hvp, {t: -g64[t] for t in g64}, precond, 1e-8, opts.mixed_cg_iters)
        # a CG that missed its tolerance: the reused factor no longer
        # preconditions well; refactorize next iteration
        extras = {"pstate": {"Linv": Linv, "dvec": dvec, "stale": not cg_ok}}
        return ({t: x[t].to(ga.dtype) for t in x}, {t: g64[t].to(ga.dtype) for t in g64},
                cg_ok, extras)

    # -- one LM step (the host-scheduled loop) ------------------------------------
    def step(self, values, lam, rt, pstate=None):
        """One LM iteration at ``values`` with damping ``lam`` (a numpy scalar
        of the graph dtype).
        ``pstate`` (a lazy-preconditioner state dict) is updated in place.

        Returns (trial values, cost0, cost1, gnorm, dnorm, exact, pred,
        cg_iters) with the scalars as host floats."""
        gaW = self._gaW
        lins, parts = self._linearize(values, rt)
        cost0 = self._sumsq(lins)
        delta, g, exact, extras = self._linear_solve(lins, lam, rt, parts, pstate)
        if pstate is not None and "pstate" in extras:
            pstate.update(extras["pstate"])
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

    def _marquardt(self, lam, okb, rho):
        """The damping after a step, in the graph dtype as the JAX package's
        lam."""
        opts, lt = self.opts, self._lam_type
        if not okb or rho < 0.25:
            return np.minimum(lam * lt(opts.lam_up), lt(opts.lam_max))
        if rho > 0.7:
            return np.maximum(lam * lt(opts.lam_down), lt(opts.lam_min))
        return lam

    def _accepted_code(self, gn, dn, exact, cost_prev, c1, lam, lam0):
        """Convergence code of an accepted step (0: go on). ftol/xtol only
        trust an exact (non-truncated) solve; dtol needs lam <= ``lam0``."""
        opts = self.opts
        if gn < opts.gtol:
            return 1
        if exact and dn < opts.xtol:
            return 2
        if exact and math.isfinite(cost_prev) and abs(cost_prev - c1) <= (
                self._ftol * max(1.0, abs(cost_prev))):
            return 3
        if self._dtol > 0 and dn < self._dtol and float(lam) <= lam0:
            return 6
        return 0

    def _rejected_code(self, dn, n_rej, lam, step_floor):
        if dn < step_floor:
            return 4
        if n_rej >= 8 or float(lam) >= self.opts.lam_max:
            return 5
        return 0

    def _stats(self, hist, code, n_rej, gnorm, final_cost):
        converged = code in (1, 2, 3, 4, 6) or (code == 5 and n_rej >= 8 and len(hist) > 3)
        return SolveStats(
            iterations=len(hist),
            final_cost=final_cost,
            gnorm=gnorm,
            converged=bool(converged),
            history=hist,
            linear=self.linear,
            reason=self._REASONS.get(code, "max_iters"),
        )

    def _record(self, hist, it, c0, c1, gn, dn, okb, lam, cg_k):
        hist.append(dict(iter=it, cost0=c0, cost1=c1, gnorm=gn, dnorm=dn,
                         accepted=okb, lam=float(lam), cg=cg_k))
        if self.opts.verbose:
            print(f"  LM it={it} cost={c0:.6g}->{c1:.6g} |g|={gn:.3g} "
                  f"|dx|={dn:.3g} ok={okb} lam={float(lam):.1e} cg={cg_k}")

    # -- the LM loops -----------------------------------------------------------------
    def solve_host(self, values=None, rt=None):
        """LM with one step per iteration and the trial cost from a separate
        residual pass (the JAX package's ``solve_host``). ``rt`` is the
        graph's runtime_state (this solver's own by default)."""
        ga, opts = self.ga, self.opts
        values, rt = self._start(values, rt)
        lam = self._lam_type(opts.lam0)
        step_floor = 1e-4 if ga.dtype == F32 else 1e-9
        hist = []
        cost_prev = math.inf
        n_rej = 0
        code = 0
        gnorm = math.nan
        pstate = self._pstate0()
        for it in range(int(opts.max_iters)):
            trial, c0, c1, gn, dn, exact, pred, cg_k = self.step(values, lam, rt, pstate)
            rho = (c0 - c1) / (pred if pred > 1e-30 else 1e-30)
            okb = math.isfinite(c1) and c1 < c0
            lam = self._marquardt(lam, okb, rho)
            gnorm = gn
            self._record(hist, it, c0, c1, gn, dn, okb, lam, cg_k)
            if okb:
                values = trial
                code = self._accepted_code(gn, dn, exact, cost_prev, c1, lam, opts.lam0)
                cost_prev = c1
                n_rej = 0
            else:
                n_rej += 1
                code = self._rejected_code(dn, n_rej, lam, step_floor)
            if code:
                break
        # final cost accumulated in the graph dtype, as the JAX package's
        final_cost = float(cost_at(ga, values, rt))
        return values, self._stats(hist, code, n_rej, gnorm, final_cost)

    def solve(self, values=None, rt=None):
        """The LM solve: the speculative-accept loop for ndchol with
        ``speculative``, else :meth:`solve_host`. ``rt`` is the graph's
        runtime_state; pass the CURRENT graph's when this solver came from
        :meth:`cached`."""
        if not self._speculative:
            return self.solve_host(values, rt)
        values, rt = self._start(values, rt)
        return self._solve_speculative(values, rt)

    def _solve_speculative(self, values, rt):
        """Linearize AT THE TRIAL POINT: its residuals give the trial cost,
        and an accepted step hands its linearization (and its workspace) to
        the next iteration, so no separate cost pass and no final cost pass
        is made. A rejected step keeps the carried linearization and forces a
        reused factorization stale. ``final_cost`` is the carried f64 cost."""
        gaW, opts = self._gaW, self.opts
        cdt = self._cdt
        lam = self._lam_type(opts.lam0)
        step_floor = 1e-4 if gaW.dtype == F32 else 1e-9
        ws, ws_trial = self._ws, self._ws_trial
        lins, parts = self._linearize(values, rt, ws)
        cost0 = float(self._sumsq(lins))
        hist = []
        cost_prev = math.inf
        n_rej = 0
        code = 0
        gnorm = 0.0
        pstate = self._pstate0()
        for it in range(int(opts.max_iters)):
            delta, g, exact, extras = self._linear_solve(lins, lam, rt, parts, pstate)
            pstate = extras.get("pstate", pstate)
            gvec = g if isinstance(g, dict) else unflatten_tangent(gaW, g)
            trial = self._boxplus_all(values, delta, rt)
            lins_t, parts_t = self._linearize(trial, rt, ws_trial)
            c1, gn, dn, pr, ex = torch.stack([
                self._sumsq(lins_t), torch.sqrt(_tdot(gvec, gvec)).to(cdt),
                torch.sqrt(_tdot(delta, delta)).to(cdt), extras["pred"].to(cdt),
                torch.as_tensor(exact, device=gaW.device).to(cdt),
            ]).tolist()
            rho = (cost0 - c1) / (pr if pr > 1e-30 else 1e-30)
            okb = math.isfinite(c1) and c1 < cost0
            lam = self._marquardt(lam, okb, rho)
            gnorm = gn
            self._record(hist, it, cost0, c1, gn, dn, okb, lam, int(extras.get("cg_iters", 0)))
            if okb:
                values, lins, parts = trial, lins_t, parts_t
                ws, ws_trial = ws_trial, ws
                # the JAX package's loop compares lam with lam0 in lam's dtype
                code = self._accepted_code(gn, dn, bool(ex), cost_prev, c1, lam,
                                           float(self._lam_type(opts.lam0)))
                cost0 = cost_prev = c1
                n_rej = 0
            else:
                n_rej += 1
                code = self._rejected_code(dn, n_rej, lam, step_floor)
                # lam grew 8x: a carried factorization no longer matches
                if "stale" in pstate:
                    pstate = {**pstate, "stale": True}
            if code:
                break
        return values, self._stats(hist, code, n_rej, gnorm, cost0)


# --------------------------- covariance recovery ---------------------------

def _blocked_spd_inverse(H, blk: int = 1024):
    """H^-1 for SPD H: Cholesky, L^-1 by row blocks, then L^-T L^-1."""
    L = _nan_if_failed(*torch.linalg.cholesky_ex(H))
    Linv = _row_blocked_tri_inv(L, blk)
    del L
    return Linv.T @ Linv


def marginal_covariances(ga: GraphArrays, values, rt=None, method="auto"):
    """Per-variable marginal covariance blocks in the local tangent frame
    (testParametricCovariances.jl:33-55). Returns {type_name: (n, dof, dof)}
    in the graph dtype; assembled and inverted in f64.

    ``method``:
      - "dense": full-H inverse (with a 1e-8 ridge) — O(n^3) flops, O(n^2)
        memory; exact, fine for fixtures.
      - "takahashi": selected inversion along the nested-dissection
        elimination tree — only the inverse entries on the filled pattern.
      - "auto": takahashi above 1,500 tangent dims, dense below.
    """
    lins = linearize_all(ga, values, rt)
    if method == "auto":
        method = "takahashi" if ga.total_dof > 1500 else "dense"
    if method == "takahashi":
        return _marginal_covariances_takahashi(ga, lins, rt, F64)
    if method != "dense":
        raise ValueError(f"unknown covariance method {method!r}")
    H, _g = dense_normal_eqs(ga, lins, dtype=F64, rt=rt)
    H.diagonal().add_(1e-8)
    cov = _blocked_spd_inverse(H)
    del H
    out, off = {}, 0
    for t in ga.type_names:
        n, d = ga.counts[t], ga.manifolds[t].dof
        idx = off + torch.arange(n, device=ga.device)[:, None] * d + torch.arange(
            d, device=ga.device)[None, :]
        out[t] = cov[idx[:, :, None], idx[:, None, :]].to(ga.dtype)
        off += n * d
    return out


def _takahashi_locations(sym):
    """(level, node, offset) of every scalar dimension in its supernode (-1,
    0, 0 for one in no supernode), from the plan's ``sup_idx_{l}`` maps."""
    lev = np.full(sym.D, -1, np.int64)
    node = np.zeros(sym.D, np.int64)
    off = np.zeros(sym.D, np.int64)
    for l, (n_l, _sm, _bm) in enumerate(sym.plan):
        if n_l == 0:
            continue
        sup = np.asarray(sym.arrs[f"sup_idx_{l}"])
        j, a = np.nonzero(sup < sym.D)
        s = sup[j, a]
        lev[s], node[s], off[s] = l, j, a
    return lev, node, off


def _takahashi_gather(sym, locations, scal):
    """For variables with scalar dims ``scal`` (n, d): the flat index of each
    variable's d x d block in its level's X fronts (n, d, d) and the level
    (n,). A variable's dims lie in one supernode by construction of the
    variable-level dissection."""
    lev, node, off = locations
    fsz = np.array([sm + bm for (_n, sm, bm) in sym.plan], np.int64)
    l0, j0 = lev[scal[:, 0]], node[scal[:, 0]]
    found = l0 >= 0
    if not ((lev[scal[found]] == l0[found, None]).all()
            and (node[scal[found]] == j0[found, None]).all()):
        raise ValueError("variable split across supernodes")
    f = fsz[np.where(found, l0, 0)][:, None, None]
    o = off[scal]
    gidx = j0[:, None, None] * f * f + o[:, :, None] * f + o[:, None, :]
    gidx[~found] = 0
    return gidx, np.where(found, l0, 0)


def _marginal_covariances_takahashi(ga: GraphArrays, lins, rt, hdt):
    """Sparse covariance recovery: ND multifrontal factorization of the
    undamped, Jacobi-scaled information matrix (+1e-8 relative ridge) and the
    Takahashi selected inverse, then each variable's dof x dof block gathered
    from its supernode front and un-scaled (including the free mask)."""
    from rome_tpu_torch.solvers.sparse import (
        ndchol_assemble, ndchol_factorize, ndchol_takahashi,
    )

    rt = rt if rt is not None else runtime_state(ga)
    # the plan of the rt's actual connectivity (cached on its bytes, never on
    # the identity of ga)
    sym, arrs = _symbolic_plan(ga, 16, rt["vslots"])
    vals = normal_eq_entry_values(ga, lins, dtype=hdt)
    fvec = free_vector(ga, rt).to(hdt)
    diag_H = arrs["sum_diag"].add_(torch.zeros(sym.D, dtype=hdt, device=ga.device),
                                   vals) * fvec
    df = 1.0 / torch.sqrt(torch.clamp(diag_H, min=1e-12)) * fvec
    diag_add = fvec * 1e-8 + (1.0 - fvec)
    Ws = ndchol_assemble(sym, arrs, vals, df, diag_add)
    Linvs, L21s, _ = ndchol_factorize(sym, arrs, Ws)
    Xs = ndchol_takahashi(sym, arrs, Linvs, L21s)
    flat = {l: X.reshape(-1) for l, X in enumerate(Xs) if X is not None}
    locations = _takahashi_locations(sym)
    base, _D = tangent_offsets(ga)
    out = {}
    for t in ga.type_names:
        n, d = ga.counts[t], ga.manifolds[t].dof
        scal = base[t] + np.arange(n * d).reshape(n, d)
        gidx, glev = _takahashi_gather(sym, locations, scal)
        blocks = torch.zeros((n, d, d), dtype=hdt, device=ga.device)
        for l in np.unique(glev):
            if int(l) not in flat:
                continue
            sel = np.nonzero(glev == l)[0]
            got = flat[int(l)][torch.as_tensor(gidx[sel].reshape(-1), device=ga.device)]
            blocks[torch.as_tensor(sel, device=ga.device)] = got.reshape(len(sel), d, d)
        dvar = df[torch.as_tensor(scal, device=ga.device)]
        out[t] = (blocks * dvar[:, :, None] * dvar[:, None, :]).to(ga.dtype)
    return out
