"""Batched Levenberg-Marquardt over factor batches (counterpart of
``rome_tpu/solvers/gauss_newton.py``).

Two loops, as in the JAX package, both with the accept, Marquardt and
convergence decisions computed on the device (``_lm_update``, the JAX loop's
``where`` chains) from the loop state in device tensors (``_LMState``):
  - ``ParametricSolver.solve``: for ``linear="ndchol"`` with
    ``GNOptions.speculative`` (the default), the speculative-accept loop,
    which linearizes at the trial point: its residuals are the trial cost,
    and an accepted step copies its linearization into the carried one. It
    is one device program per connectivity (``_LMProgram``,
    ``utils/device_loop``), as the JAX package's ``schedule="fused"`` solve
    is one jitted program: a start phase (with ``GNOptions.fused_chordal``
    the chordal stages, then the first linearize) and one LM iteration
    guarded by "it < max_iters and no convergence code", its CG polish a
    bounded loop of guarded iterations. On the card it is captured once as
    CUDA graphs and replayed ``max_iters`` times with no host read until the
    one final read (iterations, code, cost, gradient norm, history); on the
    CPU the same body runs eagerly, reading each guard on the host.
  - ``ParametricSolver.solve_host``: one LM step per iteration, the trial
    cost from a separate residual pass (``cost_at``), one read of the
    decisions per iteration. ``solve`` is ``solve_host`` for every other
    linear solver and with ``speculative=False``.
Not yet in the program (the host loop, eager on the card too):
``linear != "ndchol"``, ``precond_reuse`` (the speculative loop with a
reused factorization), ``speculative=False`` and ``schedule="host"``.

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
``dense`` and ``dense32`` form, scale and factor the normal equations over
the solve's free dims only (``DenseScatter.of`` with the free mask): a
fixed-lag step's frozen history and shape-bucket padding never enter the
D x D system. Every dense factorization counts ``dense.factorizations`` and
its order in ``dense.dof`` (``utils/profiling.count``).

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
    DenseScatter,
    NormalEqWorkspace,
    NormalParts,
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
from rome_tpu_torch.utils.device_loop import EAGER, Program
from rome_tpu_torch.utils.math import einsum
from rome_tpu_torch.utils.profiling import annotate, count

F32, F64 = torch.float32, torch.float64
_LINEAR = ("dense", "dense32", "ndchol", "pcg", "mixed")
# the solvers that assemble the dense normal equations
_DENSE_LINEAR = ("dense", "dense32", "mixed")


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


def _dense_cholesky(H):
    """The lower Cholesky factor of the dense ``H`` (:func:`_nan_if_failed`),
    counted as one of ``dense.factorizations`` of ``dense.dof`` its order."""
    count("dense.factorizations")
    count("dense.dof", H.shape[0])
    return _nan_if_failed(*torch.linalg.cholesky_ex(H))


def guarded_cg(run, minv, apply, b, tol, iters):
    """Preconditioned CG on ``apply`` x = ``b`` (flat vectors) from x = 0: a
    bounded loop of ``iters`` guarded iterations while |r| > tol |b|
    (``run``'s control flow, ``utils/device_loop``), the JAX package's
    ``cg_polish`` while_loop. Returns (x, residual, iterations as a 0-dim
    int64 tensor)."""
    bn = torch.linalg.norm(b) + 1e-300
    x = torch.zeros_like(b)
    r = b.clone()
    p = torch.zeros_like(b)
    rz = torch.zeros((), dtype=b.dtype, device=b.device)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    live = torch.linalg.norm(r) > tol * bn

    def body():
        z = minv(r)
        rz2 = torch.dot(r, z)
        beta = torch.where(k == 0, 0.0, rz2 / _safe(rz))
        p.copy_(z + beta * p)
        Ap = apply(p)
        alpha = rz2 / _safe(torch.dot(p, Ap))
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * Ap)
        rz.copy_(rz2)
        k.add_(1)
        live.copy_(torch.linalg.norm(r) > tol * bn)

    run.loop(iters, live, body)
    return x, r, k


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
    ``fused_chordal``: the chordal init of a Pose2 graph with odometry runs
    inside the ``solve`` program, before its first linearize (the JAX
    package's fused_chordal, its output in the working dtype); without it,
    and where ``solve`` is not a program, ``solve_graph_parametric`` runs
    ``chordal_init_pose2`` first.
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
        # this graph's own dense plan and the free mask it was made for
        self._dense = self._dense_free = None
        self._sym, self._nd = (
            _symbolic_plan(ga, opts.nd_leaf) if linear == "ndchol" else (None, None)
        )
        # cost accumulation dtype: always f64; the damping in the graph dtype
        self._cdt = F64
        self._mixed_j = linear == "ndchol" and opts.mixed_jacobians and self._use64
        self._speculative = linear == "ndchol" and opts.speculative
        # the mixed path's entry vector and K1 normal-epilogue plans of the
        # host loops, reused by every iteration; the host speculative loop
        # (precond_reuse) keeps a second set for the trial point (the current
        # point's linearization must survive it)
        self._ws = NormalEqWorkspace(self._gaW) if self._mixed_j else None
        self._ws_trial = (
            NormalEqWorkspace(self._gaW) if self._mixed_j and self._speculative else None
        )
        # the speculative loop as a device program (_LMProgram), one per
        # connectivity (ndchol plan), as the JAX package's _programs_for
        self._program_path = self._speculative and not opts.precond_reuse
        self._programs = {}
        self.last_program = None

    @classmethod
    def cached(cls, ga: GraphArrays, opts: GNOptions = None):
        """Structure-keyed solver reuse: the same structure signature and
        options give the same solver (pass the new graph's runtime_state and
        values to :meth:`solve`). At most ``_SOLVER_CACHE_MAX`` solvers are
        kept: a full cache is cleared."""
        opts = opts or GNOptions()
        key = (structure_signature(ga), tuple(sorted(vars(opts).items())))
        solver = _SOLVER_CACHE.get(key)
        if solver is not None:
            count("solver_cache.hit")
            return solver
        count("solver_cache.miss")
        if len(_SOLVER_CACHE) >= _SOLVER_CACHE_MAX:
            count("solver_cache.clear")
            _SOLVER_CACHE.clear()
        with annotate("solver.build"):
            solver = _SOLVER_CACHE[key] = cls(ga, opts)
        return solver

    # -- building blocks ---------------------------------------------------------
    def _is_own(self, rt):
        """Whether ``rt`` holds this graph's own connectivity."""
        vs, own = rt["vslots"], self._rt0["vslots"]
        return len(vs) == len(own) and all(a is b for a, b in zip(vs, own))

    def _plan_for(self, rt):
        """The ndchol (plan, index tensors) of the connectivity ``rt`` holds:
        this graph's own, or one re-derived (and cached) for another's."""
        if self._is_own(rt):
            return self._sym, self._nd
        return _symbolic_plan(self.ga, self.opts.nd_leaf, rt["vslots"])

    def _scatter_for(self, rt):
        """The tangent sums' plan (``TangentScatter``) of ``rt``'s
        connectivity: this graph's own, or one made for another's."""
        if self._is_own(rt):
            return self._scatter
        return TangentScatter.of(self.ga, rt["vslots"])

    def _dense_for(self, rt):
        """The dense normal equations' plan (``DenseScatter``) of ``rt``'s
        connectivity: this graph's own (made at its first use and kept while
        the free mask holds), or one made for another's. The dense and
        dense32 solves take a plan over ``rt``'s free dims only: a frozen or
        pad dim's row is an identity decoupled from the rest and its update
        is zero, so the free block's system is the same without it. Its mask
        is read from the device once per call."""
        free = None
        if self.linear in ("dense", "dense32"):
            free = (free_vector(self.ga, rt) > 0).cpu().numpy()
        if not self._is_own(rt):
            return DenseScatter.of(self.ga, rt["vslots"], free)
        if self._dense is None or not np.array_equal(free, self._dense_free):
            self._dense = DenseScatter.of(self.ga, self._rt0["vslots"], free)
            self._dense_free = free
        return self._dense

    def _with_dense(self, rt):
        """(``rt`` with its dense plan, the plan): the one the solver put
        there, else one made for it."""
        if "dense" not in rt:
            rt = {**rt, "dense": self._dense_for(rt)}
        return rt, rt["dense"]

    def plans(self, rt=None, host=True):
        """``rt`` (this solver's own by default) with the plans of its
        connectivity that a solve takes, looked up or made: the ndchol plan
        and, unless the device program solves it (``host=False`` and the
        program path), the tangent sums' plan and the dense solvers' plan."""
        rt = rt if rt is not None else self._rt0
        if self.linear == "ndchol" and "ndchol" not in rt:
            rt = {**rt, "ndchol": self._plan_for(rt)}
        if host or not self._program_path:
            if "scatter" not in rt:
                rt = {**rt, "scatter": self._scatter_for(rt)}
            if self.linear in _DENSE_LINEAR and "dense" not in rt:
                rt = {**rt, "dense": self._dense_for(rt)}
        return rt

    def _start(self, values, rt):
        """(values in the working dtype, rt with the ndchol plan, the
        tangent sums' plan and the dense solvers' plan)."""
        values = values or self.ga.values0
        if self._use64:
            values = {t: v.to(F64) for t, v in values.items()}
        return values, self.plans(rt)

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

    def _cg_polish(self, minv, hD, b, tol, run=EAGER):
        """CG on the true damped system, preconditioned by the fresh f32
        factorization (:func:`guarded_cg`, ``polish_iters`` iterations at
        most). Returns (x, residual, iterations as a 0-dim int64 tensor)."""
        return guarded_cg(run, minv, hD, b, tol, self.opts.polish_iters)

    def _polish_result(self, gaW, g, x, r, k, tol):
        """(delta, g, exact, extras) of a CG polish: ``exact`` is the residual
        test, ``pred`` the model reduction from the CG state (H x = b - r and
        b = -g, so pred = 0.5 b.x + 0.5 x.r)."""
        b = -flatten_tangent(gaW, g)
        exact = torch.linalg.norm(r) <= tol * (torch.linalg.norm(b) + 1e-300)
        pred = 0.5 * (torch.dot(b, x) + torch.dot(x, r))
        return unflatten_tangent(gaW, x), g, exact, {"pred": pred, "cg_iters": k}

    def _linear_solve(self, lins, lam, rt, parts, pstate, run=EAGER):
        """(delta, g, exact, extras) of this solver's linear solve at the
        damping ``lam`` (a 0-dim tensor of the graph dtype); extras may
        carry "pred", "cg_iters" and the next "pstate". ``run``: the control
        flow of the CG polish (dense32, ndchol)."""
        return getattr(self, f"_solve_{self.linear}")(lins, lam, rt, parts, pstate, run=run)

    # -- linear solvers ---------------------------------------------------------
    def _solve_dense(self, lins, lam, rt, parts=None, pstate=None, run=EAGER):
        """f64 assembly, Jacobi scaling, f32 Cholesky, safeguarded f64
        iterative refinement."""
        ga, opts = self.ga, self.opts
        use64 = opts.ir_rounds > 0
        hdt = F64 if use64 else ga.dtype
        rt, plan = self._with_dense(rt)
        H, g = dense_normal_eqs(ga, lins, dtype=hdt, rt=rt)
        diag = torch.clamp(torch.diagonal(H), min=1e-8)
        Hd = H + lam.to(hdt) * torch.diag(diag)
        d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-12))
        Hs = Hd * d[:, None] * d[None, :]
        bs = -g * d
        L = _dense_cholesky(Hs.to(ga.dtype))

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
        x = (plan.extend(y * d) * free_vector(ga, rt).to(hdt)).to(ga.dtype)
        return unflatten_tangent(ga, x), plan.extend(g).to(ga.dtype), True, {}

    def _solve_dense32(self, lins, lam, rt, parts=None, pstate=None, run=EAGER):
        """f32 dense normal equations with Jacobi scaling and ``chol_jitter``,
        ONE f32 Cholesky as the preconditioner of a short CG on the true
        damped system with the matrix-free Hvp in the working dtype. H is
        damped, scaled and factored in place: H and L are the only D x D
        buffers, over the free dims only where ``rt``'s plan has them (the
        preconditioner gathers them from the full-length CG vectors and
        scatters its result back)."""
        gaW, opts = self._gaW, self.opts
        wdt = gaW.dtype
        lam32 = lam.to(F32)
        rt, plan = self._with_dense(rt)
        H, _g32 = dense_normal_eqs(gaW, lins, dtype=F32, rt=rt)
        diag = torch.clamp(torch.diagonal(H), min=1e-8)
        H.diagonal().add_(lam32 * diag)                 # Hd
        d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
        H.mul_(d[:, None]).mul_(d[None, :])             # Hs = D Hd D
        H.diagonal().add_(opts.chol_jitter)
        L = _dense_cholesky(H)
        del H
        fvec = free_vector(gaW, rt).to(wdt)

        def minv(r):
            y = torch.cholesky_solve((plan.restrict(r.to(F32)) * d)[:, None], L)[:, 0]
            return plan.extend((y * d).to(wdt)) * fvec

        g = gradient_from_lins(gaW, lins, rt, parts=parts)
        diagW, lamW = plan.extend(diag.to(wdt)), lam32.to(wdt)

        def hD(x):
            out = hvp_from_lins(gaW, lins, unflatten_tangent(gaW, x), rt)
            return (flatten_tangent(gaW, out) + lamW * diagW * x) * fvec

        x, r, k = self._cg_polish(minv, hD, -flatten_tangent(gaW, g), opts.polish_tol, run)
        return self._polish_result(gaW, g, x, r, k, opts.polish_tol)

    def _solve_ndchol(self, lins, lam, rt, parts=None, pstate=None, run=EAGER):
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
        # a device program's phases (``run.span``); nothing in a host loop
        with run.span("lm.assemble"):
            vals = normal_eq_entry_values(gaW, lins, dtype=F32, parts=parts)
            fvec32 = free_vector(gaW, rt).to(F32)
            lam32 = lam.to(F32)
            # the free mask is 0/1, so it applies after the sum exactly
            diag_H = nd["sum_diag"].add_(torch.zeros(sym.D, dtype=F32, device=ga.device),
                                         vals) * fvec32
            dv = torch.rsqrt(torch.clamp(diag_H * (1.0 + lam32), min=1e-12))
            df = dv * fvec32
            reuse = opts.precond_reuse and not (pstate or {}).get("stale", True)
            if not reuse:
                diag_add = fvec32 * (lam32 / (1.0 + lam32) + jitter) + (1.0 - fvec32)
                Ws = ndchol_assemble(sym, nd, vals, df, diag_add)
        if reuse:
            Linvs, L21s, dfp = pstate["Linvs"], pstate["L21s"], pstate["df"]
        else:
            with run.span("lm.factorize"):
                Linvs, L21s, _L11s = ndchol_factorize(sym, nd, Ws)
            dfp = df

        def minv(r):
            y = ndchol_solve(sym, nd, Linvs, L21s, r.to(F32) * dfp)
            return (y * dfp).to(wdt)

        with run.span("lm.cg"):
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

            x, r, k = self._cg_polish(minv, hD, -flatten_tangent(gaW, g), ptol, run)
            out = self._polish_result(gaW, g, x, r, k, ptol)
        if opts.precond_reuse:
            # refresh signal: the CG needed enough iterations that the reused
            # factor stopped paying for itself
            out[3]["pstate"] = {"Linvs": Linvs, "L21s": L21s, "df": dfp,
                                "stale": k >= opts.precond_cg_cap}
        return out

    def _solve_pcg(self, lins, lam, rt, parts=None, pstate=None, run=EAGER):
        """Block-Jacobi preconditioned CG on the matrix-free damped Hvp, in
        the graph dtype."""
        ga, opts = self.ga, self.opts
        free = rt["free"]
        gvec = gradient_from_lins(ga, lins, rt)
        D = block_diag_from_lins(ga, lins, rt)
        dd, Pinv = {}, {}
        for t in ga.type_names:
            eye = torch.eye(ga.manifolds[t].dof, dtype=ga.dtype, device=ga.device)
            # Marquardt damping on the diagonal of JᵀJ
            dd[t] = torch.clamp(torch.diagonal(D[t], dim1=-2, dim2=-1), min=1e-8)
            blk = D[t] + lam * dd[t][..., None] * eye + 1e-8 * eye
            fmask = free[t][:, None, None]
            Pinv[t] = torch.linalg.inv_ex(blk * fmask + eye * (1.0 - fmask))[0]

        def hvp(v):
            out = hvp_from_lins(ga, lins, v, rt)
            return {t: (out[t] + lam * dd[t] * v[t]) * free[t][:, None] for t in out}

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
        L = _dense_cholesky(H)
        del H
        return _row_blocked_tri_inv(L), dvec

    def _solve_mixed(self, lins, lam, rt, parts=None, pstate=None, run=EAGER):
        """Exact f64 Gauss-Newton steps: an f64 matrix-free CG on the true
        damped system, preconditioned by an explicit f32 inverse that is
        refreshed lazily: only when the previous CG missed its tolerance
        (``stale``)."""
        ga, ga64, opts = self.ga, self._ga64, self.opts
        if (pstate or {}).get("stale", True):
            Linv, dvec = self._mixed_refresh(lins, lam, rt)
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
        lam64 = lam.to(F64)
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
    def _step_tensors(self, values, lam, rt, pstate=None):
        """One LM iteration at ``values`` with damping ``lam`` (a 0-dim
        tensor): (trial values, cost0, cost1, gnorm, dnorm, exact, pred,
        cg_iters) as device tensors. ``pstate`` is updated in place."""
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
        exact = torch.as_tensor(exact, device=pred.device)
        cg = extras.get("cg_iters", torch.zeros((), dtype=torch.int64, device=pred.device))
        return (trial, cost0.to(self._cdt), cost1, gnorm.to(self._cdt), dnorm.to(self._cdt),
                exact, pred, cg)

    def step(self, values, lam, rt, pstate=None):
        """One LM iteration at ``values`` with damping ``lam`` (a scalar).
        ``pstate`` (a lazy-preconditioner state dict) is updated in place.

        Returns (trial values, cost0, cost1, gnorm, dnorm, exact, pred,
        cg_iters) with the scalars as host numbers."""
        lam = torch.as_tensor(lam, dtype=self.ga.dtype, device=self.ga.device)
        trial, *scalars = self._step_tensors(values, lam, rt, pstate)
        # ONE device-to-host transfer for every scalar
        c0, c1, gn, dn, ex, pr, cg = torch.stack([t.to(self._cdt) for t in scalars]).tolist()
        return trial, c0, c1, gn, dn, bool(ex), pr, int(cg)

    # -- the LM decisions, on the device ------------------------------------------
    def _marquardt(self, lam, ok, rho):
        """The damping after a step, in lam's dtype (the graph dtype) as the
        JAX package's."""
        o = self.opts
        grow = torch.clamp(lam * o.lam_up, max=o.lam_max)
        shrink = torch.clamp(lam * o.lam_down, min=o.lam_min)
        return torch.where(~ok | (rho < 0.25), grow, torch.where(rho > 0.7, shrink, lam))

    def _accepted_code(self, gn, dn, exact, cost_prev, c1, lam):
        """Convergence code of an accepted step (0: go on). ftol/xtol only
        trust an exact (non-truncated) solve; dtol needs lam <= ``lam0``
        (compared in lam's dtype)."""
        o = self.opts
        ftol_hit = torch.abs(cost_prev - c1) <= (
            self._ftol * torch.clamp(torch.abs(cost_prev), min=1.0))
        dtol_hit = ((dn < self._dtol) & (lam <= o.lam0) if self._dtol > 0
                    else torch.zeros_like(dn, dtype=torch.bool))
        return torch.where(gn < o.gtol, 1, torch.where(
            exact & (dn < o.xtol), 2, torch.where(
                exact & torch.isfinite(cost_prev) & ftol_hit, 3, torch.where(dtol_hit, 6, 0))))

    def _rejected_code(self, dn, n_rej, lam, step_floor):
        return torch.where(dn < step_floor, 4, torch.where(
            (n_rej >= 8) | (lam >= self.opts.lam_max), 5, 0))

    def _lm_update(self, st, c1, gn, dn, exact, pred, cg, step_floor):
        """One LM iteration's decisions on the device, from the trial cost
        ``c1``, the gradient and step norms, the solve's exactness, the
        model reduction ``pred`` and its CG iterations: the history row at
        ``st.it``, then ``st`` advanced in place (the JAX loop's body).
        Returns ``ok``, the accept decision (a 0-dim bool tensor)."""
        cost0 = st.cost0
        ok = torch.isfinite(c1) & (c1 < cost0)
        rho = (cost0 - c1) / torch.where(pred > 1e-30, pred, 1e-30)
        lam = self._marquardt(st.lam, ok, rho)
        n_rej = torch.where(ok, 0, st.n_rej + 1)
        code = torch.where(ok, self._accepted_code(gn, dn, exact, st.cost_prev, c1, lam),
                           self._rejected_code(dn, n_rej, lam, step_floor))
        row = torch.stack([cost0, c1, gn, dn, ok.to(F64), lam.to(F64), cg.to(F64)])
        st.hist.index_copy_(0, st.it.reshape(1), row.reshape(1, 7))
        st.cost_prev.copy_(torch.where(ok, c1, st.cost_prev))
        st.cost0.copy_(torch.where(ok, c1, cost0))
        st.lam.copy_(lam)
        st.n_rej.copy_(n_rej)
        st.code.copy_(code)
        st.gnorm.copy_(gn)
        st.it.add_(1)
        st.running.copy_((st.it < self.opts.max_iters) & (st.code == 0))
        return ok

    def _stats(self, host, final_cost=None):
        """SolveStats from ``_LMState.read_list``'s values read to the host
        (``final_cost``: the solve's own, else the carried cost)."""
        it, code, n_rej = (int(v) for v in host[:3])
        gnorm, cost0 = float(host[3]), float(host[4])
        rows = np.asarray(host[5:]).reshape(-1, 7)[:it]
        hist = [dict(iter=k, cost0=float(h[0]), cost1=float(h[1]), gnorm=float(h[2]),
                     dnorm=float(h[3]), accepted=bool(h[4] > 0.5), lam=float(h[5]), cg=int(h[6]))
                for k, h in enumerate(rows)]
        if self.opts.verbose:
            for h in hist:
                print(f"  LM it={h['iter']} cost={h['cost0']:.6g}->{h['cost1']:.6g} "
                      f"|g|={h['gnorm']:.3g} |dx|={h['dnorm']:.3g} ok={h['accepted']} "
                      f"lam={h['lam']:.1e} cg={h['cg']}")
        converged = code in (1, 2, 3, 4, 6) or (code == 5 and n_rej >= 8 and it > 3)
        return SolveStats(
            iterations=it,
            final_cost=cost0 if final_cost is None else float(final_cost),
            gnorm=gnorm,
            converged=bool(converged),
            history=hist,
            linear=self.linear,
            reason=self._REASONS.get(code, "max_iters"),
        )

    # -- the LM loops -----------------------------------------------------------------
    def solve_host(self, values=None, rt=None):
        """LM with one step per iteration and the trial cost from a separate
        residual pass (the JAX package's ``solve_host``); one read of the
        device's decisions per iteration. ``rt`` is the graph's
        runtime_state (this solver's own by default)."""
        ga = self.ga
        values, rt = self._start(values, rt)
        st = _LMState(self)
        step_floor = 1e-4 if ga.dtype == F32 else 1e-9
        pstate = self._pstate0()
        for _ in range(int(self.opts.max_iters)):
            trial, c0, c1, gn, dn, exact, pred, cg = self._step_tensors(values, st.lam, rt, pstate)
            st.cost0.copy_(c0)
            ok = self._lm_update(st, c1, gn, dn, exact, pred, cg, step_floor)
            okb, running = torch.stack([ok, st.running]).tolist()
            if okb:
                values = trial
            if not running:
                break
        # final cost accumulated in the graph dtype, as the JAX package's
        host = _read(st.read_list() + [cost_at(ga, values, rt)])
        return values, self._stats(host[:-1], final_cost=host[-1])

    @property
    def fuses_chordal(self):
        """Whether :meth:`solve` runs the chordal init itself: the program
        with ``fused_chordal`` on a Pose2 graph with odometry batches."""
        return (self._program_path and self.opts.fused_chordal and "Pose2" in self.ga.counts
                and any(b.ftype.name in _ODO_BATCHES for b in self.ga.batches))

    def solve(self, values=None, rt=None, eager=False):
        """The LM solve: for ndchol with ``speculative`` the speculative-
        accept loop (the device program; with ``precond_reuse`` its host
        loop), else :meth:`solve_host`. ``rt`` is the graph's runtime_state;
        pass the CURRENT graph's when this solver came from :meth:`cached`.
        ``eager`` runs the program's plain version (each guard read on the
        host) instead of its captured graphs."""
        if not self._speculative:
            return self.solve_host(values, rt)
        if not self._program_path:
            values, rt = self._start(values, rt)
            return self._solve_speculative(values, rt)
        rt = rt if rt is not None else self._rt0
        sym = (rt["ndchol"] if "ndchol" in rt else self._plan_for(rt))[0]
        # keyed by the plan's identity; the entry holds the plan, so the id
        # is not reused while the entry lives
        _sym, program = self._programs.get(id(sym), (None, None))
        if program is None:
            _v, rt0 = self._start(None, rt)
            if len(self._programs) >= _PROGRAMS_MAX:
                self._programs.clear()
            program = _LMProgram(self, rt0)
            self._programs[id(sym)] = (sym, program)
        self.last_program = program
        return program.solve(values or self.ga.values0, rt, eager)

    def _solve_speculative(self, values, rt):
        """The speculative-accept loop with ``precond_reuse``, on the host:
        linearize AT THE TRIAL POINT (its residuals give the trial cost), an
        accepted step hands its linearization (and its workspace) to the
        next iteration, a rejected one keeps the carried linearization and
        forces a reused factorization stale. One read of the decisions per
        iteration; ``final_cost`` is the carried f64 cost."""
        gaW = self._gaW
        st = _LMState(self)
        step_floor = 1e-4 if gaW.dtype == F32 else 1e-9
        ws, ws_trial = self._ws, self._ws_trial
        lins, parts = self._linearize(values, rt, ws)
        st.cost0.copy_(self._sumsq(lins))
        pstate = self._pstate0()
        for _ in range(int(self.opts.max_iters)):
            delta, g, exact, extras = self._linear_solve(lins, st.lam, rt, parts, pstate)
            pstate = extras.get("pstate", pstate)
            trial = self._boxplus_all(values, delta, rt)
            lins_t, parts_t = self._linearize(trial, rt, ws_trial)
            ok = self._lm_update(st, self._sumsq(lins_t), torch.sqrt(_tdot(g, g)).to(F64),
                                 torch.sqrt(_tdot(delta, delta)).to(F64), exact,
                                 extras["pred"].to(F64), extras["cg_iters"], step_floor)
            okb, running = torch.stack([ok, st.running]).tolist()
            if okb:
                values, lins, parts = trial, lins_t, parts_t
                ws, ws_trial = ws_trial, ws
            elif "stale" in pstate:
                # lam grew 8x: a carried factorization no longer matches
                pstate = {**pstate, "stale": True}
            if not running:
                break
        return values, self._stats(_read(st.read_list()))


_PROGRAMS_MAX = 4
_ODO_BATCHES = ("Pose2Pose2", "MutablePose2Pose2Gaussian")


def _read(tensors):
    """One device-to-host read of ``tensors``, flattened as float64."""
    return torch.cat([t.reshape(-1).to(F64) for t in tensors]).cpu().numpy()


class _LMState:
    """The LM loop's state in device tensors (the JAX loop's carry): the
    damping ``lam`` in the graph dtype (as the JAX package's), the carried
    and the last accepted cost and the last gradient norm (float64), the
    iteration count, the consecutive rejections and the convergence code
    (int64), ``running`` (it < max_iters and code == 0) and the
    (max_iters, 7) float64 history [cost0, cost1, gnorm, dnorm, accepted,
    lam, cg iterations]. Made in its initial state; :meth:`reset` returns
    to it (the cost is the caller's)."""

    def __init__(self, solver):
        ga, dev = solver.ga, solver.ga.device
        self._lam0, self._iters = solver.opts.lam0, int(solver.opts.max_iters)

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=dev)

        self.lam, self.cost0, self.cost_prev, self.gnorm = (
            scalar(ga.dtype), scalar(F64), scalar(F64), scalar(F64))
        self.it, self.n_rej, self.code = (scalar(torch.int64) for _ in range(3))
        self.running = scalar(torch.bool)
        self.hist = torch.zeros((max(self._iters, 1), 7), dtype=F64, device=dev)
        self.reset()

    def reset(self):
        self.lam.fill_(self._lam0)
        self.cost_prev.fill_(math.inf)
        for t in (self.gnorm, self.it, self.n_rej, self.code, self.hist):
            t.zero_()
        self.running.fill_(self._iters > 0)

    def read_list(self):
        """What a solve's final read takes: it, code, n_rej, gnorm, the
        carried cost, then the history."""
        return [self.it, self.code, self.n_rej, self.gnorm, self.cost0, self.hist]


class _LMProgram:
    """The speculative ndchol LM solve of one connectivity as a device
    program (``utils/device_loop.Program``), the JAX package's jitted fused
    loop (rome_tpu/solvers/gauss_newton.py ``_make_solve_loop``).

    Static inputs, which each solve copies in: the values (in the working
    dtype) and a copy of the runtime state (params, slots, weights, free
    masks) beside the connectivity's ndchol and tangent-sum plans. Phases:
    ``_start`` (the inputs into the state; with ``fused_chordal`` the
    chordal stages, whose result is kept in ``chordal_start``; the first
    linearize into the carried linearization; the loop state reset) once,
    then ``_iterate`` (one LM iteration, guarded by ``running``)
    ``max_iters`` times. The carried linearization (residuals, Jacobians
    and, on the mixed path, the JᵀJ entry vector and Jᵀr contributions)
    lives in buffers of its own: the trial's linearization is made in the
    solver's workspace and an accepted step copies it in (``torch.where``
    on the accept decision), as the JAX loop selects its carry."""

    def __init__(self, solver, rt):
        ga, gaW = solver.ga, solver._gaW
        self.solver = solver
        self.values_in = {t: torch.empty(v.shape, dtype=gaW.dtype, device=ga.device)
                          for t, v in ga.values0.items()}
        self.values = {t: torch.empty_like(v) for t, v in self.values_in.items()}
        self.rt = {
            "params": tuple({k: v.clone() for k, v in p.items()} for p in rt["params"]),
            "vslots": tuple(v.clone() for v in rt["vslots"]),
            "weight": tuple(w.clone() for w in rt["weight"]),
            "free": {t: f.clone() for t, f in rt["free"].items()},
            "ndchol": rt["ndchol"],
            "scatter": rt["scatter"],
        }
        self.ws = NormalEqWorkspace(gaW) if solver._mixed_j else None
        self.carried = self.parts = None
        self.st = _LMState(solver)
        self.step_floor = 1e-4 if gaW.dtype == F32 else 1e-9
        self.chordal = self.chordal_start = None
        if solver.fuses_chordal:
            from rome_tpu_torch.solvers.init2d import _chordal_plan

            r = self.rt
            edges = [(r["vslots"][i][:, 0], r["vslots"][i][:, 1], r["params"][i]["z"],
                      r["params"][i]["sqrt_info"], r["weight"][i])
                     for i, b in enumerate(ga.batches) if b.ftype.name in _ODO_BATCHES]
            priors = [(r["vslots"][i][:, 0], r["params"][i]["z"], r["params"][i]["sqrt_info"],
                       r["weight"][i])
                      for i, b in enumerate(ga.batches) if b.ftype.name == "PriorPose2"]
            plan, arrs = _chordal_plan(ga.counts["Pose2"], edges, priors, ga.device)
            self.chordal = (edges, priors, plan.sym, arrs)
            self.chordal_start = torch.empty_like(self.values["Pose2"])
        self.program = Program(ga.device, [(self._start, 1),
                                           (self._iterate, int(solver.opts.max_iters))],
                               name="lm_ndchol" + ("_fused_chordal" if self.chordal else ""))

    def _start(self, run):
        s = self.solver
        for t, v in self.values.items():
            v.copy_(self.values_in[t])
        if self.chordal is not None:
            from rome_tpu_torch.solvers.init2d import _chordal_body

            edges, priors, sym, arrs = self.chordal
            pose2 = self.values["Pose2"]
            with run.span("lm.chordal"):
                pose2.copy_(_chordal_body(pose2.dtype, pose2.shape[0], pose2, edges, priors,
                                          self.rt["free"]["Pose2"], sym, arrs, run))
                self.chordal_start.copy_(pose2)
        with run.span("lm.start_linearize"):
            lins, parts = s._linearize(self.values, self.rt, self.ws)
            if self.carried is None:
                self.carried = [(r.clone(), tuple(J.clone() for J in Js))
                                for _b, r, Js, _v in lins]
                if parts is not None:
                    self.parts = NormalParts(parts.vals.clone(), parts.offsets,
                                             {i: j.clone() for i, j in parts.jtr.items()})
            else:
                self._carry(lins, parts)
            self.st.reset()
            self.st.cost0.copy_(s._sumsq(lins))

    def _carry(self, lins, parts, ok=None):
        """The carried linearization := ``lins`` / ``parts`` (where ``ok``)."""
        def put(dst, src):
            dst.copy_(src if ok is None else torch.where(ok, src, dst))

        for (r, Js), (_b, r1, Js1, _v) in zip(self.carried, lins):
            put(r, r1)
            for J, J1 in zip(Js, Js1):
                put(J, J1)
        if parts is not None:
            put(self.parts.vals, parts.vals)
            for i, j in self.parts.jtr.items():
                put(j, parts.jtr[i])

    def _iterate(self, run):
        run.cond(self.st.running, lambda: self._step(run))

    def _step(self, run):
        s, st, rt = self.solver, self.st, self.rt
        lins = [(b, r, Js, vs) for b, (r, Js), vs in zip(s.ga.batches, self.carried, rt["vslots"])]
        # device phases lm.assemble, lm.factorize and lm.cg inside
        delta, g, exact, extras = s._linear_solve(lins, st.lam, rt, self.parts, None, run=run)
        with run.span("lm.linearize"):
            trial = s._boxplus_all(self.values, delta, rt)
            lins_t, parts_t = s._linearize(trial, rt, self.ws)
        with run.span("lm.update"):
            ok = s._lm_update(st, s._sumsq(lins_t), torch.sqrt(_tdot(g, g)).to(F64),
                              torch.sqrt(_tdot(delta, delta)).to(F64), exact,
                              extras["pred"].to(F64), extras["cg_iters"], self.step_floor)
            for t, v in self.values.items():
                v.copy_(torch.where(ok, trial[t], v))
            self._carry(lins_t, parts_t, ok)

    def solve(self, values, rt, eager=False):
        """Copy ``values`` and ``rt`` in, run the program (its plain version
        with ``eager``), make its one read. Returns (values, SolveStats)."""
        for t, v in self.values_in.items():
            v.copy_(values[t])
        for dst, src in ((self.rt["vslots"], rt["vslots"]), (self.rt["weight"], rt["weight"])):
            for d, s_ in zip(dst, src):
                d.copy_(s_)
        for d, s_ in zip(self.rt["params"], rt["params"]):
            for k, v in d.items():
                v.copy_(s_[k])
        for t, f in self.rt["free"].items():
            f.copy_(rt["free"][t])
        self.program.run(eager=eager)
        host = self.program.read(self.st.read_list())
        return {t: v.clone() for t, v in self.values.items()}, self.solver._stats(host)


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
