"""Chordal two-stage linear initialization for 2D pose graphs (counterpart of
``rome_tpu/solvers/init2d.py``).

Two *linear* least-squares solves:

  stage 1 (rotation, chordal relaxation): each rotation is parametrized by
    its unnormalized first column u_i = (c_i, s_i); the edge constraint
    R_j = R_i R(z_th) is linear in u: r = u_j - R(z_th) u_i, so there is no
    angle wrap anywhere. theta = atan2(s, c) afterwards.
  stage 2 (translation): given rotations, R_i^T (t_j - t_i) = z_t is linear
    in t.

Each stage solves its normal equations with an f32 factorization (dense
Cholesky below 300 poses, the nested-dissection multifrontal Cholesky from
300 up) as the preconditioner of an f64 CG against an edge-based f64
matvec. Frozen (free=0) poses are held bit-identical.

Both stages are one device program (``utils/device_loop``), as the JAX
package's one jitted program: each CG is a bounded loop of 30 guarded
iterations whose condition is evaluated on the device, the dense path's
safeguard a ``torch.where``. On the card :func:`chordal_init_pose2` captures
the program once per connectivity and replays it; with
``GNOptions.fused_chordal`` the LM program runs the same stages before its
first linearize (``solvers/gauss_newton.py``). On the CPU the same body
runs eagerly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rome_tpu_torch.graph.lower import GraphArrays
from rome_tpu_torch.ops.segment_sum import SegmentPlan
from rome_tpu_torch.solvers.linearize import TangentScatter
from rome_tpu_torch.utils.device_loop import EAGER, Program
from rome_tpu_torch.utils.math import einsum, rot2

_ODO_BATCHES = ("Pose2Pose2", "MutablePose2Pose2Gaussian")
F32, F64 = torch.float32, torch.float64


def _pose2_edges(ga: GraphArrays):
    return [
        (b.vslots[:, 0], b.vslots[:, 1], b.params["z"], b.params["sqrt_info"], b.weight)
        for b in ga.batches if b.ftype.name in _ODO_BATCHES
    ]


def _pose2_priors(ga: GraphArrays):
    return [
        (b.vslots[:, 0], b.params["z"], b.params["sqrt_info"], b.weight)
        for b in ga.batches if b.ftype.name == "PriorPose2"
    ]


def _rdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _solve_spd_delta(A, g, free, dtype, matvec, run=EAGER):
    """GN step for a linear problem: solve A dx = -g with frozen rows pinned
    to dx = 0. Jacobi scaling + f32 Cholesky (+1e-6 ridge) as the
    preconditioner of an f64 CG against the UNPINNED matvec ``matvec``."""
    dev = A.device
    f = free.to(A.dtype)
    A = A * (f[:, None] * f[None, :]) + torch.diag(1.0 - f)
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-12))
    bs = -g * d
    nD = A.shape[0]
    As32 = (A * d[:, None] * d[None, :]).to(F32) + 1e-6 * torch.eye(nD, dtype=F32, device=dev)
    L, info = torch.linalg.cholesky_ex(As32)
    L = torch.where(info != 0, math.nan, L)
    # explicit triangular inverse: the CG applies the preconditioner ~30x
    Linv = torch.linalg.solve_triangular(L, torch.eye(nD, dtype=F32, device=dev), upper=False)

    def prec(r):
        return (Linv.T @ (Linv @ r.to(F32))).to(g.dtype)

    one_minus_f = 1.0 - f

    def apply_s(v):
        x = d * v
        return d * (f * matvec(f * x) + one_minus_f * x)

    y = prec(bs)
    x = y.clone()
    r = bs - apply_s(x)
    p = prec(r)
    rz = _rdot(r, p)
    bn = torch.linalg.norm(bs) + 1e-300
    live = torch.linalg.norm(r) > 1e-7 * bn

    def body():
        # CG from the single f32 solve, 30 guarded iterations at most
        Ap = apply_s(p)
        alpha = rz / _rdot(p, Ap)
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * Ap)
        z = prec(r)
        rz2 = _rdot(r, z)
        p.copy_(z + (rz2 / rz) * p)
        rz.copy_(rz2)
        live.copy_(torch.linalg.norm(r) > 1e-7 * bn)

    run.loop(30, live, body)
    # safeguard: keep the single f32 solve if CG diverged
    y = torch.where(torch.linalg.norm(bs - apply_s(x)) <= torch.linalg.norm(bs - apply_s(y)),
                    x, y)
    return (y * d * f).to(dtype)


def _ndchol_spd_delta(sym, nd, vals_vec, g, free2, matvec, out_dtype,
                      tol=1e-7, ridge=1e-6, run=EAGER):
    """Sparse twin of :func:`_solve_spd_delta`: ND multifrontal f32
    factorization of the 2-dof chordal system as the preconditioner of an
    f64 CG against the edge-based matvec."""
    from rome_tpu_torch.solvers.gauss_newton import guarded_cg
    from rome_tpu_torch.solvers.sparse import (
        ndchol_assemble, ndchol_factorize, ndchol_solve,
    )

    rdt = g.dtype
    f = free2.to(F32)
    vals32 = vals_vec.to(F32)
    # f is 0/1: masking the sum is masking each entry
    diag_A = nd["sum_diag"].add_(torch.zeros(sym.D, dtype=F32, device=g.device), vals32) * f
    df = torch.rsqrt(torch.clamp(diag_A, min=1e-12)) * f
    diag_add = f * ridge + (1.0 - f)
    Ws = ndchol_assemble(sym, nd, vals32, df, diag_add)
    Linvs, L21s, _L11s = ndchol_factorize(sym, nd, Ws)

    def minv(r):
        y = ndchol_solve(sym, nd, Linvs, L21s, r.to(F32) * df)
        return (y * df).to(rdt)

    frdt = free2.to(rdt)
    b = (-g) * frdt
    if rdt == F32:
        return (minv(b) * frdt).to(out_dtype)
    one_minus = 1.0 - frdt

    def apply_A(v):
        return frdt * matvec(frdt * v) + one_minus * v

    # tolerance 1e-7 on both stages: end-to-end ATE is very sensitive to
    # the rotation-stage precision (see the JAX package's init2d notes)
    x, _r, _k = guarded_cg(run, minv, apply_A, b, tol, 30)
    return (x * frdt).to(out_dtype)


# above this many poses the two stage solves go SPARSE (nested dissection)
_SPARSE_THRESHOLD = 300
# chordal solve tunables, as in the JAX package
_CHORDAL_LEAF = 64
_CHORDAL_RIDGE = 1e-7
_CHORDAL_TOL_ROT = 1e-7
_CHORDAL_TOL_TRANS = 1e-7


class _ChordalPlan:
    """The chordal systems' plan for one pose-graph connectivity (both
    stages share it): the 2-dof systems' batches (per edge batch its (i, j)
    slots, per prior batch its slots) and, from ``_SPARSE_THRESHOLD`` poses
    up, their ND symbolic factorization, whose assembly and diagonal sum
    each position's entries by batch, then the factor's poses, then place.
    :meth:`device_arrs` gives the stage's fixed-order sums on a device."""

    def __init__(self, n, ei, pi):
        from rome_tpu_torch.solvers.sparse import symbolic_factor
        from rome_tpu_torch.solvers.sparse.symbolic import entry_keys

        self.n = n
        self.specs = ([(("U", "U"), np.stack([i, j], axis=1).astype(np.int64)) for i, j in ei]
                      + [(("U",), np.asarray(idx, np.int64)[:, None]) for idx in pi])
        self.sym = None
        if n >= _SPARSE_THRESHOLD:
            self.sym = symbolic_factor(["U"], {"U": n}, {"U": 2}, self.specs,
                                       leaf=_CHORDAL_LEAF)
            self.sym.entry_key = entry_keys({"U": 2}, self.specs)

    def device_arrs(self, device):
        """On ``device``: ``rows``, one plan of every contribution to the
        (n, 2) pose rows (both stages' gradients and matvecs): per edge batch
        its tails' contributions, then its heads', then per prior batch its
        poses', a row's summed by batch, slot, then the factor's poses; and
        either ``nd``, the ND plan's tensors (``sum_diag`` among them), or
        ``dense``, the plan of the 2n x 2n matrix at the flat destination
        row * 2n + col, its entries in the ND path's order."""
        from rome_tpu_torch.solvers.sparse.symbolic import entry_coords, entry_keys

        out = {"rows": TangentScatter(["U"], self.specs, device).plans["U"]}
        if self.sym is not None:
            out["nd"] = self.sym.device_arrs(device)
        else:
            r, c = entry_coords(["U"], {"U": self.n}, {"U": 2}, self.specs)
            out["dense"] = SegmentPlan(r * (2 * self.n) + c,
                                       keys=(entry_keys({"U": 2}, self.specs),), device=device)
        return out


def _chordal_key(n, edges, priors):
    """The chordal systems' connectivity key (host copies of the slots)."""
    return (
        "chordal",
        n,
        tuple(e[0].cpu().numpy().tobytes() + e[1].cpu().numpy().tobytes() for e in edges),
        tuple(p[0].cpu().numpy().tobytes() for p in priors),
    )


def _chordal_plan(n, edges, priors, device, key=None):
    """The chordal systems' plan and its tensors on ``device``, cached per
    pose-graph connectivity (beside the LM's ND plans)."""
    from rome_tpu_torch.solvers.sparse import cached_symbolic

    key = key or _chordal_key(n, edges, priors)

    def build():
        ei = [(e[0].cpu().numpy(), e[1].cpu().numpy()) for e in edges]
        return _ChordalPlan(n, ei, [p[0].cpu().numpy() for p in priors])

    return cached_symbolic(key, build, device)


class ChordalProgram:
    """Both chordal stages of one connectivity as a device program
    (``utils/device_loop.Program``): static inputs that each call copies in
    (the Pose2 values, every edge and prior batch's slots, z, sqrt-info and
    weight, the free mask), the stages replayed from them, the Pose2 values
    out. ``dtype`` is the output's."""

    def __init__(self, n, edges, priors, free, dtype, plan, arrs):
        dev = free.device

        def buf(t):
            return torch.empty(t.shape, dtype=t.dtype, device=dev)

        self.n, self.dtype, self.sym, self.arrs = n, dtype, plan.sym, arrs
        self.pose2 = torch.empty((n, 3), dtype=dtype, device=dev)
        self.edges = [tuple(buf(t) for t in e) for e in edges]
        self.priors = [tuple(buf(t) for t in p) for p in priors]
        self.free = buf(free)
        self.out = torch.empty((n, 3), dtype=dtype, device=dev)
        self.program = Program(dev, [(self._body, 1)], name="chordal")

    def _body(self, run):
        self.out.copy_(_chordal_body(self.dtype, self.n, self.pose2, self.edges, self.priors,
                                     self.free, self.sym, self.arrs, run))

    def __call__(self, pose2, edges, priors, free, eager=False):
        """The chordal Pose2 values of these inputs (a new tensor); with
        ``eager`` the program's plain version."""
        for dst, src in zip(self.edges + self.priors, edges + priors):
            for d, s in zip(dst, src):
                d.copy_(s)
        self.pose2.copy_(pose2)
        self.free.copy_(free)
        self.program.run(eager=eager)
        return self.out.clone()


_PROGRAMS: dict = {}
_PROGRAMS_MAX = 8


def chordal_init_pose2(ga: GraphArrays, values, eager=False):
    """Return values with the Pose2 block re-initialized by the two-stage
    chordal solve. Other variable types pass through untouched. On the card
    the stages are one captured program per connectivity (at most
    ``_PROGRAMS_MAX`` kept), replayed; ``eager`` runs its plain version."""
    if "Pose2" not in ga.counts:
        return values
    n = ga.counts["Pose2"]
    edges = _pose2_edges(ga)
    if not edges:
        return values
    priors = _pose2_priors(ga)
    key = getattr(ga, "_chordal_key", None)
    if key is None:
        key = ga._chordal_key = _chordal_key(n, edges, priors)
    plan, arrs = _chordal_plan(n, edges, priors, ga.device, key)
    out = dict(values)
    free = ga.free["Pose2"]
    if ga.device.type != "cuda":
        out["Pose2"] = _chordal_body(ga.dtype, n, values["Pose2"], edges, priors, free,
                                     plan.sym, arrs)
        return out
    pkey = (key, str(ga.dtype), str(ga.device))
    program = _PROGRAMS.get(pkey)
    if program is None:
        if len(_PROGRAMS) >= _PROGRAMS_MAX:
            _PROGRAMS.clear()
        program = _PROGRAMS[pkey] = ChordalProgram(n, edges, priors, free, ga.dtype, plan, arrs)
    out["Pose2"] = program(values["Pose2"], edges, priors, free, eager=eager)
    return out


def _rot_terms(edges, priors):
    """Stage 1's per-batch constants: per edge batch (i, j, wq, Rz), per
    prior batch (idx, wq, the prior's (cos, sin))."""
    et = [(i, j, (S[:, 2, 2] * w) ** 2, rot2(z[:, 2])) for i, j, z, S, w in edges]
    pt = [(idx, (S[:, 2, 2] * w) ** 2, torch.stack([torch.cos(z[:, 2]), torch.sin(z[:, 2])], -1))
          for idx, z, S, w in priors]
    return et, pt


def _rot_rows(et, pt, x, grad=False):
    """Stage 1's row contributions at the (n, 2) point ``x``, in the rows
    plan's order: the gradient with ``grad``, else the matvec A x."""
    parts = []
    for i, j, wq, Rz in et:
        r = x[j] - einsum("nij,nj->ni", Rz, x[i])
        parts += [-wq[:, None] * einsum("nji,nj->ni", Rz, r), wq[:, None] * r]
    for idx, wq, ut in pt:
        parts.append(wq[:, None] * (x[idx] - ut if grad else x[idx]))
    return parts


def _tr_terms(edges, priors, R):
    """Stage 2's per-batch constants at the rotations ``R``: per edge batch
    (i, j, R_i, R_i W, R_i W R_i^T, the edge's t), per prior batch (idx, W,
    the prior's t)."""
    et = []
    for i, j, z, S, w in edges:
        Ri = R[i]
        RW = einsum("nij,njk->nik", Ri, _edge_info(S, w))
        et.append((i, j, Ri, RW, einsum("nik,nlk->nil", RW, Ri), z[:, :2]))
    pt = [(idx, _edge_info(S, w), z[:, :2]) for idx, z, S, w in priors]
    return et, pt


def _edge_info(S, w):
    St = S[:, :2, :2]
    return einsum("nij,nik->njk", St, St) * (w ** 2)[:, None, None]  # (m,2,2)


def _tr_rows(et, pt, x, grad=False):
    """Stage 2's row contributions at the (n, 2) point ``x``, in the rows
    plan's order: the gradient with ``grad``, else the matvec A x."""
    parts = []
    for i, j, Ri, RW, RWRt, zt in et:
        if grad:
            # r = R_i^T (t_j - t_i) - dt;  J_tj = R_i^T, J_ti = -R_i^T
            e = einsum("nij,nj->ni", RW, einsum("nji,nj->ni", Ri, x[j] - x[i]) - zt)
        else:
            e = einsum("nij,nj->ni", RWRt, x[j] - x[i])
        parts += [-e, e]
    for idx, W, zt in pt:
        parts.append(einsum("njk,nk->nj", W, x[idx] - zt if grad else x[idx]))
    return parts


def _rot_entries(et, pt):
    """Stage 1's f32 matrix entries in the ND plan's order (entry_coords for
    vslots (i, j)): A[i,i] = wI, A[i,j] = -wRz^T, A[j,i] = -wRz, A[j,j] = wI
    (Rz^T Rz = I); a prior's wI."""
    vals = []
    for _i, _j, wq, Rz in et:
        wI = wq[:, None, None].to(F32) * torch.eye(2, dtype=F32, device=wq.device)
        wRz = (wq[:, None, None] * Rz).to(F32)
        vals += [wI, -wRz.transpose(-1, -2), -wRz, wI]
    for _idx, wq, _ut in pt:
        vals.append(wq[:, None, None].to(F32) * torch.eye(2, dtype=F32, device=wq.device))
    return torch.cat([v.reshape(-1) for v in vals])


def _tr_entries(et, pt):
    """Stage 2's f32 matrix entries in the same order: R_i W R_i^T with its
    signs, a prior's W."""
    vals = []
    for _i, _j, _Ri, _RW, RWRt, _zt in et:
        b = RWRt.to(F32)
        vals += [b, -b, -b, b]
    vals += [W.to(F32) for _idx, W, _zt in pt]
    return torch.cat([v.reshape(-1) for v in vals])


def _chordal_body(dtype, n, pose2_values, edges, priors, free, sym, arrs, run=EAGER):
    # assembly/refinement precision f64 (the Laplacian solves need it); the
    # factorizations are f32. Every sum of colliding contributions goes
    # through one of the plan's fixed-order sums (``arrs``)
    dev = pose2_values.device
    adt = F64
    th0 = pose2_values[:, 2].to(adt)
    t0 = pose2_values[:, :2].to(adt)
    edges = [(i, j, z.to(adt), S.to(adt), w.to(adt)) for i, j, z, S, w in edges]
    priors = [(i, z.to(adt), S.to(adt), w.to(adt)) for i, z, S, w in priors]
    f2 = torch.repeat_interleave(free, 2)

    def rows(parts):
        return arrs["rows"].add_(torch.zeros((n, 2), dtype=adt, device=dev),
                                 torch.cat(parts)).reshape(-1)

    def solve(vals, g, matvec, tol):
        if sym is not None:
            return _ndchol_spd_delta(sym, arrs["nd"], vals, g, f2, matvec, adt,
                                     tol=tol, ridge=_CHORDAL_RIDGE, run=run)
        A = arrs["dense"].add_(torch.zeros(4 * n * n, dtype=F32, device=dev), vals)
        return _solve_spd_delta(A.view(2 * n, 2 * n), g, f2, adt, matvec, run)

    # -------- stage 1: chordal rotation relaxation (linear in (c, s)) ------
    u0 = torch.stack([torch.cos(th0), torch.sin(th0)], dim=-1)  # (n, 2)
    et, pt = _rot_terms(edges, priors)
    g = rows(_rot_rows(et, pt, u0, grad=True))
    du = solve(_rot_entries(et, pt), g,
               lambda xf: rows(_rot_rows(et, pt, xf.reshape(n, 2))), _CHORDAL_TOL_ROT)
    u = u0 + du.reshape(n, 2)
    th = torch.where(free > 0, torch.atan2(u[:, 1], u[:, 0]), th0)

    # -------- stage 2: translations (single linear solve) ------------------
    R = rot2(th)
    et, pt = _tr_terms(edges, priors, R)
    g = rows(_tr_rows(et, pt, t0, grad=True))
    dt = solve(_tr_entries(et, pt), g,
               lambda xf: rows(_tr_rows(et, pt, xf.reshape(n, 2))), _CHORDAL_TOL_TRANS)
    t = t0 + dt.reshape(n, 2)
    # frozen poses stay bit-identical to the input (fixed-lag contract)
    out = torch.cat([t, th[:, None]], dim=-1).to(dtype)
    return torch.where(free[:, None] > 0, out, pose2_values)
