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
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.graph.lower import GraphArrays
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


def _safe(x):
    """Denominator guard: |x| < 1e-300 -> 1e-300 (as the JAX package)."""
    return torch.where(torch.abs(x) < 1e-300, torch.full_like(x, 1e-300), x)


def _solve_spd_delta(A, g, free, dtype, matvec):
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
    if int(info) != 0:
        L = torch.full_like(L, float("nan"))
    # explicit triangular inverse: the CG applies the preconditioner ~30x
    Linv = torch.linalg.solve_triangular(L, torch.eye(nD, dtype=F32, device=dev), upper=False)

    def prec(r):
        return (Linv.T @ (Linv @ r.to(F32))).to(g.dtype)

    one_minus_f = 1.0 - f

    def apply_s(v):
        x = d * v
        return d * (f * matvec(f * x) + one_minus_f * x)

    y = prec(bs)
    x = y
    r = bs - apply_s(x)
    z = prec(r)
    p = z
    rz = _rdot(r, z)
    bn = float(torch.linalg.norm(bs)) + 1e-300
    k = 0
    while k < 30 and float(torch.linalg.norm(r)) > 1e-7 * bn:
        Ap = apply_s(p)
        alpha = rz / _rdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz2 = _rdot(r, z)
        p = z + (rz2 / rz) * p
        rz = rz2
        k += 1
    # safeguard: keep the single f32 solve if CG diverged
    if float(torch.linalg.norm(bs - apply_s(x))) <= float(torch.linalg.norm(bs - apply_s(y))):
        y = x
    return (y * d * f).to(dtype)


def _ndchol_spd_delta(sym, nd, vals_vec, g, free2, matvec, out_dtype,
                      tol=1e-7, ridge=1e-6):
    """Sparse twin of :func:`_solve_spd_delta`: ND multifrontal f32
    factorization of the 2-dof chordal system as the preconditioner of an
    f64 CG against the edge-based matvec."""
    from rome_tpu_torch.solvers.sparse import (
        ndchol_assemble, ndchol_factorize, ndchol_solve,
    )

    rdt = g.dtype
    f = free2.to(F32)
    vals32 = vals_vec.to(F32)
    diag_A = torch.zeros(sym.D, dtype=F32, device=g.device).index_add_(
        0, nd["diag_dst"], vals32[nd["diag_src"]] * f[nd["diag_dst"]] ** 2
    )
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

    bn = float(torch.linalg.norm(b)) + 1e-300
    x = torch.zeros_like(b)
    r = b
    p = torch.zeros_like(b)
    rz = torch.zeros((), dtype=rdt, device=b.device)
    k = 0
    # tolerance 1e-7 on both stages: end-to-end ATE is very sensitive to
    # the rotation-stage precision (see the JAX package's init2d notes)
    while k < 30 and float(torch.linalg.norm(r)) > tol * bn:
        z = minv(r)
        rz2 = _rdot(r, z)
        beta = rz2 / _safe(rz) if k else torch.zeros_like(rz2)
        p = z + beta * p
        Ap = apply_A(p)
        alpha = rz2 / _safe(_rdot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        rz = rz2
        k += 1
    return (x * frdt).to(out_dtype)


# above this many poses the two stage solves go SPARSE (nested dissection)
_SPARSE_THRESHOLD = 300
# chordal solve tunables, as in the JAX package
_CHORDAL_LEAF = 64
_CHORDAL_RIDGE = 1e-7
_CHORDAL_TOL_ROT = 1e-7
_CHORDAL_TOL_TRANS = 1e-7


def _chordal_symbolic(n, edges, priors, leaf=None):
    """Symbolic ND factorization of the 2-dof chordal systems (both stages
    share the pose graph's sparsity)."""
    from rome_tpu_torch.solvers.sparse import symbolic_factor

    specs = []
    for i, j, _z, _S, _w in edges:
        specs.append((("U", "U"), np.stack([i, j], axis=1).astype(np.int64)))
    for idx, _z, _S, _w in priors:
        specs.append((("U",), np.asarray(idx)[:, None].astype(np.int64)))
    return symbolic_factor(
        ["U"], {"U": n}, {"U": 2}, specs,
        leaf=leaf if leaf is not None else _CHORDAL_LEAF,
    )


def _chordal_plan(n, edges, priors, device):
    """The chordal systems' symbolic plan, cached per pose-graph connectivity."""
    from rome_tpu_torch.solvers.sparse import cached_symbolic

    ei = [(e[0].cpu().numpy(), e[1].cpu().numpy()) for e in edges]
    pi = [p[0].cpu().numpy() for p in priors]
    key = (
        "chordal",
        n,
        tuple(a.tobytes() + b.tobytes() for a, b in ei),
        tuple(a.tobytes() for a in pi),
    )
    return cached_symbolic(
        key,
        lambda: _chordal_symbolic(
            n, [(a, b, None, None, None) for a, b in ei],
            [(a, None, None, None) for a in pi],
        ),
        device,
    )


def chordal_init_pose2(ga: GraphArrays, values):
    """Return values with the Pose2 block re-initialized by the two-stage
    chordal solve. Other variable types pass through untouched."""
    if "Pose2" not in ga.counts:
        return values
    n = ga.counts["Pose2"]
    edges = _pose2_edges(ga)
    if not edges:
        return values
    priors = _pose2_priors(ga)
    if n >= _SPARSE_THRESHOLD:
        sym, nd = _chordal_plan(n, edges, priors, ga.device)
    else:
        sym, nd = None, None
    out = dict(values)
    out["Pose2"] = _chordal_body(
        ga.dtype, n, values["Pose2"], edges, priors, ga.free["Pose2"], sym, nd
    )
    return out


def _idx2(i):
    """(m,) pose slots -> (m, 2) scalar indices of the 2-dof unknowns."""
    return 2 * i[:, None] + torch.arange(2, device=i.device)[None, :]


def _scatter_block(A, ii, jj, blk):
    """A[ii[:, a], jj[:, b]] += blk[:, a, b] (accumulating)."""
    m = blk.shape[0]
    rows = ii[:, :, None].expand(m, 2, 2).reshape(-1)
    cols = jj[:, None, :].expand(m, 2, 2).reshape(-1)
    A.index_put_((rows, cols), blk.reshape(-1), accumulate=True)


def _chordal_body(dtype, n, pose2_values, edges, priors, free, sym=None, nd=None):
    # assembly/refinement precision f64 (the Laplacian solves need it); the
    # factorizations are f32
    dev = pose2_values.device
    adt = F64
    th0 = pose2_values[:, 2].to(adt)
    t0 = pose2_values[:, :2].to(adt)
    edges = [(i, j, z.to(adt), S.to(adt), w.to(adt)) for i, j, z, S, w in edges]
    priors = [(i, z.to(adt), S.to(adt), w.to(adt)) for i, z, S, w in priors]
    out_dtype = dtype
    sparse = sym is not None
    f2 = torch.repeat_interleave(free, 2)

    # -------- stage 1: chordal rotation relaxation (linear in (c, s)) ------
    u0 = torch.stack([torch.cos(th0), torch.sin(th0)], dim=-1)  # (n, 2)
    A = None if sparse else torch.zeros((2 * n, 2 * n), dtype=F32, device=dev)
    vals1 = []  # sparse-path contribution blocks, entry_coords order
    g = torch.zeros((n, 2), dtype=adt, device=dev)
    for i, j, z, S, w in edges:
        wq = (S[:, 2, 2] * w) ** 2  # info weight of the rotation row
        Rz = rot2(z[:, 2])  # (m, 2, 2)
        r = u0[j] - einsum("nij,nj->ni", Rz, u0[i])
        g.index_add_(0, j, wq[:, None] * r)
        g.index_add_(0, i, -wq[:, None] * einsum("nji,nj->ni", Rz, r))
        eye2 = torch.eye(2, dtype=F32, device=dev).expand(Rz.shape)
        wI = wq[:, None, None].to(F32) * eye2
        wRz = (wq[:, None, None] * Rz).to(F32)
        if sparse:
            # (k,l) block order of sparse.symbolic.entry_coords for vslots
            # (i, j): A[i,i]=wI  A[i,j]=-wRz^T  A[j,i]=-wRz  A[j,j]=wI
            vals1 += [wI.reshape(-1), (-wRz.transpose(-1, -2)).reshape(-1),
                      (-wRz).reshape(-1), wI.reshape(-1)]
        else:
            ii, jj = _idx2(i), _idx2(j)
            _scatter_block(A, jj, jj, wI)
            _scatter_block(A, ii, ii, wI)  # Rz^T Rz = I
            _scatter_block(A, jj, ii, -wRz)
            _scatter_block(A, ii, jj, -wRz.transpose(-1, -2))
    for idx, z, S, w in priors:
        wq = (S[:, 2, 2] * w) ** 2
        ut = torch.stack([torch.cos(z[:, 2]), torch.sin(z[:, 2])], -1)
        g.index_add_(0, idx, wq[:, None] * (u0[idx] - ut))
        eye2 = torch.eye(2, dtype=F32, device=dev).expand(idx.shape[0], 2, 2)
        wI = wq[:, None, None].to(F32) * eye2
        if sparse:
            vals1.append(wI.reshape(-1))
        else:
            ii = _idx2(idx)
            _scatter_block(A, ii, ii, wI)

    def mv_rot(xf):
        # edge-based A@x, O(m)
        x = xf.reshape(n, 2)
        y = torch.zeros_like(x)
        for i, j, z, S, w in edges:
            wq = (S[:, 2, 2] * w) ** 2
            Rz = rot2(z[:, 2])
            e = x[j] - einsum("nij,nj->ni", Rz, x[i])
            y.index_add_(0, j, wq[:, None] * e)
            y.index_add_(0, i, -wq[:, None] * einsum("nji,nj->ni", Rz, e))
        for idx, z, S, w in priors:
            wq = (S[:, 2, 2] * w) ** 2
            y.index_add_(0, idx, wq[:, None] * x[idx])
        return y.reshape(-1)

    if sparse:
        du = _ndchol_spd_delta(
            sym, nd, torch.cat(vals1), g.reshape(-1), f2, mv_rot, adt,
            tol=_CHORDAL_TOL_ROT, ridge=_CHORDAL_RIDGE,
        )
    else:
        du = _solve_spd_delta(A, g.reshape(-1), f2, adt, mv_rot)
    u = u0 + du.reshape(n, 2)
    th = torch.where(free > 0, torch.atan2(u[:, 1], u[:, 0]), th0)

    # -------- stage 2: translations (single linear solve) ------------------
    R = rot2(th)
    A = None if sparse else torch.zeros((2 * n, 2 * n), dtype=F32, device=dev)
    vals2 = []
    g = torch.zeros((n, 2), dtype=adt, device=dev)

    def edge_info(S, w):
        St = S[:, :2, :2]
        return einsum("nij,nik->njk", St, St) * (w ** 2)[:, None, None]  # (m,2,2)

    for i, j, z, S, w in edges:
        W = edge_info(S, w)
        Ri = R[i]
        # r = R_i^T (t_j - t_i) - dt;  J_tj = R_i^T, J_ti = -R_i^T
        r = einsum("nji,nj->ni", Ri, t0[j] - t0[i]) - z[:, :2]
        RW = einsum("nij,njk->nik", Ri, W)          # R_i W
        RWRt = einsum("nik,nlk->nil", RW, Ri)       # R_i W R_i^T
        RWr = einsum("nij,nj->ni", RW, r)
        g.index_add_(0, j, RWr)
        g.index_add_(0, i, -RWr)
        RWRt32 = RWRt.to(F32)
        if sparse:
            vals2 += [RWRt32.reshape(-1), (-RWRt32).reshape(-1),
                      (-RWRt32).reshape(-1), RWRt32.reshape(-1)]
        else:
            ii, jj = _idx2(i), _idx2(j)
            _scatter_block(A, jj, jj, RWRt32)
            _scatter_block(A, ii, ii, RWRt32)
            _scatter_block(A, jj, ii, -RWRt32)
            _scatter_block(A, ii, jj, -RWRt32)
    for idx, z, S, w in priors:
        W = edge_info(S, w)
        r = t0[idx] - z[:, :2]
        g.index_add_(0, idx, einsum("njk,nk->nj", W, r))
        if sparse:
            vals2.append(W.to(F32).reshape(-1))
        else:
            ii = _idx2(idx)
            _scatter_block(A, ii, ii, W.to(F32))

    def mv_tr(xf):
        x = xf.reshape(n, 2)
        y = torch.zeros_like(x)
        for i, j, z, S, w in edges:
            W = edge_info(S, w)
            Ri = R[i]
            RWRt = einsum("nik,nlk->nil", einsum("nij,njk->nik", Ri, W), Ri)
            e = einsum("nij,nj->ni", RWRt, x[j] - x[i])
            y.index_add_(0, j, e)
            y.index_add_(0, i, -e)
        for idx, z, S, w in priors:
            y.index_add_(0, idx, einsum("nij,nj->ni", edge_info(S, w), x[idx]))
        return y.reshape(-1)

    if sparse:
        dt = _ndchol_spd_delta(
            sym, nd, torch.cat(vals2), g.reshape(-1), f2, mv_tr, adt,
            tol=_CHORDAL_TOL_TRANS, ridge=_CHORDAL_RIDGE,
        )
    else:
        dt = _solve_spd_delta(A, g.reshape(-1), f2, adt, mv_tr)
    t = t0 + dt.reshape(n, 2)
    # frozen poses stay bit-identical to the input (fixed-lag contract)
    out = torch.cat([t, th[:, None]], dim=-1).to(out_dtype)
    return torch.where(free[:, None] > 0, out, pose2_values)
