"""The benchmark's plain reference: a frozen copy of tools/cpu_reference.py.

A float64 numpy/scipy chordal initialisation (Carlone et al.) and sparse
Levenberg-Marquardt (scipy ``splu``) for SE(2) pose graphs, with the
residual conventions of the solver under test (hybrid SE(2) tangent,
whitened residuals, cost 0.5 * sum |r_w|^2). The functions from ``wrap`` to
``solve_lm`` are tools/cpu_reference.py's, unchanged.

Added below them, for the benchmark's comparisons:

- ``pack``: a world's edges as this module's (i, j, z, sqrt_info) tuples;
- ``solve_batch``: chordal init + ``solve_lm`` with the x0 prior;
- ``solve_free``: LM over a subset of poses with the others held fixed and
  no prior (a fixed-lag step's problem), and ``edge_cost``;
- ``ate_values``: SE(2)-aligned ATE (bench_torch.py's);
- ``bf16`` and the ``control`` solvers: the same reference computed with
  its inputs and every pose it keeps rounded to bfloat16, the precision
  below the configuration's float32.

Imports numpy and scipy only, nothing of the solver under test.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def wrap(a):
    return np.remainder(a + np.pi, 2 * np.pi) - np.pi


def rot(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s], [s, c]])


def se2_compose(a, b):
    t = a[:2] + rot(a[2]) @ b[:2]
    return np.array([t[0], t[1], wrap(a[2] + b[2])])


def parse_g2o_se2(path):
    """EDGE_SE2 lines -> (edges, n_poses). Info matrix -> sqrt_info via the
    same inv + Hermitian-repair + Cholesky route as rome_tpu.io.g2o."""
    edges = []
    n = 0
    with open(path) as fh:
        for ln in fh:
            tok = ln.split()
            if not tok or tok[0] != "EDGE_SE2":
                continue
            i, j = int(tok[1]), int(tok[2])
            z = np.array([float(v) for v in tok[3:6]])
            i11, i12, i13, i22, i23, i33 = (float(v) for v in tok[6:12])
            info = np.array([[i11, i12, i13], [i12, i22, i23], [i13, i23, i33]])
            cov = np.linalg.inv(info)
            cov = 0.5 * (cov + cov.T)
            w, V = np.linalg.eigh(cov)
            cov = (V * np.maximum(w, 1e-12)) @ V.T
            L = np.linalg.cholesky(cov + 1e-14 * np.eye(3))
            sqrt_info = np.linalg.inv(L)
            edges.append((i, j, z, sqrt_info))
            n = max(n, i + 1, j + 1)
    return edges, n


def chordal_init(edges, n):
    """Chordal rotation relaxation + linear translation solve (Carlone et
    al.) — the strongest classical init for 2D pose graphs. Linear in the
    unnormalized rotation columns u_i = (cos th_i, sin th_i), so it has no
    angle-wrap sensitivity and lands inside the LM basin (measured: M3500
    12 LM iters to the optimum; MIT reaches the cost-20.6 global basin that
    odometry init misses entirely, stalling at the 383.8 local minimum)."""
    I = np.array([e[0] for e in edges])
    J = np.array([e[1] for e in edges])
    Z = np.stack([e[2] for e in edges])
    S = np.stack([e[3] for e in edges])
    m = len(edges)
    w = S[:, 2, 2]
    cz, sz = np.cos(Z[:, 2]), np.sin(Z[:, 2])
    rows, cols, vals = [], [], []
    r_idx = np.arange(m)
    rows += [2 * r_idx, 2 * r_idx, 2 * r_idx]
    cols += [2 * J, 2 * I, 2 * I + 1]
    vals += [w * np.ones(m), -w * cz, w * sz]
    rows += [2 * r_idx + 1, 2 * r_idx + 1, 2 * r_idx + 1]
    cols += [2 * J + 1, 2 * I + 1, 2 * I]
    vals += [w * np.ones(m), -w * cz, -w * sz]
    wa = 1e3  # anchor u_0 = (1, 0)
    rows += [np.array([2 * m]), np.array([2 * m + 1])]
    cols += [np.array([0]), np.array([1])]
    vals += [np.array([wa]), np.array([wa])]
    b = np.zeros(2 * m + 2)
    b[2 * m] = wa
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(2 * m + 2, 2 * n),
    ).tocsr()
    u = spla.splu((A.T @ A).tocsc()).solve(A.T @ b)
    th = np.arctan2(u[1::2], u[0::2])

    # translation: r = S ( R_i^T (t_j - t_i) - z_t ), linear in t
    R = _rots(th)
    St = S[:, :2, :2]
    SRt = np.einsum("mab,mcb->mac", St, R[I])
    rows2 = (2 * r_idx[:, None, None] + np.arange(2)[None, :, None]).repeat(2, 2)
    cols_j = np.broadcast_to((2 * J)[:, None, None] + np.arange(2)[None, None, :], (m, 2, 2))
    cols_i = np.broadcast_to((2 * I)[:, None, None] + np.arange(2)[None, None, :], (m, 2, 2))
    bvec = np.einsum("mab,mb->ma", St, Z[:, :2]).ravel()
    rows_a = np.concatenate([rows2.ravel(), rows2.ravel(), [2 * m, 2 * m + 1]])
    cols_a = np.concatenate([cols_j.ravel(), cols_i.ravel(), [0, 1]])
    vals_a = np.concatenate([SRt.ravel(), -SRt.ravel(), [wa, wa]])
    b2 = np.concatenate([bvec, [0.0, 0.0]])
    A2 = sp.coo_matrix((vals_a, (rows_a, cols_a)), shape=(2 * m + 2, 2 * n)).tocsr()
    t = spla.splu((A2.T @ A2).tocsc()).solve(A2.T @ b2).reshape(n, 2)
    return np.concatenate([t, th[:, None]], axis=1)


def pack_edges(edges):
    m = len(edges)
    I = np.array([e[0] for e in edges], dtype=np.int64)
    J = np.array([e[1] for e in edges], dtype=np.int64)
    Z = np.stack([e[2] for e in edges])
    S = np.stack([e[3] for e in edges])
    return I, J, Z, S, m


def _rots(th):
    c, s = np.cos(th), np.sin(th)
    R = np.empty(th.shape + (2, 2))
    R[..., 0, 0] = c
    R[..., 0, 1] = -s
    R[..., 1, 0] = s
    R[..., 1, 1] = c
    return R


def residuals_and_jacobian(x, packed, prior_sqrt_info, build_jac=True):
    """Whitened residuals + sparse Jacobian wrt per-pose hybrid tangent.

    Edge residual r = local(q, p∘exp(z)) with hybrid tangent:
      qhat = p∘exp(z);  r = (R(th_q)^T (t_qhat - t_q), wrap(th_qhat - th_q))
    Analytic Jacobians wrt body-frame perturbations, vectorized over edges.
    """
    I, J, Z, S, m = packed
    p, q = x[I], x[J]
    Rp, Rq = _rots(p[:, 2]), _rots(q[:, 2])
    RqT = np.swapaxes(Rq, -1, -2)
    t_qhat = p[:, :2] + np.einsum("mab,mb->ma", Rp, Z[:, :2])
    th_qhat = p[:, 2] + Z[:, 2]
    dt = t_qhat - q[:, :2]
    rloc = np.concatenate(
        [np.einsum("mab,mb->ma", RqT, dt), wrap(th_qhat - q[:, 2])[:, None]],
        axis=1,
    )
    r_edges = np.einsum("mab,mb->ma", S, rloc)

    # anchor prior on pose 0: r = local(p0, identity)
    p0 = x[0]
    R0T = rot(p0[2]).T
    rp = np.array([*(R0T @ (-p0[:2])), wrap(-p0[2])])
    r = np.concatenate([r_edges.ravel(), prior_sqrt_info @ rp])
    if not build_jac:
        return r, None

    # d r / d (body perturbation of p): dR(th)/dth = R(th)·G, G=[[0,-1],[1,0]]
    RqTRp = RqT @ Rp
    Gz = np.stack([-Z[:, 1], Z[:, 0]], axis=1)
    Jp = np.zeros((m, 3, 3))
    Jp[:, :2, :2] = RqTRp
    Jp[:, :2, 2] = np.einsum("mab,mb->ma", RqTRp, Gz)
    Jp[:, 2, 2] = 1.0
    # d r / d (body perturbation of q): dr_t/dd_t = -I; dr_t/dd_th = -G r_t
    Jq = np.zeros((m, 3, 3))
    Jq[:, 0, 0] = -1.0
    Jq[:, 1, 1] = -1.0
    Jq[:, 0, 2] = rloc[:, 1]
    Jq[:, 1, 2] = -rloc[:, 0]
    Jq[:, 2, 2] = -1.0
    SJp = S @ Jp
    SJq = S @ Jq

    # triplets: rows 3k+a, cols 3v+b for both blocks + the prior block
    a = np.arange(3)
    row_base = 3 * np.arange(m)
    rows_blk = (row_base[:, None, None] + a[:, None]).repeat(3, axis=2)  # (m,3,3)
    cols_p = (3 * I)[:, None, None] + a[None, None, :]
    cols_q = (3 * J)[:, None, None] + a[None, None, :]
    cols_p = np.broadcast_to(cols_p, (m, 3, 3))
    cols_q = np.broadcast_to(cols_q, (m, 3, 3))

    Jp0 = np.zeros((3, 3))
    Jp0[:2, :2] = -np.eye(2)
    Jp0[:2, 2] = np.array([rp[1], -rp[0]])
    Jp0[2, 2] = -1.0
    SJ0 = prior_sqrt_info @ Jp0
    rows0 = 3 * m + a[:, None].repeat(3, axis=1)
    cols0 = np.broadcast_to(a[None, :], (3, 3))

    rows = np.concatenate([rows_blk.ravel(), rows_blk.ravel(), rows0.ravel()])
    cols = np.concatenate([cols_p.ravel(), cols_q.ravel(), cols0.ravel()])
    vals = np.concatenate([SJp.ravel(), SJq.ravel(), SJ0.ravel()])
    Jmat = sp.coo_matrix(
        (vals, (rows, cols)), shape=(3 * (m + 1), 3 * x.shape[0])
    ).tocsr()
    return r, Jmat


def cost_of(x, packed, prior_sqrt_info):
    r, _ = residuals_and_jacobian(x, packed, prior_sqrt_info, build_jac=False)
    return 0.5 * float(r @ r)


def solve_lm(x, edges, prior_sqrt_info, max_iters=200, gtol=1e-8, ftol=1e-12):
    packed = pack_edges(edges)
    lam = 1e-6
    cost_prev = np.inf
    n_iter = 0
    n_rej = 0
    converged = False
    lins = None
    for it in range(max_iters):
        n_iter = it + 1
        if lins is None:
            r, J = residuals_and_jacobian(x, packed, prior_sqrt_info)
            cost0 = 0.5 * float(r @ r)
            g = J.T @ r
            H = (J.T @ J).tocsc()
            lins = (r, J, cost0, g, H)
        else:
            r, J, cost0, g, H = lins
        if np.linalg.norm(g) < gtol:
            converged = True
            break
        Hd = H + sp.diags(lam * np.maximum(H.diagonal(), 1e-8))
        try:
            d = spla.splu(Hd).solve(-g)
        except RuntimeError:
            lam = min(lam * 8.0, 1e12)
            continue
        dd = d.reshape(-1, 3)
        # body-frame retraction: x ⊞ d = (t + R(th)·d_t, wrap(th + d_th))
        xt = np.empty_like(x)
        xt[:, :2] = x[:, :2] + np.einsum("nab,nb->na", _rots(x[:, 2]), dd[:, :2])
        xt[:, 2] = wrap(x[:, 2] + dd[:, 2])
        cost1 = cost_of(xt, packed, prior_sqrt_info)
        if np.isfinite(cost1) and cost1 < cost0:
            x = xt
            lam = max(lam * 0.25, 1e-12)
            lins = None  # re-linearize at the new point
            n_rej = 0
            if np.isfinite(cost_prev) and abs(cost_prev - cost1) <= ftol * max(
                1.0, abs(cost_prev)
            ):
                converged = True
                break
            cost_prev = cost1
        else:
            lam = min(lam * 8.0, 1e12)
            n_rej += 1
            if n_rej >= 20:
                converged = True  # stalled at numerical floor
                break
    return x, cost_of(x, packed, prior_sqrt_info), n_iter, converged


# ---------------------------------------------------------------------------
# additions for the benchmark
# ---------------------------------------------------------------------------

def prior_sqrt_info(sigmas):
    return np.diag(1.0 / np.asarray(sigmas, float))


def pack(i, j, z, sigmas):
    """Edges ``i`` -> ``j`` with means ``z`` (m, 3) and standard deviations
    ``sigmas`` (m, 3) as (i, j, z, sqrt_info) tuples."""
    return [(int(a), int(b), np.asarray(zz, float), np.diag(1.0 / np.asarray(s, float)))
            for a, b, zz, s in zip(i, j, z, sigmas)]


def solve_batch(edges, n, prior_sigmas, round_to=None, max_iters=200):
    """Chordal init + LM with a prior on x0 (tools/cpu_reference.py's
    ``main`` without the spanning-tree alternative). ``round_to`` (a
    function of an array) is applied to the inputs, the init and every
    iterate: the control, which runs at most ``max_iters`` iterations.
    Returns (poses (n, 3), cost, iterations,
    converged)."""
    P = prior_sqrt_info(prior_sigmas)
    if round_to is None:
        x0 = chordal_init(edges, n)
        return solve_lm(x0, edges, P, max_iters=max_iters)
    edges_r = [(a, b, round_to(z), round_to(S)) for a, b, z, S in edges]
    x0 = round_to(chordal_init(edges_r, n))
    return _lm(x0, pack_edges(edges_r), round_to(P), np.ones(n, bool), round_to,
               max_iters=max_iters)


def edge_cost(x, packed):
    """0.5 * sum |r_w|^2 over ``packed`` edges (no prior)."""
    r, _ = residuals_and_jacobian(x, packed, np.zeros((3, 3)), build_jac=False)
    return 0.5 * float(r @ r)


def solve_free(x, edges, free, round_to=None, max_iters=200):
    """LM over the poses where ``free`` (n,) is true, the others held at
    ``x``; ``edges`` are the factors of the problem (each touching a free
    pose), no prior. Returns (poses, cost, iterations, converged)."""
    packed = pack_edges(edges)
    if round_to is not None:
        packed = (packed[0], packed[1], round_to(packed[2]), round_to(packed[3]), packed[4])
    return _lm(np.array(x, float), packed, np.zeros((3, 3)), np.asarray(free, bool),
               round_to or (lambda a: a), max_iters=max_iters)


def _lm(x, packed, prior, free, rnd, max_iters=200, gtol=1e-8, ftol=1e-12):
    """``solve_lm``'s loop over the columns of the ``free`` poses, each
    iterate passed through ``rnd``."""
    cols = (3 * np.flatnonzero(free)[:, None] + np.arange(3)).ravel()
    lam, cost_prev, n_rej, converged, it = 1e-6, np.inf, 0, False, 0
    lins = None
    for it in range(1, max_iters + 1):
        if lins is None:
            r, J = residuals_and_jacobian(x, packed, prior)
            J = J[:, cols]
            cost0 = 0.5 * float(r @ r)
            g = J.T @ r
            H = (J.T @ J).tocsc()
            lins = (cost0, g, H)
        cost0, g, H = lins
        if np.linalg.norm(g) < gtol:
            converged = True
            break
        Hd = H + sp.diags(lam * np.maximum(H.diagonal(), 1e-8))
        try:
            d = spla.splu(Hd.tocsc()).solve(-g)
        except RuntimeError:
            lam = min(lam * 8.0, 1e12)
            continue
        dd = np.zeros_like(x)
        dd[free] = d.reshape(-1, 3)
        xt = np.empty_like(x)
        xt[:, :2] = x[:, :2] + np.einsum("nab,nb->na", _rots(x[:, 2]), dd[:, :2])
        xt[:, 2] = wrap(x[:, 2] + dd[:, 2])
        xt = np.where(free[:, None], rnd(xt), x)
        cost1 = 0.5 * float(np.sum(residuals_and_jacobian(xt, packed, prior, False)[0] ** 2))
        if np.isfinite(cost1) and cost1 < cost0:
            x, lins, n_rej = xt, None, 0
            lam = max(lam * 0.25, 1e-12)
            if np.isfinite(cost_prev) and abs(cost_prev - cost1) <= ftol * max(1.0, abs(cost_prev)):
                converged = True
                break
            cost_prev = cost1
        else:
            lam = min(lam * 8.0, 1e12)
            n_rej += 1
            if n_rej >= 20:
                converged = True
                break
    return x, 0.5 * float(np.sum(residuals_and_jacobian(x, packed, prior, False)[0] ** 2)), \
        it, converged


def bf16(a):
    """``a`` rounded to bfloat16 (round to nearest even, through float32),
    returned as float64."""
    f = np.ascontiguousarray(a, dtype=np.float32)
    b = f.view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32).astype(np.float64).reshape(np.shape(a))


def ate_values(poses, gt_poses):
    """ATE RMSE of (n, >= 2) positions after SE(2) alignment (Kabsch on the
    2-D positions) to the truth's (bench_torch.py's)."""
    E, G = np.asarray(poses)[:, :2], np.asarray(gt_poses)[:, :2]
    Ec, Gc = E - E.mean(0), G - G.mean(0)
    U, _s, Vt = np.linalg.svd(Gc.T @ Ec)
    R = U @ np.diag([1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    return float(np.sqrt(np.mean(np.sum((Ec @ R.T + G.mean(0) - G) ** 2, axis=1))))
