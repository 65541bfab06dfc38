"""Numeric phase of the nested-dissection multifrontal Cholesky, in PyTorch
(counterpart of ``rome_tpu/solvers/sparse/ndchol.py``).

One assembly into per-level padded front tensors, a leaf-to-root sweep of
batched dense partial Cholesky factorizations, and two tree sweeps for the
solve. The static level structure comes from the :class:`SymbolicChol` plan;
the index maps (``arrs``) are the tensors of
``SymbolicChol.device_arrs(device)``. The levels' fronts, and their
right-hand sides, live in one flat buffer each, so every sum of colliding
contributions (the assembly; per level, its extend-add and its forward-sweep
update into all its ancestors) is one sum in the order its ``sum_*`` plan
fixes: a factorization gives the same bits on every run. The other scatters
write each destination once.

Scaling convention: the caller assembles the Jacobi-scaled damped system
Hs = D (H + lam*diag(H)) D with unit diagonal via per-entry scale factors;
here we only add ``diag_add`` (damping remainder + jitter + frozen identity)
plus 1.0 on padding diagonals.

Failure contract: a front that is not positive definite factors to NaN (not
an exception), so the LM loop sees a non-finite trial cost, rejects the step
and grows the damping.
"""

from __future__ import annotations

import math

import torch

from rome_tpu_torch.utils.store import Store

# connectivity key -> (host symbolic plan, {device: index tensors}); the ND
# symbolic phase is the costly host step of a cold solve at 10k poses
_PLANS = Store("symbolic", 8, span="symbolic.build")


def cached_symbolic(key, build, device):
    """(plan, index tensors on ``device``) for the hashable connectivity
    ``key``; ``build()`` makes the :class:`SymbolicChol` plan on a miss. At
    most 8 plans are kept: a full store is cleared (``_PLANS``)."""
    sym, devs = _PLANS.get(key, lambda: (build(), {}))
    dkey = str(device)
    if dkey not in devs:
        devs[dkey] = sym.device_arrs(device)
    return sym, devs[dkey]


def ndchol_assemble(sym, arrs, vals, scale_vec, diag_add):
    """Build per-level front tensors from scaled entry contributions.

    vals: (E,) raw J^T J entry contributions (f32).
    scale_vec: (D,) per-scalar-dim scale (d * free) — entries are scaled by
      scale_vec[row]*scale_vec[col].
    diag_add: (D,) value added to each real diagonal front position.
    Returns list of (n_l, fmax_l, fmax_l) front tensors, views of one flat
    buffer (``arrs["front_offsets"]``).
    """
    sv = vals * scale_vec[arrs["rows"]] * scale_vec[arrs["cols"]]
    offs = arrs["front_offsets"]
    w = torch.zeros((offs[-1],), dtype=vals.dtype, device=vals.device)
    arrs["sum_asm"].add_(w, sv)
    # the padding and the real diagonals: each position once
    dummy = arrs["dummy_diag_all"]
    w.index_add_(0, dummy, torch.ones_like(dummy, dtype=vals.dtype))
    w.index_add_(0, arrs["real_diag_all"],
                 diag_add[arrs["real_diag_scalar_all"]].to(vals.dtype))
    return [w[offs[l]: offs[l + 1]].reshape(n_l, sm + bm, sm + bm)
            for l, (n_l, sm, bm) in enumerate(sym.plan)]


def _chol_or_nan(A):
    """Batched lower Cholesky; fronts that are not positive definite come
    back as all-NaN (``torch.linalg.cholesky`` would raise instead)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[:, None, None], math.nan, L)


def _tri_inv(L):
    """Batched inverse of lower-triangular (n, m, m) ``L``."""
    m = L.shape[-1]
    eye = torch.eye(m, dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _tri_inv_blocked(L):
    """Batched lower-triangular inverse by recursive 2x2-block Schur,

        [[A, 0], [B, C]]^-1 = [[A^-1, 0], [-C^-1 B A^-1, C^-1]],

    down to blocks of at most 32, which are inverted by substitution."""
    m = L.shape[-1]
    if m <= 32:
        return _tri_inv(L)
    h = m // 2
    Ai = _tri_inv_blocked(L[..., :h, :h])
    Ci = _tri_inv_blocked(L[..., h:, h:])
    X = -(Ci @ (L[..., h:, :h] @ Ai))
    top = torch.cat([Ai, L.new_zeros(L.shape[:-2] + (h, m - h))], dim=-1)
    return torch.cat([top, torch.cat([X, Ci], dim=-1)], dim=-2)


def _chol_blocked(A):
    """Batched Cholesky by recursive 2x2 blocking: small native factorizations
    of blocks of at most 32, everything else batched matmuls. A front that
    is not positive definite still comes back with NaNs."""
    m = A.shape[-1]
    if m <= 32:
        return _chol_or_nan(A)
    h = m // 2
    L11 = _chol_blocked(A[..., :h, :h])
    L21 = A[..., h:, :h] @ _tri_inv_blocked(L11).transpose(-1, -2)
    L22 = _chol_blocked(A[..., h:, h:] - L21 @ L21.transpose(-1, -2))
    top = torch.cat([L11, A.new_zeros(A.shape[:-2] + (h, m - h))], dim=-1)
    return torch.cat([top, torch.cat([L21, L22], dim=-1)], dim=-2)


def ndchol_factorize(sym, arrs, Ws, blocked=False):
    """Leaf-to-root batched partial Cholesky with fan-in Schur scatters.

    Per level: ONE batched Cholesky, ONE batched triangular inversion
    (L11^{-1} against identity), then L21, the Schur update and both solve
    sweeps are batched matmuls. The Schur updates are added into the
    ancestor fronts of a copy of ``Ws`` in one flat buffer (``Ws`` is left
    as it was), one fixed-order sum per level (``sum_ea_{l}``).
    ``blocked=True`` factors and inverts each level by recursive 2x2
    blocking (matmuls around small native factorizations) instead of one
    native call each; its extra float32 rounding makes a weaker
    preconditioner, so it is off by default.

    Returns (Linvs, L21s, L11s) lists per level."""
    offs = arrs["front_offsets"]
    flat = torch.cat([W.reshape(-1) for W in Ws])
    Linvs, L21s, L11s = [], [], []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        if n_l == 0:
            Linvs.append(None)
            L21s.append(None)
            L11s.append(None)
            continue
        W = flat[offs[l]: offs[l + 1]].reshape(n_l, sm + bm, sm + bm)
        if blocked:
            L11 = _chol_blocked(W[:, :sm, :sm])
            Linv = _tri_inv_blocked(L11)
        else:
            L11 = _chol_or_nan(W[:, :sm, :sm])
            Linv = _tri_inv(L11)
        L11s.append(L11)
        Linvs.append(Linv)
        if bm == 0:
            L21s.append(None)
            continue
        L21 = W[:, sm:, :sm] @ Linv.transpose(-1, -2)  # A21 L11^{-T}
        L21s.append(L21)
        U = W[:, sm:, sm:] - L21 @ L21.transpose(-1, -2)
        if f"sum_ea_{l}" in arrs:
            arrs[f"sum_ea_{l}"].add_(flat, U.reshape(-1))
    return Linvs, L21s, L11s


def ndchol_solve(sym, arrs, Linvs, L21s, b):
    """Two tree sweeps: solve (L L^T) x = b for the scaled system — batched
    matmuls and precomputed scatters/gathers, no triangular solves.

    b: (D,) in the factor dtype. Returns x: (D,)."""
    dt, dev = b.dtype, b.device
    offs = arrs["rhs_offsets"]
    R = torch.zeros((offs[-1],), dtype=dt, device=dev)  # every level's rhs
    R[arrs["rhs_dst_all"]] = b[arrs["rhs_src_all"]]
    # forward: L y = b (leaf-to-root)
    ys = []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        if n_l == 0 or sm == 0:
            ys.append(None)
            continue
        y = (Linvs[l] @ R[offs[l]: offs[l + 1]].reshape(n_l, sm, 1))[..., 0]
        ys.append(y)
        if bm == 0:
            continue
        uf = -(L21s[l] @ y[..., None])[..., 0].reshape(-1)  # (n_l*bm,)
        if f"sum_fea_{l}" in arrs:
            arrs[f"sum_fea_{l}"].add_(R, uf)
    # backward: L^T x = y (root-to-leaf); slot D is the dump row that the
    # padding entries of sup_idx write to (duplicate writes land only there)
    x = torch.zeros((sym.D + 1,), dtype=dt, device=dev)
    for l in range(sym.nlev - 1, -1, -1):
        n_l, sm, bm = sym.plan[l]
        if n_l == 0 or sm == 0:
            continue
        t = ys[l]
        if bm:
            xb = x[arrs[f"bnd_idx_{l}"]] * arrs[f"bnd_mask_{l}"].to(dt)
            t = t - (L21s[l].transpose(-1, -2) @ xb[..., None])[..., 0]
        xs = (Linvs[l].transpose(-1, -2) @ t[..., None])[..., 0]
        x[arrs[f"sup_idx_{l}"].reshape(-1)] = xs.reshape(-1)
    return x[: sym.D]


def ndchol_logdet(sym, L11s):
    """log det of the scaled damped system (sum of 2*log diag(L11), real
    columns only — padding diagonals are exactly 1)."""
    out = 0.0
    for L11 in L11s:
        if L11 is None:
            continue
        d = torch.diagonal(L11, dim1=-2, dim2=-1)
        out = out + 2.0 * torch.sum(torch.log(torch.clamp(d, min=1e-30)))
    return out


def ndchol_takahashi(sym, arrs, Linvs, L21s):
    """Selected inverse on the filled pattern (Takahashi), root-to-leaf.

    Returns per-level X_front tensors (n_l, fmax_l, fmax_l) holding
    [[X_SS, X_SB], [X_BS, X_BB]] of the SCALED system inverse (None for an
    empty level); callers un-scale marginal blocks with the Jacobi d vector.
    Level-batched: X_BB is gathered (``tak_bb_{l}``) from the ancestor
    fronts already computed, which live in one flat buffer."""
    sizes = [n * (sm + bm) * (sm + bm) for (n, sm, bm) in sym.plan]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    ref = next(L for L in Linvs if L is not None)
    xall = torch.zeros((offs[-1] + 1,), dtype=ref.dtype, device=ref.device)  # +1 dump slot
    Xs = [None] * sym.nlev
    for l in range(sym.nlev - 1, -1, -1):
        n_l, sm, bm = sym.plan[l]
        if n_l == 0:
            continue
        Linv = Linvs[l]
        A11inv = Linv.transpose(-1, -2) @ Linv  # inv(A11) = L11^-T L11^-1
        if bm:
            XBB = xall[arrs[f"tak_bb_{l}"]].reshape(n_l, bm, bm)
            W = L21s[l] @ Linv  # A21 A11^-1 (b, s)
            XBW = XBB @ W
            XSS = A11inv + W.transpose(-1, -2) @ XBW
            X = torch.cat([torch.cat([XSS, -XBW.transpose(-1, -2)], dim=2),
                           torch.cat([-XBW, XBB], dim=2)], dim=1)
        else:
            X = A11inv
        Xs[l] = X
        xall[offs[l]: offs[l + 1]] = X.reshape(-1)
    return Xs
