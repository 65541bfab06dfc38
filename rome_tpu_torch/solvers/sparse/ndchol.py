"""Numeric phase of the nested-dissection multifrontal Cholesky, in PyTorch
(counterpart of ``rome_tpu/solvers/sparse/ndchol.py``).

One scatter-add assembly into per-level padded front tensors, a leaf-to-root
sweep of batched dense partial Cholesky factorizations, and two tree sweeps
for the solve. The static level structure comes from the
:class:`SymbolicChol` plan; the index maps (``arrs``) are the tensors of
``SymbolicChol.device_arrs(device)``.

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

# connectivity key -> (host symbolic plan, {device: index tensors}); the ND
# symbolic phase is the costly host step of a cold solve at 10k poses
_PLANS: dict = {}
_PLANS_MAX = 8


def cached_symbolic(key, build, device):
    """(plan, index tensors on ``device``) for the hashable connectivity
    ``key``; ``build()`` makes the :class:`SymbolicChol` plan on a miss. At
    most ``_PLANS_MAX`` plans are kept: a full cache is cleared."""
    entry = _PLANS.get(key)
    if entry is None:
        if len(_PLANS) >= _PLANS_MAX:
            _PLANS.clear()
        entry = _PLANS[key] = (build(), {})
    sym, devs = entry
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
    Returns list of (n_l, fmax_l, fmax_l) front tensors.
    """
    sv = vals * scale_vec[arrs["rows"]] * scale_vec[arrs["cols"]]
    Ws = []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        f = sm + bm
        w = torch.zeros((n_l * f * f,), dtype=vals.dtype, device=vals.device)
        if n_l:
            w.index_add_(0, arrs[f"asm_dst_{l}"], sv[arrs[f"asm_src_{l}"]])
            dummy = arrs[f"dummy_diag_{l}"]
            w.index_add_(0, dummy, torch.ones_like(dummy, dtype=vals.dtype))
            w.index_add_(
                0, arrs[f"real_diag_{l}"],
                diag_add[arrs[f"real_diag_scalar_{l}"]].to(vals.dtype),
            )
        Ws.append(w.reshape(n_l, f, f))
    return Ws


def _chol_or_nan(A):
    """Batched lower Cholesky; fronts that are not positive definite come
    back as all-NaN (``torch.linalg.cholesky`` would raise instead)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[:, None, None], math.nan, L)


def ndchol_factorize(sym, arrs, Ws, blocked=False):
    """Leaf-to-root batched partial Cholesky with fan-in Schur scatters.

    Per level: ONE batched Cholesky, ONE batched triangular inversion
    (L11^{-1} against identity), then L21, the Schur update and both solve
    sweeps are batched matmuls. The Schur updates are added into the
    ancestor fronts of ``Ws`` in place.

    Returns (Linvs, L21s, L11s) lists per level."""
    if blocked:
        raise NotImplementedError(
            "ndchol_factorize(blocked=True) is not ported (ROADMAP slice B1)"
        )
    flat = [W.reshape(-1) for W in Ws]
    Linvs, L21s, L11s = [], [], []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        if n_l == 0:
            Linvs.append(None)
            L21s.append(None)
            L11s.append(None)
            continue
        W = flat[l].reshape(n_l, sm + bm, sm + bm)
        L11 = _chol_or_nan(W[:, :sm, :sm])
        eye = torch.eye(sm, dtype=W.dtype, device=W.device).expand(n_l, sm, sm)
        Linv = torch.linalg.solve_triangular(L11, eye, upper=False)
        L11s.append(L11)
        Linvs.append(Linv)
        if bm == 0:
            L21s.append(None)
            continue
        L21 = W[:, sm:, :sm] @ Linv.transpose(-1, -2)  # A21 L11^{-T}
        L21s.append(L21)
        U = W[:, sm:, sm:] - L21 @ L21.transpose(-1, -2)
        u = U.reshape(-1)
        for (ll, m) in sym.ea_pairs:
            if ll == l:
                flat[m].index_add_(
                    0, arrs[f"ea_dst_{l}_{m}"], u[arrs[f"ea_src_{l}_{m}"]]
                )
    return Linvs, L21s, L11s


def ndchol_solve(sym, arrs, Linvs, L21s, b):
    """Two tree sweeps: solve (L L^T) x = b for the scaled system — batched
    matmuls and precomputed scatters/gathers, no triangular solves.

    b: (D,) in the factor dtype. Returns x: (D,)."""
    dt, dev = b.dtype, b.device
    Rs = []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        r = torch.zeros((n_l * sm,), dtype=dt, device=dev)
        if n_l and sm:
            r[arrs[f"rhs_dst_{l}"]] = b[arrs[f"rhs_src_{l}"]]
        Rs.append(r)
    # forward: L y = b (leaf-to-root)
    ys = []
    for l, (n_l, sm, bm) in enumerate(sym.plan):
        if n_l == 0 or sm == 0:
            ys.append(None)
            continue
        y = (Linvs[l] @ Rs[l].reshape(n_l, sm, 1))[..., 0]
        ys.append(y)
        if bm == 0:
            continue
        uf = -(L21s[l] @ y[..., None])[..., 0].reshape(-1)  # (n_l*bm,)
        for (ll, m) in sym.fea_pairs:
            if ll == l:
                Rs[m].index_add_(
                    0, arrs[f"fea_dst_{l}_{m}"], uf[arrs[f"fea_src_{l}_{m}"]]
                )
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
