"""Host-side symbolic phase of the nested-dissection multifrontal Cholesky.

A copy of ``rome_tpu/solvers/sparse/symbolic.py`` (held to it by
tests/test_torch_ndchol.py). What differs: ``SymbolicChol.device_arrs``
returns torch tensors and, beside the index maps, the flat-buffer maps and
the fixed-order plans of the port's numeric phase
(``ops/segment_sum.SegmentPlan``), whose ties follow
``SymbolicChol.entry_key`` (made by :func:`entry_keys`) where it is set.

One-time per graph structure (numpy only): build the variable
adjacency from the lowered factor batches, compute a nested-dissection
supernode tree (BFS vertex separators), and emit every index map the device
numeric phase needs so that the *entire* numeric factorization+solve is
gathers, scatter-adds, and level-batched dense kernels with static shapes.

Design notes (TPU-first, not a translation of any CPU sparse solver):

- The elimination tree is the ND separator tree itself: each tree node's
  supernode = its separator (leaves = whole leaf regions, densified). Depth
  is O(log n), so the numeric phase is ~log(n) batched stages instead of the
  O(n) sequential column eliminations of a CPU up-looking solver.
- Fan-in formulation: every assembled entry and every Schur-update entry is
  scattered DIRECTLY to the front of the supernode that eliminates it (the
  earlier-eliminated endpoint), not relayed through intermediate parents.
  This is algebraically identical to classic extend-add (update entries pass
  through ancestors unchanged, accumulating) and turns all data movement
  into precomputed flat scatter-adds.
- Fronts at one tree level are padded to a common (smax, fmax) and batched;
  padding columns carry an identity diagonal so the batched Cholesky /
  triangular solves need no masking.

Reference contract: the Bayes-tree elimination that the reference's
solveTree! builds per solve (RoME.jl, src/legacy/Slam.jl:261;
SURVEY.md §3.4 / §7) — the ND separator tree plays the role of the Bayes
tree, with cliques batched per level.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# graph extraction
# ---------------------------------------------------------------------------

def _var_tables(type_names, counts, dofs):
    """Global variable ids in tangent_offsets order; scalar layout."""
    n_vars = sum(counts[t] for t in type_names)
    var_dof = np.zeros(n_vars, np.int32)
    var_base = np.zeros(n_vars, np.int64)  # scalar offset of each var
    off = 0
    vid = 0
    vid_base = {}
    for t in type_names:
        vid_base[t] = vid
        for _ in range(counts[t]):
            var_dof[vid] = dofs[t]
            var_base[vid] = off
            off += dofs[t]
            vid += 1
    return n_vars, int(off), var_dof, var_base, vid_base


def _adjacency_csr(n_vars, cliques):
    """CSR adjacency from an iterable of (var-id arrays) cliques."""
    rows, cols = [], []
    for cl in cliques:
        k = cl.shape[1]
        if k < 2:
            continue
        for a in range(k):
            for b in range(k):
                if a != b:
                    rows.append(cl[:, a])
                    cols.append(cl[:, b])
    if rows:
        r = np.concatenate(rows)
        c = np.concatenate(cols)
    else:
        r = np.zeros(0, np.int64)
        c = np.zeros(0, np.int64)
    import scipy.sparse as sp

    adj = sp.coo_matrix(
        (np.ones(len(r), np.int8), (r, c)), shape=(n_vars, n_vars)
    ).tocsr()
    adj.data[:] = 1
    return adj


# ---------------------------------------------------------------------------
# nested dissection
# ---------------------------------------------------------------------------

class _Dissector:
    def __init__(self, indptr, indices, n_vars, leaf):
        self.indptr = indptr
        self.indices = indices
        self.leaf = leaf
        self.mark = np.full(n_vars, -1, np.int64)  # membership token
        self.token = 0
        self.nodes = []  # dicts: svars (np array), children (node ids)

    def _new_token(self, sub):
        self.token += 1
        self.mark[sub] = self.token
        return self.token

    def _bfs(self, sub, start, tok):
        """BFS levels within the membership `tok`. Returns (order, lev)."""
        lev = {start: 0}
        order = [start]
        head = 0
        indptr, indices, mark = self.indptr, self.indices, self.mark
        while head < len(order):
            v = order[head]
            head += 1
            lv = lev[v]
            for u in indices[indptr[v] : indptr[v + 1]]:
                if mark[u] == tok and u not in lev:
                    lev[u] = lv + 1
                    order.append(u)
        return order, lev

    def _components(self, sub, tok):
        seen = set()
        comps = []
        for s in sub:
            if s in seen:
                continue
            order, _ = self._bfs(sub, s, tok)
            seen.update(order)
            comps.append(np.array(order, dtype=sub.dtype))
        return comps

    def _fallback_split(self, sub, tok):
        """Index-halves split with an explicit vertex separator."""
        half = len(sub) // 2
        a0 = set(sub[:half].tolist())
        b0 = set(sub[half:].tolist())
        indptr, indices, mark = self.indptr, self.indices, self.mark
        S = []
        for v in sub[:half]:
            for u in indices[indptr[v] : indptr[v + 1]]:
                if mark[u] == tok and u in b0:
                    S.append(v)
                    break
        Sset = set(S)
        A = np.array([v for v in sub[:half] if v not in Sset], dtype=sub.dtype)
        B = sub[half:]
        return np.array(S, dtype=sub.dtype), A, B

    def dissect(self, sub):
        """Returns list of root node ids (a forest when disconnected)."""
        if len(sub) <= self.leaf:
            self.nodes.append({"svars": np.sort(sub), "children": []})
            return [len(self.nodes) - 1]
        tok = self._new_token(sub)
        comps = self._components(sub, tok)
        if len(comps) > 1:
            out = []
            for c in comps:
                out.extend(self.dissect(c))
            return out
        # pseudo-peripheral start, BFS level-set vertex separator
        order, lev = self._bfs(sub, int(sub[0]), tok)
        far = order[-1]
        order, lev = self._bfs(sub, far, tok)
        nlev = lev[order[-1]] + 1
        S = A = B = None
        if nlev >= 3:
            lev_arr = np.array([lev[v] for v in order])
            order_arr = np.array(order, dtype=sub.dtype)
            counts = np.bincount(lev_arr, minlength=nlev)
            cum = np.cumsum(counts)
            n = len(sub)
            best = None
            for c in range(1, nlev - 1):
                na = cum[c - 1]
                nb = n - cum[c]
                if min(na, nb) >= 0.25 * (na + nb) and (
                    best is None or counts[c] < best[0]
                ):
                    best = (counts[c], c)
            if best is None:
                # closest-to-median cut
                c = int(np.searchsorted(cum, n // 2))
                c = min(max(c, 1), nlev - 2)
                best = (counts[c], c)
            c = best[1]
            S = order_arr[lev_arr == c]
            A = order_arr[lev_arr < c]
            B = order_arr[lev_arr > c]
        if S is None or len(A) == 0 or len(B) == 0:
            S, A, B = self._fallback_split(sub, tok)
        if len(S) >= len(sub) or (len(A) == 0 and len(B) == 0):
            # degenerate (near-clique): densify as one supernode leaf
            self.nodes.append({"svars": np.sort(sub), "children": []})
            return [len(self.nodes) - 1]
        children = []
        if len(A):
            children.extend(self.dissect(A))
        if len(B):
            children.extend(self.dissect(B))
        self.nodes.append({"svars": np.sort(S), "children": children})
        return [len(self.nodes) - 1]


# ---------------------------------------------------------------------------
# symbolic factorization container
# ---------------------------------------------------------------------------

@dataclass
class SymbolicChol:
    """Everything the device numeric phase needs.

    ``plan`` is the static level structure; ``arrs`` is a flat dict of numpy
    index arrays that :meth:`device_arrs` moves onto the device."""

    D: int                      # total scalar tangent dims
    E: int                      # number of assembled entry contributions
    nlev: int
    plan: tuple                 # ((n_l, smax_l, bmax_l), ...) per level
    ea_pairs: tuple             # ((l, m), ...) Schur-update scatter routes
    fea_pairs: tuple            # ((l, m), ...) forward-solve scatter routes
    arrs: dict = field(repr=False)
    stats: dict = field(default_factory=dict)
    # per assembled entry, the structural key that orders the contributions
    # of one front position (``entry_keys``); None: the entry order
    entry_key: Optional[np.ndarray] = field(default=None, repr=False)

    def device_arrs(self, device="cpu"):
        """The index maps as torch tensors on ``device``: integer maps as
        int64 (torch's index dtype), masks as float32. Besides them, what
        the port's numeric phase reads: the levels' fronts and right-hand
        sides each live in one flat buffer (``front_offsets``,
        ``rhs_offsets``: per level, its start), the assembly's and the
        right-hand side's maps address those buffers (``rhs_dst_all``,
        ``rhs_src_all``, ``dummy_diag_all``, ``real_diag_all``,
        ``real_diag_scalar_all``), and every sum of colliding contributions
        has a fixed-order plan (``ops/segment_sum.SegmentPlan``): the
        assembly (``sum_asm``), per level its extend-add into every ancestor
        (``sum_ea_{l}``) and its forward-sweep update (``sum_fea_{l}``),
        and the diagonal of H (``sum_diag``)."""
        import torch

        from rome_tpu_torch.ops.segment_sum import SegmentPlan

        out = {
            k: torch.as_tensor(
                v.astype(np.int64) if v.dtype.kind in "iu" else v, device=device
            )
            for k, v in self.arrs.items()
        }
        a = self.arrs
        fo = np.cumsum([0] + [n * (sm + bm) ** 2 for n, sm, bm in self.plan])
        ro = np.cumsum([0] + [n * sm for n, sm, _bm in self.plan])
        out["front_offsets"], out["rhs_offsets"] = fo.tolist(), ro.tolist()
        levels = range(self.nlev)

        def cat(fmt, offs=None):
            parts = [a[fmt.format(l=l)].astype(np.int64) + (0 if offs is None else offs[l])
                     for l in levels]
            return np.concatenate(parts) if parts else np.zeros(0, np.int64)

        def index(arr):
            return torch.as_tensor(arr, device=device)

        out["rhs_dst_all"], out["rhs_src_all"] = index(cat("rhs_dst_{l}", ro)), index(
            cat("rhs_src_{l}"))
        out["dummy_diag_all"] = index(cat("dummy_diag_{l}", fo))
        out["real_diag_all"] = index(cat("real_diag_{l}", fo))
        out["real_diag_scalar_all"] = index(cat("real_diag_scalar_{l}"))

        def keys(src):
            return () if self.entry_key is None else (self.entry_key[src],)

        src = cat("asm_src_{l}")
        out["sum_asm"] = SegmentPlan(cat("asm_dst_{l}", fo), src, keys(src), device)
        for kind, pairs, offs in (("ea", self.ea_pairs, fo), ("fea", self.fea_pairs, ro)):
            for l in levels:
                ms = [m for ll, m in pairs if ll == l]
                if ms:
                    out[f"sum_{kind}_{l}"] = SegmentPlan(
                        np.concatenate([a[f"{kind}_dst_{l}_{m}"] + offs[m] for m in ms]),
                        np.concatenate([a[f"{kind}_src_{l}_{m}"] for m in ms]), device=device)
        out["sum_diag"] = SegmentPlan(a["diag_dst"], a["diag_src"], keys(a["diag_src"]),
                                      device)
        return out


def entry_coords(type_names, counts, dofs, batch_specs):
    """Global (row, col) scalar coordinates of every normal-equation entry
    contribution, in EXACTLY the order `normal_eq_entry_values` (and
    dense_normal_eqs) emits values: per batch, per (k, l) slot pair, the
    (n, dk, dl) block reshaped row-major.

    ``batch_specs``: list of (vtypes tuple, vslots (n, arity) numpy array).
    """
    base, off = {}, 0
    for t in type_names:
        base[t] = off
        off += counts[t] * dofs[t]
    rows_all, cols_all = [], []
    for vtypes, vslots in batch_specs:
        n = vslots.shape[0]
        offs = []
        for k, t in enumerate(vtypes):
            d = dofs[t]
            o = base[t] + vslots[:, k].astype(np.int64) * d
            offs.append(o[:, None] + np.arange(d)[None, :])  # (n, d)
        for k in range(len(vtypes)):
            dk = offs[k].shape[1]
            for l in range(len(vtypes)):
                dl = offs[l].shape[1]
                rows_all.append(
                    np.broadcast_to(offs[k][:, :, None], (n, dk, dl)).reshape(-1)
                )
                cols_all.append(
                    np.broadcast_to(offs[l][:, None, :], (n, dk, dl)).reshape(-1)
                )
    if rows_all:
        return np.concatenate(rows_all), np.concatenate(cols_all)
    return np.zeros(0, np.int64), np.zeros(0, np.int64)


def entry_keys(dofs, batch_specs):
    """Per normal-equation entry (in ``entry_coords``' order), its batch and
    its factor's variable slots (padded with -1): the key that orders the
    contributions of one front position by the graph's structure rather
    than by the batches' row order. Port-only; arguments as in
    :func:`entry_coords`."""
    width = max((vs.shape[1] for _vt, vs in batch_specs), default=0)
    out = []
    for i, (vtypes, vslots) in enumerate(batch_specs):
        n, arity = vslots.shape
        row = np.full((n, 1 + width), -1, dtype=np.int64)
        row[:, 0] = i
        row[:, 1: 1 + arity] = vslots
        for tk in vtypes:
            for tl in vtypes:
                # the (n, dk, dl) block of this slot pair, row-major
                out.append(np.repeat(row, dofs[tk] * dofs[tl], axis=0))
    return np.concatenate(out) if out else np.zeros((0, 1 + width), np.int64)


def symbolic_factor(
    type_names,
    counts,
    dofs,
    batch_specs,
    leaf: int = 16,
) -> SymbolicChol:
    """Full symbolic analysis. ``batch_specs`` as in :func:`entry_coords`."""
    n_vars, D, var_dof, var_base, vid_base = _var_tables(
        type_names, counts, dofs
    )
    # factor cliques as var-id arrays (n, arity)
    cliques = []
    for vtypes, vslots in batch_specs:
        cl = np.stack(
            [
                vid_base[t] + vslots[:, k].astype(np.int64)
                for k, t in enumerate(vtypes)
            ],
            axis=1,
        )
        cliques.append(cl)
    adj = _adjacency_csr(n_vars, cliques)

    dis = _Dissector(adj.indptr, adj.indices, n_vars, leaf)
    all_vars = np.arange(n_vars, dtype=np.int64)
    # vars with no edges at all still need fronts (priors-only / frozen)
    roots = dis.dissect(all_vars)
    nodes = dis.nodes
    n_nodes = len(nodes)

    # heights (levels): leaves 0, parent = 1 + max(children)
    height = np.zeros(n_nodes, np.int64)
    for j, nd in enumerate(nodes):  # children always created before parents
        if nd["children"]:
            height[j] = 1 + max(height[c] for c in nd["children"])
    # post-order eranks (children before parents; roots in order)
    erank = np.full(n_vars, -1, np.int64)
    sup_of_var = np.full(n_vars, -1, np.int64)
    ctr = 0
    stack = [(r, False) for r in reversed(roots)]
    post = []
    while stack:
        j, done = stack.pop()
        if done:
            post.append(j)
            for v in nodes[j]["svars"]:
                erank[v] = ctr
                ctr += 1
                sup_of_var[v] = j
        else:
            stack.append((j, True))
            for c in reversed(nodes[j]["children"]):
                stack.append((c, False))
    assert ctr == n_vars, (ctr, n_vars)

    # reach (boundary) sets, post-order
    reach = [None] * n_nodes
    subvars = [None] * n_nodes
    indptr, indices = adj.indptr, adj.indices
    for j in post:
        nd = nodes[j]
        sv = set(int(v) for v in nd["svars"])
        r = set()
        for c in nd["children"]:
            r |= reach[c]
            sv |= subvars[c]
        for v in nd["svars"]:
            r.update(int(u) for u in indices[indptr[v] : indptr[v + 1]])
        r -= sv
        reach[j] = r
        subvars[j] = sv

    # front layouts (scalar granularity), level grouping
    nlev = int(height.max()) + 1
    lev_nodes = [np.where(height == l)[0] for l in range(nlev)]
    node_local = np.zeros(n_nodes, np.int64)
    lev_of_node = height
    for l in range(nlev):
        node_local[lev_nodes[l]] = np.arange(len(lev_nodes[l]))

    def scalars_of(vs):
        return np.concatenate(
            [np.arange(var_base[v], var_base[v] + var_dof[v]) for v in vs]
        ) if len(vs) else np.zeros(0, np.int64)

    sup_scal = [None] * n_nodes  # supernode scalar list (erank order)
    bnd_scal = [None] * n_nodes  # boundary scalar list (erank-sorted)
    for j in range(n_nodes):
        sv = sorted(nodes[j]["svars"], key=lambda v: erank[v])
        bv = sorted(reach[j], key=lambda v: erank[v])
        sup_scal[j] = scalars_of(sv)
        bnd_scal[j] = scalars_of(bv)

    smax = [
        max((len(sup_scal[j]) for j in lev_nodes[l]), default=0)
        for l in range(nlev)
    ]
    bmax = [
        max((len(bnd_scal[j]) for j in lev_nodes[l]), default=0)
        for l in range(nlev)
    ]
    fmax = [smax[l] + bmax[l] for l in range(nlev)]
    plan = tuple(
        (len(lev_nodes[l]), smax[l], bmax[l]) for l in range(nlev)
    )

    # POS[j, s]: local front column of scalar s in front j (-1 absent).
    # Layout: [sup (s_j) | pad to smax | bnd (b_j) | pad to fmax].
    POS = np.full((n_nodes, D), -1, np.int32)
    sup_pos = np.full(D, -1, np.int64)   # offset within own supernode
    sup_node_of_scal = np.full(D, -1, np.int64)
    for j in range(n_nodes):
        l = lev_of_node[j]
        ss, bs = sup_scal[j], bnd_scal[j]
        POS[j, ss] = np.arange(len(ss), dtype=np.int32)
        POS[j, bs] = (smax[l] + np.arange(len(bs))).astype(np.int32)
        sup_pos[ss] = np.arange(len(ss))
        sup_node_of_scal[ss] = j

    var_of_scal = np.repeat(np.arange(n_vars, dtype=np.int64), var_dof)
    erank_of_scal = erank[var_of_scal]

    arrs: dict = {}

    # ---- assembly maps -----------------------------------------------------
    rows, cols = entry_coords(type_names, counts, dofs, batch_specs)
    E = len(rows)
    arrs["rows"] = rows.astype(np.int32)
    arrs["cols"] = cols.astype(np.int32)
    dmask = rows == cols
    arrs["diag_src"] = np.where(dmask)[0].astype(np.int32)
    arrs["diag_dst"] = rows[dmask].astype(np.int32)

    first = np.where(erank_of_scal[rows] <= erank_of_scal[cols], rows, cols)
    dest = sup_node_of_scal[first]
    lr = POS[dest, rows]
    lc = POS[dest, cols]
    assert (lr >= 0).all() and (lc >= 0).all(), "assembly entry outside front"
    dlev = lev_of_node[dest]
    for l in range(nlev):
        sel = np.where(dlev == l)[0]
        f = fmax[l]
        arrs[f"asm_src_{l}"] = sel.astype(np.int32)
        arrs[f"asm_dst_{l}"] = (
            node_local[dest[sel]] * (f * f)
            + lr[sel].astype(np.int64) * f
            + lc[sel]
        ).astype(np.int32)

    # real diagonal front positions (one per scalar, in its own supernode)
    own = sup_node_of_scal
    dlev_s = lev_of_node[own]
    for l in range(nlev):
        sel = np.where(dlev_s == l)[0]
        f = fmax[l]
        p = sup_pos[sel]
        arrs[f"real_diag_{l}"] = (
            node_local[own[sel]] * (f * f) + p * f + p
        ).astype(np.int32)
        arrs[f"real_diag_scalar_{l}"] = sel.astype(np.int32)
        # rhs scatter: scalar -> (node, sup offset) in the level's R buffer
        arrs[f"rhs_src_{l}"] = sel.astype(np.int32)
        arrs[f"rhs_dst_{l}"] = (
            node_local[own[sel]] * smax[l] + p
        ).astype(np.int32)

    # dummy (padding) diagonal positions
    for l in range(nlev):
        f = fmax[l]
        pos = []
        for j in lev_nodes[l]:
            s_j, b_j = len(sup_scal[j]), len(bnd_scal[j])
            dummies = np.concatenate(
                [np.arange(s_j, smax[l]), np.arange(smax[l] + b_j, f)]
            )
            pos.append(node_local[j] * (f * f) + dummies * f + dummies)
        arrs[f"dummy_diag_{l}"] = (
            np.concatenate(pos).astype(np.int32) if pos else
            np.zeros(0, np.int32)
        )

    # ---- Schur-update (fan-in extend-add) + forward-solve maps ------------
    ea: dict = {}
    fea: dict = {}
    for l in range(nlev):
        bm = bmax[l]
        if bm == 0:
            continue
        for j in lev_nodes[l]:
            bs = bnd_scal[j]
            b_j = len(bs)
            if b_j == 0:
                continue
            nl = node_local[j]
            # matrix update entries (p, q) over boundary x boundary
            P, Q = np.meshgrid(np.arange(b_j), np.arange(b_j), indexing="ij")
            P, Q = P.reshape(-1), Q.reshape(-1)
            r, c = bs[P], bs[Q]
            first = np.where(erank_of_scal[r] <= erank_of_scal[c], r, c)
            dn = sup_node_of_scal[first]
            m_arr = lev_of_node[dn]
            lr = POS[dn, r].astype(np.int64)
            lc = POS[dn, c].astype(np.int64)
            assert (lr >= 0).all() and (lc >= 0).all()
            src = nl * (bm * bm) + P.astype(np.int64) * bm + Q
            for m in np.unique(m_arr):
                sel = m_arr == m
                f = fmax[m]
                key = (l, int(m))
                dd = (
                    node_local[dn[sel]] * (f * f) + lr[sel] * f + lc[sel]
                )
                ea.setdefault(key, ([], []))
                ea[key][0].append(src[sel])
                ea[key][1].append(dd)
            # rhs update entries (p,) -> scalar's own supernode R slot
            dn1 = sup_node_of_scal[bs]
            m1 = lev_of_node[dn1]
            src1 = nl * bm + np.arange(b_j, dtype=np.int64)
            for m in np.unique(m1):
                sel = m1 == m
                key = (l, int(m))
                dd = node_local[dn1[sel]] * smax[m] + sup_pos[bs[sel]]
                fea.setdefault(key, ([], []))
                fea[key][0].append(src1[sel])
                fea[key][1].append(dd)

    ea_pairs = tuple(sorted(ea.keys()))
    fea_pairs = tuple(sorted(fea.keys()))
    for (l, m), (s, d) in ea.items():
        arrs[f"ea_src_{l}_{m}"] = np.concatenate(s).astype(np.int32)
        arrs[f"ea_dst_{l}_{m}"] = np.concatenate(d).astype(np.int32)
    for (l, m), (s, d) in fea.items():
        arrs[f"fea_src_{l}_{m}"] = np.concatenate(s).astype(np.int32)
        arrs[f"fea_dst_{l}_{m}"] = np.concatenate(d).astype(np.int32)

    # ---- backward-solve gathers -------------------------------------------
    for l in range(nlev):
        n_l, sm, bm = plan[l]
        bnd_idx = np.zeros((n_l, bm), np.int32)
        bnd_mask = np.zeros((n_l, bm), np.float32)
        sup_idx = np.full((n_l, sm), D, np.int32)  # sentinel: dump row
        for j in lev_nodes[l]:
            nl = node_local[j]
            bs, ss = bnd_scal[j], sup_scal[j]
            bnd_idx[nl, : len(bs)] = bs
            bnd_mask[nl, : len(bs)] = 1.0
            sup_idx[nl, : len(ss)] = ss
        arrs[f"bnd_idx_{l}"] = bnd_idx
        arrs[f"bnd_mask_{l}"] = bnd_mask
        arrs[f"sup_idx_{l}"] = sup_idx

    # ---- Takahashi (selected-inverse) boundary gathers --------------------
    # for each node: flat index into the concatenated all-level X storage of
    # the inverse entry for each (boundary, boundary) pair; padding points at
    # the trailing dump slot.
    xoffs = [0]
    for (n_l, sm, bm) in plan:
        xoffs.append(xoffs[-1] + n_l * (sm + bm) * (sm + bm))
    dump = xoffs[-1]
    for l in range(nlev):
        n_l, sm, bm = plan[l]
        if bm == 0:
            arrs[f"tak_bb_{l}"] = np.zeros(0, np.int32)
            continue
        tak = np.full((n_l, bm, bm), dump, np.int64)
        for j in lev_nodes[l]:
            bs = bnd_scal[j]
            b_j = len(bs)
            if b_j == 0:
                continue
            P, Q = np.meshgrid(np.arange(b_j), np.arange(b_j), indexing="ij")
            r, c = bs[P.reshape(-1)], bs[Q.reshape(-1)]
            first = np.where(erank_of_scal[r] <= erank_of_scal[c], r, c)
            dn = sup_node_of_scal[first]
            m_arr = lev_of_node[dn]
            fm = np.array([fmax[m] for m in m_arr])
            lr = POS[dn, r].astype(np.int64)
            lc = POS[dn, c].astype(np.int64)
            flat = (
                np.array([xoffs[m] for m in m_arr])
                + node_local[dn] * fm * fm
                + lr * fm
                + lc
            )
            tak[node_local[j], P.reshape(-1), Q.reshape(-1)] = flat
        arrs[f"tak_bb_{l}"] = tak.reshape(-1).astype(np.int32)

    front_nnz = sum(p[0] * (p[1] + p[2]) ** 2 for p in plan)
    # flat front indices (tak_bb_*, asm_dst_*, ea_dst_*) are int32; past
    # 2^31 padded entries they would wrap and silently corrupt the
    # factorization — fail loudly instead (int64 index support would need
    # a wider gather path, not just a dtype change)
    if front_nnz >= 2**31:
        raise OverflowError(
            f"symbolic_factor: {front_nnz} padded front entries exceed "
            "int32 index range; reduce problem size or raise nd_leaf"
        )
    stats = {
        "n_vars": n_vars,
        "n_nodes": n_nodes,
        "nlev": nlev,
        "plan": plan,
        "padded_front_entries": int(front_nnz),
        "true_front_entries": int(
            sum((len(sup_scal[j]) + len(bnd_scal[j])) ** 2 for j in range(n_nodes))
        ),
        "max_front": int(max((p[1] + p[2]) for p in plan)),
        "n_entries": int(E),
        "n_update_entries": int(
            sum(len(arrs[f"ea_src_{l}_{m}"]) for (l, m) in ea_pairs)
        ),
    }
    return SymbolicChol(
        D=D, E=E, nlev=nlev, plan=plan, ea_pairs=ea_pairs,
        fea_pairs=fea_pairs, arrs=arrs, stats=stats,
    )
