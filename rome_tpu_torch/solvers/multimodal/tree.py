"""Bayes tree — variable elimination, clique tree and tree-scheduled solves
(counterpart of ``rome_tpu/solvers/multimodal/tree.py``).

The tree is host metadata: an elimination order (approximate minimum
degree), the clique tree built from it, and the cliques a re-solve must
touch. Its construction is a copy of the JAX package's, held to it exactly
by the tests. The per-clique work (``approx_conv`` messages and Gibbs belief
products) runs on the batched engine's device kernels; cliques on the same
tree level are independent and dispatch together.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.utils.device import entry_device


# ----------------------- elimination ordering -------------------------------

def get_elimination_order(fg: FactorGraph, constraints=(), maxincidence: Optional[int] = None):
    """Approximate-minimum-degree elimination order over solvable variables.

    ``constraints`` lists variables forced to the END of the order (eliminated
    last, near the root). ``maxincidence`` guards against hub variables
    exploding fill-in (SolverParams.maxincidence)."""
    maxincidence = maxincidence or fg.params.maxincidence
    # adjacency between variables through shared factors
    adj: dict[str, set] = {}
    for flabel in fg._fct_order:
        f = fg.factors[flabel]
        if f.solvable <= 0:
            continue
        vs = [v for v in f.variables if fg.variables[v].solvable > 0]
        for v in vs:
            adj.setdefault(v, set()).update(u for u in vs if u != v)
    for v in fg._var_order:
        if fg.variables[v].solvable > 0:
            adj.setdefault(v, set())

    for v, n in adj.items():
        if len(n) > maxincidence:
            raise RuntimeError(
                f"variable {v} exceeds maxincidence={maxincidence} "
                f"({len(n)} neighbors)"
            )

    last = [v for v in constraints if v in adj]
    order = []
    work = {v: set(n) for v, n in adj.items() if v not in last}
    while work:
        # min-degree choice, insertion order as tiebreak
        v = min(work, key=lambda u: (len(work[u]), fg._var_order.index(u)))
        order.append(v)
        nbrs = work.pop(v)
        # connect the eliminated variable's neighbors (fill-in)
        for a in nbrs:
            if a in work:
                work[a].discard(v)
                work[a].update(b for b in nbrs if b != a and b in work)
    order.extend(last)
    return order


# ----------------------------- tree types -----------------------------------

@dataclass
class Clique:
    index: int
    frontals: list
    separator: list
    factors: list = field(default_factory=list)
    parent: Optional[int] = None
    children: list = field(default_factory=list)
    # content signature for recycling decisions
    signature: tuple = ()

    @property
    def variables(self):
        return list(self.frontals) + list(self.separator)

    def __repr__(self):
        return f"Clique({','.join(self.frontals)} | {','.join(self.separator)})"


@dataclass
class BayesTree:
    cliques: list                      # list[Clique], root is index 0
    order: list                        # elimination order used
    levels: list = field(default_factory=list)  # list[list[int]] root-first
    build_time: float = 0.0
    num_recycled: int = 0
    dirty: set = field(default_factory=set)  # clique indices re-solved

    @property
    def num_cliques(self):
        return len(self.cliques)

    def clique_of(self, var: str) -> Optional[Clique]:
        for c in self.cliques:
            if var in c.frontals:
                return c
        return None


def calc_cliques_recycled(tree: BayesTree):
    """calcCliquesRecycled analogue: (total, reused)."""
    return tree.num_cliques, tree.num_recycled


# --------------------------- tree construction ------------------------------

def build_tree_from_ordering(
    fg: FactorGraph, order=None, old_tree: Optional[BayesTree] = None
) -> BayesTree:
    """Symbolic elimination -> Bayes tree (buildTreeFromOrdering! analogue).

    Eliminating v creates a conditional p(v | S_v) with S_v = v's remaining
    neighbors after fill-in; v joins its parent clique when S_v matches the
    parent's frontal+separator scope, otherwise starts a new clique with
    separator S_v."""
    t0 = time.time()
    order = order or get_elimination_order(fg)
    pos = {v: i for i, v in enumerate(order)}

    # adjacency with fill-in gives each variable's separator
    adj: dict[str, set] = {v: set() for v in order}
    for flabel in fg._fct_order:
        f = fg.factors[flabel]
        if f.solvable <= 0:
            continue
        vs = [v for v in f.variables if v in pos]
        for v in vs:
            adj[v].update(u for u in vs if u != v)

    seps: dict[str, list] = {}
    work = {v: set(n) for v, n in adj.items()}
    for v in order:
        nbrs = {u for u in work[v] if pos[u] > pos[v]}
        seps[v] = sorted(nbrs, key=lambda u: pos[u])
        for a in nbrs:
            work[a].update(b for b in nbrs if b != a)
            work[a].discard(v)

    # group conditionals into cliques (maximal-clique supernodes)
    cliques: list[Clique] = []
    clique_of: dict[str, int] = {}
    for v in reversed(order):  # root side first
        S = seps[v]
        if not S:
            c = Clique(index=len(cliques), frontals=[v], separator=[])
            cliques.append(c)
            clique_of[v] = c.index
            continue
        # parent candidate: the clique of the earliest-eliminated separator
        # variable
        first = min(S, key=lambda u: pos[u])
        pidx = clique_of[first]
        parent = cliques[pidx]
        if set(S) == set(parent.frontals) | set(parent.separator) or (
            set(S) <= set(parent.frontals) | set(parent.separator)
            and len(parent.frontals) + len(S) <= len(parent.variables)
            and set(S) >= set(parent.separator)
        ):
            # absorb: v becomes a frontal of the parent clique
            parent.frontals.append(v)
            clique_of[v] = pidx
        else:
            c = Clique(index=len(cliques), frontals=[v], separator=list(S), parent=pidx)
            cliques.append(c)
            parent.children.append(c.index)
            clique_of[v] = c.index

    # assign factors to the clique where their first-eliminated variable lives
    for flabel in fg._fct_order:
        f = fg.factors[flabel]
        if f.solvable <= 0:
            continue
        vs = [v for v in f.variables if v in pos]
        if not vs:
            continue
        lead = min(vs, key=lambda u: pos[u])
        cliques[clique_of[lead]].factors.append(flabel)

    for c in cliques:
        c.signature = (
            tuple(sorted(c.frontals)),
            tuple(sorted(c.separator)),
            tuple(sorted(c.factors)),
        )

    # levels (root-first BFS over all roots)
    levels: list[list[int]] = []
    frontier = [c.index for c in cliques if c.parent is None]
    seen = set()
    while frontier:
        levels.append(frontier)
        seen.update(frontier)
        frontier = [k for i in frontier for k in cliques[i].children if k not in seen]

    tree = BayesTree(cliques=cliques, order=order, levels=levels,
                     build_time=time.time() - t0)
    if old_tree is not None:
        old_sigs = {c.signature for c in old_tree.cliques}
        tree.num_recycled = sum(1 for c in cliques if c.signature in old_sigs)
    return tree


# ------------------------------ tree solve ----------------------------------

def _dirty_cliques(tree: BayesTree, old_tree: Optional[BayesTree]):
    """Cliques that must be re-solved: every clique whose signature is not
    in the old tree, plus all its ancestors (upsolve messages flow rootward).
    Signature-matched cliques off the dirty path are recycled: skipped, their
    beliefs bit-identical."""
    if old_tree is None:
        tree.num_recycled = 0
        return {c.index for c in tree.cliques}
    old_sigs = {c.signature for c in old_tree.cliques}
    dirty: set = set()
    for c in tree.cliques:
        if c.signature not in old_sigs:
            i = c.index
            while i is not None and i not in dirty:
                dirty.add(i)
                i = tree.cliques[i].parent
    tree.num_recycled = tree.num_cliques - len(dirty)
    return dirty


def solve_tree(
    fg: FactorGraph,
    old_tree: Optional[BayesTree] = None,
    solve_key: str = "default",
    N: Optional[int] = None,
    seed: int = 1331,
    init: bool = True,
    downsolve: Optional[bool] = None,
    engine: str = "batched",
    device="cuda",
) -> BayesTree:
    """solveTree!(fg[, oldtree]) analogue: build the tree (recycling against
    the old one), then clique-scheduled nonparametric belief propagation on
    ``device`` — upsolve leaves to root, then downsolve root to leaves
    (SolverParams.downsolve) — and surface means as point estimates.

    engine="batched": each tree level is one masked sweep of the batched
    engine (the level's messages batched, its frontal variables' products in
    one call per type), upsolve messages restricted to each clique's
    subtree-assigned factors (SolverParams.useMsgLikelihoods). Recycled
    cliques are skipped, beliefs and points bit-identical.
    engine="loop": per-variable ``predict_belief`` (the reference-shaped
    cross-check). ``seed`` seeds the solve's ``torch.Generator``.
    """
    from rome_tpu_torch.solvers.multimodal.batched import set_points_from_beliefs
    from rome_tpu_torch.solvers.multimodal.solve import (
        init_all_beliefs,
        init_variable_belief,
        predict_belief,
    )

    if engine not in ("batched", "loop"):
        raise ValueError(f"unknown engine {engine!r}")
    entry_device(device)
    N = N or fg.params.N
    gen = torch.Generator(device=device).manual_seed(int(seed))
    downsolve = fg.params.downsolve if downsolve is None else downsolve
    tree = build_tree_from_ordering(fg, old_tree=old_tree)
    dirty = _dirty_cliques(tree, old_tree)
    tree.dirty = dirty
    if fg.params.showtree:
        print(format_tree(tree))
    if fg.params.drawtree:
        os.makedirs(fg.params.logpath, exist_ok=True)
        with open(os.path.join(fg.params.logpath, "bt.txt"), "w") as fh:
            fh.write(format_tree(tree))

    if init:
        init_all_beliefs(fg, solve_key, N=N, gen=gen, device=device)

    if engine == "batched":
        _solve_tree_batched(fg, tree, dirty, solve_key, N, gen, downsolve,
                            restrict_subtree=fg.params.useMsgLikelihoods, device=device)
        if fg.params.dbg:
            os.makedirs(fg.params.logpath, exist_ok=True)
            with open(os.path.join(fg.params.logpath, "solve_dbg.json"), "w") as fh:
                json.dump({
                    "num_cliques": tree.num_cliques,
                    "num_recycled": tree.num_recycled,
                    "dirty": sorted(dirty),
                    "levels": [list(l) for l in tree.levels],
                    "build_time": tree.build_time,
                }, fh)
        return tree

    def update_clique(cidx: int):
        for v in tree.cliques[cidx].frontals:
            rec = fg.variables[v]
            if rec.solvable <= 0 or rec.marginalized:
                continue
            pts = predict_belief(fg, v, solve_key=solve_key, gen=gen, N=N, device=device)
            if pts is not None:
                init_variable_belief(fg, v, pts, solve_key)

    # upsolve: deepest level first; same-level cliques are independent
    for level in reversed(tree.levels):
        for cidx in level:
            if cidx in dirty:
                update_clique(cidx)
    # downsolve: root outward
    if downsolve:
        for level in tree.levels:
            for cidx in level:
                if cidx in dirty:
                    update_clique(cidx)

    set_points_from_beliefs(fg, [
        l for l, rec in fg.variables.items()
        if solve_key in rec.beliefs and rec.solvable > 0 and not rec.marginalized
    ], solve_key, device)
    return tree


def format_tree(tree: BayesTree) -> str:
    """ASCII rendering of the Bayes tree (drawTree/showTree analogue)."""
    lines = [
        f"BayesTree: {tree.num_cliques} cliques, "
        f"{len(tree.levels)} levels, {tree.num_recycled} recycled"
    ]

    def walk(ci, depth):
        c = tree.cliques[ci]
        mark = "*" if ci in tree.dirty else " "
        lines.append(
            "  " * depth
            + f"{mark}[{ci}] {','.join(c.frontals)} | {','.join(c.separator)}"
            + (f"  ({len(c.factors)} fct)" if c.factors else "")
        )
        for ch in c.children:
            walk(ch, depth + 1)

    for c in tree.cliques:
        if c.parent is None:
            walk(c.index, 1)
    return "\n".join(lines)


drawTree = format_tree


def _solve_tree_batched(fg, tree, dirty, solve_key, N, gen, downsolve,
                        restrict_subtree=True, device="cuda"):
    """Level-batched tree schedule over the batched engine's sweep."""
    from rome_tpu_torch.solvers.multimodal.batched import BatchedNonparametricSolver

    solver = BatchedNonparametricSolver(fg, solve_key, N=N, device=device)
    ga, bp = solver.ga, solver.bp
    beliefs = solver.gather_beliefs()

    subtree_facts: dict[int, set] = {}

    def facts_of_subtree(ci):
        if ci not in subtree_facts:
            c = tree.cliques[ci]
            s = set(c.factors)
            for ch in c.children:
                s |= facts_of_subtree(ch)
            subtree_facts[ci] = s
        return subtree_facts[ci]

    var_slot = {lbl: (t, s) for t in ga.type_names for s, lbl in enumerate(ga.var_labels[t])}
    touched = {t: [] for t in ga.type_names}

    def level_masks(cliques_sel, restrict_subtree):
        var_masks = {t: np.zeros(ga.counts[t]) for t in ga.type_names}
        fill = np.zeros if restrict_subtree else np.ones
        msg_masks = {t: fill((ga.counts[t], bp.kmax[t])) for t in ga.type_names}
        for ci in cliques_sel:
            c = tree.cliques[ci]
            allowed = facts_of_subtree(ci) if restrict_subtree else None
            for v in c.frontals:
                if v not in var_slot:
                    continue
                rec = fg.variables[v]
                if rec.solvable <= 0 or rec.marginalized:
                    continue
                t, s = var_slot[v]
                var_masks[t][s] = 1.0
                touched[t].append(s)
                if restrict_subtree:
                    for k, fl in enumerate(bp.msg_factor[t][s]):
                        if fl and fl in allowed:
                            msg_masks[t][s, k] = 1.0
        return var_masks, msg_masks

    # upsolve: deepest level first, messages restricted to subtree factors;
    # downsolve: root outward, full message sets
    schedule = [(level, restrict_subtree) for level in reversed(tree.levels)]
    if downsolve:
        schedule += [(level, False) for level in tree.levels]
    for level, restrict in schedule:
        sel = [ci for ci in level if ci in dirty]
        if sel:
            vm, mm = level_masks(sel, restrict)
            beliefs = solver.sweep(beliefs, gen, vm, mm)

    # points only for the variables the schedule updated: recycled cliques
    # keep beliefs AND point estimates bit-identical
    solver.write_back(beliefs, slots={t: sorted(set(s)) for t, s in touched.items()})


# reference-style aliases
getEliminationOrder = get_elimination_order
buildTreeFromOrdering = build_tree_from_ordering
solveTree = solve_tree
calcCliquesRecycled = calc_cliques_recycled
