"""Lower a FactorGraph to dense structure-of-arrays batches for the solvers
(counterpart of ``rome_tpu/graph/lower.py``).

Factors group by type into dense batches (params stacked, variable slots as
int64 index tensors); variables group by type into dense point tensors. All
tensors of a :class:`GraphArrays` live on its ``device``.

The connectivity of a lowered graph, its variable counts and every batch's
variable slots, is a hashable key made from the host slots before they go
to the device (``FactorBatch.key``, ``GraphArrays.key``): every store of
per-connectivity plans and programs is keyed by it, and every plan that
needs the slots on the host reads them from it (:func:`slots_of`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from rome_tpu_torch.factors.base import FactorType
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.utils.device import entry_device


@dataclass
class FactorBatch:
    ftype: FactorType
    n: int
    vtypes: tuple            # type name per variable slot
    vslots: object           # (n, arity) — slot within the type array
    params: dict             # str -> (n, ...) arrays
    weight: object           # (n,) float — 0/1 solvable mask
    labels: list = field(default_factory=list)
    # nonparametric-path metadata (add_factor kwargs)
    nullhypo: object = None  # (n,) float eta per factor
    inflation: object = None  # (n,) float init-noise scale per factor
    # batch_key of vslots: set by to_device, else by whoever builds the batch
    key: tuple = None


def batch_key(ftype_name: str, vtypes, vslots) -> tuple:
    """A batch's connectivity key: its factor type's name, its variable
    types and the bytes of its (n, arity) host slots as int64."""
    return (ftype_name, tuple(vtypes), np.ascontiguousarray(vslots, np.int64).tobytes())


def slots_of(key: tuple) -> np.ndarray:
    """The (n, arity) int64 host slots a :func:`batch_key` holds (read-only)."""
    return np.frombuffer(key[2], np.int64).reshape(-1, len(key[1]))


@dataclass
class GraphArrays:
    type_names: list                 # ordered variable types present
    manifolds: dict                  # type name -> Manifold
    counts: dict                     # type name -> n
    values0: dict                    # type name -> (n, point_dim)
    free: dict                       # type name -> (n,) float, 1 = optimize
    batches: list                    # list[FactorBatch]
    var_labels: dict                 # type name -> list of labels by slot
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")
    # factor labels NOT lowered into batches (multihypo-extended factors),
    # for the nonparametric engine's per-factor fallback
    excluded_factors: list = field(default_factory=list)
    # lowered with ``pad=True``: every count is its shape bucket's, so the
    # structure signature repeats as the graph grows
    padded: bool = False

    @property
    def key(self) -> tuple:
        """The connectivity key: the variable type names, their counts and
        every batch's key. The free mask is data, not connectivity."""
        return (tuple(self.type_names), tuple(self.counts[t] for t in self.type_names),
                tuple(b.key for b in self.batches))

    @property
    def total_dof(self):
        return sum(self.counts[t] * self.manifolds[t].dof for t in self.type_names)

    def tangent_zeros(self):
        return {
            t: torch.zeros(
                (self.counts[t], self.manifolds[t].dof),
                dtype=self.dtype, device=self.device,
            )
            for t in self.type_names
        }

    def to_device(self):
        """Move every host array onto ``self.device`` (values, params, free,
        weight, nullhypo and inflation in ``self.dtype``; slots as int64),
        each batch's key made from its host slots first."""
        dev, dt = self.device, self.dtype

        def fl(v):
            return torch.tensor(np.asarray(v), device=dev).to(dt)

        self.values0 = {k: fl(v) for k, v in self.values0.items()}
        self.free = {k: fl(v) for k, v in self.free.items()}
        for b in self.batches:
            b.key = batch_key(b.ftype.name, b.vtypes, b.vslots)
            b.vslots = torch.tensor(np.asarray(b.vslots, np.int64), device=dev)
            b.params = {k: fl(v).contiguous() for k, v in b.params.items()}
            b.weight = fl(b.weight)
            if b.nullhypo is not None:
                b.nullhypo = fl(b.nullhypo)
                b.inflation = fl(b.inflation)
        return self


def bucket_size(n: int) -> int:
    """Shape bucket: round up to ~12.5% granularity (multiples of
    2^(bit_length-3), min 8)."""
    if n <= 8:
        return 8
    g = max(8, 1 << (int(n).bit_length() - 3))
    return ((n + g - 1) // g) * g


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to n rows by replicating the last row (a VALID row, masked
    by weight/free zeros downstream)."""
    if a.shape[0] >= n:
        return a
    reps = np.repeat(a[-1:], n - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


def lower(
    fg: FactorGraph,
    solve_key: str = "parametric",
    dtype=torch.float32,
    pad: bool = False,
    device="cuda",
) -> GraphArrays:
    """Build dense solver tensors from the graph on ``device`` (the card
    unless the caller passes ``device="cpu"``).

    Variables with solvable=0 or marginalized=True stay in the arrays as
    constants (free=0); factors with solvable=0 or with every variable frozen
    are dropped.
    """
    entry_device(device)
    type_names, var_labels = [], {}
    for label in fg._var_order:
        t = fg.variables[label].vtype.name
        if t not in var_labels:
            var_labels[t] = []
            type_names.append(t)
        var_labels[t].append(label)

    manifolds, counts, values0, free = {}, {}, {}, {}
    for t in type_names:
        labels = var_labels[t]
        recs = [fg.variables[l] for l in labels]
        man = recs[0].manifold
        manifolds[t] = man
        counts[t] = len(labels)
        values0[t] = np.stack([
            np.asarray(r.points[solve_key], dtype=np.float64)
            if solve_key in r.points else man.identity(torch.float64).numpy()
            for r in recs
        ])
        free[t] = np.array(
            [1.0 if (r.solvable > 0 and not r.marginalized) else 0.0 for r in recs]
        )

    groups: dict[str, list] = {}
    excluded = []
    for flabel in fg._fct_order:
        f = fg.factors[flabel]
        if f.solvable <= 0:
            continue
        if len(f.variables) != f.ftype.arity:
            excluded.append(flabel)  # multihypo-extended factor
            continue
        recs = [fg.variables[v] for v in f.variables]
        if all(r.solvable <= 0 or r.marginalized for r in recs):
            continue
        groups.setdefault(f.ftype.name, []).append(f)

    batches = []
    for tname, fs in groups.items():
        ftype = fs[0].ftype
        n = len(fs)
        vslots = np.zeros((n, ftype.arity), dtype=np.int32)
        for i, f in enumerate(fs):
            for k, v in enumerate(f.variables):
                vslots[i, k] = fg.variables[v].slot
        # batch only the param keys every instance carries
        common = set(fs[0].params)
        for f in fs[1:]:
            common &= set(f.params)
        params = {
            key: np.stack([f.params[key] for f in fs]) for key in sorted(common)
        }
        batches.append(
            FactorBatch(
                ftype=ftype,
                n=n,
                vtypes=tuple(vt.name for vt in ftype.variable_types),
                vslots=vslots,
                params=params,
                weight=np.ones(n),
                labels=[f.label for f in fs],
                nullhypo=np.array([float(f.nullhypo or 0.0) for f in fs]),
                inflation=np.array([
                    float(f.inflation if f.inflation is not None else fg.params.inflation)
                    for f in fs
                ]),
            )
        )

    if pad:
        for t in type_names:
            n = bucket_size(counts[t])
            if n > counts[t]:
                values0[t] = _pad_rows(values0[t], n)
                free[t] = np.concatenate([free[t], np.zeros(n - counts[t])])
                var_labels[t] = var_labels[t] + [
                    f"__pad_{t}_{i}" for i in range(n - counts[t])
                ]
                counts[t] = n
        for b in batches:
            n = bucket_size(b.n)
            if n > b.n:
                b.vslots = _pad_rows(b.vslots, n)
                b.params = {k: _pad_rows(v, n) for k, v in b.params.items()}
                b.weight = np.concatenate([b.weight, np.zeros(n - b.n)])
                b.nullhypo = _pad_rows(b.nullhypo, n)
                b.inflation = _pad_rows(b.inflation, n)
                b.labels = b.labels + [None] * (n - b.n)
                b.n = n

    ga = GraphArrays(
        type_names=type_names,
        manifolds=manifolds,
        counts=counts,
        values0=values0,
        free=free,
        batches=batches,
        var_labels=var_labels,
        dtype=dtype,
        device=torch.device(device),
        excluded_factors=excluded,
        padded=pad,
    )
    return ga.to_device()


def write_back(fg: FactorGraph, ga: GraphArrays, values, solve_key: str = "parametric"):
    """Push solved values back into the graph records.

    Frozen variables (free=0) are NOT written: they keep their original
    float64 host values bit-identical (fixed-lag freeze guarantee).
    """
    for t in ga.type_names:
        man = ga.manifolds[t]
        arr = man.normalize(values[t]).to(torch.float64).cpu().numpy()
        free = ga.free[t].cpu().numpy()
        for slot, label in enumerate(ga.var_labels[t]):
            if free[slot] == 0.0:
                continue
            fg.variables[label].points[solve_key] = arr[slot]
            fg.variables[label].initialized[solve_key] = True
