"""Factor-graph container (counterpart of ``rome_tpu/graph/graph.py``).

The graph is host-side metadata (labels, tags, solvable flags, points as
float64 numpy); all numeric solver state lowers to dense per-type tensors and
per-factor-type batches (graph/lower.py). The closed-form initializers run as
eager float64 torch on the CPU.
"""

from __future__ import annotations

import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution
from rome_tpu_torch.factors.base import Factor
from rome_tpu_torch.variables import VariableType, get_variable_type


@dataclass
class SolverParams:
    """The solver settings the port reads (the JAX package's SolverParams
    has a few more that nothing reads; io.serialization writes their
    defaults into a saved graph)."""

    N: int = 100                      # particles per belief
    graphinit: bool = True            # init new variables by factor propagation
    treeinit: bool = False            # solve_graph_nonparametric routes through the Bayes tree
    downsolve: bool = True            # the tree solve's root-to-leaves pass
    multiproc: bool = False           # factor-sharded solve inside a process group of > 1 rank; one rank solves as usual
    drawtree: bool = False            # write the ASCII Bayes tree to logpath/bt.txt
    showtree: bool = False            # print the ASCII Bayes tree after the build
    # True: the tree upsolve restricts each clique's messages to its
    # subtree-assigned factors; False: full neighborhood belief products
    useMsgLikelihoods: bool = True
    qfl: int = 99999999               # quasi fixed-lag window length (frontend.fifo_freeze)
    inflation: float = 5.0            # nonparametric init-noise scale
    maxincidence: int = 500           # elimination-order guard against hub variables
    dbg: bool = False                 # write the tree solve's summary to logpath
    logpath: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "rome_tpu")
    )
    max_iters: int = 100
    lm_lambda0: float = 1e-4
    dtype: str = "float32"


@dataclass
class VariableRecord:
    label: str
    vtype: VariableType
    slot: int                          # index within this type's dense arrays
    timestamp_ns: int = 0
    tags: tuple = ()
    solvable: int = 1
    marginalized: bool = False
    points: dict = field(default_factory=dict)       # solvekey -> (point_dim,)
    # solvekey -> (N, point_dim) numpy particles of the nonparametric engine
    beliefs: dict = field(default_factory=dict)
    ppes: dict = field(default_factory=dict)         # ppe key -> coords
    initialized: dict = field(default_factory=dict)  # solvekey -> bool

    @property
    def manifold(self):
        return self.vtype.manifold


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, device="cpu")


def _identity(rec: VariableRecord) -> np.ndarray:
    return rec.manifold.identity(torch.float64).numpy()


class FactorGraph:
    """In-memory factor graph."""

    def __init__(self, params: Optional[SolverParams] = None, session: str = "default"):
        self.params = params or SolverParams()
        self.session = session
        self.variables: dict[str, VariableRecord] = {}
        self.factors: dict[str, Factor] = {}
        self._var_order: list[str] = []
        self._fct_order: list[str] = []
        self._type_counts: dict[str, int] = {}
        self._adj: dict[str, list[str]] = {}  # var label -> factor labels

    # -- construction ---------------------------------------------------------
    def add_variable(
        self,
        label: str,
        vtype,
        timestamp_ns: Optional[int] = None,
        tags: Sequence[str] = (),
        solvable: int = 1,
    ) -> VariableRecord:
        label = str(label)
        if label in self.variables:
            raise ValueError(f"variable {label!r} already exists")
        vt = get_variable_type(vtype)
        slot = self._type_counts.get(vt.name, 0)
        self._type_counts[vt.name] = slot + 1
        rec = VariableRecord(
            label=label,
            vtype=vt,
            slot=slot,
            timestamp_ns=int(timestamp_ns if timestamp_ns is not None else time.time_ns()),
            tags=tuple(tags),
            solvable=int(solvable),
        )
        self.variables[label] = rec
        self._var_order.append(label)
        self._adj[label] = []
        return rec

    def add_factor(
        self,
        var_labels: Sequence[str],
        factor: Factor,
        label: Optional[str] = None,
        graphinit: Optional[bool] = None,
        solvable: int = 1,
        multihypo: Optional[Sequence[float]] = None,
        nullhypo: float = 0.0,
        tags: Sequence[str] = (),
        timestamp_ns: Optional[int] = None,
        inflation: Optional[float] = None,
    ) -> Factor:
        var_labels = tuple(str(v) for v in var_labels)
        for v in var_labels:
            if v not in self.variables:
                raise KeyError(f"unknown variable {v!r}")
        expect = factor.ftype.variable_types
        if multihypo is not None and len(var_labels) > len(expect):
            # multihypo layout: the extra variables are data-association
            # candidates for the LAST factor slot; all share that slot's type
            for v, et in zip(var_labels[: len(expect) - 1], expect[:-1]):
                at = self.variables[v].vtype
                if at.name != et.name:
                    raise TypeError(
                        f"{factor.ftype.name} slot expects {et.name}, variable {v} is {at.name}"
                    )
            last = expect[-1]
            for v in var_labels[len(expect) - 1:]:
                at = self.variables[v].vtype
                if at.name != last.name:
                    raise TypeError(
                        f"{factor.ftype.name} candidate slot expects {last.name}, "
                        f"variable {v} is {at.name}"
                    )
            if len(multihypo) != len(var_labels):
                raise ValueError("multihypo length must match variables")
        else:
            if len(var_labels) != len(expect):
                raise ValueError(
                    f"{factor.ftype.name} expects {len(expect)} variables, got {len(var_labels)}"
                )
            for v, et in zip(var_labels, expect):
                at = self.variables[v].vtype
                if at.name != et.name:
                    raise TypeError(
                        f"{factor.ftype.name} slot expects {et.name}, variable {v} is {at.name}"
                    )
        factor.variables = var_labels
        if factor.ftype.needs_dt and "dt" not in factor.params:
            ts = [self.variables[v].timestamp_ns for v in var_labels]
            factor.params["dt"] = np.float64(ts[-1] - ts[0]) * 1e-9
        factor.label = label or (factor.ftype.name.lower() + "f_" + "_".join(var_labels))
        if factor.label in self.factors:
            k = 1
            while f"{factor.label}_{k}" in self.factors:
                k += 1
            factor.label = f"{factor.label}_{k}"
        factor.solvable = int(solvable)
        factor.multihypo = list(multihypo) if multihypo is not None else None
        factor.nullhypo = float(nullhypo)
        factor.tags = tuple(tags)
        factor.inflation = inflation
        factor.timestamp_ns = int(
            timestamp_ns if timestamp_ns is not None else time.time_ns()
        )
        self.factors[factor.label] = factor
        self._fct_order.append(factor.label)
        for v in var_labels:
            self._adj[v].append(factor.label)

        do_init = self.params.graphinit if graphinit is None else graphinit
        if do_init:
            self._graphinit_factor(factor)
        return factor

    # -- queries ----------------------------------------------------------------
    def exists(self, label: str) -> bool:
        return label in self.variables or label in self.factors

    def ls(self, pattern: Optional[str] = None, tags: Optional[Sequence[str]] = None):
        out = list(self._var_order)
        if pattern is not None:
            rx = re.compile(pattern)
            out = [l for l in out if rx.search(l)]
        if tags:
            ts = set(tags)
            out = [l for l in out if ts & set(self.variables[l].tags)]
        return sorted(out)

    def lsf(self, pattern: Optional[str] = None):
        out = list(self._fct_order)
        if pattern is not None:
            rx = re.compile(pattern)
            out = [l for l in out if rx.search(l)]
        return sorted(out)

    def get_variable(self, label: str) -> VariableRecord:
        return self.variables[str(label)]

    def get_factor(self, label: str) -> Factor:
        return self.factors[str(label)]

    def neighbors(self, label: str):
        """A variable's factor labels, or a factor's variable labels."""
        label = str(label)
        if label in self.variables:
            return list(self._adj[label])
        return list(self.factors[label].variables)

    @property
    def num_variables(self):
        return len(self.variables)

    @property
    def num_factors(self):
        return len(self.factors)

    # -- state access -------------------------------------------------------------
    def get_point(self, label: str, solve_key: str = "parametric") -> np.ndarray:
        rec = self.variables[str(label)]
        if solve_key not in rec.points:
            raise KeyError(f"{label} has no point for solveKey {solve_key!r}")
        return np.asarray(rec.points[solve_key])

    def set_point(self, label: str, point, solve_key: str = "parametric"):
        rec = self.variables[str(label)]
        point = np.asarray(point, dtype=np.float64).reshape(rec.vtype.point_dim)
        rec.points[solve_key] = point
        rec.initialized[solve_key] = True

    def get_coords(self, label: str, solve_key: str = "parametric") -> np.ndarray:
        """Tangent coords of the point (log); e.g. Pose2 -> (x, y, theta)."""
        rec = self.variables[str(label)]
        return rec.manifold.log(_f64(rec.points[solve_key])).numpy()

    def set_coords(self, label: str, coords, solve_key: str = "parametric"):
        rec = self.variables[str(label)]
        coords = np.asarray(coords, dtype=np.float64).reshape(rec.vtype.dof)
        self.set_point(label, rec.manifold.exp(_f64(coords)).numpy(), solve_key)

    def init_variable(self, label: str, value, solve_key: str = "parametric"):
        """value may be a Distribution (mean taken as coords) or a flat point /
        coords array."""
        rec = self.variables[str(label)]
        if isinstance(value, Distribution):
            self.set_coords(label, value.mean(), solve_key)
        else:
            arr = np.asarray(value, dtype=np.float64).reshape(-1)
            if arr.size == rec.vtype.point_dim:
                self.set_point(label, arr, solve_key)
            elif arr.size == rec.vtype.dof:
                self.set_coords(label, arr, solve_key)
            else:
                raise ValueError(
                    f"value size {arr.size} matches neither point_dim nor dof of {rec.vtype}"
                )

    def is_initialized(self, label: str, solve_key: str = "parametric") -> bool:
        return bool(self.variables[str(label)].initialized.get(solve_key, False))

    # PPE plumbing (simulated ground truth of the canonical generators)
    def set_ppe(self, label: str, coords, ppe_key: str = "simulated"):
        self.variables[str(label)].ppes[ppe_key] = np.asarray(coords, dtype=np.float64)

    def get_ppe(self, label: str, ppe_key: str = "simulated") -> np.ndarray:
        return self.variables[str(label)].ppes[ppe_key]

    def set_solvable(self, label: str, value: int):
        label = str(label)
        if label in self.variables:
            self.variables[label].solvable = int(value)
        elif label in self.factors:
            self.factors[label].solvable = int(value)
        else:
            raise KeyError(label)

    def set_marginalized(self, label: str, value: bool = True):
        self.variables[str(label)].marginalized = bool(value)

    # -- initialization (initAll! analogue) ----------------------------------------
    def _graphinit_factor(self, factor: Factor, solve_key: str = "parametric"):
        """Propagate an estimate through the factor into any uninitialized
        connected variable whose other variables are ready (closed-form
        initializer, eager float64 torch on the CPU)."""
        recs = [self.variables[v] for v in factor.variables]
        for k, rec in enumerate(recs):
            if rec.initialized.get(solve_key):
                continue
            init = factor.ftype.initializers.get(k)
            if init is None:
                continue
            others_ready = all(
                recs[j].initialized.get(solve_key) for j in range(len(recs)) if j != k
            )
            if not others_ready and len(recs) > 1:
                continue
            pts = [
                _f64(r.points[solve_key]) if solve_key in r.points
                else r.manifold.identity(torch.float64)
                for r in recs
            ]
            params = {key: _f64(v) for key, v in factor.params.items()}
            newpt = rec.manifold.normalize(init(params, pts)).numpy()
            self.set_point(rec.label, newpt, solve_key)

    def init_all(self, solve_key: str = "parametric", max_sweeps: int = 1000):
        """Repeated sweeps of closed-form initializer propagation; whenever a
        sweep makes no progress, seed the first remaining uninitialized
        variable with the manifold identity (the gauge root) and continue."""
        remaining = [
            fl
            for fl in self._fct_order
            if not all(
                self.variables[v].initialized.get(solve_key, False)
                for v in self.factors[fl].variables
            )
        ]
        for _ in range(max_sweeps):
            progress = False
            still = []
            for flabel in remaining:
                factor = self.factors[flabel]
                before = [
                    self.variables[v].initialized.get(solve_key, False)
                    for v in factor.variables
                ]
                if all(before):
                    continue
                self._graphinit_factor(factor, solve_key)
                after = [
                    self.variables[v].initialized.get(solve_key, False)
                    for v in factor.variables
                ]
                if before != after:
                    progress = True
                if not all(after):
                    still.append(flabel)
            remaining = still
            if not remaining:
                break
            if not progress:
                seeded = False
                for label in self._var_order:
                    rec = self.variables[label]
                    if not rec.initialized.get(solve_key):
                        rec.points[solve_key] = _identity(rec)
                        rec.initialized[solve_key] = True
                        seeded = True
                        break
                if not seeded:
                    break
        for label, rec in self.variables.items():
            if not rec.initialized.get(solve_key):
                rec.points[solve_key] = _identity(rec)
                rec.initialized[solve_key] = True

    def __repr__(self):
        return (
            f"FactorGraph(session={self.session!r}, {self.num_variables} variables, "
            f"{self.num_factors} factors)"
        )

