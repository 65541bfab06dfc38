"""Build the port's :class:`GraphArrays` from plain numpy arrays.

A lowered graph is the state that crosses between the two packages: the same
values, factor parameters, slots, weights and free masks, so that both
solvers work on exactly the same arrays; so are the nonparametric engine's
particle beliefs. The caller passes numpy views
(``np.asarray`` of each array of the JAX package's ``GraphArrays``); nothing
here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.factors.base import get_factor_type
from rome_tpu_torch.graph.lower import FactorBatch, GraphArrays
from rome_tpu_torch.utils.device import entry_device
from rome_tpu_torch.variables import get_variable_type


def graph_arrays_from_numpy(
    type_names,
    counts,
    values0,
    free,
    batches,
    var_labels=None,
    dtype=torch.float32,
    device="cuda",
    excluded_factors=(),
) -> GraphArrays:
    """Assemble a GraphArrays on ``device``.

    ``values0``/``free``: type name -> (n, point_dim) / (n,) arrays.
    ``batches``: list of dicts with keys ``ftype`` (factor type name),
    ``vslots`` (n, arity), ``params`` (name -> (n, ...)), ``weight`` (n,),
    and optionally ``labels`` (factor labels by row), ``nullhypo`` and
    ``inflation`` ((n,) each, the nonparametric engine's per-factor data).
    ``var_labels``: type name -> labels by slot (defaults to ``t{slot}``).
    """
    entry_device(device)
    fbs = []
    for b in batches:
        ftype = get_factor_type(b["ftype"])
        vslots = np.asarray(b["vslots"])
        fbs.append(
            FactorBatch(
                ftype=ftype,
                n=int(vslots.shape[0]),
                vtypes=tuple(vt.name for vt in ftype.variable_types),
                vslots=vslots,
                params={k: np.asarray(v) for k, v in b["params"].items()},
                weight=np.asarray(b["weight"]),
                labels=list(b.get("labels", [])),
                nullhypo=None if b.get("nullhypo") is None else np.asarray(b["nullhypo"]),
                inflation=None if b.get("inflation") is None else np.asarray(b["inflation"]),
            )
        )
    if var_labels is None:
        var_labels = {t: [f"{t}{i}" for i in range(counts[t])] for t in type_names}
    ga = GraphArrays(
        type_names=list(type_names),
        manifolds={t: get_variable_type(t).manifold for t in type_names},
        counts={t: int(counts[t]) for t in type_names},
        values0={t: np.asarray(values0[t]) for t in type_names},
        free={t: np.asarray(free[t]) for t in type_names},
        batches=fbs,
        var_labels={t: list(var_labels[t]) for t in type_names},
        dtype=dtype,
        device=torch.device(device),
        excluded_factors=list(excluded_factors),
    )
    return ga.to_device()


def graph_arrays_to_numpy(ga) -> dict:
    """The numpy arrays of a lowered graph, as :func:`graph_arrays_from_numpy`
    takes them (its keyword arguments less ``dtype`` and ``device``): for
    either package's GraphArrays, so one graph can be rebuilt elsewhere (in
    another process, on another device)."""
    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    return dict(
        type_names=list(ga.type_names),
        counts={t: int(ga.counts[t]) for t in ga.type_names},
        values0={t: host(v) for t, v in ga.values0.items()},
        free={t: host(v) for t, v in ga.free.items()},
        batches=[dict(ftype=b.ftype.name, vslots=host(b.vslots),
                      params={k: host(v) for k, v in b.params.items()},
                      weight=host(b.weight)) for b in ga.batches],
        var_labels={t: list(ga.var_labels[t]) for t in ga.type_names},
    )


def beliefs_from_numpy(beliefs, device="cuda", dtype=torch.float32) -> dict:
    """Particle beliefs ``{type: (V, N, point_dim)}`` as tensors on
    ``device``: the same particles for both engines."""
    entry_device(device)
    return {
        t: torch.tensor(np.asarray(v), dtype=dtype, device=device)
        for t, v in beliefs.items()
    }
