"""Graph serialization — saveDFG / loadDFG and the packed-factor layer
(counterpart of ``rome_tpu/io/serialization.py``).

The reference serializes every factor through a ``Packed*`` twin struct with
``convert`` both ways (pattern: src/factors/Pose2D.jl:30-84) and saves/loads
whole graphs via DFG ``saveDFG``/``loadDFG`` at every solve boundary
(examples/MITDatasetBatch.jl:41-44; SURVEY.md §5 checkpoint/resume). Here the
same capability is one JSON document: factor params are already plain arrays,
distributions pack to tagged dicts, and the whole graph round-trips
bit-exactly through ``save_dfg``/``load_dfg``.

The port writes the JAX package's document: the same ``format`` and
``version``, the same keys, and arrays as base64 of little-endian float64.
A file saved by either package loads in the other.

Files ending in ``.tar.gz`` are gzip-compressed (single-member tar like the
reference's saveDFG output); anything else is plain JSON.
"""

from __future__ import annotations

import base64
import gzip
import io as _io
import json
import os
import tarfile

import numpy as np
import torch

from rome_tpu_torch.distributions import (
    Categorical,
    Distribution,
    Mixture,
    MvNormal,
    Normal,
    Uniform,
)
from rome_tpu_torch.factors.base import Factor, get_factor_type
from rome_tpu_torch.graph.graph import FactorGraph, SolverParams
from rome_tpu_torch.variables import get_variable_type

FORMAT_VERSION = 1


# ----------------------------- manifold packing -----------------------------

def pack_manifold(man) -> dict:
    """Structural manifold encoding (for particle-belief measurements)."""
    from rome_tpu_torch.manifolds.base import (
        SE2, SE3, SO2, SO3, ProductGroup, TranslationGroup,
    )

    if isinstance(man, ProductGroup):
        return {
            "kind": "ProductGroup",
            "parts": [pack_manifold(p) for p in man.parts],
            "name": man.name,
        }
    if isinstance(man, TranslationGroup):
        return {"kind": "TranslationGroup", "n": man.dof}
    for cls, tag in ((SE2, "SE2"), (SE3, "SE3"), (SO2, "SO2"), (SO3, "SO3")):
        if isinstance(man, cls):
            return {"kind": tag}
    raise TypeError(f"cannot pack manifold {type(man).__name__}")


def unpack_manifold(obj: dict):
    from rome_tpu_torch.manifolds.base import (
        SE2, SE3, SO2, SO3, ProductGroup, TranslationGroup,
    )

    kind = obj["kind"]
    if kind == "ProductGroup":
        return ProductGroup(
            [unpack_manifold(p) for p in obj["parts"]], name=obj.get("name")
        )
    if kind == "TranslationGroup":
        return TranslationGroup(obj["n"])
    return {"SE2": SE2, "SE3": SE3, "SO2": SO2, "SO3": SO3}[kind]()


# --------------------------- distribution packing ---------------------------

def pack_distribution(d: Distribution) -> dict:
    """Distribution -> tagged JSON dict (PackedSamplableBelief analogue).

    Covers the FULL measurement surface, matching the reference's exhaustive
    Packed* converter coverage (test/testpackingconverters.jl;
    ext packing pattern RoMEFluxExt.jl:62-70): the parametric distributions,
    the NN mixture component, scalar-field level-set beliefs, and particle
    (manifold-KDE) beliefs."""
    from rome_tpu_torch.factors.fluxmix import NNOdoPredictor
    from rome_tpu_torch.services.scalar_fields import LevelSetGridNormal
    from rome_tpu_torch.solvers.multimodal.kde import ManifoldKernelDensity

    if isinstance(d, NNOdoPredictor):
        return {
            "_type": "NNOdoPredictor",
            "nn": {k: _pack_array(v) for k, v in d.nn.items()},
            "data": _pack_array(d.data),
            "jitter": d.jitter,
        }
    if isinstance(d, LevelSetGridNormal):
        return {
            "_type": "LevelSetGridNormal",
            "img": _pack_array(d.img),
            "x": _pack_array(d.x),
            "y": _pack_array(d.y),
            "level": d.level,
            "sigma": d.sigma,
            "sigma_scale": d.sigma_scale,
            "N": d.N,
        }
    if isinstance(d, ManifoldKernelDensity):
        return {
            "_type": "ManifoldKernelDensity",
            "manifold": pack_manifold(d.manifold),
            "points": _pack_array(d.points.detach().cpu().numpy()),
            "bandwidth": _pack_array(d.bandwidth.detach().cpu().numpy()),
        }
    if isinstance(d, Normal):
        return {"_type": "Normal", "mu": d.mu, "sigma": d.sigma}
    if isinstance(d, MvNormal):
        return {
            "_type": "MvNormal",
            "mu": d.mu.tolist(),
            "cov": d.cov().tolist(),
        }
    if isinstance(d, Uniform):
        return {"_type": "Uniform", "a": d.a, "b": d.b}
    if isinstance(d, Categorical):
        return {"_type": "Categorical", "p": d.p.tolist()}
    if isinstance(d, Mixture):
        return {
            "_type": "Mixture",
            "components": [pack_distribution(c) for c in d.components],
            "weights": d.weights.tolist(),
        }
    raise TypeError(f"cannot pack distribution {type(d).__name__}")


def unpack_distribution(obj: dict) -> Distribution:
    t = obj["_type"]
    if t == "NNOdoPredictor":
        from rome_tpu_torch.factors.fluxmix import NNOdoPredictor

        return NNOdoPredictor(
            {k: _unpack_array(v) for k, v in obj["nn"].items()},
            _unpack_array(obj["data"]),
            jitter=obj["jitter"],
        )
    if t == "LevelSetGridNormal":
        from rome_tpu_torch.services.scalar_fields import LevelSetGridNormal

        return LevelSetGridNormal(
            _unpack_array(obj["img"]),
            (_unpack_array(obj["x"]), _unpack_array(obj["y"])),
            obj["level"],
            obj["sigma"],
            sigma_scale=obj["sigma_scale"],
            N=obj["N"],
        )
    if t == "ManifoldKernelDensity":
        from rome_tpu_torch.solvers.multimodal.kde import ManifoldKernelDensity

        # particles are float32 on the CPU, as the KDE that was packed held them
        return ManifoldKernelDensity.from_points(
            unpack_manifold(obj["manifold"]),
            torch.as_tensor(_unpack_array(obj["points"]), dtype=torch.float32),
            bandwidth=_unpack_array(obj["bandwidth"]),
        )
    if t == "Normal":
        return Normal(obj["mu"], obj["sigma"])
    if t == "MvNormal":
        return MvNormal(obj["mu"], np.asarray(obj["cov"]))
    if t == "Uniform":
        return Uniform(obj["a"], obj["b"])
    if t == "Categorical":
        return Categorical(obj["p"])
    if t == "Mixture":
        return Mixture(
            [unpack_distribution(c) for c in obj["components"]], obj["weights"]
        )
    raise TypeError(f"unknown packed distribution type {t!r}")


# ----------------------------- array packing --------------------------------

def _pack_array(a: np.ndarray) -> dict:
    """Bit-exact float64 array encoding (base64 of raw little-endian bytes).

    JSON floats round-trip doubles exactly in python, but base64 is ~3x more
    compact for large particle arrays and unambiguous about dtype/shape.
    """
    a = np.ascontiguousarray(a, dtype=np.float64)
    return {
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def _unpack_array(obj) -> np.ndarray:
    if isinstance(obj, dict):
        buf = base64.b64decode(obj["data"])
        return np.frombuffer(buf, dtype=np.float64).reshape(obj["shape"]).copy()
    return np.asarray(obj, dtype=np.float64)


# ----------------------------- factor packing -------------------------------

def pack_factor(f: Factor) -> dict:
    return {
        "label": f.label,
        "ftype": f.ftype.name,
        "variables": list(f.variables),
        "params": {k: _pack_array(v) for k, v in f.params.items()},
        "dists": [pack_distribution(d) for d in f.dists],
        "multihypo": list(f.multihypo) if f.multihypo is not None else None,
        "nullhypo": f.nullhypo,
        "solvable": f.solvable,
        "tags": list(f.tags),
        "timestamp_ns": f.timestamp_ns,
        "inflation": f.inflation,
    }


def unpack_factor(obj: dict) -> Factor:
    f = Factor(
        ftype=get_factor_type(obj["ftype"]),
        variables=tuple(obj["variables"]),
        params={k: _unpack_array(v) for k, v in obj["params"].items()},
        dists=tuple(unpack_distribution(d) for d in obj["dists"]),
        label=obj["label"],
        multihypo=obj.get("multihypo"),
        nullhypo=obj.get("nullhypo", 0.0),
        solvable=obj.get("solvable", 1),
        tags=tuple(obj.get("tags", ())),
        timestamp_ns=obj.get("timestamp_ns", 0),
        inflation=obj.get("inflation"),
    )
    return f


# ------------------------------ graph save/load -----------------------------

def _graph_to_doc(fg: FactorGraph, include_beliefs: bool = True) -> dict:
    variables = []
    for label in fg._var_order:
        r = fg.variables[label]
        variables.append(
            {
                "label": r.label,
                "vtype": r.vtype.name,
                "timestamp_ns": r.timestamp_ns,
                "tags": list(r.tags),
                "solvable": r.solvable,
                "marginalized": r.marginalized,
                "points": {k: _pack_array(v) for k, v in r.points.items()},
                "beliefs": (
                    {k: _pack_array(v) for k, v in r.beliefs.items()}
                    if include_beliefs
                    else {}
                ),
                "ppes": {k: _pack_array(v) for k, v in r.ppes.items()},
                "initialized": dict(r.initialized),
                # blob REFERENCES only (payloads live in the blob store —
                # io/blobstore.py; DFG BlobEntry semantics)
                "data_entries": {
                    k: e.to_doc()
                    for k, e in getattr(r, "data_entries", {}).items()
                },
            }
        )
    factors = [pack_factor(fg.factors[l]) for l in fg._fct_order]
    params = {
        k: v
        for k, v in vars(fg.params).items()
        if isinstance(v, (int, float, str, bool, tuple, list))
    }
    params = {k: (list(v) if isinstance(v, tuple) else v) for k, v in params.items()}
    params = dict(REFERENCE_ONLY_PARAMS, **params)
    return {
        "format": "rome_tpu.dfg",
        "version": FORMAT_VERSION,
        "session": fg.session,
        "params": params,
        "variables": variables,
        "factors": factors,
    }


# SolverParams fields of the JAX package that no solver of either package
# reads: written with their defaults so that both packages save the same
# keys, and ignored on load
REFERENCE_ONLY_PARAMS = {"isfixedlag": False, "limitfixeddown": False, "async_": False,
                         "algorithms": [":default", ":parametric"], "cg_tol": 1e-8}


def _doc_to_graph(doc: dict) -> FactorGraph:
    if doc.get("format") != "rome_tpu.dfg":
        raise ValueError("not a rome_tpu.dfg document")
    params = SolverParams()
    for k, v in doc.get("params", {}).items():
        if hasattr(params, k):
            cur = getattr(params, k)
            setattr(params, k, tuple(v) if isinstance(cur, tuple) else v)
    fg = FactorGraph(params=params, session=doc.get("session", "default"))
    fg.params.graphinit = False  # restored points are authoritative
    for v in doc["variables"]:
        rec = fg.add_variable(
            v["label"],
            get_variable_type(v["vtype"]),
            timestamp_ns=v["timestamp_ns"],
            tags=v["tags"],
            solvable=v["solvable"],
        )
        rec.marginalized = v.get("marginalized", False)
        rec.points = {k: _unpack_array(a) for k, a in v.get("points", {}).items()}
        rec.beliefs = {k: _unpack_array(a) for k, a in v.get("beliefs", {}).items()}
        rec.ppes = {k: _unpack_array(a) for k, a in v.get("ppes", {}).items()}
        rec.initialized = dict(v.get("initialized", {}))
        if v.get("data_entries"):
            from rome_tpu_torch.io.blobstore import BlobEntry

            rec.data_entries = {
                k: BlobEntry.from_doc(d)
                for k, d in v["data_entries"].items()
            }
    for fobj in doc["factors"]:
        f = unpack_factor(fobj)
        fg.add_factor(
            list(f.variables),
            f,
            label=f.label,
            graphinit=False,
            solvable=f.solvable,
            multihypo=f.multihypo,
            nullhypo=f.nullhypo,
            tags=f.tags,
            timestamp_ns=f.timestamp_ns,
            inflation=f.inflation,
        )
    fg.params.graphinit = doc.get("params", {}).get("graphinit", True)
    return fg


def save_dfg(fg: FactorGraph, path: str, include_beliefs: bool = True) -> str:
    """saveDFG analogue. ``path`` ending in .tar.gz writes a gzipped tar with
    one dfg.json member (reference-style archive); otherwise plain JSON.
    Returns the path written."""
    doc = _graph_to_doc(fg, include_beliefs=include_beliefs)
    payload = json.dumps(doc).encode()
    if path.endswith(".tar.gz"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with tarfile.open(path, "w:gz") as tar:
            info = tarfile.TarInfo("dfg.json")
            info.size = len(payload)
            tar.addfile(info, _io.BytesIO(payload))
        return path
    if not path.endswith(".json"):
        path = path + ".json"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(payload)
    return path


def load_dfg(path: str) -> FactorGraph:
    """loadDFG analogue (accepts the .json or .tar.gz forms of save_dfg)."""
    if not os.path.exists(path) and os.path.exists(path + ".json"):
        path = path + ".json"
    if path.endswith(".tar.gz"):
        with tarfile.open(path, "r:gz") as tar:
            member = tar.getmember("dfg.json")
            payload = tar.extractfile(member).read()
    else:
        with open(path, "rb") as f:
            payload = f.read()
        if payload[:2] == b"\x1f\x8b":
            payload = gzip.decompress(payload)
    return _doc_to_graph(json.loads(payload.decode()))


# reference-style aliases
saveDFG = save_dfg
loadDFG = load_dfg


# ---------------------------------------------------------------------------
# Bayes tree serialization (saveTree/loadTree analogue, MITDatasetBatch.jl:45)
# ---------------------------------------------------------------------------

def save_tree(tree, path: str) -> str:
    """Serialize a BayesTree to JSON (saveTree(tree, file.jld2) analogue)."""
    import json

    if not path.endswith(".json"):
        path = path + ".json"
    doc = {
        "order": list(tree.order),
        "build_time": tree.build_time,
        "num_recycled": tree.num_recycled,
        "levels": [list(l) for l in tree.levels],
        "cliques": [
            {
                "index": c.index,
                "frontals": list(c.frontals),
                "separator": list(c.separator),
                "factors": list(c.factors),
                "parent": c.parent,
                "children": list(c.children),
                "signature": [list(s) for s in c.signature],
            }
            for c in tree.cliques
        ],
    }
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def load_tree(path: str):
    """Inverse of :func:`save_tree`."""
    import json

    from rome_tpu_torch.solvers.multimodal.tree import BayesTree, Clique

    if not path.endswith(".json"):
        path = path + ".json"
    with open(path) as fh:
        doc = json.load(fh)
    cliques = [
        Clique(
            index=c["index"],
            frontals=list(c["frontals"]),
            separator=list(c["separator"]),
            factors=list(c["factors"]),
            parent=c["parent"],
            children=list(c["children"]),
            signature=tuple(tuple(s) for s in c["signature"]),
        )
        for c in doc["cliques"]
    ]
    return BayesTree(
        cliques=cliques,
        order=list(doc["order"]),
        levels=[list(l) for l in doc["levels"]],
        build_time=doc.get("build_time", 0.0),
        num_recycled=doc.get("num_recycled", 0),
    )


saveTree = save_tree
loadTree = load_tree
