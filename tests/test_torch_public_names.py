"""The port defines every public name of the JAX package.

Both packages are read with ``ast``, nothing is imported: for every module of
``rome_tpu/`` the port has a counterpart file at the same path (or the files
named in ``COUNTERPARTS``), and every public name the JAX module defines — a
``def``, a ``class``, a module-level assignment, an ``__all__`` entry and, in
a package ``__init__``, a re-exported import — is defined there too, as is
every public method of each of its classes (looked up through the port's
bases). ``EXCLUDED`` is the one list of what has no counterpart, each entry
with its reason.
"""

import ast
import functools
import os

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
JAX_PKG = os.path.join(REPO, "rome_tpu")
PORT_PKG = os.path.join(REPO, "rome_tpu_torch")

# JAX modules whose names the port keeps in more than one file: the kernel
# entry points live beside their CUDA wrappers under the same names
# (pose2pose2_linearize and FUSED_LINEARIZE in ops/linearize_cuda.py,
# se2_pairwise_logw and euclid_pairwise_logw in ops/pairwise_cuda.py)
COUNTERPARTS = {
    "ops/fused_linearize.py": ("ops/fused_linearize.py", "ops/linearize_cuda.py"),
    "ops/pairwise.py": ("ops/pairwise.py", "ops/pairwise_cuda.py"),
}

EXCLUDED = {
    # TPU-only modules: the Pallas Pose2Pose2 kernel's 24-plane packing (its
    # kernel is K1, csrc/pose2pose2_linearize.cu), the persistent XLA compile
    # cache, and the pinning of eager jnp ops to the JAX CPU backend (the
    # port's counterpart is ``device="cpu"``)
    "modules": {"ops/linearize_pallas.py", "utils/compile_cache.py", "utils/host.py"},
    # TPU-only names: the compile cache's switch, re-exported at the top
    "names": {"__init__.py": {"enable_compile_cache"}},
    # names a JAX module only imports for its own use (not re-exported by a
    # package __init__, so they are not counted); listed for the reader
    "imported_only": ("host_default_device", "NamedSharding", "P"),
}


def _modules(root):
    out = []
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/"))
    return sorted(out)


def _parse(path):
    with open(path) as fh:
        return ast.parse(fh.read())


def _targets(node):
    ts = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in ts:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                yield n.id


def _public_names(tree, is_init):
    """(names, classes): the module's public top-level names and, per public
    class, its public methods and the names of its bases."""
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            classes[node.name] = (
                {n.name for n in node.body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))},
                [b.id for b in node.bases if isinstance(b, ast.Name)])
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in _targets(node):
                names.add(t)
                if t == "__all__" and node.value is not None:
                    names.update(ast.literal_eval(node.value))
        elif isinstance(node, ast.ImportFrom) and is_init:
            names.update(a.asname or a.name for a in node.names if a.name != "*")
        elif isinstance(node, ast.If):  # e.g. a guarded definition
            sub, subcls = _public_names(ast.Module(body=node.body, type_ignores=[]), is_init)
            names |= sub
            classes.update(subcls)
    public = {n for n in names if not n.startswith("_")}
    return public, {c: (m, b) for c, (m, b) in classes.items() if not c.startswith("_")}


def _port_files(rel):
    return COUNTERPARTS.get(rel, (rel,))


@functools.lru_cache(maxsize=1)
def _port_index():
    """Every class of the port by name: its methods and bases."""
    idx = {}
    for rel in _modules(PORT_PKG):
        _n, cls = _public_names(_parse(os.path.join(PORT_PKG, rel)), False)
        for c, v in cls.items():
            idx.setdefault(c, []).append(v)
    return idx


def _methods(cls, idx, seen=None):
    seen = set() if seen is None else seen
    out = set()
    for methods, bases in idx.get(cls, []):
        out |= methods
        for b in bases:
            if b not in seen:
                seen.add(b)
                out |= _methods(b, idx, seen)
    return out


JAX_MODULES = [m for m in _modules(JAX_PKG) if m not in EXCLUDED["modules"]]


def test_excluded_modules_exist_and_have_no_port():
    for rel in EXCLUDED["modules"]:
        assert os.path.exists(os.path.join(JAX_PKG, rel)), rel
        assert not os.path.exists(os.path.join(PORT_PKG, rel)), rel
    assert len(JAX_MODULES) + len(EXCLUDED["modules"]) == len(_modules(JAX_PKG))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_defines_every_public_name(rel):
    is_init = rel.endswith("__init__.py")
    want, jax_classes = _public_names(_parse(os.path.join(JAX_PKG, rel)), is_init)
    want -= EXCLUDED["names"].get(rel, set())
    have = set()
    for prel in _port_files(rel):
        path = os.path.join(PORT_PKG, prel)
        assert os.path.exists(path), f"no counterpart of rome_tpu/{rel}: {prel}"
        have |= _public_names(_parse(path), is_init)[0]
    missing = sorted(want - have)
    assert not missing, f"rome_tpu_torch/{rel} lacks {missing}"
    idx = _port_index()
    for cls, (methods, _bases) in jax_classes.items():
        public = {m for m in methods if not m.startswith("_")}
        lacking = sorted(public - _methods(cls, idx))
        assert not lacking, f"rome_tpu_torch/{rel}: {cls} lacks {lacking}"


def test_imported_only_names_are_not_defined_by_the_jax_modules():
    """The names listed as only imported are indeed never defined in a JAX
    module that is counted (so the list hides nothing)."""
    for rel in JAX_MODULES:
        if rel.endswith("__init__.py"):
            continue
        names, _c = _public_names(_parse(os.path.join(JAX_PKG, rel)), False)
        assert not names & set(EXCLUDED["imported_only"]), rel
