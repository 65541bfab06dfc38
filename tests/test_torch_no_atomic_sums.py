"""No colliding scatter-add outside the fixed-order sums.

A scatter-add on a CUDA tensor (``index_add_``, ``index_put_(...,
accumulate=True)``, ``scatter_add_``, ``scatter_reduce``) adds colliding
contributions with atomics, in an order that changes from run to run, so the
port would stop giving one answer per input. Every such sum goes through
``rome_tpu_torch/ops/segment_sum.SegmentPlan``. This test parses every module
of ``rome_tpu_torch/`` with ``ast`` (importing nothing) and fails on any such
call outside ``ops/segment_sum.py`` that the allow-list does not name; each
entry gives the file, the function, how many calls and why they may stay.
"""

import ast
import os

import pytest

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "rome_tpu_torch")
HOME = "ops/segment_sum.py"
SCATTERS = {"index_add", "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
            "scatter_reduce_"}
ACCUMULATING = {"index_put", "index_put_"}

# (file, function) -> (calls, reason)
ALLOWED = {
    ("solvers/sparse/ndchol.py", "ndchol_assemble"): (
        2, "each position written once: the padding diagonals and the real "
           "diagonals are distinct positions of the flat front buffer "
           "(tests/test_torch_fixed_order.py checks the maps are unique)"),
}


def _accumulates(call):
    for kw in call.keywords:
        if kw.arg == "accumulate":
            return not (isinstance(kw.value, ast.Constant) and kw.value.value is False)
    return (len(call.args) >= 3 and isinstance(call.args[2], ast.Constant)
            and call.args[2].value is True)


def scatter_calls(source):
    """(function, method, line) of every scatter-add call in ``source``; the
    function is the innermost enclosing def ("" at module level)."""
    out = []

    def visit(node, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            name = node.func.attr
            if name in SCATTERS or (name in ACCUMULATING and _accumulates(node)):
                out.append((fn, name, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(ast.parse(source), "")
    return out


def _port_calls():
    found = {}
    for base, _dirs, files in os.walk(ROOT):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            rel = os.path.relpath(path, ROOT).replace(os.sep, "/")
            with open(path, encoding="utf-8") as fh:
                calls = scatter_calls(fh.read())
            if calls:
                found[rel] = calls
    return found


def test_no_scatter_add_outside_the_fixed_order_sums():
    found = _port_calls()
    assert HOME in found, "the scan found no scatter in ops/segment_sum.py"
    bad = []
    for rel, calls in found.items():
        if rel == HOME:
            continue
        per_fn = {}
        for fn, name, line in calls:
            per_fn.setdefault(fn, []).append(f"{rel}:{line} {fn}: {name}")
        for fn, where in per_fn.items():
            allowed = ALLOWED.get((rel, fn))
            if allowed is None or len(where) > allowed[0]:
                bad.extend(where)
    assert not bad, ("scatter-adds outside ops/segment_sum.py (sum them through a "
                     "SegmentPlan, or allow-list them with a reason):\n" + "\n".join(bad))


def test_every_allowed_entry_is_still_there():
    found = _port_calls()
    for (rel, fn), (n, reason) in ALLOWED.items():
        assert reason
        got = [c for c in found.get(rel, []) if c[0] == fn]
        assert len(got) == n, f"{rel} {fn}: {len(got)} scatter-adds, the allow-list says {n}"


@pytest.mark.parametrize("snippet,hits", [
    ("def f(o, i, v):\n    o.index_add_(0, i, v)", 1),
    ("def f(o, i, v):\n    return o.index_add(0, i, v)", 1),
    ("def f(o, i, v):\n    return torch.index_add(o, 0, i, v)", 1),
    ("def f(o, i, v):\n    o.index_put_((i,), v, accumulate=True)", 1),
    ("def f(o, i, v):\n    o.index_put_((i,), v, True)", 1),
    ("def f(o, i, v):\n    o.index_put_((i,), v)", 0),
    ("def f(o, i, v):\n    o.index_put_((i,), v, accumulate=False)", 0),
    ("def f(o, i, v):\n    o.scatter_add_(0, i, v)", 1),
    ("def f(o, i, v):\n    return torch.scatter_add(o, 0, i, v)", 1),
    ("def f(o, i, v):\n    return o.scatter_reduce(0, i, v, 'sum')", 1),
    ("def f(o, i, v):\n    def g():\n        o.index_add_(0, i, v)\n    return g", 1),
])
def test_the_scan_sees_every_form(snippet, hits):
    calls = scatter_calls(snippet)
    assert len(calls) == hits
    if hits:
        assert calls[0][0] in ("f", "g")
