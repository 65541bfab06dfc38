"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py),
plus the tests of the state hand-over between the two packages
(rome_tpu_torch/graph/convert.py).

Every builder takes the package module (``rome_tpu`` or ``rome_tpu_torch``)
so both sides build the same graph from the same numpy seed.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
import rome_tpu_torch as T  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu_torch.graph.convert import graph_arrays_from_numpy  # noqa: E402


def grid_graph(mod, rows=6, cols=6, seed=0, frozen=()):
    """A 2D grid pose graph (odometry chain + cross links + x0 prior), as
    tests/test_ndchol.py builds it; ``mod`` is either package."""
    rng = np.random.default_rng(seed)
    fg = mod.FactorGraph()
    n = rows * cols
    for i in range(n):
        fg.add_variable(f"x{i}", mod.Pose2)
    fg.add_factor(["x0"], mod.PriorPose2(mod.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))

    def noisy(dx, dy, dth):
        return mod.MvNormal(
            [dx + rng.normal(0, 0.02), dy + rng.normal(0, 0.02),
             dth + rng.normal(0, 0.01)],
            [0.1, 0.1, 0.05],
        )

    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            if c + 1 < cols:
                fg.add_factor([f"x{i}", f"x{i+1}"], mod.Pose2Pose2(noisy(1, 0, 0)))
            if r + 1 < rows:
                fg.add_factor([f"x{i}", f"x{i+cols}"], mod.Pose2Pose2(noisy(0, 1, 0)))
    fg.init_all()
    for lbl in frozen:
        fg.variables[lbl].solvable = 0
    return fg


def reordered_graph(mod, src, order):
    """The graph ``src`` with its variables created in ``order`` (indices
    into src's variable order) and the same factors: other slots, so another
    connectivity of the same structure."""
    fg = mod.FactorGraph()
    labels = src._var_order
    for i in order:
        fg.add_variable(labels[i], src.variables[labels[i]].vtype)
    for fl in src._fct_order:
        f = src.factors[fl]
        fg.add_factor(list(f.variables), copy.copy(f), label=fl, graphinit=False)
    fg.init_all()
    return fg


def octagon_file(tmp_path, info=(100.0, 0.0, 0.0, 400.0, 0.0, 1000.0)):
    """8-pose ring, unit legs turned by pi/4 (tests/test_g2o.py:17-29)."""
    lines = []
    for i in range(8):
        j = (i + 1) % 8
        lines.append(
            f"EDGE_SE2 {i} {j} 1.0 0.0 0.7853981633974483 "
            + " ".join(str(v) for v in info)
        )
    p = tmp_path / "octagon.g2o"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def port_arrays(ga, dtype=None):
    """The port's GraphArrays built from the numpy views of a JAX-package
    GraphArrays (the same arrays, on the CPU)."""
    if dtype is None:
        dtype = torch.float64 if ga.dtype == jnp.float64 else torch.float32
    return graph_arrays_from_numpy(
        ga.type_names,
        ga.counts,
        {t: np.asarray(v) for t, v in ga.values0.items()},
        {t: np.asarray(v) for t, v in ga.free.items()},
        [
            dict(
                ftype=b.ftype.name,
                vslots=np.asarray(b.vslots),
                params={k: np.asarray(v) for k, v in b.params.items()},
                weight=np.asarray(b.weight),
            )
            for b in ga.batches
        ],
        var_labels=ga.var_labels,
        dtype=dtype,
        device="cpu",
    )


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_graph_arrays_from_numpy_carries_every_array(dtype):
    with jax.enable_x64():
        ga = jax_lower(grid_graph(R, 4, 4, frozen=("x3",)), dtype=getattr(jnp, dtype))
        tg = port_arrays(ga)
    assert tg.dtype == getattr(torch, dtype)
    assert tg.type_names == ga.type_names and tg.counts == ga.counts
    for t in ga.type_names:
        np.testing.assert_array_equal(tg.values0[t].numpy(), np.asarray(ga.values0[t]))
        np.testing.assert_array_equal(tg.free[t].numpy(), np.asarray(ga.free[t]))
    assert [b.ftype.name for b in tg.batches] == [b.ftype.name for b in ga.batches]
    for bt, bj in zip(tg.batches, ga.batches):
        assert bt.n == bj.n and bt.vtypes == bj.vtypes
        np.testing.assert_array_equal(bt.vslots.numpy(), np.asarray(bj.vslots))
        np.testing.assert_array_equal(bt.weight.numpy(), np.asarray(bj.weight))
        for k in bj.params:
            np.testing.assert_array_equal(bt.params[k].numpy(), np.asarray(bj.params[k]))


def test_grid_graph_builds_the_same_graph_in_both_packages():
    fa, fb = grid_graph(R, 3, 3, seed=5), grid_graph(T, 3, 3, seed=5)
    assert fa._fct_order == fb._fct_order and fa._var_order == fb._var_order
    for fl in fa._fct_order:
        for k, v in fa.factors[fl].params.items():
            np.testing.assert_array_equal(fb.factors[fl].params[k], v)
