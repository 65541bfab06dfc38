"""The port's per-factor loop engine (``engine="loop"``: ``predict_belief``
per variable, its Gibbs products through K2/K3's plain versions here) on
the hexagonal graph at N = 50.

- Both engines pass the band check of tests/test_multimodal.py:117-136,
  scaled to N: at least 35 % of the particles (18 of 50) within +-3 m in x
  and y and +-0.3 rad in heading of each pose's ground truth, and of the
  landmark within 3 m.
- The loop and the batched engine agree by the mean symmetric k-NN KL over
  the poses < 1.0 (tools/bench_multimodal.py:74-95's gate).
- The port's loop engine agrees with the JAX package's (``engine="loop"``
  on the same graph) by the mean symmetric k-NN KL < 1.0, over the poses and
  over the landmark.
- From the same beliefs (the JAX loop solve's), the port's ``predict_belief``
  agrees with the JAX ``predict_belief`` by KL < 1.0, for a pose with a
  prior, a pose between two odometry factors and the landmark.
- ``predict_belief`` takes the adjacent factors by default, a given subset
  otherwise, and returns the belief when no factor sends a message.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import rome_tpu_torch as T  # noqa: E402
from rome_tpu.canonical.generators import generate_graph_hexagonal as jax_hexagonal  # noqa: E402
from rome_tpu.solvers.multimodal import predict_belief as jax_predict  # noqa: E402
from rome_tpu.solvers.multimodal import solve_graph_nonparametric as jax_solve  # noqa: E402
from rome_tpu_torch.canonical import generate_graph_hexagonal  # noqa: E402
from rome_tpu_torch.manifolds.base import SE2_, T2  # noqa: E402
from rome_tpu_torch.solvers.multimodal import predict_belief  # noqa: E402
from rome_tpu_torch.solvers.multimodal.metrics import symmetric_kl_knn  # noqa: E402
from rome_tpu_torch.utils.math import sym_rem_np  # noqa: E402

N = 50
IN_BAND = math.ceil(0.35 * N)
KL_GATE = 1.0


@pytest.fixture(scope="module")
def solved():
    out = {}
    for engine in ("loop", "batched"):
        fg = generate_graph_hexagonal(N=N)
        T.solve_graph_nonparametric(fg, sweeps=3, N=N, engine=engine, seed=11, device="cpu")
        out[engine] = fg
    return out


@pytest.fixture(scope="module")
def jax_loop():
    fg = jax_hexagonal(N=N)
    jax_solve(fg, sweeps=3, N=N, engine="loop", key=jax.random.PRNGKey(11))
    return fg


def _kl(man, a, b):
    return symmetric_kl_knn(man, torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b)))


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_hexagonal_bands(solved, engine):
    fg = solved[engine]
    for i in range(7):
        sim = fg.get_ppe(f"x{i}")
        pts = fg.variables[f"x{i}"].beliefs["default"]
        assert pts.shape == (N, 3) and pts.dtype == np.float32
        assert np.sum(np.abs(pts[:, 0] - sim[0]) < 3.0) >= IN_BAND, (i, "x")
        assert np.sum(np.abs(pts[:, 1] - sim[1]) < 3.0) >= IN_BAND, (i, "y")
        assert np.sum(np.abs(sym_rem_np(pts[:, 2] - sim[2])) < 0.3) >= IN_BAND, (i, "theta")
        np.testing.assert_allclose(fg.get_point(f"x{i}", "default")[:2], sim[:2], atol=3.0)
    lm = fg.variables["l1"].beliefs["default"]
    assert np.sum(np.linalg.norm(lm - np.array([20.0, 0.0]), axis=1) < 3.0) >= IN_BAND


def test_loop_agrees_with_batched_by_kl(solved):
    kl = np.mean([
        symmetric_kl_knn(SE2_, torch.as_tensor(solved["loop"].variables[l].beliefs["default"]),
                         torch.as_tensor(solved["batched"].variables[l].beliefs["default"]))
        for l in solved["loop"].ls(r"^x\d+$")
    ])
    assert kl < KL_GATE


@pytest.mark.parametrize("pattern,man", [(r"^x\d+$", SE2_), (r"^l\d+$", T2)],
                         ids=["poses", "landmark"])
def test_loop_engine_agrees_with_jax_by_kl(solved, jax_loop, pattern, man):
    port = solved["loop"]
    labels = jax_loop.ls(pattern)
    assert port.ls(pattern) == labels
    kl = np.mean([_kl(man, jax_loop.variables[l].beliefs["default"],
                      port.variables[l].beliefs["default"]) for l in labels])
    assert kl < KL_GATE, kl


@pytest.mark.parametrize("label,man", [("x0", SE2_), ("x3", SE2_), ("l1", T2)])
def test_predict_belief_agrees_with_jax_by_kl(jax_loop, label, man):
    ft = generate_graph_hexagonal(N=N)
    for l, rec in jax_loop.variables.items():
        ft.variables[l].beliefs["default"] = np.asarray(rec.beliefs["default"], np.float32)
    assert ft.neighbors(label) == jax_loop.neighbors(label)
    assert len(ft.neighbors(label)) >= 2
    want = np.asarray(jax_predict(jax_loop, label, key=jax.random.PRNGKey(3), N=N))
    got = predict_belief(ft, label, N=N, seed=3, device="cpu")
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _kl(man, want, got) < KL_GATE


def test_predict_belief_factor_selection(solved):
    fg = solved["loop"]
    x3 = fg.neighbors("x3")
    assert len(x3) == 2
    both = predict_belief(fg, "x3", N=N, seed=1, device="cpu")
    one = predict_belief(fg, "x3", factor_labels=x3[:1], N=N, seed=1, device="cpu")
    assert both.shape == one.shape == (N, 3) and torch.isfinite(both).all()
    # one message: the product is the message itself, drawn from the same seed
    want = T.approx_conv(fg, x3[0], "x3", N=N, seed=1, device="cpu")
    assert torch.equal(one, want)
    # no solvable factor: the current belief comes back
    for fl in x3:
        fg.set_solvable(fl, 0)
    try:
        np.testing.assert_array_equal(predict_belief(fg, "x3", N=N, device="cpu").numpy(),
                                      fg.variables["x3"].beliefs["default"])
    finally:
        for fl in x3:
            fg.set_solvable(fl, 1)
