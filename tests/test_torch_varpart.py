"""The port's owner-computes variable partition (rome_tpu_torch/parallel/
varpart.py) against the JAX package's, over real gloo process groups on the
CPU (ranks spawned from tests/torch_ranks.py).

- ``VarPartitionPlan``: every routing table equal to the JAX plan's on the
  same lowered ``_build_chain_fixture(256)`` at 2 and 4 ranks, and the
  scatter / gather round trip.
- The LM solve of tests/test_varpart.py's 256-pose chain in float64 at world
  2 against the JAX package's at ndev 2 (x64): the same reason code,
  iterations within 4, and test_varpart.py's bound (the single-device cost
  of the result <= 1.01 x the port's dense optimum + 1e-6); world-size
  invariance: the same iterations and code at worlds 1, 2 and 4.
- In float32 with test_varpart.py's ftol 3e-7 at worlds 1, 2 and 4: its
  gates (converged, final cost < 1 % of the start, the same cost bound, the
  16 poses by the prior within 0.2 m of the dense optimum). The port's
  Schur step is float64 in both cases (the JAX package's is in the graph
  dtype): a rank's dense system is 8 (D_own + D_sep)² bytes, 4.6 MB here and
  7.2 GB for a 10,000-pose chain on one rank, which the card holds.
- The probes: the start cost equals the single-device cost within 1e-12
  relative; the owner blocks of the gradient through the separator-tail
  reduction equal the single-device gradient within 1e-9.
- The collective census: per LM iteration 4 + 2 x types all-reduces (the
  JAX package's count), then the final cost (1 + types) and the gather
  (types); every rank returns the same values.
- The Schur step's ridge (1e-6 on the Jacobi-scaled systems, the JAX
  package's) sets the LM iteration count on the corridor chain: with it
  the port takes the JAX package's count (within 1), without it at most
  the single-device ndchol's + 2. ``ridge_study(n_poses, ndev, port)``
  gives the counts at any size (at 10,000 poses pass port=False: the
  port's world-1 system is 7.2 GB).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from rome_tpu.parallel.varpart import VarPartitionPlan as JPlan  # noqa: E402
from rome_tpu.parallel.varpart import make_varpart_solver as j_varpart  # noqa: E402
from rome_tpu_torch.graph.convert import graph_arrays_to_numpy as arrays_of  # noqa: E402
from rome_tpu_torch.parallel.distributed import global_mesh, spawn_ranks  # noqa: E402
from rome_tpu_torch.parallel import varpart  # noqa: E402
from rome_tpu_torch.parallel.varpart import VarPartitionPlan  # noqa: E402
from rome_tpu_torch.solvers.gauss_newton import GNOptions, ParametricSolver  # noqa: E402
from rome_tpu_torch.solvers.linearize import (  # noqa: E402
    cost_at, gradient_from_lins, linearize_all,
)
from test_torch_sharding import to_f64  # noqa: E402
from test_varpart import _chain_fixture  # noqa: E402
from torch_ranks import port_ga, varpart_rank  # noqa: E402

WORLDS = (1, 2, 4)
CASES = (("float64", 1e-8), ("float32", 3e-7))


@pytest.mark.parametrize("ndev", [2, 4])
def test_plan_arrays_equal(ndev):
    gaj = ge._build_chain_fixture(256)
    jp = JPlan(gaj, ndev)
    tp = VarPartitionPlan(port_ga(arrays_of(gaj), torch.float32), ndev)
    assert tp.n_loc == jp.n_loc and tp.n_sep == jp.n_sep
    for name in ("bounds", "owner", "sep_ids", "sep_real", "sep_src", "sep_own", "own2sep",
                 "own_gids", "own_valid"):
        for t in gaj.type_names:
            np.testing.assert_array_equal(getattr(tp, name)[t], getattr(jp, name)[t], err_msg=name)
    for a, b in zip(tp.fdev, jp.fdev):
        np.testing.assert_array_equal(a, b)
    for fa, fb in zip(tp.fb_local, jp.fb_local):
        assert fa["vtypes"] == fb["vtypes"] and fa["ftype"].name == fb["ftype"].name
        np.testing.assert_array_equal(fa["vslots"], fb["vslots"])
        np.testing.assert_array_equal(fa["weight"], fb["weight"])
        assert sorted(fa["params"]) == sorted(fb["params"])
        for k in fb["params"]:
            np.testing.assert_array_equal(fa["params"][k], fb["params"][k], err_msg=k)
    assert tp.comms_note() == jp.comms_note()
    vals = tp.gather_values(tp.scatter_values(tp.ga.values0))
    for t in gaj.type_names:
        np.testing.assert_array_equal(vals[t], np.asarray(gaj.values0[t]))
    assert sum(len(d) for d in tp.fdev) == sum(b.n for b in gaj.batches)


@pytest.fixture(scope="module")
def runs():
    """The port's ranks at worlds 1, 2 and 4 (both cases), the JAX solve at
    ndev 2 (float64), and each case's graph and dense optimum."""
    with jax.enable_x64():
        chain32 = _chain_fixture(256)
        chain = to_f64(chain32)
        ranks = {w: spawn_ranks(varpart_rank, w, args=(arrays_of(chain), CASES), device="cpu")
                 for w in WORLDS}
        solve, _plan = j_varpart(chain, Mesh(np.array(jax.devices()[:2]), ("v",)),
                                 max_iters=60)
        _v, jst = solve(lam0=1e-4)
    refs = {}
    for dtype, _ftol in CASES:
        ga = port_ga(arrays_of(chain), getattr(torch, dtype))
        v_ref, st_ref = ParametricSolver(
            ga, GNOptions(linear="dense", max_iters=60, lam0=1e-4)).solve()
        assert st_ref.converged
        refs[dtype] = (ga, v_ref, st_ref)
    return ranks, jst, refs


def _row(runs, world, dtype):
    ranks = runs[0][world]
    i = [c[0] for c in CASES].index(dtype)
    for r in ranks[1:]:
        for t in r[i]["values"]:
            np.testing.assert_array_equal(r[i]["values"][t], ranks[0][i]["values"][t])
        assert r[i]["iterations"] == ranks[0][i]["iterations"]
    return ranks[0][i], [r[i] for r in ranks]


def _single_cost(ga, values):
    return float(cost_at(ga, {t: torch.as_tensor(v).to(ga.dtype) for t, v in values.items()},
                         accum_dtype=torch.float64))


def test_varpart_solve_matches_jax(runs):
    t, _all = _row(runs, 2, "float64")
    j = runs[1]
    assert t["reason"] == j["reason"], (t["reason"], j["reason"])
    assert abs(t["iterations"] - j["iterations"]) <= 4, (t["iterations"], j["iterations"])
    ga, _v_ref, st_ref = runs[2]["float64"]
    assert _single_cost(ga, t["values"]) <= st_ref.final_cost * 1.01 + 1e-6


def test_world_size_invariance(runs):
    rows = {w: _row(runs, w, "float64")[0] for w in WORLDS}
    assert len({(r["iterations"], r["reason"]) for r in rows.values()}) == 1, \
        {w: (r["iterations"], r["reason"]) for w, r in rows.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_float32_solve_meets_test_varpart_gates(runs, world):
    t, _all = _row(runs, world, "float32")
    ga, v_ref, st_ref = runs[2]["float32"]
    cost0 = _single_cost(ga, {k: v.numpy() for k, v in ga.values0.items()})
    assert t["converged"], t["reason"]
    assert t["final_cost"] < cost0 * 0.01
    assert _single_cost(ga, t["values"]) <= st_ref.final_cost * 1.01 + 1e-6
    for k in t["values"]:
        np.testing.assert_allclose(t["values"][k][:16], v_ref[k][:16].numpy(), atol=0.2)


@pytest.mark.parametrize("world", WORLDS)
def test_probes_match_single_device(runs, world):
    ga, _v, _st = runs[2]["float64"]
    lins = linearize_all(ga, ga.values0)
    g = gradient_from_lins(ga, lins)
    c = float(cost_at(ga, ga.values0))
    _t, rows = _row(runs, world, "float64")
    for r in rows:
        assert abs(r["probes"]["lin_cost"] - c) <= 1e-12 * c
        assert np.isfinite(r["probes"]["schur_full"])
    for t in ga.type_names:
        got = np.concatenate([
            r["probes"]["grad"][t][: r["bounds"][t][rk + 1] - r["bounds"][t][rk]]
            for rk, r in enumerate(rows)])
        np.testing.assert_allclose(got, g[t].numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_collective_census(runs, world):
    ga = runs[2]["float64"][0]
    ntypes = len(ga.type_names)
    for dtype, _ftol in CASES:
        t, _all = _row(runs, world, dtype)
        assert t["collectives"] == t["iterations"] * (4 + 2 * ntypes) + 2 * ntypes + 1
        assert t["schur_solves"] == t["iterations"]
        assert t["comms"] == VarPartitionPlan(ga, world).comms_note()


def ridge_study(n_poses, ndev=4, port=True):
    """LM iterations and final costs on ``_build_chain_fixture(n_poses,
    "local")`` in float64: the JAX varpart at ``ndev`` devices (x64), and
    with ``port`` the port's varpart at world 1 with the reference's ridge
    (``varpart.SCHUR_RIDGE``) and with 0, and the port's single-device
    ndchol."""
    with jax.enable_x64():
        chain = to_f64(ge._build_chain_fixture(n_poses, "local"))
        solve, _plan = j_varpart(chain, Mesh(np.array(jax.devices()[:ndev]), ("v",)),
                                 max_iters=60)
        _v, st = solve(lam0=1e-4)
    out = {"jax": (int(st["iterations"]), float(st["final_cost"]))}
    if port:
        ga = port_ga(arrays_of(chain), torch.float64)
        ridge = varpart.SCHUR_RIDGE
        try:
            for key, r in (("port_ridge", ridge), ("port_no_ridge", 0.0)):
                varpart.SCHUR_RIDGE = r
                solve, _plan = varpart.make_varpart_solver(ga, global_mesh("v", "cpu"),
                                                           max_iters=60, device="cpu")
                _v, st = solve(lam0=1e-4)
                out[key] = (st["iterations"], st["final_cost"])
        finally:
            varpart.SCHUR_RIDGE = ridge
        _v, st = ParametricSolver(ga, GNOptions(linear="ndchol", max_iters=100,
                                                lam0=1e-4)).solve()
        out["ndchol"] = (st.iterations, st.final_cost)
    return out


def test_ridge_sets_the_iteration_count():
    r = ridge_study(1000)
    assert abs(r["port_ridge"][0] - r["jax"][0]) <= 1, r
    assert r["port_no_ridge"][0] <= r["ndchol"][0] + 2, r
    assert r["port_no_ridge"][0] * 1.5 <= r["port_ridge"][0], r
    assert r["port_no_ridge"][1] < r["port_ridge"][1], r
