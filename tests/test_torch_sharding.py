"""The port's factor-sharded solve (rome_tpu_torch/parallel/sharding.py)
against the JAX package's, over real gloo process groups on the CPU.

The JAX side runs on the conftest's 8-device CPU mesh with ``ndev`` equal to
the port's world size, both in float64 (the JAX side under x64, so its
collectives are float64 too). The port's ranks are spawned processes
(tests/torch_ranks.py); every rank must return the same result.

- ``pad_batches_for_mesh``: bit-equal vslots, weights and params.
- One step on the 8-pose circle of tests/test_sharding.py:20-31 (lam 1e-6,
  PCG tol 1e-10) at worlds 1, 2 and 4 against JAX's at the same ndev: the
  same accept flag, cost0 and cost1 within 1e-6 relative, poses within
  1e-6 (float64 end to end: the two packages sum the scatter-adds in
  different orders, and 100 PCG iterations at tol 1e-10 carry that to a
  measured 3.2e-9 relative in cost1 at world 1); and against the
  port's single-device ``linear="pcg"`` step within
  tests/test_sharding.py:62-66's bounds.
- The LM solve of the 256-pose chain (``_build_chain_fixture(256, "local")``;
  with random closures neither package converges in 100 iterations): the
  same reason code as JAX at each world size, iterations within 4, final
  cost within 1e-6 relative; and world-size invariance: the same iteration
  count and code at worlds 1, 2 and 4.
- A fault of the reference: the JAX package's ``solve_distributed`` ignores
  ``max_iters`` (its fused loop runs to 100); the port's honours it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from rome_tpu.canonical.generators import generate_graph_circle  # noqa: E402
from rome_tpu.graph.lower import lower as jax_lower  # noqa: E402
from rome_tpu.parallel import sharding as JS  # noqa: E402
from rome_tpu_torch.graph.convert import graph_arrays_to_numpy as arrays_of  # noqa: E402
from rome_tpu_torch.parallel import sharding as TS  # noqa: E402
from rome_tpu_torch.parallel.distributed import spawn_ranks  # noqa: E402
from rome_tpu_torch.solvers.gauss_newton import GNOptions, ParametricSolver  # noqa: E402
from rome_tpu_torch.solvers.linearize import runtime_state  # noqa: E402
from torch_ranks import port_ga, sharding_rank  # noqa: E402

WORLDS = (1, 2, 4)


def to_f64(ga):
    """A JAX GraphArrays with every float array in float64 (call under x64)."""
    f = lambda v: jnp.asarray(v, jnp.float64)  # noqa: E731
    return dataclasses.replace(
        ga, dtype=jnp.float64,
        values0={t: f(v) for t, v in ga.values0.items()},
        free={t: f(v) for t, v in ga.free.items()},
        batches=[dataclasses.replace(b, weight=f(b.weight),
                                     params={k: f(v) for k, v in b.params.items()})
                 for b in ga.batches],
    )


def circle(dtype=jnp.float64):
    """tests/test_sharding.py's fixture: circle(8), perturbed by rng(1)."""
    fg = generate_graph_circle(8)
    fg.init_all()
    ga = jax_lower(fg, dtype=dtype)
    rng = np.random.default_rng(1)
    ga.values0 = {
        t: ga.manifolds[t].normalize(v + jnp.asarray(rng.normal(size=v.shape) * 0.2, dtype=dtype))
        for t, v in ga.values0.items()
    }
    return ga


def jmesh(ndev):
    return Mesh(np.array(jax.devices()[:ndev]), ("f",))


@pytest.fixture(scope="module")
def runs():
    """Per world size: the port's rank results and the JAX package's."""
    with jax.enable_x64():
        circ = circle()
        chain = to_f64(ge._build_chain_fixture(256, "local"))
        out = {}
        for w in WORLDS:
            ranks = spawn_ranks(sharding_rank, w, args=(arrays_of(circ), arrays_of(chain)),
                                device="cpu")
            step, ga_p = JS.make_sharded_gn_step(circ, jmesh(w), pcg_iters=100, pcg_tol=1e-10)
            v1, c0, c1, g, ok = step(ga_p.values0, jnp.asarray(1e-6, jnp.float64))
            jstep = dict(values={t: np.asarray(v) for t, v in v1.items()}, c0=float(c0),
                         c1=float(c1), gnorm=float(g), ok=bool(ok))
            step, ga_p = JS.make_sharded_gn_step(chain, jmesh(w), pcg_iters=100)
            _v, it, code, fc = step.solve(ga_p.values0, jnp.asarray(1e-4, jnp.float64))
            out[w] = dict(ranks=ranks, step=jstep,
                          solve=dict(iterations=int(it), code=int(code), final_cost=float(fc)))
        return out, circ, chain


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_pad_batches_bit_equal(n_shards):
    ga = circle(jnp.float32)
    jp = JS.pad_batches_for_mesh(ga, n_shards)
    tp = TS.pad_batches_for_mesh(port_ga(arrays_of(ga), torch.float32), n_shards)
    for bj, bt in zip(jp.batches, tp.batches):
        assert bt.n == bj.n and bt.n % n_shards == 0
        np.testing.assert_array_equal(bt.vslots.numpy(), np.asarray(bj.vslots))
        np.testing.assert_array_equal(bt.weight.numpy(), np.asarray(bj.weight))
        assert sorted(bt.params) == sorted(bj.params)
        for k in bj.params:
            np.testing.assert_array_equal(bt.params[k].numpy(), np.asarray(bj.params[k]))


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        a, b = ranks[0][key], r[key]
        for t in a["values"]:
            np.testing.assert_array_equal(a["values"][t], b["values"][t])
        assert {k: v for k, v in a.items() if k != "values"} == \
            {k: v for k, v in b.items() if k != "values"}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_jax(runs, world):
    out, circ, _chain = runs
    ranks, j = out[world]["ranks"], out[world]["step"]
    _same_on_every_rank(ranks, "step")
    t = ranks[0]["step"]
    assert t["ok"] and j["ok"]
    assert abs(t["c0"] - j["c0"]) <= 1e-6 * max(1.0, abs(j["c0"]))
    assert abs(t["c1"] - j["c1"]) <= 1e-6 * max(1.0, abs(j["c1"]))
    for k in j["values"]:
        np.testing.assert_allclose(t["values"][k], j["values"][k], atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_single_device_pcg(runs, world):
    """tests/test_sharding.py:62-66's bounds against the port's own
    single-device pcg step."""
    out, circ, _chain = runs
    t = out[world]["ranks"][0]["step"]
    ga = port_ga(arrays_of(circ))
    solver = ParametricSolver(ga, GNOptions(linear="pcg", pcg_iters=100, pcg_tol=1e-10))
    trial, c0, c1, *_ = solver.step(ga.values0, np.float64(1e-6), runtime_state(ga))
    assert abs(t["c0"] - c0) < 1e-3 * max(1.0, abs(c0))
    assert abs(t["c1"] - c1) < 2e-2 * max(1.0, abs(c1))
    for k in trial:
        np.testing.assert_allclose(t["values"][k], trial[k].numpy(), atol=5e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_matches_jax(runs, world):
    out, _circ, _chain = runs
    ranks, j = out[world]["ranks"], out[world]["solve"]
    _same_on_every_rank(ranks, "solve")
    t = ranks[0]["solve"]
    assert t["reason"] == ParametricSolver._REASONS[j["code"]], (t, j)
    assert abs(t["iterations"] - j["iterations"]) <= 4, (t["iterations"], j["iterations"])
    assert abs(t["final_cost"] - j["final_cost"]) <= 1e-6 * max(1.0, j["final_cost"])
    # per LM iteration at least the first reduction and the trial cost,
    # then the final cost
    assert t["collectives"] >= 2 * t["iterations"] + 1


def test_world_size_invariance(runs):
    """Float64 reductions before the all_reduce: the LM trajectory does not
    depend on the world size."""
    out, _circ, _chain = runs
    rows = {w: out[w]["ranks"][0]["solve"] for w in WORLDS}
    assert len({(r["iterations"], r["reason"]) for r in rows.values()}) == 1, \
        {w: (r["iterations"], r["reason"]) for w, r in rows.items()}
    costs = [r["final_cost"] for r in rows.values()]
    assert max(costs) <= min(costs) * (1 + 1e-9) + 1e-15


def test_max_iters_is_honoured_unlike_the_reference(runs):
    """The JAX package's solve_distributed drops max_iters (its fused loop
    hardcodes 100 iterations): asked for one iteration, it runs more. The
    port's runs exactly one."""
    out, circ, _chain = runs
    with jax.enable_x64():
        _v, stats = JS.solve_distributed(circ, jmesh(2), max_iters=1)
    assert stats["iterations"] > 1
    assert all(r["max_iters_1"] == 1 for w in WORLDS for r in out[w]["ranks"])
