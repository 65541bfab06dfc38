"""The port's distributed runtime (rome_tpu_torch/parallel/distributed.py) and
top-level entry points (rome_tpu_torch/graft_entry.py), on the CPU over real
gloo process groups (ranks spawned from tests/torch_ranks.py).

- Without a process group: ``init_distributed`` returns False, the global
  mesh has one rank and its all-reduce is a counted no-op; a world of more
  than one rank without a rendezvous, and ``dryrun_multichip`` at a world
  size the group does not have, raise.
- In a world-2 group: ``solve_graph_parametric`` with ``multiproc`` takes the
  distributed route and equals ``solve_graph_distributed`` bit for bit on
  every rank; ``dryrun_multichip(2)`` passes its own assertions (varpart
  and factor-sharded solves of the 1,024-pose chain below 1e-3 of the start
  cost, varpart converged). In a world-1 group ``multiproc`` solves as usual
  and ``dryrun_multichip(1)`` passes.
- An exception in one rank ends the spawn with an error (no hang).
- ``graph_arrays_to_numpy`` (what crosses to the ranks): the JAX package's
  lowered chain through ``graph_arrays_from_numpy`` and back gives the same
  arrays bit for bit.
- ``graft_entry``: ``_build_chain_fixture`` builds the JAX package's graph
  (same slots; measurements and values within 1e-3, angles modulo 2 pi: the
  JAX package composes the poses in float32, the port in float64, and the
  two drift apart by up to 1.6e-4 at 300 poses), and ``entry()``'s LM step
  matches the JAX package's on the same fixture (cost0 and cost1 within
  1e-5 relative: float32 graph, the port sums the cost in float64).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from rome_tpu_torch import graft_entry  # noqa: E402
from rome_tpu_torch.graph.convert import (  # noqa: E402
    graph_arrays_from_numpy, graph_arrays_to_numpy,
)
from rome_tpu_torch.parallel import distributed as D  # noqa: E402
from torch_ranks import distributed_rank, failing_rank  # noqa: E402


def test_single_process_runtime(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed(device="cpu") is False
    mesh = D.global_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.device, mesh.shape) == (1, 0, torch.device("cpu"),
                                                                {"f": 1})
    x = torch.ones(3)
    assert mesh.all_reduce(x) is x and mesh.collectives == 1
    np.testing.assert_array_equal(x.numpy(), 1.0)
    with pytest.raises(ValueError, match="init_method"):
        D.init_distributed(world_size=2, device="cpu")
    with pytest.raises(ValueError, match="world 2"):
        graft_entry.dryrun_multichip(2, device="cpu")


@pytest.fixture(scope="module")
def worlds():
    return {w: D.spawn_ranks(distributed_rank, w, args=(True,), device="cpu") for w in (1, 2)}


def test_multiproc_takes_the_distributed_route(worlds):
    ranks = worlds[2]
    for r in ranks:
        assert r["mesh"] == [(("f", 2),), (("f", 2),)]
        assert r["stats"][0] == r["stats"][1]
        for lbl, p in r["points"][0].items():
            np.testing.assert_array_equal(p, r["points"][1][lbl])
            np.testing.assert_array_equal(p, ranks[0]["points"][0][lbl])
    assert ranks[0]["stats"][0]["converged"]


def test_multiproc_in_a_world_of_one_solves_as_usual(worlds):
    (r,) = worlds[1]
    assert r["mesh"][0] is None and r["stats"][0].converged


@pytest.mark.parametrize("world", [1, 2])
def test_dryrun_multichip(worlds, world):
    for r in worlds[world]:
        d = r["dryrun"]
        assert d["varpart"]["converged"]
        assert d["varpart"]["final_cost"] < d["cost_start"] * 1e-3
        assert d["factor_sharded"]["final_cost"] < d["cost_start"] * 1e-3
        assert d == worlds[world][0]["dryrun"] or d["varpart"]["iterations"] == \
            worlds[world][0]["dryrun"]["varpart"]["iterations"]


def test_a_failing_rank_fails_the_spawn():
    """The spawn names the rank that raised first with its own error, not its
    peer whose all-reduce then lost the connection; well before the
    timeout."""
    t0 = time.time()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 raised first.*rank 1 failed"):
        D.spawn_ranks(failing_rank, 2, device="cpu", timeout_s=60.0)
    assert time.time() - t0 < 60.0


@pytest.mark.parametrize("closures", ["random", "local"])
def test_chain_fixture_is_the_jax_graph(closures):
    gj = ge._build_chain_fixture(300, closures)
    gt = graft_entry._build_chain_fixture(300, closures, device="cpu")
    assert gt.type_names == gj.type_names and gt.counts == gj.counts
    assert [b.ftype.name for b in gt.batches] == [b.ftype.name for b in gj.batches]

    def close(a, b):
        d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi  # angles modulo 2 pi
        assert np.abs(d).max() < 1e-3

    for bt, bj in zip(gt.batches, gj.batches):
        np.testing.assert_array_equal(bt.vslots.numpy(), np.asarray(bj.vslots))
        close(bt.params["z"].numpy(), bj.params["z"])
        np.testing.assert_allclose(bt.params["sqrt_info"].numpy(),
                                   np.asarray(bj.params["sqrt_info"]), rtol=1e-6)
    close(gt.values0["Pose2"].numpy(), gj.values0["Pose2"])


def test_entry_step_matches_jax():
    fn, args = ge.entry()
    out = fn(*args)
    c0j, c1j, okj = float(out[2]), float(out[3]), bool(out[6])
    step, targs = graft_entry.entry(device="cpu")
    _trial, c0, c1, *_ = step(*targs)
    assert okj and c1 < c0
    assert abs(c0 - c0j) <= 1e-5 * c0j and abs(c1 - c1j) <= 1e-5 * max(1.0, c1j)


def test_graph_arrays_round_trip():
    gj = ge._build_chain_fixture(120, "local")
    arrays = graph_arrays_to_numpy(gj)
    ga = graph_arrays_from_numpy(**arrays, device="cpu")
    again = graph_arrays_to_numpy(ga)
    assert again["type_names"] == arrays["type_names"] and again["counts"] == arrays["counts"]
    assert again["var_labels"] == arrays["var_labels"]
    for t in arrays["type_names"]:
        np.testing.assert_array_equal(again["values0"][t], arrays["values0"][t])
        np.testing.assert_array_equal(again["free"][t], arrays["free"][t])
    for a, b in zip(again["batches"], arrays["batches"]):
        assert a["ftype"] == b["ftype"] and sorted(a["params"]) == sorted(b["params"])
        np.testing.assert_array_equal(a["vslots"], b["vslots"])
        np.testing.assert_array_equal(a["weight"], b["weight"])
        for k in b["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
