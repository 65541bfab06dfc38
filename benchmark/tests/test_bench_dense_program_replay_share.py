"""``dense_program_replay_share.fixedlag``: the program's
``dense_program.hit`` over its hits and misses in the window, None where
the program keeps neither (the CPU, which solves dense32 by ``solve_host``,
and a program without the dense32 device program); listed in the stream
cell only."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import Run  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from rome_tpu_torch.utils import profiling  # noqa: E402

METRIC = "dense_program_replay_share.fixedlag"
CELL = "citygrid_fixedlag.stream"


def _ring(monkeypatch, attrs):
    """A Run of one request per entry of ``attrs`` and a ring whose
    ``bench.request`` roots hold those attributes and last each request's
    latency."""
    roots, reqs = [], []
    for i, a in enumerate(attrs):
        root = profiling.Span("bench.request", None, dict(a))
        root.start, root.end = 10**9 * i, 10**9 * i + 2 * 10**7
        roots.append(root)
        reqs.append({"wall_s": 0.02})
    monkeypatch.setattr(profiling, "roots", lambda: list(roots))
    return Run(config={}, traffic={}, setup_s=1.0, window_s=0.02 * len(reqs), requests=reqs)


def test_reads_hits_over_lookups(monkeypatch):
    read = Manifest().reader(METRIC)
    run = _ring(monkeypatch, [{"dense_program.hit": 1}, {"dense_program.miss": 1},
                              {"dense_program.hit": 1, "solver_cache.miss": 1}])
    assert read(run) == pytest.approx(2 / 3)
    assert read(_ring(monkeypatch, [{"dense_program.hit": 1}] * 4)) == 1.0


def test_reads_nothing_without_the_counters(monkeypatch):
    read = Manifest().reader(METRIC)
    assert read(_ring(monkeypatch, [{"dense.factorizations": 3}] * 3)) is None
    assert read(Run(config={}, traffic={}, setup_s=1.0)) is None
    monkeypatch.delattr(profiling, "roots")
    assert read(Run(config={}, traffic={}, setup_s=1.0, requests=[{"wall_s": 0.02}])) is None


def test_the_manifest_lists_it_in_the_stream_cell_only():
    man = Manifest()
    assert METRIC in {m["name"] for m in man.metrics(CELL, True)}
    for other in ("citygrid10k.resolve", "beehive100.np_resolve"):
        assert METRIC not in {m["name"] for m in man.metrics(other, True)}
