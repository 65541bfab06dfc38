"""``dense_dim.fixedlag``: the ratio of the program's ``dense.dof`` and
``dense.factorizations`` counters over the window's steps, None where the
program keeps neither; and a small CPU run of the stream cell, whose every
step factors its 25 free poses alone, reads 75."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.harness import Run  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from rome_tpu_torch.utils import profiling  # noqa: E402

METRIC = "dense_dim.fixedlag"


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


def test_reads_the_counters_ratio(monkeypatch):
    read = Manifest().reader(METRIC)
    run = _ring(monkeypatch, [{"dense.factorizations": 3, "dense.dof": 225},
                              {"dense.factorizations": 1, "dense.dof": 78},
                              {"dense.factorizations": 2, "dense.dof": 150}])
    assert read(run) == pytest.approx((225 + 78 + 150) / 6)


def test_reads_nothing_without_the_counters(monkeypatch):
    read = Manifest().reader(METRIC)
    assert read(_ring(monkeypatch, [{"solver_cache.hit": 1}] * 3)) is None
    assert read(Run(config={}, traffic={}, setup_s=1.0)) is None
    monkeypatch.delattr(profiling, "roots")
    assert read(Run(config={}, traffic={}, setup_s=1.0, requests=[{"wall_s": 0.02}])) is None


def test_the_manifest_lists_it_in_the_stream_cell_only():
    man = Manifest()
    assert METRIC in {m["name"] for m in man.metrics("citygrid_fixedlag.stream", True)}
    assert METRIC not in {m["name"] for m in man.metrics("citygrid10k.resolve", True)}


def test_a_small_stream_factors_the_window_alone():
    over = {"config": {"world": {"n_poses": 400}},
            "traffic": {"start": 300, "end": 350, "trace_requests": 2}}
    result, _r = harness.run_cell("citygrid_fixedlag.stream", 2**31 + 57, 1.0, True,
                                  device="cpu", overrides=over)
    assert result["correct"], result["checks"]
    assert result["metrics"][METRIC]["value"] == 75.0
