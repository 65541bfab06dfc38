"""``np_gn_replay_share.nonparam``: the program's ``np.gn_program.hit``
over its hits and misses in the window, None where the program keeps
neither; and a small CPU run of the nonparametric cell, whose set-up makes
every message's program, reads 1.0."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.harness import Run  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from rome_tpu_torch.utils import profiling  # noqa: E402

METRIC = "np_gn_replay_share.nonparam"
CELL = "beehive100.np_resolve"


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
    run = _ring(monkeypatch, [{"np.gn_program.hit": 15},
                              {"np.gn_program.hit": 10, "np.gn_program.miss": 5},
                              {"np.gn_program.hit": 15}])
    assert read(run) == pytest.approx(40 / 45)
    assert read(_ring(monkeypatch, [{"np.gn_program.hit": 15}] * 2)) == 1.0


def test_reads_nothing_without_the_counters(monkeypatch):
    read = Manifest().reader(METRIC)
    assert read(_ring(monkeypatch, [{"np.gn_solves": 15}] * 3)) is None
    assert read(Run(config={}, traffic={}, setup_s=1.0)) is None
    monkeypatch.delattr(profiling, "roots")
    assert read(Run(config={}, traffic={}, setup_s=1.0, requests=[{"wall_s": 0.02}])) is None


def test_the_manifest_lists_it_in_the_nonparametric_cell_only():
    man = Manifest()
    assert METRIC in {m["name"] for m in man.metrics(CELL, True)}
    for other in ("citygrid10k.resolve", "citygrid_fixedlag.stream"):
        assert METRIC not in {m["name"] for m in man.metrics(other, True)}


def test_a_small_run_only_replays_in_its_window():
    over = {"config": {"graph": {"pose_count_target": 10}, "judge": {"reference_solves": 4}},
            "traffic": {"trace_requests": 1}}
    result, _r = harness.run_cell(CELL, 2**31 + 91, 1.0, True, device="cpu", overrides=over)
    assert result["correct"], result["checks"]
    assert result["metrics"][METRIC]["value"] == 1.0
    assert result["metrics"]["np_gn_solves.nonparam"]["value"] == 15
