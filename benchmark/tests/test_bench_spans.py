"""The metrics that read the program's own spans, counters and device-phase
stamps (``benchmark/spans.py``): a small CPU run of each cell with
``trace=True`` reads every one of its cell's such metrics; a join broken
by one request record's latency reads none of them."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, spans  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from rome_tpu_torch.utils import profiling  # noqa: E402

SMALL = {
    "citygrid10k.resolve": {"config": {"world": {"n_poses": 400}},
                            "traffic": {"pool": 2, "trace_requests": 1}},
    "citygrid_fixedlag.stream": {"config": {"world": {"n_poses": 400}},
                                 "traffic": {"start": 300, "end": 350, "trace_requests": 2}},
}
SPAN_METRICS = {
    "citygrid10k.resolve": ["device_idle.batch", "lower_ms.batch", "write_back_ms.batch",
                            "cache_ms.batch", "chordal_ms.batch", "lm_linearize_ms.batch",
                            "lm_assemble_ms.batch", "lm_factorize_ms.batch", "lm_cg_ms.batch"],
    "citygrid_fixedlag.stream": ["lower_ms.fixedlag", "write_back_ms.fixedlag",
                                 "cache_ms.fixedlag", "cache_hit_share.fixedlag",
                                 "freeze_ms.fixedlag"],
}


@pytest.fixture(scope="module")
def runs():
    """(result, Run, the ring's roots after the run) of one small traced run
    per cell."""
    out = {}
    real = harness.Run
    for workload, over in SMALL.items():
        kept = []

        def keep(*a, **k):
            run = real(*a, **k)
            kept.append(run)
            return run

        harness.Run = keep
        try:
            result, _r = harness.run_cell(workload, 2**31 + 41, 1.5, True, device="cpu",
                                          overrides=over)
        finally:
            harness.Run = real
        out[workload] = (result, kept[0], profiling.roots())
    return out


@pytest.fixture
def ring(monkeypatch):
    """Make the ring read as it stood after ``workload``'s run."""
    def at(runs, workload):
        monkeypatch.setattr(profiling, "roots", lambda: list(runs[workload][2]))
        return runs[workload][:2]
    return at


def test_the_manifest_lists_each_span_metric_in_its_cell():
    man = Manifest()
    for workload, names in SPAN_METRICS.items():
        listed = {m["name"] for m in man.metrics(workload, True)}
        assert set(names) <= listed


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_every_span_metric_reads(runs, ring, workload):
    result, run = ring(runs, workload)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    missing = [n for n in SPAN_METRICS[workload] if n not in got]
    assert not missing, missing
    for name in SPAN_METRICS[workload]:
        value = got[name]["value"]
        assert value >= 0.0, (name, value)
        if "share" in name or "idle" in name:
            assert value <= 1.0, (name, value)
    pairs = spans.window(run)
    assert len(pairs) == len(run.requests)
    assert all(root.name == "bench.request" for _rec, root in pairs)


def test_phases_are_per_iteration(runs, ring):
    _result, run = ring(runs, "citygrid10k.resolve")
    iters = sum(r["iterations"] for r in run.requests)
    for phase in ("lm.linearize", "lm.assemble", "lm.factorize", "lm.cg", "lm.update"):
        assert spans.attr_sum(run, "calls", phase) == iters
    assert spans.attr_sum(run, "calls", "lm.chordal") == len(run.requests)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_broken_join_reads_nothing(runs, ring, workload):
    _result, run = ring(runs, workload)
    man = Manifest()
    rec = run.requests[len(run.requests) // 2]
    wall = rec["wall_s"]
    try:
        rec["wall_s"] = wall + 0.01
        for name in SPAN_METRICS[workload]:
            assert man.reader(name)(run) is None, name
    finally:
        rec["wall_s"] = wall
    assert spans.window(run) is not None


def test_nothing_to_read_without_the_ring(runs, monkeypatch):
    _result, run, _roots = runs["citygrid10k.resolve"]
    monkeypatch.delattr(profiling, "roots")
    man = Manifest()
    for name in SPAN_METRICS["citygrid10k.resolve"]:
        assert man.reader(name)(run) is None, name
