"""The metric arithmetic, the trace reduction and the manifest's rules."""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import roofline, stats  # noqa: E402
from benchmark.devtrace import DeviceTrace  # noqa: E402
from benchmark.harness import Run  # noqa: E402
from benchmark.manifest import NAME, UNIT, Manifest  # noqa: E402


def _run(walls, solve, **kw):
    reqs = [dict(wall_s=w, solve_time_s=s, poses=10_000, iterations=11,
                 new_solvers=0, k1={"normal": 12, "lin": 0}, k1_bytes={"normal": 4_898_260})
            for w, s in zip(walls, solve)]
    return Run(config={}, traffic={}, setup_s=30.0, window_s=sum(walls), requests=reqs, **kw)


def test_p95_is_over_every_request():
    walls = list(np.random.default_rng(0).gamma(4.0, 0.05, size=137))
    man = Manifest()
    got = man.reader("solve_p95_ms")(_run(walls, walls))
    assert got == pytest.approx(1e3 * np.percentile(walls, 95), rel=1e-12)
    assert man.reader("step_p95_ms")(_run(walls, walls)) == got
    assert man.reader("step_ms")(_run(walls, walls)) == pytest.approx(1e3 * np.mean(walls))


def test_rates_and_host_share():
    man = Manifest()
    run = _run([0.2, 0.3, 0.5], [0.15, 0.2, 0.45])
    assert man.reader("poses_per_s")(run) == pytest.approx(30_000 / 1.0)
    assert man.reader("host_ms.batch")(run) == pytest.approx(1e3 * 0.2 / 3)
    assert man.reader("lm_iters.batch")(run) == 11
    # the variants of one quantity share their quantity's reader
    assert man.reader_file("host_ms.fixedlag") == man.reader_file("host_ms.batch") == "host_ms"
    assert man.reader_file("solve_p95_ms") == "solve_p95_ms"
    assert man.reader("host_ms.fixedlag")(run) == man.reader("host_ms.batch")(run)
    empty = Run(config={}, traffic={}, setup_s=1.0)
    for name in ("poses_per_s", "solve_p95_ms", "host_ms.batch", "lm_iter_ms.batch",
                 "k1_normal_roofline.batch", "device_idle.fixedlag", "new_solvers.fixedlag"):
        assert man.reader(name)(empty) is None


def test_intervals_are_a_union_not_a_sum():
    ivs = [(0, 10), (5, 15), (20, 30), (22, 25), (30, 31)]
    assert stats.covered(ivs) == 26
    assert sum(e - s for s, e in ivs) == 34
    assert stats.clip(ivs, [(8, 21)]) == [(8, 10), (8, 15), (20, 21)]


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_trace_reduction():
    events = [
        _ev("user_annotation", "bench.request", 0, 100),
        _ev("user_annotation", "bench.request", 200, 100),
        _ev("user_annotation", "lm_x.iterate", 10, 50),
        _ev("cpu_op", "aten::copy_", 70, 20),
        _ev("kernel", "void pose2pose2_kernel<NormalEpilogue>", 10, 20, tid=7),
        _ev("kernel", "void other", 20, 30, tid=8),      # overlaps the first
        _ev("gpu_memcpy", "Memcpy HtoD", 210, 10, tid=7),
        _ev("kernel", "void pose2pose2_kernel<NormalEpilogue>", 400, 10, tid=7),  # outside
        _ev("gpu_user_annotation", "lm_x.iterate", 10, 40, tid=7),
    ]
    t = DeviceTrace(events)
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(50e-6)          # 10..50 and 210..220: union 40 + 10
    assert t.kernels("NormalEpilogue") == [pytest.approx(20e-6)]
    assert t.annotation_s("lm_x.iterate") == pytest.approx(40e-6)
    assert t.annotation_s("absent") is None
    b = t.breakdown()
    assert b["device_ops"][0] == ["void other", pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # 0..10 and 50..100 in the first request, 200..210 and 220..300 in the second
    assert sum(gaps.values()) == pytest.approx(150e-6)
    assert gaps["bench.request > aten::copy_"] == pytest.approx(50e-6)
    run = Run(config={}, traffic={}, setup_s=1.0, trace=t,
              traced=[dict(iterations=4, k1={"normal": 1}, k1_bytes={"normal": 67_000})])
    man = Manifest()
    assert man.reader("device_idle.fixedlag")(run) == pytest.approx(0.75)
    assert man.reader("lm_iter_ms.batch")(run) is None   # no range of that name
    share = man.reader("k1_normal_roofline.batch")(run)
    assert share == pytest.approx(100 * 67_000 / 3.35e12 / 20e-6)


def test_roofline_bytes():
    # K1 normal on citygrid's 13,085 factors and 10,000 poses; lin per factor
    assert roofline.k1_normal_bytes(13_085, 10_000) == 356 * 13_085 + 24 * 10_000
    assert roofline.k1_lin_bytes(40) == 6_400
    assert roofline.share_pct(3.35e6, 1e-6) == pytest.approx(100.0)
    assert roofline.share_pct(1, 0) is None


def test_manifest_rules():
    man = Manifest()
    assert man.problems() == []
    doc = man.doc
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in doc["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in doc["configs"]:
        assert 1 <= len(c["source"]) <= 200
    assert len(json.dumps(doc)) < 64 * 1024
    layers = {m["layer"] for m in doc["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)
