"""The cell ``beehive100.np_resolve`` at a small size on the CPU (the look
for a card skipped): a sound run comes out correct; with the timed path
broken underneath (beliefs left at their seeded init, half of each belief's
particles replaced by init draws, one pose's particles moved 1 m) and for
the control (the reference in bfloat16), not correct. Its readers, the
K2/K3 bytes and the independence of its reference side."""

import ast
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control, harness, judge  # noqa: E402
from benchmark import roofline_k2k3 as RK  # noqa: E402
from benchmark.devtrace import DeviceTrace  # noqa: E402
from benchmark.harness import Run  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from rome_tpu_torch.solvers.multimodal.batched import BatchedNonparametricSolver as BNS  # noqa: E402

CELL = "beehive100.np_resolve"
# 10 poses (18 variables) at the cell's N = 100, four pooled reference solves
SMALL = {"config": {"graph": {"pose_count_target": 10}, "judge": {"reference_solves": 4}},
         "traffic": {"trace_requests": 1}}
SEED = 2**31 + 77


def _run(seconds=1.0, trace=False):
    result, _readings = harness.run_cell(CELL, SEED, seconds, trace, device="cpu",
                                         overrides=SMALL)
    return result


def test_sound_run_is_correct():
    result = _run(trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 1
    assert list(result)[-1] == "checks"
    m = result["metrics"]
    assert m["np_gn_solves.nonparam"]["value"] == 15          # 5 message streams x 3 sweeps
    assert m["np_messages_ms.nonparam"]["value"] > 0 and m["np_products_ms.nonparam"]["value"] > 0
    # the plain K2/K3 versions run on the CPU: no launch, no roofline
    assert "k2_draw_roofline.nonparam" not in m
    assert result["info"]["judged_requests"] == 3


def left_at_init(monkeypatch):
    monkeypatch.setattr(BNS, "sweep", lambda self, beliefs, gen, *a, **k: beliefs)


def half_init(monkeypatch):
    real = BNS.write_back

    def write_back(self, beliefs, slots=None):
        init = self.gather_beliefs()   # the records still hold the seeded init
        half = self.N // 2
        real(self, {t: torch.cat([b[:, :half], init[t][:, half:]], dim=1)
                    for t, b in beliefs.items()}, slots)

    monkeypatch.setattr(BNS, "write_back", write_back)


def moved(monkeypatch):
    real = BNS.write_back

    def write_back(self, beliefs, slots=None):
        real(self, beliefs, slots)
        rec = self.fg.variables["x5"]
        rec.beliefs[self.solve_key] = rec.beliefs[self.solve_key] + np.float32([1.0, 0.0, 0.0])

    monkeypatch.setattr(BNS, "write_back", write_back)


@pytest.mark.parametrize("fault", [left_at_init, half_init, moved], ids=lambda f: f.__name__)
def test_broken_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = _run()
    assert not result["correct"], result["checks"]


def test_control_is_not_correct():
    readings = control.control_readings(CELL, 2**31 + 11, overrides=SMALL)
    assert not judge.correct(readings)
    kl, lim = readings["belief_knn_kl"]
    assert kl > 2 * lim


def test_k2_k3_draw_bytes():
    # the kernel table's beehive-100 shapes: 4.49 MB and 3.20 MB a launch
    assert RK.k2_draw_bytes(101, 100, 100) == 4_485_612
    assert RK.k3_draw_bytes(74, 100, 100, 2) == 3_197_400


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_readers_of_the_cell():
    events = [
        _ev("user_annotation", "bench.request", 0, 100),
        _ev("kernel", "void (anonymous namespace)::gibbs_kernel<(anonymous namespace)::Se2Row, "
            "true>(float const*)", 10, 10, tid=7),
        _ev("kernel", "void (anonymous namespace)::gibbs_kernel<(anonymous namespace)::Se2Row, "
            "false>(float const*)", 30, 10, tid=7),
        _ev("kernel", "_ZN12_GLOBAL__N_112gibbs_kernelINS_9EuclidRowILi2EEELb1EEEvPKf", 50, 8,
            tid=7),
    ]
    traced = [dict(k2=2, k3=1, k2_bytes=4_485_612, k3_bytes=3_197_400)]
    run = Run(config={}, traffic={}, setup_s=1.0, trace=DeviceTrace(events), traced=traced)
    man = Manifest()
    assert man.reader("k2_draw_roofline.nonparam")(run) == pytest.approx(
        100 * 4_485_612 / 3.35e12 / 10e-6)
    assert man.reader("k3_draw_roofline.nonparam")(run) == pytest.approx(
        100 * 3_197_400 / 3.35e12 / 8e-6)
    assert man.reader("device_idle.nonparam")(run) == pytest.approx(1 - 28 / 100)
    # a program without the engine's spans (the parent) reads nothing
    empty = Run(config={}, traffic={}, setup_s=1.0, requests=[dict(wall_s=1.0, poses=101)],
                window_s=1.0)
    for name in ("np_messages_ms.nonparam", "np_products_ms.nonparam", "np_gn_solves.nonparam",
                 "k2_draw_roofline.nonparam", "device_idle.nonparam"):
        assert man.reader(name)(empty) is None
    assert man.reader("poses_per_s")(empty) == 101


@pytest.mark.parametrize("name", ["nonparametric_reference.py", "nonparametric_judge.py",
                                  "controls/nonparametric.py"])
def test_reference_side_imports_nothing_of_the_program(name):
    tree = ast.parse(open(os.path.join(ROOT, "benchmark", name)).read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.partition(".")[0])
    assert not imported & {"rome_tpu_torch", "rome_tpu", "jax", "jaxlib"}
