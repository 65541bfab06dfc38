"""The cell ``sphere2500.resolve_se3`` at a small size on the CPU (the look
for a card skipped): a sound run comes out correct and its traced run reads
its per-layer metrics; with the timed path broken underneath (the answers
left at dead reckoning, one pose moved 1 m, every rotation rounded to
bfloat16) and for the control (the reference in bfloat16), not correct.
Its readers on a synthetic run, the roofline's byte count against one
written out by hand, and the ATE's alignment."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control, harness, judge  # noqa: E402
from benchmark import roofline_se3 as RS  # noqa: E402
from benchmark import se3_reference as R  # noqa: E402
from benchmark.harness import Run  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from rome_tpu_torch.solvers import parametric as P  # noqa: E402
from rome_tpu_torch.utils import profiling  # noqa: E402

CELL = "sphere2500.resolve_se3"
# 4 laps of the cell's 50 poses, two graphs, the judge in this process
SMALL = {"config": {"world": {"laps": 4, "per_lap": 50}},
         "traffic": {"pool": 2, "trace_requests": 1, "workers": 1}}
SEED = 2**31 + 77
METRICS = ["lm_iters.se3", "lower_ms.se3", "write_back_ms.se3", "lm_linearize_ms.se3",
           "lm_factorize_ms.se3", "lm_cg_ms.se3", "device_idle.se3", "trial_linearize_ms.se3",
           "se3_lin_roofline.se3"]


def _run(seconds=1.0, trace=False):
    result, _readings = harness.run_cell(CELL, SEED, seconds, trace, device="cpu",
                                         overrides=SMALL)
    return result


def test_sound_run_is_correct_and_reads_its_metrics():
    result = _run(trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 1
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"cost_excess", "ate_to_opt_m"}
    m = result["metrics"]
    missing = [n for n in METRICS if n not in m]
    assert not missing, missing
    assert 0.0 < m["se3_lin_roofline.se3"]["value"] <= 100.0
    assert m["trial_linearize_ms.se3"]["value"] <= m["lm_linearize_ms.se3"]["value"]
    assert 0.0 <= m["device_idle.se3"]["value"] <= 1.0
    assert result["info"]["repeat_max_abs"] == 0.0
    assert result["info"]["reference_converged"]


def _rewrite(monkeypatch, change):
    """The solver's write-back, then ``change(points)`` on every Pose3's
    point array (n, 7) before it lands in the graph."""
    real = P.write_back

    def write_back(fg, ga, values, solve_key="parametric"):
        real(fg, ga, values, solve_key)
        labels = ga.var_labels["Pose3"]
        pts = np.stack([fg.variables[lbl].points[solve_key] for lbl in labels])
        pts = change(pts)
        for lbl, p in zip(labels, pts):
            fg.variables[lbl].points[solve_key] = p

    monkeypatch.setattr(P, "write_back", write_back)


def left_unchanged(monkeypatch):
    monkeypatch.setattr(P, "write_back", lambda *a, **k: None)


def one_pose_moved(monkeypatch):
    def move(pts):
        pts = pts.copy()
        pts[len(pts) // 2, 0] += 1.0
        return pts

    _rewrite(monkeypatch, move)


def rotations_bf16(monkeypatch):
    def rnd(pts):
        pts = pts.copy()
        pts[:, 3:] = R.bf16(pts[:, 3:]).numpy()
        return pts

    _rewrite(monkeypatch, rnd)


@pytest.mark.parametrize("fault", [left_unchanged, one_pose_moved, rotations_bf16],
                         ids=lambda f: f.__name__)
def test_broken_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = _run()
    assert not result["correct"], result["checks"]


def test_control_is_not_correct():
    readings = control.control_readings(CELL, SEED, overrides=SMALL)
    assert set(readings) == {"cost_excess", "ate_to_opt_m"}
    assert not judge.correct(readings), readings


class _Root(SimpleNamespace):
    def walk(self):
        yield self
        yield from self.children


def _synthetic(monkeypatch, stamped=True):
    """Two window requests of 20 and 30 ms with their root spans: 3 and 2
    LM iterations, lower 2 ms and write-back 1 ms each, the program's
    phases and span; without ``stamped`` no lm.trial_linearize (a program
    before that stamp)."""
    roots, reqs = [], []
    for k, (wall, it) in enumerate(((0.020, 3), (0.030, 2))):
        start = 10**9 * (k + 1)
        kids = [_Root(name="solve.lower", start=start, end=start + 2_000_000, children=[]),
                _Root(name="solve.write_back", start=start + 3_000_000,
                      end=start + 4_000_000, children=[])]
        ns = {"lm.linearize": it * 1_500_000, "lm.factorize": it * 2_000_000,
              "lm.cg": it * 3_000_000}
        if stamped:
            ns["lm.trial_linearize"] = it * 1_000_000
        roots.append(_Root(name="bench.request", start=start,
                           end=start + int(wall * 1e9) + 1000, children=kids,
                           attrs={"device_ns": ns, "calls": {p: it for p in ns},
                                  "program_device_ns": int(wall * 0.5e9)}))
        reqs.append({"wall_s": wall, "iterations": it, "poses": 200,
                     "trial_linearize_least_s": 2e-6})
    monkeypatch.setattr(profiling, "roots", lambda: roots)
    return Run(config={}, traffic={}, setup_s=1.0, window_s=0.05, requests=reqs)


def test_readers_on_a_synthetic_run(monkeypatch):
    man = Manifest()
    run = _synthetic(monkeypatch)
    want = {"lm_iters.se3": 2.5, "lower_ms.se3": 2.0, "write_back_ms.se3": 1.0,
            "lm_linearize_ms.se3": 1.5, "lm_factorize_ms.se3": 2.0, "lm_cg_ms.se3": 3.0,
            "device_idle.se3": 0.5, "trial_linearize_ms.se3": 1.0,
            # 2 us least over 1 ms a call
            "se3_lin_roofline.se3": 0.2}
    for name, value in want.items():
        assert man.reader(name)(run) == pytest.approx(value), name
    # the parent's program stamps no lm.trial_linearize: its readers read nothing
    run = _synthetic(monkeypatch, stamped=False)
    for name in METRICS:
        got = man.reader(name)(run)
        assert (got is None) == (name in ("trial_linearize_ms.se3", "se3_lin_roofline.se3")), name


def test_roofline_counts_one_factor_by_hand():
    # Pose3Pose3: 2 int64 slots 16, z 6 x f32 24, S 36 x f32 144, weight 4;
    # residual 6 x f64 48, two f32 6 x 6 Jacobians 288
    assert RS.factor_bytes(2) == 16 + 24 + 144 + 4 + 48 + 288 == 524
    # PriorPose3: one slot, one Jacobian
    assert RS.factor_bytes(1) == 8 + 24 + 144 + 4 + 48 + 144 == 372
    assert RS.trial_linearize_bytes(4949, 1, 2500) == 4949 * 524 + 372 + 2500 * 7 * 8
    flops_s = RS.trial_linearize_flops(4949, 1) / RS.FP32_FLOPS_PER_S
    bytes_s = RS.trial_linearize_bytes(4949, 1, 2500) / RS.HBM_BYTES_PER_S
    assert flops_s < bytes_s / 5 and RS.least_seconds(4949, 1, 2500) == bytes_s
    assert RS.share_pct(bytes_s, 2 * bytes_s) == pytest.approx(50.0)
    assert RS.share_pct(bytes_s, 0.0) is None


def test_ate_aligns_a_rigid_motion_away():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 50, (40, 3)), np.tile([1.0, 0, 0, 0], (40, 1))], axis=1)
    T = R.exp(torch.tensor([3.0, -2.0, 7.0, 0.3, -0.2, 0.5], dtype=torch.float64))
    moved = R.compose(T.expand(40, 7), torch.as_tensor(x)).numpy()
    assert R.ate(moved, x) < 1e-9
    moved[7, :3] += [0.0, 0.0, 2.0]
    assert R.ate(moved, x) > 0.2
