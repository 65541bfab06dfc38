"""Whole runs of each cell at a small size on the CPU (the look for a card
skipped): sound, they come out correct; with the timed path broken
underneath, not correct. The faults a solve cell can have: a solve that
leaves its state unchanged, half of a factor batch left out, and an answer
altered where it is written. (No cell crosses chips.)"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from rome_tpu_torch.solvers import parametric as P  # noqa: E402

SMALL = {
    "citygrid10k.resolve": {"config": {"world": {"n_poses": 400}},
                            "traffic": {"pool": 2, "trace_requests": 1}},
    "citygrid_fixedlag.stream": {"config": {"world": {"n_poses": 400}},
                                 "traffic": {"start": 300, "end": 350, "trace_requests": 2}},
}
SEED = 2**31 + 77


def _run(workload, seconds=1.5, trace=False):
    result, _readings = harness.run_cell(workload, SEED, seconds, trace, device="cpu",
                                         overrides=SMALL[workload])
    return result


def unchanged(monkeypatch):
    monkeypatch.setattr(P, "write_back", lambda *a, **k: None)


def half_batch(monkeypatch):
    real = P.lower

    def lower(*a, **k):
        ga = real(*a, **k)
        for b in ga.batches:
            b.weight[b.weight.shape[0] // 2:] = 0.0
        return ga

    monkeypatch.setattr(P, "lower", lower)


def altered(monkeypatch):
    real = P.write_back

    def write_back(fg, ga, values, solve_key="parametric"):
        real(fg, ga, values, solve_key)
        label = ga.var_labels["Pose2"][ga.counts["Pose2"] - 3]
        if label in fg.variables and fg.variables[label].solvable > 0:
            fg.variables[label].points[solve_key] = fg.variables[label].points[solve_key] + [
                1.0, 0.0, 0.0]

    monkeypatch.setattr(P, "write_back", write_back)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    result = _run(workload, trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 1
    assert list(result)[-1] == "checks"
    assert result["metrics"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(workload)
    assert not result["correct"], result["checks"]
