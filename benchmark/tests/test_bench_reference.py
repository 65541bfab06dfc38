"""The frozen reference, its independence, the control and the module
check."""

import ast
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control, harness, judge  # noqa: E402
from benchmark import reference as R  # noqa: E402

SMALL = {
    "citygrid10k.resolve": {"config": {"world": {"n_poses": 400}}, "traffic": {"pool": 2}},
    "citygrid_fixedlag.stream": {"config": {"world": {"n_poses": 400}},
                                 "traffic": {"start": 300, "end": 350}},
}


def test_frozen_reference_reaches_the_stored_optimum():
    edges, n = R.parse_g2o_se2(os.path.join(ROOT, "data", "citygrid.g2o"))
    x, cost, _iters, converged = R.solve_lm(R.chordal_init(edges, n), edges,
                                            np.diag([10.0, 10.0, 20.0]))
    gt = np.load(os.path.join(ROOT, "data", "citygrid_gt.npz"))
    assert converged
    assert cost == pytest.approx(float(gt["final_cost"]), rel=1e-9)
    assert R.ate_values(x, gt["poses"]) < 1e-6


REFERENCE_SIDE = ["reference.py", "world.py", "judge.py", "control.py"] + sorted(
    os.path.join("controls", f) for f in os.listdir(os.path.join(ROOT, "benchmark", "controls"))
    if f.endswith(".py"))


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_reference_side_imports_nothing_of_the_program(name):
    tree = ast.parse(open(os.path.join(ROOT, "benchmark", name)).read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.partition(".")[0])
    assert not imported & {"rome_tpu_torch", "rome_tpu", "jax", "jaxlib", "torch"}


def test_module_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["rome_tpu_torch", "rome_tpu_torch.solvers", "jaxtyping",
                                      "benchmark.world", "flaxen"]) == []
    assert harness.forbidden_modules(["rome_tpu.solvers", "jax._src", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "rome_tpu"]


def test_bf16_rounds_to_nearest_even():
    assert R.bf16(1.0) == 1.0
    assert R.bf16(1.0 + 2 ** -9) == 1.0              # a tie goes to the even neighbour
    assert R.bf16(1.0 + 3 * 2 ** -9) == 1.0 + 2 ** -7
    assert R.bf16(1000.3) == 1000.0
    assert R.bf16(np.array([2049.0, -3.0])).tolist() == [2048.0, -3.0]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(workload):
    readings = control.control_readings(workload, 2**31 + 11, overrides=SMALL[workload])
    assert not judge.correct(readings)
    assert any("cost_excess" in k and v > 10 * lim for k, (v, lim) in readings.items())
