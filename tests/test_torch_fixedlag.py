"""chip_smoke.py's phase 16 stream (``fixedlag_citygrid_3500``) on the CPU,
through both packages: tools/torch/incremental_bench.py's time-ordered
citygrid stream, cut at its solves (``solve_chunks``: every 10 poses) and
each pose started by ``add_instruction`` (its predecessor's estimate
composed with the odometry edge); before each solve ``fifo_freeze`` with
window 25, then tools/incremental_bench.py's solve (``max_iters=30``, no
chordal init, shape buckets). The port runs ``run_incremental``; the JAX
package runs the same chunks through its own ``parse_g2o_instruction``.

- 300 poses in float64 (JAX under x64): every step's frozen set equal,
  every pose within 1e-8 m and the costs within 1e-9 relative (to
  max(1, cost), as LM's ftol test). Iteration
  counts are recorded, not held (LM's stopping tests sit at f64 noise).
  Where the two packages' LM took a different accept/reject decision on a
  trial whose cost differs from the current one at f64 noise, the step
  length of the first such trial of that solve (after it the two histories
  differ, so later trials are not paired) may be added to the 1e-8 m; that
  slack must be at most 1e-6 m, and at most one step of the stream may
  need it (x280: the port accepts a 5.0e-8 m step 1.4e-14 below the
  current cost, JAX rejects it and stops "stalled"; the poses then differ
  by 2.15e-8 m).
- 150 poses in float32: poses within 2e-3 m, costs within 1e-3 relative
  (both packages run out max_iters on some float32 steps), with no slack.
- Frozen drift exactly 0.0 in both packages: a frozen pose keeps its
  float64 value bit for bit through every later solve.
"""

import logging
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rome_tpu as R  # noqa: E402
from rome_tpu.frontend.robot_utils import fifo_freeze as jax_fifo_freeze  # noqa: E402
from rome_tpu.io.g2o import parse_g2o_instruction as jax_parse  # noqa: E402


sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir)))
import chip_smoke as C  # noqa: E402
from tools.torch import incremental_bench as IB  # noqa: E402



@pytest.fixture(autouse=True)
def quiet_gauge_warning():
    # once x0 is frozen its prior drops out and every step logs the gauge
    # anchor, in both packages
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


def _step(pose, fg, res):
    """A step's frozen set, every pose's coords, cost, iterations, reason
    and LM trials."""
    st = res["stats"]
    return dict(k=pose, frozen=sorted(l for l in fg.ls(r"^x\d+$") if fg.variables[l].solvable == 0),
                coords=np.stack([fg.get_coords(f"x{i}") for i in range(pose + 1)]),
                cost=float(st.final_cost), iterations=int(st.iterations), reason=st.reason,
                trials=[(bool(h["accepted"]), float(h["dnorm"])) for h in st.history])


def _port_run(dtype, poses):
    """Per step ``_step``; and the largest move of a frozen pose since it
    froze (``run_incremental``'s own)."""
    steps = []
    _fg, _rows, drift = IB.run_incremental(
        IB.stream_instructions(poses), fixedlag=True, qfl=C.FIXEDLAG_WINDOW, device="cpu",
        dtype=dtype, on_step=lambda row, fg, res: steps.append(_step(row["pose"], fg, res)))
    return steps, drift


def _jax_run(dtype, poses):
    """The same stream through the JAX package: per step ``_step``; and the
    largest move of a frozen pose since it froze."""
    fg = R.FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", R.Pose2)
    fg.add_factor(["x0"], R.PriorPose2(R.MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    fg.init_variable("x0", [0.0, 0.0, 0.0])
    fg.params.qfl = C.FIXEDLAG_WINDOW
    fg.params.isfixedlag = True
    steps, frozen_at, drift, pose = [], {}, 0.0, 0
    for chunk in IB.solve_chunks(IB.stream_instructions(poses)):
        for ins in chunk:
            IB.add_instruction(fg, ins, jax_parse)
            if ins[0] == "VERTEX_SE2":
                pose = max(pose, int(ins[1]))
        jax_fifo_freeze(fg)
        # the poses frozen before this solve: their values now are the reference
        for l in fg.ls(r"^x\d+$"):
            if fg.variables[l].solvable == 0 and l not in frozen_at:
                frozen_at[l] = np.asarray(fg.variables[l].points["parametric"],
                                          dtype=np.float64).copy()
        res = R.solve_graph_parametric(fg, init=False, options=R.GNOptions(max_iters=IB.MAX_ITERS),
                                       chordal_init=False, pad=True, dtype=dtype)
        for l, ref in frozen_at.items():
            p = np.asarray(fg.variables[l].points["parametric"], dtype=np.float64)
            if not np.array_equal(p.view(np.uint64), ref.view(np.uint64)):
                drift = max(drift, float(np.abs(p - ref).max()), 1e-300)
        steps.append(_step(pose, fg, res))
    return steps, drift


SPLIT_MAX_M = 1e-6


def _compare(a, b, pos_tol, cost_rtol, split_max=0.0):
    assert [s["k"] for s in a] == [s["k"] for s in b]
    worst_pos = worst_cost = 0.0
    leaned = []
    for sa, sb in zip(a, b):
        assert sa["frozen"] == sb["frozen"], sa["k"]
        d = np.abs(sa["coords"][:, :2] - sb["coords"][:, :2]).max()
        # relative to max(1, cost), as LM's own ftol test: the first steps
        # (no loop closed yet) end at a cost of f32 / f64 noise
        c = abs(sa["cost"] - sb["cost"]) / max(abs(sb["cost"]), 1.0)
        worst_pos, worst_cost = max(worst_pos, d), max(worst_cost, c)
        split = next((max(ta[1], tb[1]) for ta, tb in zip(sa["trials"], sb["trials"])
                      if ta[0] != tb[0]), 0.0)
        split = split if split <= split_max else 0.0
        assert d <= pos_tol + split, (sa["k"], d, split)
        if d > pos_tol:
            leaned.append(sa["k"])
        assert c <= cost_rtol, (sa["k"], c)
    assert len(leaned) <= 1, leaned
    return worst_pos, worst_cost


def test_fixedlag_stream_float64_matches_jax():
    with jax.enable_x64():
        ja, jdrift = _jax_run(jnp.float64, 300)
    pa, pdrift = _port_run(torch.float64, 300)
    assert len(pa) == 30                  # x10 .. x290, and x299
    assert pa[-1]["frozen"] and len(pa[-1]["frozen"]) == 300 - C.FIXEDLAG_WINDOW
    assert jdrift == 0.0 and pdrift == 0.0
    _compare(pa, ja, 1e-8, 1e-9, split_max=SPLIT_MAX_M)
    # recorded, not held: the LM iteration counts of the two packages
    same = sum(s["iterations"] == t["iterations"] for s, t in zip(pa, ja))
    assert same >= 1


def test_fixedlag_stream_float32_matches_jax():
    ja, jdrift = _jax_run(jnp.float32, 150)
    pa, pdrift = _port_run(torch.float32, 150)
    assert jdrift == 0.0 and pdrift == 0.0
    _compare(pa, ja, 2e-3, 1e-3)


def test_fixedlag_path_rehearsal(tmp_path):
    """chip_smoke's phase 16 (tools/torch/incremental_bench.py's run) at 120
    poses on the CPU: its gates hold (frozen drift, the window check against
    the f64 dense solve of a save_dfg -> load_dfg copy, the incremental tier
    of the stream's first 61 poses against the dense f64 optimum)."""
    out, launches = C.fixedlag_path("cpu", device="cpu", poses=120, incremental=61,
                                    workdir=str(tmp_path))
    fl, doc = out["fixedlag"], out["incremental_bench"]
    rows = doc["fixedlag_rows"]
    assert doc["fixedlag_full"]["steps"] == len(rows) == 12 and len(fl["checks"]) == 1
    assert all(r["frozen_drift"] == 0.0 for r in rows)
    assert rows[-1]["frozen"] == 120 - C.FIXEDLAG_WINDOW
    assert fl["checks"][0]["window_err_m"] <= C.FIXEDLAG_WINDOW_GATE_M
    assert doc["incremental"]["steps"] == 6
    assert np.isfinite(fl["end_state_ate_vs_batch_m"])
