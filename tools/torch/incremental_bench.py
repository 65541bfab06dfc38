"""Incremental and fixed-lag solve benchmark of the PyTorch port on the
card: the port of tools/incremental_bench.py.

The stream is a time-ordered copy of a g2o file (``write_stream_g2o``: each
VERTEX_SE2 line, then the EDGE_SE2 lines whose larger endpoint it is), since
data/citygrid.g2o lists every vertex before its first edge. Each
instruction goes into the graph through ``add_instruction``:
``parse_g2o_instruction(..., initialize=True)``, then the odometry edge of
(k - 1, k) starts x{k} at x{k-1}'s current estimate composed with the
edge's mean (dead reckoning from the filtered estimate, what a front end
sends; citygrid's VERTEX lines hold the truth, Manhattan's the odometry
start the JAX script streams). After every ``--stride`` poses the stream
adds (a pose: its VERTEX line and the edges that end at it; x0 is in the
graph before the stream, with its prior) and after the last, the graph is
solved as tools/incremental_bench.py solves it (``max_iters=30``, no
chordal init, ``pad=True``). Both tiers count poses: the JAX script's
stride counts instructions, which on a time-ordered stream would solve a
pose before its edges.

- The fixed-lag tier (``--poses`` poses, 3,500 by default: 350 solves):
  ``fifo_freeze`` with window ``--qfl`` (25) before each solve; every row
  carries ``frozen_drift``, the largest change of a frozen pose since it
  froze (0.0 exactly when every frozen pose kept its float64 bits); the end
  state's RMSE to the optimum of the whole graph (data/citygrid_gt.npz).
- The incremental tier: the stream's first ``--incremental`` poses (600:
  60 solves), every pose free.

Every row: the instructions read, the pose, the variables, seconds (host
clock ending in a sync), LM iterations, ``converged``, ``reason``, the final
cost, the linear solver, K1's launches, the frozen poses and their drift,
and ``new_solvers``: the solvers ``ParametricSolver.cached`` built in that
step (its cache's keys before and after; the counterpart of the JAX
script's XLA ``compiles``, 0 = the cached solver was reused). The JAX
script's compile cache has no counterpart.

    python tools/torch/incremental_bench.py [--g2o PATH] [--poses N] [--stride 10] [--qfl 25]
        [--incremental 600] [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rome_tpu_torch import FactorGraph, GNOptions, MvNormal, Pose2, PriorPose2, solve_graph_parametric  # noqa: E402
from rome_tpu_torch.frontend.robot_utils import fifo_freeze  # noqa: E402
from rome_tpu_torch.io.g2o import import_g2o, parse_g2o_instruction  # noqa: E402
from rome_tpu_torch.ops import linearize_cuda as K  # noqa: E402
from rome_tpu_torch.solvers import gauss_newton as GN  # noqa: E402
from tools.torch.bench_kernels import device_label, require_device  # noqa: E402

CITYGRID = os.path.join(REPO, "data", "citygrid.g2o")
CITYGRID_GT = os.path.join(REPO, "data", "citygrid_gt.npz")
POSES, STRIDE, QFL, INCREMENTAL, MAX_ITERS = 3500, 10, 25, 600, 30


def write_stream_g2o(path, poses, src=CITYGRID):
    """The first ``poses`` poses of ``src`` as a g2o stream in time order:
    each VERTEX_SE2 line followed by the EDGE_SE2 lines whose larger
    endpoint it is (file order), the order an incremental or fixed-lag
    example reads. Returns the number of lines written."""
    vertex, edges = {}, defaultdict(list)
    with open(src) as fh:
        for line in fh:
            t = line.split()
            if t and t[0] == "VERTEX_SE2" and int(t[1]) < poses:
                vertex[int(t[1])] = line.strip()
            elif t and t[0] == "EDGE_SE2" and max(int(t[1]), int(t[2])) < poses:
                edges[max(int(t[1]), int(t[2]))].append(line.strip())
    lines = [ln for k in range(poses) for ln in [vertex[k]] + edges[k]]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return len(lines)


def stream_instructions(poses, src=CITYGRID):
    """``write_stream_g2o``'s stream read back with ``import_g2o``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.g2o")
        write_stream_g2o(path, poses, src)
        return import_g2o(path)


def se2_compose(a, b):
    """a ∘ b of two (x, y, theta) poses in float64, theta wrapped to [-pi, pi)."""
    c, s = math.cos(a[2]), math.sin(a[2])
    th = (a[2] + b[2] + math.pi) % (2 * math.pi) - math.pi
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1], th])


def add_instruction(fg, ins, parse=parse_g2o_instruction):
    """One stream instruction into ``fg``: ``parse(fg, ins, initialize=True)``;
    then, for the odometry edge of (k - 1, k), x{k} starts at x{k-1}'s
    current estimate composed with the edge's mean. In a time-ordered stream
    that edge comes in pose k's group, before any solve sees x{k}. ``parse``
    is either package's ``parse_g2o_instruction``."""
    parse(fg, ins, initialize=True)
    if ins[0] == "EDGE_SE2" and int(ins[2]) == int(ins[1]) + 1:
        odo = [float(v) for v in ins[3:6]]
        fg.init_variable(f"x{ins[2]}", se2_compose(fg.get_coords(f"x{ins[1]}"), odo))


def solve_chunks(instructions, stride=STRIDE):
    """The stream cut at its solves: a chunk ends after the group of every
    ``stride``-th pose the stream adds (a pose's group: its first VERTEX
    line and what follows up to the next new pose's; x0 is in the graph
    before the stream) and after the last instruction."""
    chunks, cur, seen = [], [], {"0"}
    for ins in instructions:
        if ins[0].startswith("VERTEX") and ins[1] not in seen:
            if cur and len(seen) > 1 and (len(seen) - 1) % stride == 0:
                chunks.append(cur)
                cur = []
            seen.add(ins[1])
        cur.append(ins)
    if cur:
        chunks.append(cur)
    return chunks


def _mk_fg():
    """x0 with tools/incremental_bench.py:55-62's PriorPose2, graphinit off."""
    fg = FactorGraph()
    fg.params.graphinit = False
    fg.add_variable("x0", Pose2)
    fg.add_factor(["x0"], PriorPose2(MvNormal([0, 0, 0], [0.1, 0.1, 0.05])))
    fg.init_variable("x0", [0.0, 0.0, 0.0])
    return fg


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


class FrozenPoses:
    """The points of the poses a fixed-lag solve has frozen, taken when each
    first shows up frozen (before the solve it froze in). With ``window``,
    only poses older than the newest ``window`` count (a live front end's
    newest poses wait unsolved, solvable 0, until its solver takes them)."""

    def __init__(self, window=None):
        self.window = window
        self.labels, self.points, self._known = [], [], set()

    def take(self, fg):
        xs = sorted(fg.ls(r"^x\d+$"), key=lambda l: int(l[1:]))
        for lbl in xs[:-self.window] if self.window else xs:
            rec = fg.variables[lbl]
            if rec.solvable == 0 and lbl not in self._known:
                self._known.add(lbl)
                self.labels.append(lbl)
                self.points.append(rec.points["parametric"].copy())

    def drift(self, fg):
        """Largest |change| of a frozen pose's point since it froze; 0.0
        exactly when every one kept its float64 value bit for bit."""
        if not self.labels:
            return 0.0
        cur = np.stack([fg.variables[l].points["parametric"] for l in self.labels])
        ref = np.stack(self.points)
        if np.array_equal(cur.view(np.uint64), ref.view(np.uint64)):
            return 0.0
        return max(float(np.abs(cur - ref).max()), np.finfo(float).tiny)


class StepSolver:
    """A stream's solve as tools/incremental_bench.py:75-86 makes it
    (``max_iters``, no chordal init, ``pad=True``; ``dtype`` None = the
    graph's) and its row. The poses frozen before it are taken first
    (``FrozenPoses(window)``); ``rows`` holds every step's row,
    ``max_drift`` the largest frozen drift."""

    def __init__(self, device="cuda", dtype=None, max_iters=MAX_ITERS, window=None):
        self.device, self.dtype = device, dtype
        self.opts = GNOptions(max_iters=max_iters)
        self.frozen = FrozenPoses(window)
        self.rows, self.max_drift = [], 0.0

    def __call__(self, fg, **row):
        """Solve ``fg``; returns (its row, led by ``row``, the result)."""
        self.frozen.take(fg)
        keys, k1 = set(GN._SOLVER_CACHE), dict(K.LAUNCHES)
        _sync(self.device)
        t0 = time.time()
        res = solve_graph_parametric(fg, init=False, options=self.opts, chordal_init=False,
                                     pad=True, dtype=self.dtype, device=self.device)
        _sync(self.device)
        dt = time.time() - t0
        st = res["stats"]
        drift = self.frozen.drift(fg)
        self.max_drift = max(self.max_drift, drift)
        row.update(n_vars=fg.num_variables, solve_s=dt, iters=int(st.iterations),
                   converged=bool(st.converged), reason=st.reason,
                   final_cost=float(st.final_cost), linear=res["linear_solver"],
                   new_solvers=len(set(GN._SOLVER_CACHE) - keys),
                   k1_lin=K.LAUNCHES["lin"] - k1["lin"],
                   k1_normal=K.LAUNCHES["normal"] - k1["normal"],
                   frozen=len(self.frozen.labels), frozen_drift=drift)
        self.rows.append(row)
        return row, res


def run_incremental(instructions, stride=STRIDE, fixedlag=False, qfl=QFL, device="cuda",
                    on_step=None, max_iters=MAX_ITERS, dtype=None):
    """tools/incremental_bench.py's ``run_incremental`` on the port: the
    instructions through ``add_instruction``, a solve at the end of each of
    ``solve_chunks(instructions, stride)`` (with ``fixedlag``,
    ``fifo_freeze`` at window ``qfl`` first). ``on_step(row, fg, res)`` sees
    each step's row, graph and solve result. Returns (graph, rows, largest
    frozen drift)."""
    fg = _mk_fg()
    if fixedlag:
        fg.params.qfl = qfl
        fg.params.isfixedlag = True
    step = StepSolver(device, dtype, max_iters)
    read, pose = 0, 0
    for chunk in solve_chunks(instructions, stride):
        for ins in chunk:
            add_instruction(fg, ins)
            if ins[0].startswith("VERTEX"):
                pose = max(pose, int(ins[1]))
        read += len(chunk)
        if fixedlag:
            fifo_freeze(fg)
        row, res = step(fg, step=read, pose=pose)
        if on_step is not None:
            on_step(row, fg, res)
    return fg, step.rows, step.max_drift


def _summary(rows):
    """tools/incremental_bench.py's ``_summary`` with ``new_solvers`` in
    place of ``compiles``."""
    recycled = sum(1 for r in rows if r["new_solvers"] == 0)
    steady = [r["solve_s"] for r in rows if r["new_solvers"] == 0]
    unconverged = [r for r in rows if not r["converged"]]
    return dict(
        steps=len(rows),
        steps_recycled_solver=recycled,
        recycle_rate=recycled / max(1, len(rows)),
        steady_step_latency_s=dict(
            median=float(np.median(steady)) if steady else None,
            p90=float(np.percentile(steady, 90)) if steady else None,
        ),
        unconverged_steps=len(unconverged),
        unconverged_reasons=sorted({r["reason"] for r in unconverged}),
        linear={k: sum(r["linear"] == k for r in rows) for k in sorted({r["linear"] for r in rows})},
        iterations=sum(r["iters"] for r in rows),
        k1_lin=sum(r["k1_lin"] for r in rows),
        k1_normal=sum(r["k1_normal"] for r in rows),
    )


def _end_state_ate(fg, gt_file):
    """RMSE of the poses' positions to the ground truth's (no alignment)."""
    gt = np.load(gt_file)["poses"]
    errs = [np.sum((fg.get_coords(lbl)[:2] - gt[int(lbl[1:])][:2]) ** 2)
            for lbl in fg.ls(r"^x\d+$")]
    return float(np.sqrt(np.mean(errs)))


def run(device="cuda", card=None, g2o=CITYGRID, gt_file=CITYGRID_GT, poses=POSES,
        stride=STRIDE, qfl=QFL, incremental=INCREMENTAL, on_step=None, echo=print):
    """Both tiers; ``on_step(tier, row, fg, res)`` sees every step. Returns
    (the document ``main`` prints, the fixed-lag graph, the incremental
    tier's graph)."""
    card = card or device_label(device)
    instructions = stream_instructions(poses, g2o)
    echo(f"device: {card}")

    def hook(tier):
        return None if on_step is None else (lambda row, fg, res: on_step(tier, row, fg, res))

    t0 = time.time()
    fg_fl, fl_rows, max_drift = run_incremental(instructions, stride, True, qfl, device,
                                                hook("fixedlag"))
    fl_wall = time.time() - t0
    fl_sum = _summary(fl_rows)
    echo("fixedlag full: " + json.dumps(fl_sum))
    t0 = time.time()
    fg_inc, inc_rows, _ = run_incremental(stream_instructions(incremental, g2o), stride, False,
                                          qfl, device, hook("incremental"))
    inc_wall = time.time() - t0
    inc_sum = _summary(inc_rows)
    echo("incremental: " + json.dumps(inc_sum))
    stream = f"{os.path.basename(g2o)} as a time-ordered stream, poses dead-reckoned"
    doc = dict(
        device=card,
        fixedlag_full=dict(
            workload=(f"{stream}: first {poses} poses ({len(instructions)} instructions), "
                      f"stride {stride} poses, qfl={qfl}"),
            wall_s=fl_wall,
            **fl_sum,
            max_frozen_drift=max_drift,
            bit_stable=bool(max_drift == 0.0),
            end_state_ate_vs_batch_gt_m=_end_state_ate(fg_fl, gt_file),
            note=("end-state RMSE of the fixed-lag (frozen-history) estimate against the whole "
                  "graph's float64 optimum; it bounds the cost of the lag window, it does not "
                  "gate"),
        ),
        incremental=dict(
            workload=f"{stream}: first {incremental} poses, stride {stride} poses",
            wall_s=inc_wall,
            **inc_sum,
            rows=inc_rows,
        ),
        fixedlag_rows=fl_rows,
        note=("new_solvers counts the solvers ParametricSolver.cached built in a step; 0 = the "
              "cached solver of that structure (shape bucket) was reused"),
    )
    return doc, fg_fl, fg_inc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--g2o", default=CITYGRID)
    ap.add_argument("--gt", default=CITYGRID_GT, help="ground-truth npz with 'poses'")
    ap.add_argument("--poses", type=int, default=POSES)
    ap.add_argument("--stride", type=int, default=STRIDE, help="poses between solves")
    ap.add_argument("--qfl", type=int, default=QFL)
    ap.add_argument("--incremental", type=int, default=INCREMENTAL,
                    help="poses of the incremental tier")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="also write the document to this JSON file")
    args = ap.parse_args(argv)
    require_device(args.device, "incremental_bench")
    doc, _fl, _inc = run(args.device, g2o=args.g2o, gt_file=args.gt, poses=args.poses,
                         stride=args.stride, qfl=args.qfl, incremental=args.incremental,
                         echo=lambda line: print(line, flush=True))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
