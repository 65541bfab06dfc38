"""What decides ``correct``: the answers the timed path wrote back, held to
the float64 reference (``benchmark.reference``) solved on the same inputs.

Every function here takes plain arrays, so the same comparison judges the
solver under test and the control (the reference in bfloat16 in its place).
Each returns readings ``{name: (value, limit)}``; a run is correct when every
value is at most its limit.

- Batch solves (``batch_readings``): per answer, the float64 cost of the
  answer over the optimum's, ``cost_excess`` = (cost - opt) / opt, against
  the configuration's 1.002 * opt + 1e-3 (bench.py:152-156). The
  SE(2)-aligned ATE to the optimum is reported (``notes``), not compared:
  the map's normal equations have near-null modes (eigenvalues 1e-8 to
  1e-6), along which the reference itself, stopped at a cost gap of 1e-5,
  lies metres from its own optimum.
- Fixed-lag streams (``stream_readings``): each lap's batch-solved start as
  above (``start_cost_excess``); each step's answer for
  the newest ``qfl`` poses by ``step_cost_gap``, its cost (0.5 * the
  whitened chi-square) over the factors that touch those poses less the
  optimum of that step's problem, with every older pose held at the value
  the stream left it (an absolute gap: a window on an odometry chain
  without closures has an optimum of 0); and ``frozen_drift_m``, the
  largest change of a pose after it froze, which the configuration's
  freeze guarantee makes exactly 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark import reference as R
from benchmark.world import World


def _worst(readings, name, values, limits):
    """Keep the reading of ``name`` with the least room under its limit."""
    for v, lim in zip(values, limits):
        cur = readings.get(name)
        if cur is None or v - lim > cur[0] - cur[1] or not np.isfinite(v):
            readings[name] = (float(v), float(lim))


def batch_problem(world: World, z, n: int):
    """(edges, packed, prior) of the first ``n`` poses' batch problem."""
    rows = np.flatnonzero(np.maximum(world.i, world.j) < n)
    edges = R.pack(world.i[rows], world.j[rows], z[rows], world.sigmas[rows])
    return edges, R.pack_edges(edges), R.prior_sqrt_info(world.prior_sigmas)


def batch_readings(world: World, z, n: int, answers, gates, readings=None, prefix="",
                   notes=None):
    """Readings of ``answers`` ((n, 3) arrays) of the batch problem of the
    first ``n`` poses with edge means ``z``; the largest ATE to the optimum
    goes into ``notes``."""
    readings = {} if readings is None else readings
    edges, packed, prior = batch_problem(world, z, n)
    opt, c_opt, _it, _conv = R.solve_batch(edges, n, world.prior_sigmas)
    costs = [R.cost_of(np.asarray(a, float), packed, prior) for a in answers]
    _worst(readings, prefix + "cost_excess", [(c - c_opt) / c_opt for c in costs],
           [gates["cost_rel"] + gates["cost_abs"] / c_opt] * len(costs))
    if notes is not None:
        ate = max(R.ate_values(a, opt) for a in answers)
        notes[prefix + "ate_m"] = max(notes.get(prefix + "ate_m", 0.0), ate)
    return readings


@dataclass
class Lap:
    """One fixed-lag session as the judge sees it: its edge means ``z``,
    the batch answer of its first ``start`` poses, each step's (pose
    count, answer for its newest ``qfl`` poses), and the poses' values at
    the lap's end."""

    z: np.ndarray
    start: int
    batch_answer: np.ndarray
    steps: list = field(default_factory=list)
    end_state: np.ndarray = None


def step_problem(world: World, z, n: int, qfl: int):
    """(free pose indices, edges of the step's problem) at ``n`` poses: the
    newest ``qfl`` poses are free; the edges are those that touch one."""
    lo = max(n - qfl, 0)
    later = np.maximum(world.i, world.j)
    rows = np.flatnonzero((later >= lo) & (later < n))
    return np.arange(lo, n), rows


def step_cost(world: World, z, n, qfl, held, answer, round_to=None):
    """(port cost, optimum, optimum's poses) of one step: ``held`` (n, 3)
    gives every older pose, ``answer`` (qfl, 3) the newest poses. The
    optimum starts from the newest poses dead-reckoned along the odometry
    from the last held pose; with ``round_to`` it is the control's."""
    free_idx, rows = step_problem(world, z, n, qfl)
    # a compact problem: the poses the step's edges touch
    used = np.unique(np.concatenate([world.i[rows], world.j[rows], free_idx]))
    where = {int(p): k for k, p in enumerate(used)}
    ii = np.array([where[int(p)] for p in world.i[rows]])
    jj = np.array([where[int(p)] for p in world.j[rows]])
    edges = R.pack(ii, jj, z[rows], world.sigmas[rows])
    free = np.isin(used, free_idx)
    x_port = np.asarray(held, float)[used].copy()
    x_port[free] = np.asarray(answer, float)
    x0 = np.asarray(held, float)[used].copy()
    cur = np.asarray(held, float)[free_idx[0] - 1] if free_idx[0] > 0 else np.zeros(3)
    for p in free_idx:
        if p > 0:
            cur = R.se2_compose(cur, z[p - 1])   # odometry edge (p - 1, p) is row p - 1
        x0[where[int(p)]] = cur
    packed = R.pack_edges(edges)
    x_opt, c_opt, _it, _conv = R.solve_free(x0, edges, free, round_to=round_to)
    return R.edge_cost(x_port, packed), c_opt, x_opt[free]


def stream_readings(world: World, laps, qfl: int, gates, readings=None, notes=None):
    """Readings of fixed-lag ``laps`` (``Lap``)."""
    readings = {} if readings is None else readings
    for lap in laps:
        batch_readings(world, lap.z, lap.start, [lap.batch_answer], gates, readings,
                       prefix="start_", notes=notes)
        end = np.asarray(lap.end_state, float)
        # the value each pose had when it froze: its last answer while free
        last = np.asarray(lap.batch_answer, float).copy()
        last = np.concatenate([last, np.full((end.shape[0] - last.shape[0], 3), np.nan)])
        gaps = []
        for n, answer in lap.steps:
            c_port, c_opt, _x = step_cost(world, lap.z, n, qfl, end, answer)
            gaps.append(c_port - c_opt)
            last[n - qfl:n] = answer
        if gaps:
            _worst(readings, "step_cost_gap", gaps, [gates["step_cost_gap"]] * len(gaps))
        n_done = lap.steps[-1][0] if lap.steps else lap.start
        frozen = max(n_done - qfl, 0)
        drift = np.abs(end[:frozen] - last[:frozen])
        _worst(readings, "frozen_drift_m", [float(np.max(drift)) if frozen else 0.0], [0.0])
    return readings


def correct(readings):
    return all(np.isfinite(v) and v <= lim for v, lim in readings.values())
