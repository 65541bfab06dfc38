"""What decides ``correct`` for SE(3) batch solves: the answers the timed
path wrote back, each held to the float64 optimum of its graph that the
plain reference (``benchmark.se3_reference``) reaches from the same
dead-reckoned start.

- ``cost_excess``: (cost - opt) / opt of the answer's float64 cost (the
  reference's residuals) against ``cost_rel + cost_abs / opt``, the rule
  bench.py:152-156 sets and ``judge.batch_readings`` applies to citygrid;
- ``ate_to_opt_m``: the RMSE of the answer's positions after the rigid
  motion that best aligns them to the optimum's (``se3_reference.ate``),
  against the configuration's limit. Unlike citygrid's, the sphere's
  normal equations have no near-null modes (a tight prior anchors x0 and
  every pose closes a loop a lap below), so the positions themselves are
  compared.

Each function returns or fills readings ``{name: (value, limit)}`` keeping
the worst reading (least room under its limit), as ``benchmark.judge``.
The same code judges the solver under test and the control.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from benchmark import se3_reference as R
from benchmark.judge import _worst


def _optimum(problem, start, round_to=None, max_iters=200):
    torch.set_num_threads(1)
    return R.solve(problem, start, round_to=round_to, max_iters=max_iters)


def optima(problems, starts, workers=1, round_to=None, max_iters=200):
    """``se3_reference.solve`` of each problem from its start, in
    ``workers`` processes (spawned: no CUDA state crosses) when more than
    one. Returns [(poses, cost, iterations, converged), ...]."""
    n = len(problems)
    rounds = [round_to] * n
    iters = [max_iters] * n
    if workers <= 1 or n <= 1:
        return [_optimum(*a) for a in zip(problems, starts, rounds, iters)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(workers, n), mp_context=ctx) as ex:
        return list(ex.map(_optimum, problems, starts, rounds, iters))


def readings(problem, optimum, answers, gates, readings=None, notes=None):
    """Readings of ``answers`` ((n, 7) arrays) of ``problem`` against its
    ``optimum`` (``optima``'s tuple); the worst of each over the answers.
    ``notes`` gets the largest ``cost_excess`` and ATE seen."""
    readings = {} if readings is None else readings
    x_opt, c_opt = optimum[0], optimum[1]
    limit = gates["cost_rel"] + gates["cost_abs"] / c_opt
    ate_limit = gates["ate_to_opt_m"]["limit"]
    for a in answers:
        a = np.asarray(a, dtype=np.float64)
        finite = a.shape == x_opt.shape and bool(np.isfinite(a).all())
        c = R.cost(problem, a) if finite else float("inf")
        ate = R.ate(a, x_opt) if finite else float("inf")
        _worst(readings, "cost_excess", [(c - c_opt) / c_opt], [limit])
        _worst(readings, "ate_to_opt_m", [ate], [ate_limit])
        if notes is not None:
            notes["cost_excess_max"] = max(notes.get("cost_excess_max", -np.inf),
                                           (c - c_opt) / c_opt)
            notes["ate_to_opt_max_m"] = max(notes.get("ate_to_opt_max_m", 0.0), ate)
    return readings
