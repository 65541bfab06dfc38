"""Driver ``resolve_se3``: one client in a closed loop re-solving a pool of
Sphere2500 graphs (``benchmark.sphere_world``) of one layout, each a whole
3-D batch solve. Its traffic parameters: ``pool`` (graphs), ``bank`` (the
seed of the pool's noise draws), ``trace_requests``, ``workers`` (processes
for the judge's reference solves). Its control is
``benchmark/controls/resolve_se3.py``.

The configuration names the layout (``world``: ``sphere_world.structure``'s
arguments), the PriorPose3 on x0 (``prior_sigmas``), the entry's settings
(``solver``) and the limits (``gates``); the judge is
``benchmark/se3_judge.py`` against ``benchmark/se3_reference.py``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from benchmark import entry
from benchmark import roofline_se3 as RS
from benchmark import se3_reference as R
from benchmark import se3_judge as SJ
from benchmark import sphere_world as SW
from benchmark.world import noise_seed
from rome_tpu_torch import FactorGraph, MvNormal, PriorPose3, load_g2o
from rome_tpu_torch.manifolds.base import SE3_


def load(path, dtype, prior_sigmas):
    """The graph a user of the program builds from the g2o file: the file
    through ``load_g2o``, a PriorPose3 on x0 at its value."""
    fg = FactorGraph()
    fg.params.graphinit = False
    fg.params.dtype = dtype
    load_g2o(fg, path)
    x0 = SE3_.log(torch.as_tensor(fg.get_point("x0"), dtype=torch.float64)).numpy()
    fg.add_factor(["x0"], PriorPose3(MvNormal(x0, list(prior_sigmas))), graphinit=False)
    return fg


class Driver(entry.Driver):
    """Closed loop, one client, over a pool of ``pool`` graphs of the
    sphere's layout, graph k's noise drawn from (``bank``, k): the same
    graphs in every run. Each is written as g2o text and loaded through
    ``load_g2o`` in set-up. The run's seed draws the order of the requests
    (each graph once per round, the rounds' orders shuffled). Before each
    request its graph gets back its dead-reckoned values (outside the
    request's latency), so every request of a graph is the same cold
    solve."""

    def setup(self):
        cfg, tr = self.config, self.traffic
        self.world = w = SW.structure(**cfg["world"])
        self.meas, self.starts, self.graphs = [], [], []
        with tempfile.TemporaryDirectory() as tmp:
            for k in range(tr["pool"]):
                meas = SW.measurements(w, noise_seed(tr["bank"], k))
                start = SW.dead_reckon(w, meas)
                path = os.path.join(tmp, f"sphere_{k}.g2o")
                SW.write_g2o(path, w, meas, start)
                self.meas.append(meas)
                self.starts.append(start)
                self.graphs.append(load(path, self.dtype, cfg["prior_sigmas"]))
        n = w.n
        self.records = [[fg.variables[f"x{p}"] for p in range(n)] for fg in self.graphs]
        self.initial = [[r.points["parametric"] for r in recs] for recs in self.records]
        self.answers = [[] for _ in self.graphs]
        self.first = []
        for g, fg in enumerate(self.graphs):   # every graph once: the capture, then replays
            self._reset(g)
            self.solve(fg, cfg["solver"], {}, timed=False)
            self.first.append(self._points(g))
        self.order = np.random.default_rng(noise_seed(self.seed, 0))
        self.queue = []
        self.least_s = RS.least_seconds(len(w.i), 1, n)

    def _reset(self, g):
        for rec, p in zip(self.records[g], self.initial[g]):
            rec.points["parametric"] = p

    def _points(self, g):
        return np.stack([rec.points["parametric"] for rec in self.records[g]])

    def request(self, timed=True):
        if not self.queue:
            self.queue = list(self.order.permutation(len(self.graphs)))
        g = int(self.queue.pop())
        self._reset(g)
        rec = self.solve(self.graphs[g], self.config["solver"], {"poses": self.world.n},
                         timed=timed)
        rec["trial_linearize_least_s"] = self.least_s
        # the solver writes new arrays: these references keep this answer
        self.answers[g].append([r.points["parametric"] for r in self.records[g]])
        return rec

    def judge(self, gates):
        prior = self.config["prior_sigmas"]
        used = [g for g, a in enumerate(self.answers) if a]
        problems = [SW.problem(self.world, self.meas[g], prior) for g in used]
        opts = SJ.optima(problems, [self.starts[g] for g in used],
                         workers=self.traffic.get("workers", 1))
        readings, notes, repeat = {}, {}, 0.0
        for g, problem, opt in zip(used, problems, opts):
            answers = [np.stack(a) for a in self.answers[g]]
            SJ.readings(problem, opt, answers, gates, readings, notes)
            repeat = max(repeat, max(float(np.abs(a - self.first[g]).max()) for a in answers))
        notes.update(repeat_max_abs=repeat, judged_requests=sum(len(a) for a in self.answers),
                     reference_iterations=[int(o[2]) for o in opts],
                     reference_converged=all(bool(o[3]) for o in opts),
                     reference_cost=[float(o[1]) for o in opts],
                     truth_ate_m=max(R.ate(o[0], self.world.poses) for o in opts)
                     if opts else None)
        return readings, notes
