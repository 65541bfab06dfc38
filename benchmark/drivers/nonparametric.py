"""Driver ``nonparametric``: one client in a closed loop re-solving one
graph nonparametrically through ``solve_graph_nonparametric``, each request
a cold solve with its own solve seed. Its traffic parameters:
``trace_requests``, ``judge_requests``. Its control is
``benchmark/controls/nonparametric.py``.

The configuration names the graph (``graph``: the beehive generator's
arguments), the entry's settings (``solver``) and the comparison
(``judge``: ``reference_solves`` M); the judge is
``benchmark/nonparametric_judge.py`` against the frozen float64 reference
``benchmark/nonparametric_reference.py`` solved on the same device.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np

from benchmark import entry
from benchmark import nonparametric_judge as NJ
from benchmark import nonparametric_reference as NR
from benchmark import roofline_k2k3 as RK
from rome_tpu_torch import generate_graph_beehive, solve_graph_nonparametric
from rome_tpu_torch.ops import pairwise_cuda
from rome_tpu_torch.utils.profiling import annotate

# the draw epilogues' launch counters (ops/pairwise_cuda.LAUNCHES)
DRAWS = {"k2": "se2_gibbs_draw", "k3": "euclid_gibbs_draw"}
# streams of the run's seed: the requests' solve seeds, the reference's
SOLVE_STREAM, REFERENCE_STREAM = 0, 1
KEY = "default"   # the entry's solve key


def same_graph(fg, g: NR.Graph):
    """Whether the program's graph ``fg`` is the reference's ``g``: the same
    variables of the same types in creation order, and the same factors
    (type, variables, measurement mean and covariance) in creation order."""
    if [(v, fg.variables[v].vtype.name) for v in fg._var_order] != list(g.kinds.items()):
        return False
    if len(fg._fct_order) != len(g.factors):
        return False
    for label, f in zip(fg._fct_order, g.factors):
        mine = fg.factors[label]
        S = np.asarray(mine.params["sqrt_info"], dtype=np.float64)
        if (mine.ftype.name, tuple(mine.variables)) != (f.kind, tuple(f.labels)) or \
                not np.allclose(mine.params["z"], f.mean, rtol=0, atol=1e-12) or \
                not np.allclose(np.linalg.inv(S.T @ S), f.cov, rtol=1e-9, atol=1e-12):
            return False
    return True


class Driver(entry.Driver):
    """Closed loop, one client: the graph is built once; before each request
    (outside its latency) every variable's beliefs, point and initialized
    flag of the solve key are cleared, so each request is the same cold
    solve; the run's seed draws each request's solve seed. The beliefs of
    the last ``judge_requests`` requests are kept for the judge."""

    def setup(self):
        cfg = self.config
        self.fg = generate_graph_beehive(graphinit=False, **cfg["graph"])
        self.graph = NR.beehive(**cfg["graph"])
        if not same_graph(self.fg, self.graph):
            raise RuntimeError("the program's graph is not the reference's beehive graph")
        self.kinds = dict(self.graph.kinds)
        counts = collections.Counter(self.kinds.values())
        self.poses = counts["Pose2"]
        N = cfg["solver"]["N"]
        self.bytes = {"k2": RK.k2_draw_bytes(counts["Pose2"], N, N),
                      "k3": RK.k3_draw_bytes(counts["Point2"], N, N, NJ.DOF["Point2"])}
        self.seeds = np.random.default_rng([int(self.seed) % 2**64, SOLVE_STREAM])
        self.kept = collections.deque(maxlen=self.traffic["judge_requests"])
        for _ in range(2):   # the kernels' build, the structure cache, first launches
            self.request(timed=False)
        self.kept.clear()

    def _clear(self):
        for rec in self.fg.variables.values():
            rec.beliefs.pop(KEY, None)
            rec.points.pop(KEY, None)
            rec.initialized.pop(KEY, None)

    def request(self, timed=True):
        s = self.config["solver"]
        seed = int(self.seeds.integers(2**31))
        self._clear()
        before = dict(pairwise_cuda.LAUNCHES)
        entry.sync(self.device)
        with annotate("bench.request") if timed else contextlib.nullcontext():
            t0 = time.perf_counter()
            solve_graph_nonparametric(self.fg, solve_key=KEY, sweeps=s["sweeps"], N=s["N"],
                                      seed=seed, init=s["init"], engine=s["engine"],
                                      device=self.device)
            entry.sync(self.device)
            wall = time.perf_counter() - t0
        rec = {"wall_s": wall, "poses": self.poses,
               "k2_bytes": self.bytes["k2"], "k3_bytes": self.bytes["k3"]}
        rec.update({k: pairwise_cuda.LAUNCHES[name] - before[name] for k, name in DRAWS.items()})
        self.kept.append({label: np.array(self.fg.variables[label].beliefs[KEY],
                                          dtype=np.float64) for label in self.kinds})
        return rec

    def judge(self, gates):
        cfg, s = self.config, self.config["solver"]
        M = cfg["judge"]["reference_solves"]
        answers = list(self.kept)
        # M pooled solves, and as many held out as answers are judged: the
        # reference judged against itself alike (reported, not compared)
        seeds = np.random.default_rng([int(self.seed) % 2**64, REFERENCE_STREAM]).integers(
            2**31, size=M + len(answers))
        t0 = time.perf_counter()
        ref = NR.solve(self.graph, seeds.tolist(), N=s["N"], sweeps=s["sweeps"],
                       gibbs_sweeps=s["gibbs_sweeps"], device=self.device)
        ref = {label: b.cpu().numpy() for label, b in ref.items()}
        reference_s = time.perf_counter() - t0
        pooled = NJ.pool({label: b[:M] for label, b in ref.items()})
        readings = NJ.readings(answers, pooled, self.kinds, s["N"], gates)
        held = [{label: b[M + j] for label, b in ref.items()} for j in range(len(answers))]
        opt = NR.parametric_optimum(self.graph)
        poses = [label for label, kind in self.kinds.items() if kind == "Pose2"]
        err = max((float(np.mean([np.linalg.norm(a[label][:, :2].mean(0) - opt[label][:2])
                                  for label in poses])) for a in answers), default=None)
        return readings, {"judged_requests": len(answers), "reference_solves": M,
                          "reference_s": reference_s,
                          "reference_self": NJ.answer_readings(held, pooled, self.kinds,
                                                               s["N"]),
                          "mean_pose_err_m": err}
