"""Driver ``resolve``: one client in a closed loop re-solving a pool of
citygrid maps of one connectivity (``benchmark.world``), each a whole batch
solve. Its traffic parameters: ``pool`` (graphs), ``bank`` (the seed of
the pool's noise draws), ``trace_requests``. Its control is
``benchmark/controls/resolve.py``.
"""

from __future__ import annotations

import numpy as np

from benchmark import entry
from benchmark import graphs as Gr
from benchmark import judge as J
from benchmark import roofline as RL
from benchmark import world as W


class Driver(entry.Driver):
    """Closed loop, one client, over a pool of ``pool`` graphs of the
    world's connectivity, graph k's noise drawn from (``bank``, k): the
    same graphs in every run. The run's seed draws the order of the
    requests (each graph once per round, the rounds' orders shuffled), so
    every seed does the same work (the LM iterations follow the noise
    draw). Before each request its graph gets back its dead-reckoned
    initial values (outside the request's latency), so every request of a
    graph is the same solve: the solver's chordal stage starts from the
    values it is handed."""

    def setup(self):
        self.world = w = W.structure(**self.config["world"])
        n = w.n
        self.z, self.graphs = [], []
        for k in range(self.traffic["pool"]):
            z = W.measurements(w, W.noise_seed(self.traffic["bank"], k))
            self.z.append(z)
            self.graphs.append(Gr.build(w, z, n, W.dead_reckon(w, z), self.dtype))
        self.records = [[fg.variables[f"x{p}"] for p in range(n)] for fg in self.graphs]
        self.initial = [Gr.points(fg, 0, n) for fg in self.graphs]
        self.answers = [[] for _ in self.graphs]
        self.first = []
        for g, fg in enumerate(self.graphs):   # every graph once: the capture, then replays
            self._reset(g)
            self.solve(fg, self.config["solver"], {}, timed=False)
            self.first.append(np.stack(Gr.points(fg, 0, n)))
        self.order = np.random.default_rng(W.noise_seed(self.seed, 0))
        self.queue = []
        self.bytes = {"normal": RL.k1_normal_bytes(len(w.i), n)}

    def _reset(self, g):
        for rec, p in zip(self.records[g], self.initial[g]):
            rec.points["parametric"] = p

    def request(self, timed=True):
        if not self.queue:
            self.queue = list(self.order.permutation(len(self.graphs)))
        g = int(self.queue.pop())
        fg = self.graphs[g]
        self._reset(g)
        rec = self.solve(fg, self.config["solver"], {"poses": self.world.n}, timed=timed)
        rec["k1_bytes"] = self.bytes
        self.answers[g].append(Gr.points(fg, 0, self.world.n))
        return rec

    def judge(self, gates):
        readings, notes, repeat = {}, {}, 0.0
        for g, answers in enumerate(self.answers):
            if not answers:
                continue
            stacked = [np.stack(a) for a in answers]
            J.batch_readings(self.world, self.z[g], self.world.n, stacked, gates, readings,
                             notes=notes)
            repeat = max(repeat, max(float(np.abs(a - self.first[g]).max()) for a in stacked))
        return readings, dict(notes, repeat_max_abs=repeat)
