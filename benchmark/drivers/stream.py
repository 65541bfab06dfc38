"""Driver ``stream``: fixed-lag laps on the citygrid world
(``benchmark.world``): a batch-solved history, then steps of ``stride``
poses, each frozen down to the newest ``qfl`` and solved. Its traffic
parameters: ``start``, ``end``, ``stride``, ``trace_requests``. Its
control is ``benchmark/controls/stream.py``.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import entry
from benchmark import graphs as Gr
from benchmark import judge as J
from benchmark import roofline as RL
from benchmark import world as W
from rome_tpu_torch.frontend.robot_utils import fifo_freeze


class Driver(entry.Driver):
    """Fixed-lag laps over the world's first ``end`` poses: lap L draws its
    noise from (seed, L), batch-solves its first ``start`` poses (the
    configuration's ``batch_solver``; not timed as a step), then each step
    adds ``stride`` poses dead-reckoned from their predecessor's estimate,
    freezes all but the newest ``qfl`` (``fifo_freeze``) and solves
    (``step_solver``). Set-up runs lap 0 whole."""

    def setup(self):
        self.world = W.structure(**self.config["world"]).truncated(self.traffic["end"])
        self.laps, self.lap_seconds, self.lap_no = [], [], -1
        self._new_lap()
        while self.n < self.traffic["end"]:
            self.request()
        self.laps = []

    def _new_lap(self):
        if self.lap_no >= 0:
            self._close_lap()
        self.lap_no += 1
        t0 = time.perf_counter()
        w, start = self.world, self.traffic["start"]
        z = W.measurements(w, W.noise_seed(self.seed, self.lap_no))
        self.fg = Gr.build(w, z, start, W.dead_reckon(w, z, start), self.dtype)
        self.fg.params.qfl = self.config["qfl"]
        self.fg.params.isfixedlag = True
        self.solve(self.fg, self.config["batch_solver"], {}, timed=False)
        self.lap = J.Lap(z=z, start=start, batch_answer=np.stack(Gr.points(self.fg, 0, start)))
        self.laps.append(self.lap)
        self.n = start
        self.lap_seconds.append(time.perf_counter() - t0)

    def _close_lap(self):
        self.lap.end_state = np.stack(Gr.points(self.fg, 0, self.n))

    def request(self, timed=True):
        if self.n >= self.traffic["end"]:
            self._new_lap()
        w, z, qfl = self.world, self.lap.z, self.config["qfl"]
        stop = self.n + self.traffic["stride"]

        def front():
            Gr.extend(self.fg, w, z, self.n, stop)
            fifo_freeze(self.fg)

        # the step runs from handing over the poses to the solve's return
        rec = self.solve(self.fg, self.config["step_solver"], {"poses": stop}, front=front,
                         timed=timed)
        _free, rows = J.step_problem(w, z, stop, qfl)
        rec["k1_bytes"] = {"lin": RL.k1_lin_bytes(len(rows))}
        self.n = stop
        self.lap.steps.append((stop, np.stack(Gr.points(self.fg, stop - qfl, stop))))
        return rec

    def judge(self, gates):
        self._close_lap()
        notes = {}
        readings = J.stream_readings(self.world, self.laps, self.config["qfl"], gates,
                                     notes=notes)
        return readings, dict(notes, laps=len(self.laps), lap_prep_s=self.lap_seconds)
