"""The entry a driver's timed path calls, measured as one request: what
every driver (``benchmark/drivers/<name>.py``) shares on the program's side.

A request record is a dict: ``wall_s`` (host clock around the request,
ending in a synchronize), ``solve_time_s`` (the solver's own), ``poses``
(poses in the graph solved), ``iterations``, ``converged``,
``new_solvers`` (solvers the structure cache built), ``k1`` (K1 launches by
epilogue), and, set by the driver, ``k1_bytes`` (bytes one launch of each
epilogue moves on this request's real factors, ``benchmark.roofline``).
"""

from __future__ import annotations

import contextlib
import time

import torch

from rome_tpu_torch.ops import linearize_cuda as K1
from rome_tpu_torch.solvers import gauss_newton as GN
from rome_tpu_torch.solvers import parametric as P
from rome_tpu_torch.utils.profiling import annotate


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Driver:
    """A traffic driver: made from the cell's configuration, traffic
    parameters, the run's seed and the device; ``setup()`` builds and warms
    up, ``request(timed=True)`` runs one request and returns its record,
    ``judge(gates)`` returns the readings ``{name: (value, limit)}`` and
    notes of what the window's requests wrote back."""

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.dtype = config["dtype"]

    def solve(self, fg, solver, record, front=None, timed=True):
        """One call of the entry on ``fg`` with the ``solver`` settings
        (a configuration's ``options``, ``chordal_init``, ``schedule``,
        ``pad``), after ``front()`` (the front end's part of a step) when
        given; fills ``record`` with what the request measures. ``timed``
        puts it in a ``bench.request`` range, which a trace reads as the
        window."""
        opts = GN.GNOptions(**solver["options"])
        keys, k1 = set(GN._SOLVER_CACHE), dict(K1.LAUNCHES)
        sync(self.device)
        with annotate("bench.request") if timed else contextlib.nullcontext():
            t0 = time.perf_counter()
            if front is not None:
                with annotate("bench.front"):
                    front()
            res = P.solve_graph_parametric(
                fg, init=False, options=opts, chordal_init=solver["chordal_init"],
                schedule=solver["schedule"], pad=solver["pad"], device=self.device)
            sync(self.device)
            wall = time.perf_counter() - t0
        st = res["stats"]
        record.update(
            wall_s=wall, solve_time_s=res["solve_time_s"], iterations=int(st.iterations),
            converged=bool(st.converged), new_solvers=len(set(GN._SOLVER_CACHE) - keys),
            k1={k: K1.LAUNCHES[k] - k1[k] for k in K1.LAUNCHES})
        return record
