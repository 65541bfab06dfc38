"""host_ms (host_ms.batch, host_ms.fixedlag): the mean of (request latency -
the solver's own solve_time_s) over the window: the parametric API's
lowering and write-back around the solver (solvers/parametric.py), and in a
fixed-lag step also adding the stride's poses and fifo_freeze."""

from benchmark.stats import mean


def read(run):
    m = mean(r["wall_s"] - r["solve_time_s"] for r in run.requests)
    return None if m is None else 1e3 * m
