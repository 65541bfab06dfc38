"""step_ms: the mean latency of every fixed-lag step in the window (host
clock from handing the stride's poses to the graph to the step's solve
returned and synchronized)."""

from benchmark.stats import mean


def read(run):
    m = mean(r["wall_s"] for r in run.requests)
    return None if m is None else 1e3 * m
