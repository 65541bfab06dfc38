"""step_p95_ms: the 95th percentile of every fixed-lag step's latency in
the window."""

from benchmark.stats import latency_p95_ms as read  # noqa: F401
