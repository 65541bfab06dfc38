"""solve_p95_ms: the 95th percentile of every request's latency in the
window (host clock from the call of the entry to its return and a
synchronize)."""

from benchmark.stats import latency_p95_ms as read  # noqa: F401
