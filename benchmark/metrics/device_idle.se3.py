"""device_idle.se3: 1 - (the captured program's device spans / the requests'
latencies), summed over the window: the share of a request in which the
card ran none of the solve's program (as ``device_idle.batch``)."""

from benchmark import spans


def read(run):
    busy = spans.attr_sum(run, "program_device_ns")
    if busy is None:
        return None
    return 1.0 - busy / 1e9 / sum(r["wall_s"] for r in run.requests)
