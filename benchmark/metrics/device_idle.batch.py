"""device_idle.batch: 1 - (the captured programs' device spans / the
requests' latencies), summed over the window: the share of a request in
which the card ran none of the solve's program. Each program's span runs
from a %globaltimer stamp before its first graph replay to one after its
last (``utils/device_loop.Program.run``), read back in the program's one
read; the window runs without the profiler."""

from benchmark import spans


def read(run):
    busy = spans.attr_sum(run, "program_device_ns")
    if busy is None:
        return None
    return 1.0 - busy / 1e9 / sum(r["wall_s"] for r in run.requests)
