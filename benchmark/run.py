"""One run of one benchmark cell of rome_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's checks on standard error and its result as one JSON line
last on standard output (benchmark/README.md). Exits non-zero with no
result when the cell's CUDA devices are missing or the process has loaded
JAX or the JAX package.
"""

import os
import sys
import time


def process_start():
    """The process's start on the ``time.time`` clock (from /proc), else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = float(fh.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_start()

if __name__ == "__main__":
    import argparse

    # the checkout's root, in place of this directory, holds the packages
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    sys.exit(harness.main(ap.parse_args(), STARTED))
