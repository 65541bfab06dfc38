"""The control of ``correct``: the reference put in the solver's place and
computed in bfloat16, the precision below the configurations' float32
(every input and every pose it keeps rounded to bfloat16), judged by the
same comparison as a run (``benchmark.judge``). It must come out as not
correct. The benchmark's own runs do not run it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed with the readings and whether they pass.
It runs on the CPU (numpy and scipy only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def control_readings(workload, seed, root=None, overrides=None, max_iters=40):
    """The control's readings on ``workload``'s inputs for ``seed``: the
    answers a run would judge, made by the bfloat16 reference with the
    configuration's LM iteration budget, by the control of the cell's
    driver (``benchmark/controls/<driver>.py``)."""
    from benchmark.manifest import ROOT, Manifest

    man = Manifest(root or ROOT)
    _wl, config, traffic = man.cell(workload, overrides)
    return man.control(traffic["driver"]).readings(config, traffic, seed, max_iters)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from benchmark import judge as J

    for seed in args.seeds:
        readings = control_readings(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "passes": J.correct(readings),
                          "readings": {k: {"value": v, "limit": lim}
                                       for k, (v, lim) in readings.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
