"""The control of driver ``nonparametric``: the reference in bfloat16 in the
program's place. ``judge_requests`` solves with every input and state
rounded to bfloat16 (seeds drawn from (seed, 2)) are judged, as a run's
requests are, against M float64 reference solves with the seeds a run's
judge draws for the same seed. It runs on the CPU."""

import numpy as np

from benchmark import nonparametric_judge as NJ
from benchmark import nonparametric_reference as NR

CONTROL_STREAM, REFERENCE_STREAM = 2, 1


def readings(config, traffic, seed, max_iters):
    g = NR.beehive(**config["graph"])
    s, M = config["solver"], config["judge"]["reference_solves"]
    run = dict(N=s["N"], sweeps=s["sweeps"], gibbs_sweeps=s["gibbs_sweeps"], device="cpu")
    base = int(seed) % 2**64
    ref = NR.solve(g, np.random.default_rng([base, REFERENCE_STREAM]).integers(
        2**31, size=M).tolist(), **run)
    low = NR.solve(g, np.random.default_rng([base, CONTROL_STREAM]).integers(
        2**31, size=traffic["judge_requests"]).tolist(), round_to=NR.bf16, **run)
    answers = [{label: b[j].numpy() for label, b in low.items()}
               for j in range(traffic["judge_requests"])]
    pooled = NJ.pool({label: b.numpy() for label, b in ref.items()})
    return NJ.readings(answers, pooled, g.kinds, s["N"], config["gates"])
