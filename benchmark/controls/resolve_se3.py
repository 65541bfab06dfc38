"""The control of driver ``resolve_se3``: the SE(3) reference in bfloat16
(every input and every pose it keeps rounded, ``se3_reference.bf16``)
solves each graph of the pool (the same for every seed, drawn from the
traffic's ``bank``) from its dead-reckoned start in the solver's place,
judged against the float64 optimum by ``benchmark.se3_judge``."""

from benchmark import se3_judge as SJ
from benchmark import se3_reference as R
from benchmark import sphere_world as SW
from benchmark.world import noise_seed


def readings(config, traffic, seed, max_iters):
    world = SW.structure(**config["world"])
    problems, starts = [], []
    for k in range(traffic["pool"]):
        meas = SW.measurements(world, noise_seed(traffic["bank"], k))
        problems.append(SW.problem(world, meas, config["prior_sigmas"]))
        starts.append(SW.dead_reckon(world, meas))
    workers = traffic.get("workers", 1)
    opts = SJ.optima(problems, starts, workers)
    answers = SJ.optima(problems, starts, workers, round_to=R.bf16, max_iters=max_iters)
    out = {}
    for problem, opt, ans in zip(problems, opts, answers):
        SJ.readings(problem, opt, [ans[0]], config["gates"], out)
    return out
