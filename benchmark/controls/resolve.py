"""The control of driver ``resolve``: the bfloat16 reference solves each
graph of the pool (the same for every seed, drawn from the traffic's
``bank``) in the solver's place."""

from benchmark import judge as J
from benchmark import reference as R
from benchmark import world as W


def readings(config, traffic, seed, max_iters):
    world = W.structure(**config["world"])
    out = {}
    for k in range(traffic["pool"]):
        z = W.measurements(world, W.noise_seed(traffic["bank"], k))
        edges, _packed, _prior = J.batch_problem(world, z, world.n)
        x = R.solve_batch(edges, world.n, world.prior_sigmas, round_to=R.bf16,
                          max_iters=max_iters)[0]
        J.batch_readings(world, z, world.n, [x], config["gates"], out)
    return out
