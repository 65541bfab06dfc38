"""The control of driver ``stream``: one lap (noise from (seed, 0)) with
the bfloat16 reference in the solver's place, for the batch-solved start
and every step."""

import numpy as np

from benchmark import judge as J
from benchmark import reference as R
from benchmark import world as W


def readings(config, traffic, seed, max_iters):
    world = W.structure(**config["world"]).truncated(traffic["end"])
    qfl, start = config["qfl"], traffic["start"]
    z = W.measurements(world, W.noise_seed(seed, 0))
    edges, _packed, _prior = J.batch_problem(world, z, start)
    batch = R.solve_batch(edges, start, world.prior_sigmas, round_to=R.bf16,
                          max_iters=max_iters)[0]
    state = np.concatenate([batch, np.zeros((world.n - start, 3))])
    lap = J.Lap(z=z, start=start, batch_answer=batch)
    for n in range(start + traffic["stride"], traffic["end"] + 1, traffic["stride"]):
        _c, _opt, answer = J.step_cost(world, z, n, qfl, state[:n], state[n - qfl:n],
                                       round_to=R.bf16)
        state[n - qfl:n] = answer
        lap.steps.append((n, answer.copy()))
    lap.end_state = state.copy()
    return J.stream_readings(world, [lap], qfl, config["gates"])
