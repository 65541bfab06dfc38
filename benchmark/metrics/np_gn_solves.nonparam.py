"""np_gn_solves.nonparam: batched per-particle Gauss-Newton calls per window
request (the program's ``np.gn_solves`` counter, one per call of
``solvers/multimodal/convolve._gn_solve_target``, which each request's root
span holds)."""

from benchmark import spans


def read(run):
    pairs = spans.window(run)
    total = spans.attr_sum(run, "np.gn_solves")
    if pairs is None or total is None:
        return None
    return total / len(pairs)
