"""np_gn_replay_share.nonparam: the share of the window's batched
per-particle Gauss-Newton calls that replayed a kept program, hits over
lookups (the program's ``np.gn_program.hit`` and ``np.gn_program.miss``
counters, one per call of ``solvers/multimodal/convolve.conv_particles``,
which each request's root span holds; a miss makes, and on the card
captures, a new program)."""

from benchmark import spans


def read(run):
    hit = spans.attr_sum(run, "np.gn_program.hit") or 0
    miss = spans.attr_sum(run, "np.gn_program.miss") or 0
    if spans.window(run) is None or hit + miss == 0:
        return None
    return hit / (hit + miss)
