"""dense_program_replay_share.fixedlag: the share of the window's dense32
LM solves that replayed a kept program, hits over lookups (the
``dense_program.hit`` and ``dense_program.miss`` counters, one per solve on
the program path of ``solvers/gauss_newton.ParametricSolver.solve``, which
each request's root span holds; a miss makes, and on the card captures, a
program of a new step shape). None where the program keeps neither."""

from benchmark import spans


def read(run):
    hit = spans.attr_sum(run, "dense_program.hit") or 0
    miss = spans.attr_sum(run, "dense_program.miss") or 0
    if spans.window(run) is None or hit + miss == 0:
        return None
    return hit / (hit + miss)
