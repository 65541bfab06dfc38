"""dense_dim.fixedlag: the mean order of the dense LM solves' Cholesky
factorizations in the window's steps (the program's ``dense.dof`` over its
``dense.factorizations`` counters, which each request's root span holds):
the dims a step's dense solve factors."""

from benchmark import spans


def read(run):
    n = spans.attr_sum(run, "dense.factorizations")
    dof = spans.attr_sum(run, "dense.dof")
    if not n or dof is None:
        return None
    return dof / n
