"""lower_ms (lower_ms.batch, lower_ms.fixedlag): mean milliseconds per
window request in the program's ``solve.lower`` span (``graph/lower.lower``
inside ``solve_graph_parametric``), host clock."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "solve.lower")
