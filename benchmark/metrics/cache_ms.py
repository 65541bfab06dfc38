"""cache_ms (cache_ms.batch, cache_ms.fixedlag): mean milliseconds per window
request in the program's ``solve.cache`` (the structure cache,
``ParametricSolver.cached``, with any ``solver.build``) and ``solve.plan``
(the connectivity's plans, with any ``symbolic.build``) spans, host
clock."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "solve.cache", "solve.plan")
