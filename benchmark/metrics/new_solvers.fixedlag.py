"""new_solvers.fixedlag: solvers the structure cache (ParametricSolver.cached)
built per 100 steps of the window, from its keys before and after each
step."""


def read(run):
    if not run.requests:
        return None
    return 100.0 * sum(r["new_solvers"] for r in run.requests) / len(run.requests)
