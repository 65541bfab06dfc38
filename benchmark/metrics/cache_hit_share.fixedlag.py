"""cache_hit_share.fixedlag: the structure cache's hits over its lookups in
the window (the program's ``solver_cache.hit`` and ``solver_cache.miss``
counters, which each request's root span holds)."""

from benchmark import spans


def read(run):
    hit = spans.attr_sum(run, "solver_cache.hit") or 0
    miss = spans.attr_sum(run, "solver_cache.miss") or 0
    if spans.window(run) is None or hit + miss == 0:
        return None
    return hit / (hit + miss)
