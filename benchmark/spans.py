"""The program's own spans and device-phase stamps (``rome_tpu_torch``'s
``utils/profiling`` ring) joined to the window's request records, for the
readers of span metrics.

The window's requests are the ``len(run.requests)`` ``bench.request`` root
spans before the last ``len(run.traced)`` (the traced slice's) in the ring
(``benchmark.entry`` opens each request's span through ``annotate``). The
join holds only where every root lasts at least its record's ``wall_s`` and
at most 1 ms more; else, and where the program keeps no ring, it gives
None. The window runs without the profiler, so no reading here carries its
stall.
"""

from __future__ import annotations

ROOT = "bench.request"
SLACK_S = 1e-3


def window(run):
    """[(record, root span), ...] of the window's requests, or None."""
    try:
        from rome_tpu_torch.utils import profiling
    except ImportError:
        return None
    roots_fn = getattr(profiling, "roots", None)
    if roots_fn is None or not run.requests:
        return None
    roots = [r for r in roots_fn() if r.name == ROOT]
    n, t = len(run.requests), len(run.traced)
    if len(roots) < n + t:
        return None
    win = roots[len(roots) - n - t:len(roots) - t]
    for rec, root in zip(run.requests, win):
        length = (root.end - root.start) / 1e9
        if not rec["wall_s"] <= length <= rec["wall_s"] + SLACK_S:
            return None
    return list(zip(run.requests, win))


def span_ms(run, *names):
    """Mean milliseconds per window request of the spans called one of
    ``names`` below each request's root; None without a join or any such
    span."""
    pairs = window(run)
    if pairs is None:
        return None
    found, total = False, 0
    for _rec, root in pairs:
        for s in root.walk():
            if s.name in names:
                found = True
                total += s.end - s.start
    return total / 1e6 / len(pairs) if found else None


def attr_sum(run, key, sub=None):
    """The sum over the window's roots of attribute ``key`` (of its entry
    ``sub`` where the attribute is a dict); None without a join or where no
    root holds it."""
    pairs = window(run)
    if pairs is None:
        return None
    vals = []
    for _rec, root in pairs:
        v = root.attrs.get(key)
        if isinstance(v, dict):
            v = v.get(sub)
        if v is not None:
            vals.append(v)
    return sum(vals) if vals else None


def phase_ms(run, phase):
    """Device milliseconds of the program phase ``phase`` per call (its
    stamps' sum over their calls) in the window; None where none ran."""
    ns, calls = attr_sum(run, "device_ns", phase), attr_sum(run, "calls", phase)
    if ns is None or not calls:
        return None
    return ns / 1e6 / calls
