"""The statistics the metrics use, in plain Python."""

from __future__ import annotations

import math


def percentile(values, q):
    """The ``q``-th percentile of every value, by linear interpolation
    between the closest ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def latency_p95_ms(run):
    """The 95th percentile of every request's latency in ``run``'s window,
    in milliseconds; None without requests."""
    p = percentile([r["wall_s"] for r in run.requests], 95)
    return None if p is None else 1e3 * p


def union(intervals):
    """Disjoint sorted (start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals):
    """Length of the union of ``intervals`` (overlaps counted once)."""
    return sum(e - s for s, e in union(intervals))


def clip(intervals, windows):
    """The parts of ``intervals`` inside the disjoint sorted ``windows``."""
    out = []
    for s, e in intervals:
        for ws, we in windows:
            a, b = max(s, ws), min(e, we)
            if a < b:
                out.append((a, b))
    return out
