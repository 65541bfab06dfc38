"""Tracing and profiling hooks (counterpart of ``rome_tpu/utils/profiling.py``).

- :func:`annotate`: the one span primitive. It names a region in a
  ``torch.profiler`` trace (``record_function``) and, when CUDA is present,
  in the card's NVTX timeline; with recording on (:func:`enable`, the
  default) it also records the region as a span: name, start and end
  (``time.perf_counter_ns``), parent span, a request id shared by every
  span under one root, and attributes. Finished root spans, each with its
  tree of children, go into a bounded ring (the last :data:`RING_ROOTS`;
  :func:`roots`);
- :func:`count`: process counters (:data:`COUNTERS`); a count made inside a
  span is also added to that span's root as an attribute;
- :func:`note`: numbers a device program reads back (its phases' device
  nanoseconds and calls, its device span) added to the open root span;
- :func:`summary` and :func:`export_chrome`: the ring as per-name totals,
  and as a Chrome trace with the host spans on one track and the device
  programs' spans on another, on the host clock;
- :func:`trace`: a ``torch.profiler`` capture (CPU activities, and the card's
  kernels when CUDA is present) written as a Chrome trace, ``trace.json``,
  into ``logdir``;
- :class:`PhaseTimer`: per-phase accumulated seconds on the host clock, with
  the JAX package's ``rows()`` and ``report()``. Given a CUDA device it
  synchronizes the card at each phase's start and end, so a phase's seconds
  hold the device work it enqueued, not only the enqueueing.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field

import torch

# finished root spans the ring keeps (each with its children)
RING_ROOTS = 4096

_ENABLED = True
_RING: collections.deque = collections.deque(maxlen=RING_ROOTS)
_OPEN = threading.local()
_IDS = itertools.count(1)
COUNTERS: collections.Counter = collections.Counter()
# clock name -> function returning (offset_ns, uncertainty_ns): a device
# clock's reading minus perf_counter_ns at the same instant, measured anew
_CLOCKS: dict = {}


class Span:
    """One recorded region: ``name``, ``start`` and ``end``
    (``perf_counter_ns``), ``parent`` (None for a root), ``request`` (the
    root's id), ``attrs`` and ``children`` (in the order they opened)."""

    __slots__ = ("name", "start", "end", "parent", "request", "attrs", "children")

    def __init__(self, name, parent, attrs):
        self.name, self.parent, self.attrs, self.children = name, parent, attrs, []
        self.request = next(_IDS) if parent is None else parent.request
        self.start = self.end = time.perf_counter_ns()

    @property
    def root(self):
        s = self
        while s.parent is not None:
            s = s.parent
        return s

    @property
    def seconds(self):
        return (self.end - self.start) / 1e9

    def walk(self):
        """This span and every span below it, depth first, in opening order."""
        yield self
        for c in self.children:
            yield from c.walk()


def enable(flag: bool = True):
    """Switch recording (spans, counters, device-phase stamps) on or off for
    the process. A device program decides at its capture whether it stamps
    its phases."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def _stack():
    st = getattr(_OPEN, "stack", None)
    if st is None:
        st = _OPEN.stack = []
    return st


def current():
    """The innermost span open on this thread, or None."""
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def annotate(name: str, **attrs):
    """Name a region in the profiler trace, and in the NVTX timeline when
    CUDA is present; with recording on, record it as a span with ``attrs``
    (yields the span, else None)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    span = None
    try:
        with torch.profiler.record_function(name):
            if _ENABLED:
                st = _stack()
                span = Span(name, st[-1] if st else None, attrs)
                if span.parent is not None:
                    span.parent.children.append(span)
                st.append(span)
            try:
                yield span
            finally:
                if span is not None:
                    span.end = time.perf_counter_ns()
                    st.pop()
                    if span.parent is None:
                        _RING.append(span)
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _add(attrs, key, value):
    """Numbers add, dicts add per key, lists extend; anything else replaces."""
    old = attrs.get(key)
    if isinstance(value, dict):
        d = attrs.setdefault(key, {})
        for k, v in value.items():
            _add(d, k, v)
    elif isinstance(value, list):
        attrs[key] = (old or []) + value
    elif isinstance(value, (int, float)) and isinstance(old, (int, float)):
        attrs[key] = old + value
    else:
        attrs[key] = value


def count(name: str, n: int = 1):
    """Add ``n`` to the process counter ``name`` and, inside a span, to its
    root's attribute ``name``."""
    if not _ENABLED:
        return
    COUNTERS[name] += n
    span = current()
    if span is not None:
        _add(span.root.attrs, name, n)


def note(**values):
    """Add ``values`` to the attributes of the open root span on this
    thread (numbers add, dicts per key, lists extend); nothing outside a
    span or with recording off."""
    span = current() if _ENABLED else None
    if span is not None:
        root = span.root
        for k, v in values.items():
            _add(root.attrs, k, v)


def roots():
    """The ring's finished root spans, oldest first."""
    return list(_RING)


def spans(name: str, among=None):
    """Every recorded span called ``name`` under ``among`` (root spans; the
    ring by default), in order."""
    return [s for r in (roots() if among is None else among) for s in r.walk() if s.name == name]


def register_clock(name: str, mapping):
    """``mapping()`` returns (offset, uncertainty) in nanoseconds of the
    clock ``name`` against ``perf_counter_ns``; :func:`export_chrome` calls
    it once per export."""
    _CLOCKS[name] = mapping


def summary(among=None):
    """Per span name its count, total and mean milliseconds; per device
    phase its calls, total and mean device milliseconds (``device_ns`` and
    ``calls`` of the roots' attributes); the programs' device milliseconds;
    the counters the roots hold. ``among``: root spans (the ring by
    default)."""
    among = roots() if among is None else list(among)
    tot, num = collections.defaultdict(int), collections.Counter()
    dev, calls, counters, program_ns = (collections.defaultdict(int), collections.Counter(),
                                        collections.Counter(), 0)
    for r in among:
        for s in r.walk():
            tot[s.name] += s.end - s.start
            num[s.name] += 1
        a = r.attrs
        for k, v in a.get("device_ns", {}).items():
            dev[k] += v
        calls.update(a.get("calls", {}))
        program_ns += a.get("program_device_ns", 0)
        counters.update({k: v for k, v in a.items() if k in COUNTERS})
    return {
        "spans": {k: {"count": num[k], "total_ms": tot[k] / 1e6, "mean_ms": tot[k] / 1e6 / num[k]}
                  for k in tot},
        "device": {k: {"calls": calls[k], "total_ms": v / 1e6,
                       "mean_ms": v / 1e6 / calls[k] if calls[k] else None}
                   for k, v in dev.items()},
        "program_device_ms": program_ns / 1e6,
        "counters": dict(counters),
    }


def export_chrome(path: str, among=None):
    """Write ``among`` (root spans; the ring by default) as a Chrome trace:
    the host spans on track 1, each device program's span (``device_spans``
    attributes: name, begin, end, clock) on track 2, mapped onto the host
    clock by its clock's offset, measured anew here. Returns ``path``."""
    among = roots() if among is None else list(among)
    offsets = {"host": (0, 0)}
    events = [{"ph": "M", "pid": 0, "tid": t, "name": "thread_name", "args": {"name": n}}
              for t, n in ((1, "host spans"), (2, "device programs"))]
    for r in among:
        for s in r.walk():
            args = {k: v for k, v in s.attrs.items() if k != "device_spans"}
            events.append({"ph": "X", "pid": 0, "tid": 1, "name": s.name, "ts": s.start / 1e3,
                           "dur": (s.end - s.start) / 1e3,
                           "args": dict(args, request=s.request)})
        for name, begin, end, clock in r.attrs.get("device_spans", []):
            if clock not in offsets:
                offsets[clock] = _CLOCKS[clock]() if clock in _CLOCKS else None
            if offsets[clock] is None:
                continue
            off, unc = offsets[clock]
            events.append({"ph": "X", "pid": 0, "tid": 2, "name": name,
                           "ts": (begin - off) / 1e3, "dur": (end - begin) / 1e3,
                           "args": {"request": r.request, "clock": clock,
                                    "offset_uncertainty_us": unc / 1e3}})
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh, default=str)
    return path


def _default_logdir():
    return os.path.join(tempfile.gettempdir(), "rome_tpu_torch", "trace")


@contextlib.contextmanager
def trace(logdir: str = None):
    """Capture a profiler trace of the enclosed work into
    ``logdir/trace.json`` (Chrome trace format). Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or _default_logdir()
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class PhaseTimer:
    """Accumulating per-phase wall-clock timer; ``rows()`` mirrors the
    reference's per-cycle timing CSV. ``device``: with a CUDA device each
    phase starts and ends with ``torch.cuda.synchronize``."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    device: object = None

    def _sync(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.time()
        try:
            yield
        finally:
            self._sync()
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def rows(self):
        return [
            dict(phase=k, total_s=round(v, 4), calls=self.counts[k],
                 mean_s=round(v / self.counts[k], 4))
            for k, v in sorted(self.totals.items())
        ]

    def report(self) -> str:
        return "\n".join(
            f"{r['phase']},{r['total_s']},{r['calls']},{r['mean_s']}"
            for r in self.rows()
        )
