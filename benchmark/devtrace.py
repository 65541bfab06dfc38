"""A torch.profiler trace of the traced slice, reduced to what the metrics
read: the window (the host's ``bench.request`` ranges), the device's busy
time in it as the union of its operations' intervals (kernels, copies,
sets: overlaps counted once), kernel time by name, the device-side ranges
that the profiler records for the host's named ranges
(``gpu_user_annotation``), and the breakdown the result line carries.

Times in the trace are microseconds; everything returned is seconds.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

from benchmark.stats import clip, covered, union

WINDOW = "bench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
NAME_CHARS = 160


def record(fn):
    """Run ``fn()`` under torch.profiler (host and card) and return its
    ``DeviceTrace``. The Chrome trace goes through a temporary directory
    (under ``TMPDIR``) that is removed at once."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return DeviceTrace(events)


def _span(ev):
    ts = float(ev["ts"])
    return ts, ts + float(ev.get("dur", 0.0))


class DeviceTrace:
    def __init__(self, events):
        events = [e for e in events if e.get("ph") == "X" and "ts" in e]
        marks = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        self.windows = union(_span(e) for e in marks)
        self.main = {(e.get("pid"), e.get("tid")) for e in marks}
        self.device = []
        for e in events:
            if e.get("cat") in DEVICE_CATS:
                s, t = _span(e)
                if clip([(s, t)], self.windows):
                    self.device.append((s, t, e["name"], e["cat"]))
        self.annotations = defaultdict(list)
        for e in events:
            if e.get("cat") == "gpu_user_annotation":
                self.annotations[e["name"]].append(_span(e))
        self.host = sorted(
            (_span(e) + (e["cat"], e["name"])
             for e in events
             if e.get("cat") in HOST_CATS and (e.get("pid"), e.get("tid")) in self.main),
            key=lambda h: (h[0], -h[1]))

    # -- the window and the device's busy time ---------------------------------
    @property
    def window_s(self):
        return sum(e - s for s, e in self.windows) / 1e6

    @property
    def busy_s(self):
        return covered(clip([(s, e) for s, e, _n, _c in self.device], self.windows)) / 1e6

    def kernels(self, *parts):
        """Durations (s) of the window's kernels whose name holds every one
        of ``parts``."""
        return [(e - s) / 1e6 for s, e, n, c in self.device
                if c == "kernel" and all(p in n for p in parts)]

    def annotation_s(self, name):
        """Seconds of the device-side ranges the profiler records for the
        host range ``name`` inside the window (overlaps once); None when it
        recorded none."""
        spans = clip(self.annotations.get(name, []), self.windows)
        return covered(spans) / 1e6 if spans else None

    def annotation_busy_s(self, name):
        """Seconds in which a device operation ran inside the device-side
        ranges of the host range ``name`` in the window (a union); None
        when the profiler recorded no such range."""
        spans = union(clip(self.annotations.get(name, []), self.windows))
        if not spans:
            return None
        return covered(clip([(s, e) for s, e, _n, _c in self.device], spans)) / 1e6

    # -- the breakdown ------------------------------------------------------------
    def gaps(self):
        """(start, end) of every stretch of the window in which no device
        operation ran."""
        busy = union(clip([(s, e) for s, e, _n, _c in self.device], self.windows))
        out = []
        for ws, we in self.windows:
            cur = ws
            for s, e in busy:
                if e <= ws or s >= we:
                    continue
                if s > cur:
                    out.append((cur, s))
                cur = max(cur, e)
            if we > cur:
                out.append((cur, we))
        return out

    def _host_at(self, gaps):
        """For each gap, the host ranges open at its midpoint on the
        window's thread: the innermost named range, operator and runtime
        call, joined by ' > '."""
        names, stack, k = [], [], 0
        host = self.host
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            m = 0.5 * (s + e)
            while k < len(host) and host[k][0] <= m:
                while stack and stack[-1][1] < host[k][0]:
                    stack.pop()
                stack.append(host[k])
                k += 1
            while stack and stack[-1][1] < m:
                stack.pop()
            parts = []
            for cat in HOST_CATS[:3]:
                hit = next((h for h in reversed(stack) if h[2] == cat and h[0] <= m <= h[1]), None)
                if hit is not None:
                    parts.append(hit[3])
            names.append((" > ".join(parts) or "no host range")[:NAME_CHARS])
        return names, sorted(gaps, key=lambda g: g[0] + g[1])

    def breakdown(self, top=10):
        """``{"device_ops": [[kernel or copy name, seconds], ...],
        "idle_gaps": [[host ranges open, seconds], ...]}``, each the ``top``
        largest sums."""
        ops = defaultdict(float)
        for s, e, n, _c in self.device:
            ops[n[:NAME_CHARS]] += (e - s) / 1e6
        names, gaps = self._host_at(self.gaps())
        idle = defaultdict(float)
        for name, (s, e) in zip(names, gaps):
            idle[name] += (e - s) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
