"""Tracing and profiling hooks (counterpart of ``rome_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` capture (CPU activities, and the card's
  kernels when CUDA is present) written as a Chrome trace, ``trace.json``,
  into ``logdir``;
- :func:`annotate`: names a region in that trace (``record_function``) and,
  when CUDA is present, in the card's NVTX timeline;
- :class:`PhaseTimer`: per-phase accumulated seconds on the host clock, with
  the JAX package's ``rows()`` and ``report()``. Given a CUDA device it
  synchronizes the card at each phase's start and end, so a phase's seconds
  hold the device work it enqueued, not only the enqueueing.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch


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


@contextlib.contextmanager
def annotate(name: str):
    """Name a region in the profiler trace, and in the NVTX timeline when
    CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
