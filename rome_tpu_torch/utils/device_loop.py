"""Device programs: bounded loops whose conditions are evaluated on the
device, captured once as CUDA graphs and replayed (the port's counterpart of
the JAX package's jitted ``lax.while_loop`` programs).

A :class:`Program` is a list of phases, each a function of a *runner* that
reads and writes persistent tensors (the program's state) in place, and a
repeat count. The runner supplies the control flow:

- ``run.cond(pred, body)``: ``body()`` when the 0-dim bool tensor ``pred``
  is true;
- ``run.loop(n, live, body)``: a bounded ``while``: at most ``n`` runs of
  ``body()``, each while ``live`` is true (``body`` updates ``live``).

On the card the program is captured once: an eager warm-up pass runs every
phase on the streams its capture will use (kernel libraries are built and
library handles and workspaces made there, never during capture), then each
phase is captured under ``torch.cuda.graph`` on a side stream with each
guarded body in a CUDA IF conditional node (``csrc/device_loop.cu``) and a
loop as a chain of ``n`` such nodes, in groups of ``LOOP_GROUP`` under one
outer guard, so a finished loop skips most of its nodes by group. Every
later :meth:`Program.run` replays the phases' graphs: no host read, no host
work per iteration. A failed capture or replay raises; nothing falls back.

On the CPU, and on the card when ``run(eager=True)`` asks for the plain
version, the same phase functions run eagerly through :data:`EAGER`, which
reads each guard on the host. Both give the same arithmetic: the bodies are
the same code and only the runner differs.

Kernel launch counts (:func:`count`) made while a program is captured become
device counters in the graph, beside the launch they count; the program
adds them to the host counts at its one final read (:meth:`Program.read`).
The warm-up's launches are real and count on the host at once; every
capture appends its warm-up launches, seconds and node count to
:data:`CAPTURES`.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from rome_tpu_torch.utils.profiling import annotate

SOURCE = "device_loop.cu"
_P = ctypes.c_void_p
_FUNCTIONS = {
    "rome_begin_if": [_P, _P, _P],
    "rome_end_if": [_P, _P],
    "rome_graph_nodes": [_P, _P],
}
# guards of a loop that one outer guard covers
LOOP_GROUP = 8
_MAX_COUNTERS = 8

_lib = None
_STREAMS: dict = {}
_CAPTURE = threading.local()
# one entry per capture made in this process: {"name", "warmup_s",
# "capture_s", "instantiate_s", "nodes", "warmup_launches"}
CAPTURES: list = []


def _library():
    global _lib
    if _lib is None:
        from rome_tpu_torch.ops import nvcc_build

        _lib = nvcc_build.load(nvcc_build.build(SOURCE), _FUNCTIONS)
    return _lib


def build():
    """Compile the conditional-node helper library if needed; returns its
    path."""
    from rome_tpu_torch.ops import nvcc_build

    return nvcc_build.build(SOURCE)


def _stream(device, depth):
    """The side stream of nesting ``depth`` on ``device`` (0: the captures'
    own stream), made once per process."""
    key = (str(device), depth)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


def count(counts: dict, key):
    """One kernel launch for ``counts[key]``: on the host now, or, while a
    program is captured, as a device counter that the graph adds to where
    the launch is, read at the program's final read."""
    program = getattr(_CAPTURE, "program", None)
    if program is not None:
        program._counter(counts, key).add_(1)
        return
    counts[key] += 1
    warmup = getattr(_CAPTURE, "warmup", None)
    if warmup is not None:
        warmup[key] = warmup.get(key, 0) + 1


class Eager:
    """The plain version of a program's control flow: each guard read on the
    host, each body run in Python."""

    def cond(self, pred, body):
        if bool(pred):
            body()

    def loop(self, n, live, body):
        for _ in range(n):
            if not bool(live):
                return
            body()


EAGER = Eager()


class _Warmup(Eager):
    """The eager pass before a capture: every body on the side stream of
    the nesting depth its capture will have."""

    def __init__(self, device):
        self.device, self.depth = device, 0

    @contextlib.contextmanager
    def _nested(self, levels):
        cur = torch.cuda.current_stream(self.device)
        child = _stream(self.device, self.depth + levels)
        child.wait_stream(cur)
        self.depth += levels
        try:
            with torch.cuda.stream(child):
                yield
        finally:
            self.depth -= levels
            cur.wait_stream(child)

    def cond(self, pred, body):
        if bool(pred):
            with self._nested(1):
                body()

    def loop(self, n, live, body):
        for _ in range(n):
            if not bool(live):
                return
            with self._nested(2):
                body()


class _Capture:
    """The control flow of a capture: each guarded body in an IF node."""

    def __init__(self, device):
        self.device, self.depth, self.nodes = device, 0, ctypes.c_ulonglong(0)

    @contextlib.contextmanager
    def _if(self, pred):
        if not (isinstance(pred, torch.Tensor) and pred.dtype == torch.bool
                and pred.numel() == 1 and pred.device == self.device):
            raise TypeError(f"a guard is a one-element bool tensor on {self.device}")
        lib = _library()
        cur = torch.cuda.current_stream(self.device)
        child = _stream(self.device, self.depth + 1)
        err = lib.rome_begin_if(cur.cuda_stream, pred.data_ptr(), child.cuda_stream)
        if err:
            raise RuntimeError(f"conditional node refused: cudaError {err}")
        self.depth += 1
        try:
            with torch.cuda.stream(child):
                yield
        finally:
            self.depth -= 1
            err = lib.rome_end_if(child.cuda_stream, ctypes.byref(self.nodes))
        if err:
            raise RuntimeError(f"conditional body capture failed: cudaError {err}")

    def cond(self, pred, body):
        with self._if(pred):
            body()

    def loop(self, n, live, body):
        for s in range(0, n, LOOP_GROUP):
            with self._if(live):
                for _ in range(min(LOOP_GROUP, n - s)):
                    with self._if(live):
                        body()


class Program:
    """Phases ``[(fn(run), repeats), ...]`` on ``device``: captured at the
    first :meth:`run` on a CUDA device and replayed from then on; run
    eagerly on the CPU. ``name`` labels its :data:`CAPTURES` entry."""

    def __init__(self, device, phases, name="program"):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.phases = list(phases)
        self.name = name
        self._graphs = None
        self._pools = []
        self._slots = []
        self._counters = None
        self._pending = False

    @property
    def captured(self):
        return self._graphs is not None

    def _counter(self, counts, key):
        for i, (c, k) in enumerate(self._slots):
            if c is counts and k == key:
                return self._counters[i]
        if len(self._slots) == _MAX_COUNTERS:
            raise RuntimeError(f"a program counts at most {_MAX_COUNTERS} kinds of launch")
        self._slots.append((counts, key))
        return self._counters[len(self._slots) - 1]

    def run(self, eager=False, timed=False):
        """Run every phase its number of times: replayed on the card (the
        first call warms up and captures), eagerly on the CPU or with
        ``eager``. With ``timed`` (a capture only) returns each phase's
        device milliseconds (CUDA events between the phases' replays, after
        a synchronize)."""
        if self.device.type != "cuda" or eager:
            self._pending = False
            for fn, reps in self.phases:
                for _ in range(reps):
                    fn(EAGER)
            return None
        if self._graphs is None:
            self._capture()
        self._counters.zero_()
        if timed:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(len(self.phases) + 1)]
            events[0].record()
        for i, (g, (fn, reps)) in enumerate(zip(self._graphs, self.phases)):
            # a profiler trace names each phase's replays
            with annotate(f"{self.name}.{fn.__name__.lstrip('_')}"):
                for _ in range(reps):
                    g.replay()
            if timed:
                events[i + 1].record()
        self._pending = True
        if not timed:
            return None
        events[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    def _capture(self):
        import time

        dev = self.device
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        side = _stream(dev, 0)
        cur = torch.cuda.current_stream(dev)
        self._counters = torch.zeros(_MAX_COUNTERS, dtype=torch.int64, device=dev)
        t0, warm_launches = time.perf_counter(), {}
        side.wait_stream(cur)
        _CAPTURE.warmup = warm_launches
        try:
            with torch.cuda.stream(side):
                warm = _Warmup(dev)
                for fn, _reps in self.phases:
                    fn(warm)
        finally:
            _CAPTURE.warmup = None
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        warmup_s = time.perf_counter() - t0
        graphs, nodes, t0 = [], 0, time.perf_counter()
        for fn, _reps in self.phases:
            g = torch.cuda.CUDAGraph(keep_graph=True)
            bodies = torch.cuda.graph_pool_handle()
            run = _Capture(dev)
            # thread_local: a thread that is not capturing (a solve manager's
            # producer, a server's client) may still call the CUDA runtime
            with torch.cuda.graph(g, pool=torch.cuda.graph_pool_handle(), stream=side,
                                  capture_error_mode="thread_local"):
                # the conditional bodies capture on other streams: their
                # allocations go to a pool of their own
                torch._C._cuda_beginAllocateCurrentThreadToPool(index, bodies)
                self._pools.append((index, bodies))
                _CAPTURE.program = self
                try:
                    fn(run)
                finally:
                    _CAPTURE.program = None
                    torch._C._cuda_endAllocateToPool(index, bodies)
            top = ctypes.c_ulonglong(0)
            err = _library().rome_graph_nodes(g.raw_cuda_graph(), ctypes.byref(top))
            if err:
                raise RuntimeError(f"cudaGraphGetNodes failed: cudaError {err}")
            nodes += top.value + run.nodes.value
            graphs.append(g)
        t1 = time.perf_counter()
        for g in graphs:
            g.instantiate()
        torch.cuda.synchronize(dev)
        CAPTURES.append(dict(name=self.name, warmup_s=warmup_s, capture_s=t1 - t0,
                             instantiate_s=time.perf_counter() - t1, nodes=nodes,
                             warmup_launches=warm_launches))
        self._graphs = graphs

    def read(self, tensors):
        """The program's one device-to-host read: ``tensors`` flattened into
        one float64 vector (integers up to 2**53 exact) on the host, as a
        numpy array; the launch counters of the last replay are added to
        their host counts."""
        parts = [t.reshape(-1).to(torch.float64) for t in tensors]
        n = len(self._slots) if self._pending else 0
        self._pending = False
        if n:
            parts.append(self._counters[:n].to(torch.float64))
        host = torch.cat(parts).cpu().numpy()
        if n:
            for (counts, key), v in zip(self._slots, host[-n:]):
                counts[key] += int(v)
            host = host[:-n]
        return host

    def __del__(self):
        release = getattr(torch._C, "_cuda_releasePool", None)
        for index, pool in self._pools:
            try:
                release(index, pool)
            except RuntimeError:
                pass  # the allocator is gone at interpreter exit
