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
Python's cyclic garbage collector is held off while a phase is captured: an
old program freed there would destroy its graphs inside the capture.

On the CPU, and on the card when ``run(eager=True)`` asks for the plain
version, the same phase functions run eagerly through :data:`EAGER`, which
reads each guard on the host. Both give the same arithmetic: the bodies are
the same code and only the runner differs.

Kernel launch counts (:func:`count`) made while a program is captured become
device counters in the graph, beside the launch they count; the program
adds them to the host counts at its one final read (:meth:`Program.read`).
The warm-up's launches are real and count on the host at once.

Device phases (``run.span(name)``): with recording on
(``utils/profiling.enable``), a phase's begin and end are stamped by
one-thread kernels that read the card's ``%globaltimer`` (``rome_stamp``),
captured as graph nodes inside the conditional bodies, so a skipped
iteration stamps nothing; each end adds the phase's nanoseconds and one call
to its slot in a device buffer beside the counters. ``run`` stamps the
program's first replay's start and its last replay's end outside the
graphs. The read appends the slots to its one device-to-host read and
notes them on the open root span (``device_ns`` and ``calls`` per phase,
``program_device_ns``, ``device_spans``). The eager runner stamps with the
same kernels on the card and with the host clock on the CPU; outside a
program (``EAGER``, the host loops) ``span`` does nothing. A capture is a
``program.capture`` span with ``warmup``, ``capture`` and ``instantiate``
children and its graph nodes and warm-up launches as attributes.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time

import numpy as np
import torch

from rome_tpu_torch.utils import profiling
from rome_tpu_torch.utils.profiling import annotate

SOURCE = "device_loop.cu"
_P = ctypes.c_void_p
_FUNCTIONS = {
    "rome_begin_if": [_P, _P, _P],
    "rome_end_if": [_P, _P],
    "rome_graph_nodes": [_P, _P],
    "rome_stamp": [_P, _P, _P],
}
# guards of a loop that one outer guard covers
LOOP_GROUP = 8
_MAX_COUNTERS = 8
# named device phases a program stamps; one more slot holds its whole span
_MAX_PHASES = 16

_lib = None
_STREAMS: dict = {}
_CAPTURE = threading.local()
# %globaltimer - perf_counter_ns and its uncertainty (ns), as last measured
CLOCK: dict = {}


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


def clock_offset(device=None):
    """Map the card's ``%globaltimer`` onto ``time.perf_counter_ns``: a
    stamp bracketed by host reads around a synchronize, the tightest of 8.
    Returns and keeps in :data:`CLOCK` (offset, uncertainty) in ns: the
    timer's reading minus the host clock's, and half the bracket."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    buf = torch.zeros(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    best = None
    for _ in range(8):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter_ns()
        err = _library().rome_stamp(stream, buf.data_ptr(), None)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
        if err:
            raise RuntimeError(f"stamp launch failed: cudaError {err}")
        if best is None or t1 - t0 < 2 * best[1]:
            best = (int(buf.item()) - (t0 + t1) // 2, (t1 - t0) // 2)
    CLOCK.update(offset_ns=best[0], uncertainty_ns=best[1])
    return best


@contextlib.contextmanager
def _no_collection():
    """The cyclic garbage collector held off: a program it frees inside a
    capture would destroy its graphs and release its pools there, which
    invalidates the capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


class Eager:
    """The plain version of a program's control flow: each guard read on the
    host, each body run in Python. Outside a program it stamps nothing."""

    def cond(self, pred, body):
        if bool(pred):
            body()

    def loop(self, n, live, body):
        for _ in range(n):
            if not bool(live):
                return
            body()

    def span(self, name):
        return contextlib.nullcontext()


EAGER = Eager()


class _Stamped(Eager):
    """A program's eager runner: ``span`` stamps the program's phase slots."""

    def __init__(self, program):
        self.program = program

    @contextlib.contextmanager
    def span(self, name):
        prog = self.program
        row = prog._phase_row(name) if prog._stamping else None
        if row is None:
            yield
            return
        prog._stamp(row, False)
        yield
        prog._stamp(row, True)


class _Warmup(_Stamped):
    """The eager pass before a capture: every body on the side stream of
    the nesting depth its capture will have."""

    def __init__(self, device, program):
        super().__init__(program)
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


class _Capture(_Stamped):
    """The control flow of a capture: each guarded body in an IF node; a
    span's stamps become kernel nodes where the span opens and closes."""

    def __init__(self, device, program):
        super().__init__(program)
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
    eagerly on the CPU. ``name`` labels its capture span, its phases'
    profiler ranges and its device span."""

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
        # launch counters, then a (begin, ns, calls) row per named phase
        # and the program's own row, last: one int64 buffer, zeroed per run
        self._buf = None
        self._phases = []
        self._pending = False
        # whether the captured graphs hold stamp nodes; whether this run stamps
        self._graph_stamps = self._stamping = False

    @property
    def captured(self):
        return self._graphs is not None

    @property
    def _counters(self):
        return self._buf[:_MAX_COUNTERS]

    def _rows(self):
        return self._buf[_MAX_COUNTERS:].view(_MAX_PHASES + 1, 3)

    def _alloc(self):
        if self._buf is None:
            self._buf = torch.zeros(_MAX_COUNTERS + 3 * (_MAX_PHASES + 1), dtype=torch.int64,
                                    device=self.device)

    def _counter(self, counts, key):
        for i, (c, k) in enumerate(self._slots):
            if c is counts and k == key:
                return self._counters[i]
        if len(self._slots) == _MAX_COUNTERS:
            raise RuntimeError(f"a program counts at most {_MAX_COUNTERS} kinds of launch")
        self._slots.append((counts, key))
        return self._counters[len(self._slots) - 1]

    def _phase_row(self, name):
        """The stamp row of device phase ``name``, given at its first span."""
        if name not in self._phases:
            if len(self._phases) == _MAX_PHASES:
                raise RuntimeError(f"a program stamps at most {_MAX_PHASES} device phases")
            self._phases.append(name)
        return self._rows()[self._phases.index(name)]

    def _stamp(self, row, end):
        """Stamp ``row``'s begin, or with ``end`` add the time since it and a
        call: a kernel on the current stream on the card, the host clock on
        the CPU."""
        if self.device.type == "cuda":
            ptr = row.data_ptr()
            err = _library().rome_stamp(torch.cuda.current_stream(self.device).cuda_stream,
                                        ptr, ptr + row.element_size() if end else None)
            if err:
                raise RuntimeError(f"stamp launch failed: cudaError {err}")
        elif end:
            row[1] += time.perf_counter_ns() - row[0]
            row[2] += 1
        else:
            row[0] = time.perf_counter_ns()

    def run(self, eager=False):
        """Run every phase its number of times: replayed on the card (the
        first call warms up and captures), eagerly on the CPU or with
        ``eager``."""
        if self.device.type != "cuda" or eager:
            self._alloc()
            self._buf.zero_()
            self._pending, self._stamping = False, profiling.enabled()
            runner, whole = _Stamped(self), self._rows()[_MAX_PHASES]
            if self._stamping:
                self._stamp(whole, False)
            for fn, reps in self.phases:
                for _ in range(reps):
                    fn(runner)
            if self._stamping:
                self._stamp(whole, True)
            return
        if self._graphs is None:
            self._capture()
        self._buf.zero_()
        self._stamping = self._graph_stamps
        whole = self._rows()[_MAX_PHASES]
        if self._stamping:
            self._stamp(whole, False)
        for g, (fn, reps) in zip(self._graphs, self.phases):
            # a profiler trace names each phase's replays
            with annotate(f"{self.name}.{fn.__name__.lstrip('_')}"):
                for _ in range(reps):
                    g.replay()
        if self._stamping:
            self._stamp(whole, True)
        self._pending = True

    def _capture(self):
        dev = self.device
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        side = _stream(dev, 0)
        cur = torch.cuda.current_stream(dev)
        self._alloc()
        self._stamping = self._graph_stamps = profiling.enabled()
        warm_launches = {}
        with annotate("program.capture", program=self.name) as span:
            side.wait_stream(cur)
            _CAPTURE.warmup = warm_launches
            try:
                with annotate("warmup"), torch.cuda.stream(side):
                    warm = _Warmup(dev, self)
                    for fn, _reps in self.phases:
                        fn(warm)
            finally:
                _CAPTURE.warmup = None
            cur.wait_stream(side)
            torch.cuda.synchronize(dev)
            graphs, nodes = [], 0
            with annotate("capture"), _no_collection():
                for fn, _reps in self.phases:
                    g = torch.cuda.CUDAGraph(keep_graph=True)
                    bodies = torch.cuda.graph_pool_handle()
                    run = _Capture(dev, self)
                    # thread_local: a thread that is not capturing (a solve
                    # manager's producer, a server's client) may still call
                    # the CUDA runtime
                    with torch.cuda.graph(g, pool=torch.cuda.graph_pool_handle(), stream=side,
                                          capture_error_mode="thread_local"):
                        # the conditional bodies capture on other streams:
                        # their allocations go to a pool of their own
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
            with annotate("instantiate"):
                for g in graphs:
                    g.instantiate()
                torch.cuda.synchronize(dev)
            if span is not None:
                span.attrs.update(nodes=nodes, warmup_launches=warm_launches)
        if self._graph_stamps and not CLOCK:
            clock_offset(dev)
        self._graphs = graphs

    def read(self, tensors):
        """The program's one device-to-host read: ``tensors`` flattened into
        one float64 vector (integers up to 2**53 exact) on the host, as a
        numpy array. The launch counters of the last replay are added to
        their host counts; the last run's phase stamps ride in the same read
        and are noted on the open root span."""
        parts = [t.reshape(-1).to(torch.float64) for t in tensors]
        n = len(self._slots) if self._pending else 0
        stamped = self._stamping
        self._pending = self._stamping = False
        if n or stamped:
            # the int64 buffer's bits, reinterpreted back on the host
            parts.append(self._buf.view(torch.float64))
        host = torch.cat(parts).cpu().numpy()
        if not (n or stamped):
            return host
        buf = host[-len(self._buf):].view(np.int64)
        host = host[:-len(self._buf)]
        for (counts, key), v in zip(self._slots[:n], buf):
            counts[key] += int(v)
        if stamped:
            rows = buf[_MAX_COUNTERS:].reshape(_MAX_PHASES + 1, 3)
            begin, ns, _calls = (int(v) for v in rows[_MAX_PHASES])
            clock = "cuda" if self.device.type == "cuda" else "host"
            profiling.note(device_ns={p: int(rows[i, 1]) for i, p in enumerate(self._phases)},
                           calls={p: int(rows[i, 2]) for i, p in enumerate(self._phases)},
                           program_device_ns=ns,
                           device_spans=[[self.name, begin, begin + ns, clock]])
        return host

    def __del__(self):
        release = getattr(torch._C, "_cuda_releasePool", None)
        for index, pool in self._pools:
            try:
                release(index, pool)
            except RuntimeError:
                pass  # the allocator is gone at interpreter exit


profiling.register_clock("cuda", lambda: clock_offset())
