"""One run of one cell: inputs from the seed, set-up (``setup_s``), the
timed window, with ``--trace 1`` a profiled slice after it, the
comparison with the reference, the module check, and the result line.

``run_cell`` returns the result and the readings; ``main`` (``run.py``)
prints them. Tests call ``run_cell`` with ``device="cpu"``, which skips the
look for a card; the command never does.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch

from benchmark import judge
from benchmark.manifest import ROOT, Manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "rome_tpu")


@dataclass
class Run:
    """What a metric's ``read(run)`` sees. ``requests``: the window's
    request records (``benchmark.entry``); ``traced``: those of the
    profiled slice; ``trace``: its ``devtrace.DeviceTrace`` (None without
    ``--trace 1``)."""

    config: dict
    traffic: dict
    setup_s: float
    window_s: float = 0.0
    requests: list = field(default_factory=list)
    traced: list = field(default_factory=list)
    trace: object = None


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``rome_tpu_torch`` is not ``rome_tpu``)."""
    names = {m.partition(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def card():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(workload, seed, seconds, trace=False, device="cuda", root=ROOT, overrides=None,
             started=None):
    """One run of ``workload``; returns (result dict, readings). ``started``
    is the process's start on the ``time.time`` clock (set-up counts from
    it); ``overrides`` ({"config": ..., "traffic": ...}) resize a cell for
    a test on the CPU."""
    started = time.time() if started is None else started
    man = Manifest(root)
    wl, config, traffic = man.cell(workload, overrides)
    if device == "cuda":
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < wl["chips"]:
            raise SystemExit(f"{workload} needs {wl['chips']} CUDA device(s); found {found}")
        torch.cuda.reset_peak_memory_stats()
    from benchmark import devtrace

    driver = man.driver(traffic["driver"])(config, traffic, seed, device)
    driver.setup()
    run = Run(config=config, traffic=traffic, setup_s=time.time() - started)

    failed = 0
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            run.requests.append(driver.request())
    except Exception:  # noqa: BLE001 - a failed request fails the run, which still reports
        traceback.print_exc()
        failed += 1
    run.window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    if trace and not failed:
        def slice_():
            # one request outside the window first: the profiler's own
            # set-up on the captured graphs' first launches under it
            driver.request(timed=False)
            for _ in range(traffic["trace_requests"]):
                run.traced.append(driver.request())

        try:
            run.trace = devtrace.record(slice_)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            failed += 1

    readings, info = driver.judge(config["gates"])
    ok = failed == 0 and bool(run.requests) and judge.correct(readings)

    metrics = {}
    for m in man.metrics(workload, trace):
        value = man.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    if trace and run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    result = {"correct": ok, "attempted": len(run.requests) + len(run.traced) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["card"] = card() if device == "cuda" else device
    result["info"] = dict(info, window_s=run.window_s, setup_s=run.setup_s,
                          requests=len(run.requests))
    if run.trace is not None:
        result["info"]["device_ranges_s"] = {
            name: run.trace.annotation_s(name) for name in sorted(run.trace.annotations)}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in readings.items()}
    return result, readings


def _finite(x):
    """JSON has no NaN or infinity: such a number is written as a string."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(args, started):
    result, readings = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                started=started)
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, (v, lim) in readings.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0
