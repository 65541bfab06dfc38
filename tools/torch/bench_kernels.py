"""Speed-of-light rows of K1, the Pose2Pose2 linearize kernel, on the card:
the PyTorch port's counterpart of tools/bench_kernels.py.

Times K1 (``rome_tpu_torch/csrc/pose2pose2_linearize.cu``) on synthetic
Pose2Pose2 batches like tools/bench_kernels.py's ``_make_batch`` (a chain of
n factors over n + 1 poses, z ~ N((1, 0, 0.1), 0.05), sqrt-information 10 I,
weight 1) at n = 10,000, 100,000 and 1,000,000, in three variants:

- ``lin``: the lin epilogue (the Pallas kernel's contract: gathered p, q,
  z, S, w in; weighted whitened r, J1, J2 out), float32;
- ``normal``: the normal epilogue (the ndchol LM path's launch: the float64
  pose table and int64 slots in; float64 r and Jᵀr, float32 J and JᵀJ
  entry values out);
- ``plain``: the plain PyTorch version of ``lin``
  (``ops/fused_linearize.pose2pose2_linearize_plain``), the counterpart of
  the JAX script's ``fused_analytic`` / ``generic_jacfwd`` rows.

Device time per launch comes from CUDA events around back-to-back launches
queued behind a sleep kernel, so the card runs them without waiting for the
host; each launch reads an input set the launches before it did not touch
(copies rotated over at least four times the 50 MB L2). Host time per call
(perf_counter over back-to-back calls ending in a sync) is reported beside
it. Each row carries the bytes its own inputs and outputs take (from the
tensors' sizes), the least time the card could take for them (those bytes
at the published 3.35 TB/s, or the operations at the fp32 / fp64 peaks) and
its share of the stream copy rate measured in the same run. The TPU-only
rows (``pallas_packed``, the ``lax.scan`` harness) have no counterpart.

On the CPU (``--device cpu``) every variant runs the plain version; only
host times are taken and every device field is null (not measured).

    python tools/torch/bench_kernels.py [--device cuda|cpu] [--sizes N ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rome_tpu_torch.ops import linearize_cuda as K  # noqa: E402
from rome_tpu_torch.ops import pairwise_cuda as P  # noqa: E402
from rome_tpu_torch.ops.fused_linearize import pose2pose2_linearize_plain  # noqa: E402

SIZES = (10_000, 100_000, 1_000_000)
# H100 SXM published peaks (NVIDIA's data sheet, dense, no sparsity): HBM
# bytes/s, non-tensor fp32 and fp64
HBM_BYTES_PER_S, FP32_FLOPS_PER_S, FP64_FLOPS_PER_S = 3.35e12, 67e12, 34e12
# K1 lin per factor: 19 values read, 21 written (4 or 8 B each); ~60 flops
# + 2 sincos
K1_VALUES, K1_FLOPS = 40, 80
# K1 normal per factor: slots 16 B, z 12, S 36, w 4 read; r 24, J 72,
# entries 144, Jtr 48 written; ~130 fp64 operations (the residual with two
# sincos, whitening, Jtr) and ~300 fp32 (the closed form with two sincosf,
# four 3x3 products); plus the pose table, 24 B a pose, read once
K1N_BYTES, K1N_FP64, K1N_FP32, POSE_BYTES = 356, 130, 300, 24
# the JAX script's per-eval operation counts (tools/bench_kernels.py:28-29)
FLOPS_FUSED = 150
L2_BYTES = 50 * 2**20
COLD_BYTES = 4 * L2_BYTES     # input copies rotated over at least this much
REPS = {"lin": 200, "normal": 200, "plain": 10}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_label(device: str) -> str:
    """The ``device`` field of every printed time: the card's nvidia-smi name
    and power limit on "cuda", "cpu" otherwise."""
    return card_line() if device == "cuda" else "cpu"


def require_device(device: str, script: str):
    """Exit with code 2 and a message when ``device`` is "cuda" and there is
    no CUDA device: a measuring script never falls back to the CPU."""
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"{script}: unknown device {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        print(f"{script}: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        raise SystemExit(2)


def launches():
    """Every kernel's launch count so far: K2/K3 by epilogue (their
    wrappers' counters), K1 as k1_lin / k1_normal."""
    return dict(P.LAUNCHES, **{f"k1_{k}": v for k, v in K.LAUNCHES.items()})


def launched_since(before):
    """The launches made since ``before`` (what ``launches`` returned)."""
    return {k: v - before[k] for k, v in launches().items()}


def bound(nbytes, flops, bytes_per_s=HBM_BYTES_PER_S, fp64_flops=0):
    """The least time (ms) the card could take, and what bounds it: the
    bytes over ``bytes_per_s``, or the fp32 ``flops`` and ``fp64_flops``
    over their peaks."""
    t_bytes = nbytes / bytes_per_s
    t_ops = flops / FP32_FLOPS_PER_S + fp64_flops / FP64_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps=200):
    """Milliseconds per call of ``fn`` by CUDA events over ``reps``
    back-to-back calls (host launch cost included when it exceeds the
    device's)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def stream_bandwidth(card, n=1 << 28, reps=20):
    """Device-to-device copy rate of a 1 GiB float32 buffer (bytes/s; read
    + write), CUDA events over ``reps`` copies."""
    x = torch.empty(n, dtype=torch.float32, device="cuda").uniform_()
    y = torch.empty_like(x)
    ms = cuda_ms(lambda: y.copy_(x), reps=reps)
    rate = 2 * 4 * n / (ms / 1e3)
    print(f"[{card}] stream copy of {4 * n / 2**30:.0f} GiB: {ms:.4f} ms, "
          f"{rate / 1e12:.4f} TB/s (read + write)", file=sys.stderr)
    del x, y
    torch.cuda.empty_cache()
    return rate


def make_batch(n, device, seed=0):
    """A chain of ``n`` Pose2Pose2 factors over ``n + 1`` poses as
    tools/bench_kernels.py's ``_make_batch`` makes it, with pose values as
    its ``main`` draws them: (values (n + 1, 3) float64, vslots (n, 2)
    int64, z (n, 3), S (n, 3, 3), w (n,) float32)."""
    rng = np.random.default_rng(seed)
    z = rng.normal([1.0, 0.0, 0.1], 0.05, size=(n, 3))
    S = np.broadcast_to(np.eye(3) * 10.0, (n, 3, 3))
    vslots = np.stack([np.arange(n), np.arange(n) + 1], axis=1)
    values = np.random.default_rng(seed + 1).normal(0, 1.0, size=(n + 1, 3))
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(values, dtype=torch.float64, device=device),
            torch.as_tensor(vslots, dtype=torch.int64, device=device),
            torch.as_tensor(z, **f32), torch.as_tensor(np.ascontiguousarray(S), **f32),
            torch.ones(n, **f32))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def variant_call(variant, batch):
    """(call, bytes its inputs and outputs take, fp32 ops, fp64 ops) of one
    launch of ``variant`` on ``batch`` (``make_batch``'s tuple)."""
    values, vslots, z, S, w = batch
    n = vslots.shape[0]
    if variant == "normal":
        entries = torch.empty(36 * n, dtype=torch.float32, device=values.device)
        plan = K.Pose2Pose2Normal(vslots, z, S, w, values.shape[0], entries)
        outs = (plan.r, plan.J1, plan.J2, plan.jtr, entries)
        return (lambda: plan(values)), _nbytes(values, vslots, z, S, w, *outs), \
            K1N_FP32 * n, K1N_FP64 * n
    p = values[vslots[:, 0]].to(torch.float32)
    q = values[vslots[:, 1]].to(torch.float32)
    fn = K.pose2pose2_linearize if variant == "lin" else pose2pose2_linearize_plain
    r, (J1, J2) = fn(p, q, z, S, w)
    return (lambda: fn(p, q, z, S, w)), _nbytes(p, q, z, S, w, r, J1, J2), K1_FLOPS * n, 0


def _host_us(call, reps, device):
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    if device == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def _device_us(calls, reps, host_us):
    """Device µs per launch: CUDA events around ``reps`` launches (input
    copies in turn) queued behind a sleep kernel longer than the host takes
    to queue them, so the card runs them back to back."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sleep = torch.cuda.Event(enable_timing=True)
    # calibrate the sleep kernel: cycles per ms
    torch.cuda.synchronize()
    sleep.record()
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / max(sleep.elapsed_time(start), 1e-3)
    torch.cuda._sleep(int(cycles_per_ms * (2.0 * reps * host_us / 1e3 + 5.0)))
    start.record()
    for i in range(reps):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def bench_variant(variant, n, device="cuda", bytes_per_s=None, reps=None):
    """One row: ``variant`` at ``n`` factors. On "cuda": device µs per
    launch (CUDA events, ``_device_us``), host µs per call, evals/s, the
    bound and the shares of it and of the measured stream rate
    ``bytes_per_s``; on "cpu": host µs per call only."""
    reps = reps or REPS[variant]
    first = make_batch(n, device)
    call, nbytes, f32, f64 = variant_call(variant, first)
    b_ms, b_by = bound(nbytes, f32, fp64_flops=f64)
    row = dict(n=n, variant=variant, bytes=nbytes, bytes_per_eval=nbytes / n,
               bound_us=b_ms * 1e3, bound_by=b_by)
    call()
    host = _host_us(call, reps, device)
    row["host_us_per_call"] = host
    if device != "cuda":
        row.update(us=None, evals_per_sec=None, gflops_est=None, pct_of_hbm_roofline=None,
                   pct_of_measured_stream=None, timer=None, input_copies=1)
        return row
    copies = max(1, min(reps, math.ceil(COLD_BYTES / nbytes)))
    calls = [call] + [variant_call(variant, make_batch(n, device, seed=k))[0]
                      for k in range(1, copies)]
    for c in calls:
        c()
    us = _device_us(calls, reps, host)
    evals = n / (us * 1e-6)
    row.update(us=us, evals_per_sec=evals, gflops_est=evals * FLOPS_FUSED / 1e9,
               pct_of_hbm_roofline=100.0 * row["bound_us"] / us,
               pct_of_measured_stream=(100.0 * nbytes / bytes_per_s / (us * 1e-6)
                                       if bytes_per_s else None),
               timer="cuda_events", input_copies=copies)
    del calls
    torch.cuda.empty_cache()
    return row


def run(device="cuda", sizes=SIZES, card=None, bytes_per_s=None, verbose=True):
    """Every variant at every size; the measured stream rate first (on the
    card, unless ``bytes_per_s`` is given). Returns the document ``main``
    prints."""
    card = card or device_label(device)
    if device == "cuda" and bytes_per_s is None:
        bytes_per_s = stream_bandwidth(card)
    variants, before = {}, launches()
    for variant in ("lin", "normal", "plain"):
        rows = []
        for n in sizes:
            rows.append(bench_variant(variant, n, device, bytes_per_s))
            if verbose:
                print(json.dumps(dict(rows[-1], device=card)), file=sys.stderr, flush=True)
        variants[variant] = rows
    return dict(
        kernel="Pose2Pose2 linearize K1 (residual + 2 Jacobians; normal: + JtJ entries, Jtr)",
        source="rome_tpu_torch/csrc/pose2pose2_linearize.cu",
        device=card,
        methodology=("CUDA events around back-to-back launches queued behind a sleep kernel "
                     "(device time per launch), input copies rotated over >= 4x the L2; host "
                     "time per call by perf_counter beside it" if device == "cuda"
                     else "CPU: plain versions, host time per call only"),
        roofline=dict(hbm_bytes_per_s=HBM_BYTES_PER_S, fp32_flops_per_s=FP32_FLOPS_PER_S,
                      fp64_flops_per_s=FP64_FLOPS_PER_S,
                      measured_stream_bytes_per_s=bytes_per_s),
        rows=variants["lin"],
        variants=variants,
        launches=launched_since(before),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--out", help="also write the document to this JSON file")
    args = ap.parse_args(argv)
    require_device(args.device, "bench_kernels")
    doc = run(args.device, tuple(args.sizes))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
