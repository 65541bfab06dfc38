"""Sums in an order fixed by the structure: the port's scatter-adds without
atomics.

``index_add_`` on a CUDA tensor adds colliding contributions with atomics, in
an order that changes from run to run, so the same solve can take another
number of LM iterations on the next run. A :class:`SegmentPlan` is made once
per connectivity: a stable sort of the destination index (ties broken by the
caller's structural keys, then by position) puts every destination's
contributions side by side; ``add_`` then gathers the values in that order,
sums each destination's run with ``torch.segment_reduce`` (one thread, or one
CUB block, per run in a fixed order: the same bits every run) and adds the
one sum per destination into the output. Where no destination repeats, the
gather and one collision-free ``index_add_`` are all it takes.

The sort runs on the plan's device, as one stable ``torch.sort`` per key
column and one of the destinations (least significant first): a stable
sort's output is unique, so the plan is the same on every run and on every
device, whether its indices come from the host or from the device.

A plan's run arrays have one entry per distinct destination, so their
lengths change with the connectivity. A :class:`FixedSegmentPlan` holds a
plan in arrays whose lengths the entry count alone fixes, for a device
program that serves every connectivity of one shape: it loads another
plan of the same entry count by copying into its buffers.
"""

from __future__ import annotations

import torch


def _index(x, device):
    return torch.as_tensor(x, device=device).to(torch.int64)


class SegmentPlan:
    """Fixed-order ``out[dst[e]] += vals[src[e]]`` over every entry ``e``.

    ``dst``, ``src`` (default: the positions) and ``keys`` are numpy arrays
    or tensors. ``keys``: per-entry integer arrays (each (E,) or (E, c))
    that order the contributions of one destination before the position
    does; the first key is the most significant.
    """

    def __init__(self, dst, src=None, keys=(), device="cpu"):
        dst = _index(dst, device).reshape(-1)
        cols = []
        for k in keys:
            k = _index(k, device)
            cols.extend([k] if k.dim() == 1 else list(k.T))
        order = torch.arange(dst.numel(), device=device)
        for col in reversed([dst] + cols):
            order = order[torch.sort(col[order], stable=True).indices]
        sdst = dst[order]
        uniq, counts = torch.unique_consecutive(sdst, return_counts=True)
        self.n = int(dst.numel())
        self.src = order if src is None else _index(src, device).reshape(-1)[order]
        self.dst = uniq
        self.offsets = None
        if uniq.numel() != self.n:
            self.offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        self.max_run = int(counts.max()) if self.n else 0

    def add_(self, out: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """``out`` (rows along dim 0) plus each destination's contributions
        from ``vals`` (entries along dim 0), summed in the plan's order."""
        if self.n == 0:
            return out
        v = vals.index_select(0, self.src)
        if self.offsets is not None:
            v = torch.segment_reduce(v, "sum", offsets=self.offsets, axis=0, unsafe=True)
        return out.index_add_(0, self.dst, v.to(out.dtype))


class FixedSegmentPlan:
    """A :class:`SegmentPlan` in arrays of fixed length: ``src`` and ``dst``
    (E,) and ``offsets`` (E + 1,) for a plan of E entries. The plan's runs
    come first, in its order; the rest are empty runs into the row
    ``dump``, which ``out`` must have and whose sum no caller reads. A
    plan whose destinations never repeat has runs of one entry. Its sums
    are the plan's bit for bit: each run sums the same contributions in the
    same order (a sum starts at +0.0, and 0.0 + x is x) and an empty run
    adds +0.0 to the dump row only. :meth:`load` copies in another plan of
    E entries on the device, with no host read."""

    def __init__(self, plan: SegmentPlan, dump: int):
        self.n, self.dump = plan.n, dump
        dev = plan.src.device
        self.src = torch.empty(plan.n, dtype=torch.int64, device=dev)
        self.dst = torch.empty(plan.n, dtype=torch.int64, device=dev)
        self.offsets = torch.empty(plan.n + 1, dtype=torch.int64, device=dev)
        self.load(plan)

    def load(self, plan: SegmentPlan):
        """This plan's sums := ``plan``'s."""
        if plan.n != self.n:
            raise ValueError(f"a plan of {plan.n} entries in a fixed plan of {self.n}")
        u = plan.dst.numel()
        self.src.copy_(plan.src)
        self.dst[:u].copy_(plan.dst)
        self.dst[u:].fill_(self.dump)
        if plan.offsets is None:
            torch.arange(self.n + 1, out=self.offsets)
        else:
            self.offsets[: u + 1].copy_(plan.offsets)
            self.offsets[u + 1:].fill_(self.n)
        return self

    def add_(self, out: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """As :meth:`SegmentPlan.add_`; ``out`` has the row ``dump``."""
        if self.n == 0:
            return out
        v = vals.index_select(0, self.src)
        v = torch.segment_reduce(v, "sum", offsets=self.offsets, axis=0, unsafe=True)
        return out.index_add_(0, self.dst, v.to(out.dtype))
