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
