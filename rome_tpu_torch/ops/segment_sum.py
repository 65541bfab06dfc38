"""Sums in an order fixed by the structure: the Levenberg-Marquardt path's
scatter-adds without atomics.

``index_add_`` on a CUDA tensor adds colliding contributions with atomics, in
an order that changes from run to run, so the same solve can take another
number of LM iterations on the next run. A :class:`SegmentPlan` is made once
per connectivity on the host: a stable sort of the destination index (ties
broken by the caller's structural keys, then by position) puts every
destination's contributions side by side; ``add_`` then gathers the values in
that order, sums each destination's run with ``torch.segment_reduce`` (one
thread, or one CUB block, per run in a fixed order: the same bits every run)
and adds the one sum per destination into the output. Where no destination
repeats, the gather and one collision-free ``index_add_`` are all it takes.
"""

from __future__ import annotations

import numpy as np
import torch


class SegmentPlan:
    """Fixed-order ``out[dst[e]] += vals[src[e]]`` over every entry ``e``.

    ``keys``: per-entry integer arrays (each (E,) or (E, c)) that order the
    contributions of one destination before the position does; the first
    key is the most significant.
    """

    def __init__(self, dst, src=None, keys=(), device="cpu"):
        dst = np.asarray(dst, dtype=np.int64).reshape(-1)
        src = np.arange(dst.size, dtype=np.int64) if src is None else (
            np.asarray(src, dtype=np.int64).reshape(-1))
        cols = []
        for k in keys:
            k = np.asarray(k, dtype=np.int64)
            cols.extend([k] if k.ndim == 1 else list(k.T))
        # np.lexsort: the last key is the primary one; stable among equals
        order = np.lexsort(tuple(reversed(cols)) + (dst,)) if cols else (
            np.argsort(dst, kind="stable"))
        sdst = dst[order]
        uniq, starts = np.unique(sdst, return_index=True)
        self.n = int(dst.size)
        self.src = torch.as_tensor(src[order], device=device)
        self.dst = torch.as_tensor(uniq, device=device)
        self.offsets = None
        if uniq.size != dst.size:
            self.offsets = torch.as_tensor(np.append(starts, dst.size), device=device)
        self.max_run = int(np.diff(np.append(starts, dst.size)).max()) if dst.size else 0

    def add_(self, out: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """``out`` (rows along dim 0) plus each destination's contributions
        from ``vals`` (entries along dim 0), summed in the plan's order."""
        if self.n == 0:
            return out
        v = vals.index_select(0, self.src)
        if self.offsets is not None:
            v = torch.segment_reduce(v, "sum", offsets=self.offsets, axis=0, unsafe=True)
        return out.index_add_(0, self.dst, v.to(out.dtype))

