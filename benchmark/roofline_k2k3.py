"""The bytes one launch of the Gibbs label draws K2 and K3 must move
(rome_tpu_torch/csrc/pairwise_logw.cu, the draw epilogue of each), counted
from the launch's shape as ``benchmark/roofline.py`` counts K1's: each
input read once and each output written once, at the HBM peak there.

A draw launch scores every candidate j of one density against every output
particle n of each of V variables and draws one label per (v, n): it reads
ref and mu (V, N, dof), pts (V, Nj, dof), inv_var (V, dof), K3's circular
mask (dof,) and the uniforms u (V, N, Nj), all float32, and writes the
labels (V, N) as int64. Its operations (about 30 a pair) take under a
third of the byte time at the fp32 peak at the shapes the cells run, so
its least time is its bytes over the HBM rate.
"""

from __future__ import annotations

F32, I64 = 4, 8


def k2_draw_bytes(V: int, N: int, Nj: int) -> int:
    """K2 (SE(2), dof 3)."""
    return F32 * (2 * V * N * 3 + V * Nj * 3 + V * 3 + V * N * Nj) + I64 * V * N


def k3_draw_bytes(V: int, N: int, Nj: int, dof: int) -> int:
    """K3 (per-dim linear or circular, ``dof`` <= 8)."""
    return F32 * (2 * V * N * dof + V * Nj * dof + V * dof + dof + V * N * Nj) + I64 * V * N


def draw_times(trace, row):
    """Durations (s) of the trace's draw launches of the kernel instance
    whose score row is ``row`` (``Se2Row``: K2; ``EuclidRow``: K3), by the
    demangled name (``(anonymous namespace)::gibbs_kernel<(anonymous
    namespace)::Se2Row, true>(...)``) or the mangled one
    (``..._Z12gibbs_kernelIN12_GLOBAL__N_16Se2RowELb1EE...``); the logw
    epilogue's (``false>``, ``Lb0E``) are not."""
    return [t for mark in (", true>", "Lb1E") for t in trace.kernels("gibbs_kernel", row, mark)]
