"""The yardstick of the kernels' roofline shares: the card's published
peak and the bytes one launch of K1 (rome_tpu_torch/csrc/
pose2pose2_linearize.cu) must move, counted from the real factors once,
without padding (tools/torch/bench_kernels.py's counts).

K1 is bound by bytes at every shape the cells run (its operations take
under a tenth of the byte time at the fp32 and fp64 peaks), so its least
time is its bytes over the HBM rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s (at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12

# K1 normal, per factor: slots 16 B, z 12, S 36, w 4 read; r 24, J 72, JtJ
# entries 144, Jtr 48 written; plus the float64 pose table, 24 B a pose,
# read once
K1_NORMAL_FACTOR_BYTES, POSE_BYTES = 356, 24
# K1 lin, per factor: p, q, z (3 each), S (9), w (1) read and r (3), J1, J2
# (9 each) written, float32
K1_LIN_FACTOR_BYTES = 160


def k1_normal_bytes(factors: int, poses: int) -> int:
    return K1_NORMAL_FACTOR_BYTES * factors + POSE_BYTES * poses


def k1_lin_bytes(factors: int) -> int:
    return K1_LIN_FACTOR_BYTES * factors


def share_pct(nbytes: float, seconds: float):
    """Percent of the least time ``nbytes`` take at the HBM peak that
    ``seconds`` of kernel time reached; None without kernel time."""
    if seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
