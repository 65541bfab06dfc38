"""The yardstick of ``se3_lin_roofline``: the least time one trial linearize
of a Pose3 graph's LM iteration can take on the card, from the bytes and
the operations its real factors need (``roofline.py`` counts K1's alike).

What one trial linearize (``solvers/linearize.linearize_all_mixed_j`` at
the trial point, the program's ``lm.trial_linearize`` phase) must move, each
input read once and each output written once, in the dtypes the program
holds them (a float32 graph on the ndchol path: poses in float64, params
and weights float32, slots int64, residuals float64, Jacobians float32):

- per factor of arity k and measurement size d: k slots (8 B each), z
  (d x 4 B), the whitening matrix (d x d x 4 B), the weight (4 B) read;
  the residual (d x 8 B) and k Jacobians (d x 6 x 4 B each) written;
- per pose: its (t, q) in float64 (7 x 8 B), read once.

The operations are those of the closed form (the reference's analytic
Jacobians, ``benchmark/se3_reference.py``), counted per factor below. At
the float32 peak they take a tenth of the byte time or less, so the bytes
bound the phase; ``least_seconds`` takes the larger of the two anyway.
"""

from __future__ import annotations

from benchmark.roofline import HBM_BYTES_PER_S

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores (700 W)
FP32_FLOPS_PER_S = 67e12

SLOT_B, PARAM_B, POSE_B, RESID_B, JAC_B = 8, 4, 8, 8, 4
POSE_WIDTH, DOF = 7, 6

# closed-form operations of one factor (multiply-adds as two): Exp of z's
# rotation 20, compose 58 (rotate 30, quaternion product 28), inverse 30,
# compose 58, Log 20, whitening 66; the Jacobian blocks R_q^T R_p 45, its
# product with [z_t]x 45, Jr^-1 40, Jr^-1 R_z^T 45 and R_z 30, whitening
# both 6 x 6 blocks 2 x 396
POSE3POSE3_FLOPS = 20 + 58 + 30 + 58 + 20 + 66 + 45 + 45 + 40 + 45 + 30 + 2 * 396
# Exp 20, inverse 30, compose 58, Log 20, whitening 66; Jl^-1 40, one
# whitened 6 x 6 block 396
PRIOR_POSE3_FLOPS = 20 + 30 + 58 + 20 + 66 + 40 + 396


def factor_bytes(arity: int, zdim: int = DOF) -> int:
    """Bytes one factor of ``arity`` Pose3 slots moves in a linearize."""
    reads = arity * SLOT_B + zdim * PARAM_B + zdim * zdim * PARAM_B + PARAM_B
    writes = zdim * RESID_B + arity * zdim * DOF * JAC_B
    return reads + writes


def trial_linearize_bytes(between: int, priors: int, poses: int) -> int:
    """Least bytes of one trial linearize of ``between`` Pose3Pose3 and
    ``priors`` PriorPose3 factors over ``poses`` Pose3 variables."""
    return (between * factor_bytes(2) + priors * factor_bytes(1)
            + poses * POSE_WIDTH * POSE_B)


def trial_linearize_flops(between: int, priors: int) -> int:
    return between * POSE3POSE3_FLOPS + priors * PRIOR_POSE3_FLOPS


def least_seconds(between: int, priors: int, poses: int) -> float:
    """The larger of the bytes' time at the HBM rate and the operations'
    at the float32 peak."""
    return max(trial_linearize_bytes(between, priors, poses) / HBM_BYTES_PER_S,
               trial_linearize_flops(between, priors) / FP32_FLOPS_PER_S)


def share_pct(least_s: float, seconds: float):
    """Percent of the least time that ``seconds`` of the phase reached;
    None without a time."""
    if seconds is None or seconds <= 0:
        return None
    return 100.0 * least_s / seconds
