"""Closed-form Pose2Pose2 linearization, plain PyTorch.

Counterpart of ``rome_tpu/ops/fused_linearize.py``: the same whitened
residual and Jacobians, with the factor weight applied (the contract of the
hand kernel K1's ``lin`` epilogue in ``ops/linearize_cuda.py``, whose plain
version this is). :func:`pose2pose2_normal_plain` is the plain version of
K1's ``normal`` epilogue: the ndchol LM path's composition for a Pose2Pose2
batch, in the order the solver ran it before the epilogue existed.

Derivation (Pose2Pose2, hybrid SE(2) tangent — Pose2D.jl:48-67):
  qhat = p ∘ exp(z);  r_raw = log(q'⁻¹ ∘ qhat) with q' = q ∘ exp(dq),
  p' = p ∘ exp(dp). At dp = dq = 0, writing θ1 = pθ - qθ, R = R(θ1):
    r_t = R(-qθ)(tp + R(pθ) z_t - tq),  r_θ = wrap(pθ + zθ - qθ)
    ∂r_t/∂dp_t = R(θ1)          ∂r_t/∂dpθ = R(θ1) J z_t
    ∂r_t/∂dq_t = -I             ∂r_t/∂dqθ = -J r_t
    ∂r_θ/∂dpθ = 1               ∂r_θ/∂dqθ = -1       (J = R(π/2))
Whitening multiplies rows by S = sqrt_info; the weight multiplies through.
"""

from __future__ import annotations

import torch

from rome_tpu_torch.factors.pose2 import POSE2POSE2
from rome_tpu_torch.manifolds.base import SE2_
from rome_tpu_torch.utils.math import einsum, matvec, sym_rem


def pose2pose2_linearize_plain(p, q, z, S, w):
    """Weighted whitened (r0, (J1, J2)) for a Pose2Pose2 batch.

    p, q, z: (n, 3); S: (n, 3, 3); w: (n,). Returns r0 (n, 3) and J1, J2
    (n, 3, 3), each multiplied by w.
    """
    px, py, pt = p[:, 0], p[:, 1], p[:, 2]
    qx, qy, qt = q[:, 0], q[:, 1], q[:, 2]
    zx, zy, zt = z[:, 0], z[:, 1], z[:, 2]

    cp, sp = torch.cos(pt), torch.sin(pt)
    cq, sq = torch.cos(qt), torch.sin(qt)
    # theta1 = pt - qt via angle-sum identities
    c1 = cp * cq + sp * sq
    s1 = sp * cq - cp * sq

    # qhat translation minus q translation, then rotate by R(-qt)
    dx = px + cp * zx - sp * zy - qx
    dy = py + sp * zx + cp * zy - qy
    r0x = cq * dx + sq * dy
    r0y = -sq * dx + cq * dy
    r0t = sym_rem(pt + zt - qt)

    # J1 columns: [R(θ1) | R(θ1) J z_t], J z_t = (-zy, zx)
    a = -c1 * zy - s1 * zx
    b = -s1 * zy + c1 * zx
    one = torch.ones_like(c1)
    zero = torch.zeros_like(c1)
    J1 = torch.stack(
        [
            torch.stack([c1, -s1, a], dim=-1),
            torch.stack([s1, c1, b], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    # J2: [-I | -J r_t]; -J r = (r_y, -r_x)
    J2 = torch.stack(
        [
            torch.stack([-one, zero, r0y], dim=-1),
            torch.stack([zero, -one, -r0x], dim=-1),
            torch.stack([zero, zero, -one], dim=-1),
        ],
        dim=-2,
    )
    r0 = torch.stack([r0x, r0y, r0t], dim=-1)
    # whiten, then weight
    r0 = torch.einsum("nij,nj->ni", S, r0)
    J1 = S @ J1
    J2 = S @ J2
    return r0 * w[:, None], (J1 * w[:, None, None], J2 * w[:, None, None])


def pose2pose2_normal_plain(values, vslots, z, S, w):
    """K1's normal epilogue, plain: one Pose2Pose2 batch of the ndchol LM path.

    values: (count, 3) float64 pose table; vslots: (n, 2) int64 slots of p
    and q; z (n, 3), S (n, 3, 3), w (n,) in the graph's float32. Returns
    r (n, 3) float64 (the generic residual route, ``batch_residual`` on the
    float64 graph), (J1, J2) (n, 3, 3) float32 (the lin epilogue on the
    float32-rounded poses), the JᵀJ entry values (4, n, 3, 3) float32 in the
    symbolic phase's order J1ᵀJ1, J1ᵀJ2, J2ᵀJ1, J2ᵀJ2, and the Jᵀr
    contributions (2, n, 3) float64 (J promoted), each computed as
    ``normal_eq_entry_values`` and ``gradient_from_lins`` compute them.
    """
    p, q = values[vslots[:, 0]], values[vslots[:, 1]]
    zero = (torch.zeros(p.shape, dtype=values.dtype, device=values.device),
            torch.zeros(q.shape, dtype=values.dtype, device=values.device))
    raw = POSE2POSE2.residual({"z": z}, SE2_.boxplus(p, zero[0]), SE2_.boxplus(q, zero[1]))
    r = matvec(S, raw) * w[:, None]
    _r32, Js = pose2pose2_linearize_plain(
        p.to(torch.float32), q.to(torch.float32), z, S, w)
    entries = torch.stack([einsum("nij,nik->njk", Js[k], Js[l]) for k in (0, 1) for l in (0, 1)])
    jtr = torch.stack([einsum("nij,ni->nj", J, r) for J in Js])
    return r, Js, entries, jtr
