"""Gaussian odometry accumulation + dead-reckon tether support (counterpart
of ``rome_tpu/frontend/odometry.py``; reference: OdometryUtils.jl).

Host-side float64 numpy, except :func:`assemble_chords_dict`, which composes
the chords in float32 torch on its ``device`` as the JAX package does in
float32 JAX.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from rome_tpu_torch.distributions import MvNormal
from rome_tpu_torch.factors.base import Factor, gaussian_params
from rome_tpu_torch.factors.pose2 import MutablePose2Pose2Gaussian, Pose2Pose2
from rome_tpu_torch.graph.graph import FactorGraph
from rome_tpu_torch.variables import Pose2


def _sym_rem(theta):
    """Wrap angle(s) to [-pi, pi) in float64 numpy (``utils.math.sym_rem``'s
    arithmetic)."""
    return np.mod(np.asarray(theta, dtype=np.float64) + np.pi, 2 * np.pi) - np.pi


def _se2_mat(x):
    """Homogeneous SE(2) matrix from (x, y, theta) — the reference's SE2()."""
    c, s = np.cos(x[2]), np.sin(x[2])
    return np.array([[c, -s, x[0]], [s, c, x[1]], [0, 0, 1.0]])


def _se2_vee(H):
    return np.array([H[0, 2], H[1, 2], np.arctan2(H[1, 0], H[0, 0])])


def accumulate_discrete_local_frame(
    mpp: Factor,
    DX,
    Qc,
    dt: float = 1.0,
    Fk=None,
    Gk=None,
):
    """accumulateDiscreteLocalFrame! (OdometryUtils.jl:24-51): advance the
    mutable odometry factor mean by ``X_2 = X_1 ∘ DX`` and propagate its
    covariance ``P_{k+1} = Phi P_k Phi^T + Qd`` with first-order
    continuous->discrete noise integration of the body-frame density Qc."""
    assert mpp.ftype.name == "MutablePose2Pose2Gaussian"
    DX = np.asarray(DX, dtype=np.float64)
    Qc = np.asarray(Qc, dtype=np.float64)
    mu = mpp.params["z"].copy()
    Sigma = np.asarray(mpp.dists[0].cov())

    Phik = _se2_mat(DX)
    Gk = np.eye(3) if Gk is None else np.asarray(Gk)
    # discrete noise: Qd ≈ Phi G Qc G^T Phi^T dt (Chirikjian Vol.II 2012 p.35
    # first-order; matches IIF cont2disc usage in the reference)
    Qd = Phik @ Gk @ Qc @ Gk.T @ Phik.T * dt

    kXk1 = _se2_mat(mu) @ Phik
    Cov = Phik @ Sigma @ Phik.T + Qd
    check = np.linalg.norm(Cov - Cov.T)
    assert check < 1.0, "covariance dangerously non-Hermitian"
    Cov = 0.5 * (Cov + Cov.T)

    mean = _se2_vee(kXk1)
    mpp.params.update(gaussian_params(mean, Cov))
    mpp.dists = (MvNormal(mean, Cov),)
    return mpp


def duplicate_to_standard_factor_variable(
    mpp: Factor,
    fg: FactorGraph,
    prevsym: str,
    newsym: str,
    solvable: int = 1,
    graphinit: bool = True,
    cov: Optional[np.ndarray] = None,
) -> str:
    """duplicateToStandardFactorVariable (OdometryUtils.jl:67-86): snapshot
    the accumulated mutable odometry into a standard Pose2Pose2 + new
    variable. Returns the new factor label."""
    mean = mpp.params["z"].copy()
    C = np.asarray(mpp.dists[0].cov()) if cov is None else np.asarray(cov)
    posepose = Pose2Pose2(MvNormal(mean, C))
    fg.add_variable(newsym, Pose2, solvable=solvable, timestamp_ns=mpp.timestamp_ns)
    fct = fg.add_factor(
        [prevsym, newsym], posepose, solvable=solvable, graphinit=graphinit,
        timestamp_ns=mpp.timestamp_ns,
    )
    return fct.label


def reset_factor(mpp: Factor):
    """resetFactor! (OdometryUtils.jl:93): zero the accumulated transform."""
    mean = np.zeros(3)
    cov = 1e-6 * np.eye(3)
    mpp.params.update(gaussian_params(mean, cov))
    mpp.dists = (MvNormal(mean, cov),)
    return mpp


def extract_delta_odo(XX, YY, TH):
    """extractDeltaOdo (OdometryUtils.jl:111-128): recover body-frame deltas
    from world-frame dead-reckoning traces."""
    XX, YY, TH = (np.asarray(a, dtype=np.float64) for a in (XX, YY, TH))
    n = len(XX)
    DX = np.zeros((3, n))
    for i in range(1, n):
        wTbk = _se2_mat([XX[i - 1], YY[i - 1], TH[i - 1]])
        wTbk1 = _se2_mat([XX[i], YY[i], TH[i]])
        DX[:, i] = _se2_vee(np.linalg.inv(wTbk) @ wTbk1)
    return DX


def _pair_factor(fg: FactorGraph, a: str, b: str):
    """First binary factor joining variables a and b, or None."""
    for flbl in fg._adj.get(a, ()):
        f = fg.factors[flbl]
        if len(f.variables) == 2 and b in f.variables:
            return f
    return None


def accumulate_factor_chain(fg: FactorGraph, from_: str, to_: str):
    """accumulateFactorChain analogue (OdometryUtils.jl:~135): compose the
    odometry measurement means along the consecutive pose chain
    ``from_ -> ... -> to_`` into one relative SE(2) transform; also return
    the same chord according to the current SLAM solution."""
    i0 = int(re.sub(r"\D", "", from_))
    i1 = int(re.sub(r"\D", "", to_))
    prefix = re.sub(r"\d+$", "", from_)
    acc = np.zeros(3)
    for k in range(i0, i1):
        f = _pair_factor(fg, f"{prefix}{k}", f"{prefix}{k + 1}")
        if f is None:
            raise KeyError(f"no odometry factor {prefix}{k}->{prefix}{k + 1}")
        acc = _se2_vee(_se2_mat(acc) @ _se2_mat(np.asarray(f.params["z"])))
    soln = None
    if fg.is_initialized(from_) and fg.is_initialized(to_):
        xa, xb = fg.get_coords(from_), fg.get_coords(to_)
        soln = _se2_vee(np.linalg.inv(_se2_mat(xa)) @ _se2_mat(xb))
    return acc, soln


def assemble_chords_dict(fg: FactorGraph, vsyms=None, maxadi: int = 10, device="cuda"):
    """assembleChordsDict analogue (OdometryUtils.jl:169-194).

    For every pose x_i and every x_j up to ``maxadi`` ahead, the relative
    SE(2) chord (a) composed from odometry measurements only and (b) from the
    SLAM solution. The reference spawns a Julia task per chord
    (Threads.@spawn); here all chords come out of one float32 prefix-compose
    of the odometry means on ``device`` (the headings are a cumulative sum,
    the positions a cumulative sum of each step's translation rotated by the
    heading before it) and one batched ``local`` over every (i, j) pair.
    Returns {from: {to: (meas_rel, soln_rel)}} with (3,) float32 arrays (the
    reference returns 3x100 particle matrices; sample around the means with
    the accumulated covariance if particle form is needed)."""
    import torch

    from rome_tpu_torch.manifolds.base import SE2_
    from rome_tpu_torch.utils.device import entry_device
    from rome_tpu_torch.utils.math import matvec, rot2, sym_rem

    entry_device(device)
    if vsyms is None:
        vsyms = fg.ls(r"^x\d+$")
    vsyms = sorted(vsyms, key=lambda s: int(re.sub(r"\D", "", s)))
    n = len(vsyms)
    if n < 2:
        return {}

    dxs = []
    for a, b in zip(vsyms[:-1], vsyms[1:]):
        f = _pair_factor(fg, a, b)
        if f is None:
            raise KeyError(f"no odometry factor {a}->{b}")
        dxs.append(np.asarray(f.params["z"]))
    dxs = torch.as_tensor(np.stack(dxs), dtype=torch.float32, device=device)

    zero = torch.zeros(1, dtype=torch.float32, device=device)
    heading = torch.cat([zero, torch.cumsum(dxs[:, 2], 0)])
    steps = matvec(rot2(heading[:-1]), dxs[:, :2])
    xy = torch.cat([torch.zeros(1, 2, dtype=torch.float32, device=device),
                    torch.cumsum(steps, 0)])
    cum_meas = torch.cat([xy, sym_rem(heading)[:, None]], dim=-1)

    have_soln = all(fg.is_initialized(v) for v in vsyms)
    cum_soln = (
        torch.as_tensor(np.stack([fg.get_coords(v) for v in vsyms]), dtype=torch.float32,
                        device=device)
        if have_soln
        else None
    )

    i = torch.arange(n - 1, device=device)[:, None]
    j = i + torch.arange(1, maxadi + 1, device=device)[None, :]
    keep = j <= n - 1
    ii, jj = i.expand_as(j)[keep], j[keep]
    rel_meas = SE2_.local(cum_meas[ii], cum_meas[jj]).cpu().numpy()
    rel_soln = (
        SE2_.local(cum_soln[ii], cum_soln[jj]).cpu().numpy() if cum_soln is not None else None
    )

    chords: dict = {}
    for k, (a, b) in enumerate(zip(ii.tolist(), jj.tolist())):
        chords.setdefault(vsyms[a], {})[vsyms[b]] = (
            rel_meas[k],
            None if rel_soln is None else rel_soln[k],
        )
    return chords


def add_odo_fg(
    fg: FactorGraph,
    odo_factor: Factor,
    solvable: int = 1,
    graphinit: bool = True,
) -> str:
    """addOdoFG! (OdometryUtils.jl:206-280): append a new pose connected to
    the latest ``x<n>`` pose by the given odometry factor; auto-increments
    the pose label. Returns the new variable label."""
    xs = [l for l in fg.ls(r"^x\d+$")]
    assert xs, "graph needs an initial pose (use initFactorGraph / ZeroPose)"
    last = max(xs, key=lambda s: int(re.search(r"\d+", s).group()))
    n = int(re.search(r"\d+", last).group()) + 1
    new = f"x{n}"
    fg.add_variable(new, Pose2, solvable=solvable)
    fg.add_factor([last, new], odo_factor, solvable=solvable, graphinit=graphinit)
    return new


def trigger_pose(
    x, x_last, t_now=None, t_prev=None, distrule=0.5, timerule=1e12, yawrule=0.3
) -> int:
    """triggerPose (OdometryUtils.jl:282-299): new-pose decision rule.

    Returns 1 on distance trigger, 2 on yaw trigger, 3 on time trigger,
    0 otherwise. Two-argument form ``trigger_pose(x, xprev, dist, yaw)`` is
    also accepted for convenience (time rule disabled).
    """
    if t_now is not None and t_prev is None:
        # legacy convenience: (x, xprev, distrule, yawrule)
        distrule, yawrule = float(t_now), float(distrule)
        t_now = t_prev = 0.0
    t_now = 0.0 if t_now is None else float(t_now)
    t_prev = 0.0 if t_prev is None else float(t_prev)
    x, x_last = np.asarray(x), np.asarray(x_last)
    if np.linalg.norm(x[:2] - x_last[:2]) >= distrule:
        return 1
    if abs(float(_sym_rem(x[2] - x_last[2]))) >= yawrule:
        return 2
    if t_now - t_prev > timerule:
        return 3
    return 0


# reference-style aliases
accumulateDiscreteLocalFrame = accumulate_discrete_local_frame
duplicateToStandardFactorVariable = duplicate_to_standard_factor_variable
resetFactor = reset_factor
extractDeltaOdo = extract_delta_odo
addOdoFG = add_odo_fg
triggerPose = trigger_pose
