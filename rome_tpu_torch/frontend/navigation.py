"""Dead-reckoning navigation front-end (GenericInSituSystem), counterpart of
``rome_tpu/frontend/navigation.py``.

Reference: NavigationSystem.jl:7-166 — the Victoria-Park-style
dead-reckoning state container with pose-trigger integration and
feature-tracker plumbing; Ackermann odometry helpers from
examples/WheeledRobotUtils.jl:86-127. The dead reckoning is float64 numpy on
the host; the feature trackers run on ``device`` (``frontend.tracker``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from rome_tpu_torch.frontend.odometry import trigger_pose
from rome_tpu_torch.frontend.tracker import FeatureTracker, c2p


def _se2_mat(x):
    c, s = np.cos(x[2]), np.sin(x[2])
    return np.array([[c, -s, x[0]], [s, c, x[1]], [0, 0, 1.0]])


def _se2_vee(H):
    return np.array([H[0, 2], H[1, 2], np.arctan2(H[1, 0], H[0, 0])])


@dataclass
class LaserFeatures:
    """entities/RobotDataTypes.jl:1-4."""

    t: float
    feats: np.ndarray  # (>=2, numz) columns [range; bearing; ...]


@dataclass
class GenericInSituSystem:
    """NavigationSystem.jl:7-24: dead-reckon state + odo subsampling +
    per-pose feature associations."""

    xprev: np.ndarray
    x: np.ndarray
    dOdo: dict = field(default_factory=dict)       # poseid -> [x,y,th,T,rule]
    FeatAssc: dict = field(default_factory=dict)   # poseid -> {fid: meas}
    Tprev: float = 0.0
    T0: float = 0.0
    poseid: int = 1
    wTbk1: np.ndarray = field(default_factory=lambda: np.eye(3))
    bk1Tbk: np.ndarray = field(default_factory=lambda: np.eye(3))
    lstlaseridx: int = 0
    trackers: Optional[FeatureTracker] = None


def make_in_situ_system(x, bfts0, device="cuda") -> GenericInSituSystem:
    """makeInSituSys (NavigationSystem.jl:22-46); the trackers on ``device``."""
    x = np.asarray(x, dtype=np.float64)
    sys = GenericInSituSystem(
        xprev=x.copy(), x=x.copy(), wTbk1=_se2_mat(x),
        trackers=FeatureTracker.init_from(bfts0, device=device),
    )
    sys.dOdo[sys.poseid] = np.array([x[0], x[1], x[2], sys.T0, 0.0])
    return sys


def make_generic_in_situ_system(x) -> GenericInSituSystem:
    """makeGenericInSituSys (NavigationSystem.jl:49-73)."""
    x = np.asarray(x, dtype=np.float64)
    sys = GenericInSituSystem(xprev=x.copy(), x=x.copy(), wTbk1=_se2_mat(x))
    sys.dOdo[sys.poseid] = np.array([x[0], x[1], x[2], sys.T0, 0.0])
    return sys


def pose_trig_and_add(
    sys: GenericInSituSystem,
    Ts: float,
    distrule: float,
    timerule: float,
    yawrule: float,
    xprev=None,
    auxtrig: bool = False,
) -> bool:
    """poseTrigAndAdd! (NavigationSystem.jl:76-93): subsample dead-reckoned
    motion into factor-graph poses; resets local frame on trigger."""
    xprev = np.zeros(3) if xprev is None else np.asarray(xprev)
    rule = trigger_pose(sys.x, xprev, Ts, sys.Tprev, distrule, timerule, yawrule)
    if rule != 0 or auxtrig:
        sys.bk1Tbk = _se2_mat(sys.x)
        sys.poseid += 1
        sys.dOdo[sys.poseid] = np.array([sys.x[0], sys.x[1], sys.x[2], Ts, float(rule)])
        sys.wTbk1 = sys.wTbk1 @ sys.bk1Tbk
        sys.Tprev = Ts
        sys.x[:] = 0.0
        return True
    return False


def get_feats_at_t(lsr_feats, T, prev: int = 1):
    """getFeatsAtT (WheeledRobotUtils.jl:117-127); lsr_feats is a dict of
    1-based indices -> LaserFeatures."""
    if T == 0:
        return 1, 0.0
    for i in range(prev, len(lsr_feats) + 1):
        if lsr_feats[i].t > T:
            return i - 1, lsr_feats[i - 1].t
    return len(lsr_feats), lsr_feats[len(lsr_feats)].t


def process_tree_trackers_updates(
    sys: GenericInSituSystem,
    lsr_feats: dict,
    Ts: float,
    b1Dxb,
    prop_noise=(0.05, 0.05, 0.004),
    meas_noise=(0.5, 0.05),
):
    """processTreeTrackersUpdates! (NavigationSystem.jl:107-123)."""
    sys.trackers.propagate_all(b1Dxb, prop_noise)
    newlsridx, _ = get_feats_at_t(lsr_feats, Ts, prev=max(sys.lstlaseridx, 1))
    if newlsridx != sys.lstlaseridx:
        sys.lstlaseridx = newlsridx
        bfts = lsr_feats[newlsridx].feats
        assoc = sys.trackers.associate(bfts)
        sys.trackers.meas_update(assoc, meas_noise)


# --------------------- Ackermann odometry helpers ---------------------------

def vc(v, alpha, L=2.80381, H=0.828329):
    """Rear-axle to vehicle-center speed (WheeledRobotUtils.jl:86)."""
    return v / (1.0 - np.tan(alpha) * H / L)


def d_phi(v, alpha, L=2.80381):
    """Yaw rate (WheeledRobotUtils.jl:88)."""
    return v * np.tan(alpha) / L


def compensate_raw_drs(drs, whlsf=0.94, strsf=1.0199, strbi=0.00159):
    """compensateRawDRS (WheeledRobotUtils.jl:90-93)."""
    return whlsf * drs[1], strsf * drs[2] + strbi


def ute_odom_easy(x, whlspd, strangl, dt, L=2.80381, H=0.828329):
    """uteOdomEasy (WheeledRobotUtils.jl:95-103): integrate one Ackermann
    step in SE(2)."""
    v = vc(whlspd, strangl, L=L, H=H)
    dph = d_phi(v, strangl, L=L)
    pose = _se2_mat(np.asarray(x, dtype=np.float64)) @ _se2_mat(
        dt * np.array([v, 0.0, dph])
    )
    return _se2_vee(pose)


def adv_odo_by_rules(
    DRS,
    lsr_feats: dict,
    distrule: float = 20.0,
    timerule: float = 30.0,
    yawrule: float = np.pi / 3,
    trkfeats: bool = True,
    device="cuda",
):
    """advOdoByRules (NavigationSystem.jl:126-166): drive the full DRS
    stream, trigger poses, track features (on ``device``); returns (dOdo,
    FeatAssc)."""
    DRS = np.asarray(DRS, dtype=np.float64)
    bfts0 = lsr_feats[1].feats
    sys = make_in_situ_system(np.zeros(3), bfts0, device=device)
    sys.FeatAssc[sys.poseid] = {
        f.id: f.lastz for f in sys.trackers.trackers.values()
    }
    for i in range(DRS.shape[0]):
        dt = DRS[i, 0] - sys.T0
        whlspd, strang = compensate_raw_drs(DRS[i])
        bTbm = _se2_mat(sys.x)
        sys.x = ute_odom_easy(sys.x, whlspd, strang, dt)
        bTbp = _se2_mat(sys.x)
        if trkfeats:
            bmTbp = _se2_vee(np.linalg.inv(bTbm) @ bTbp)
            process_tree_trackers_updates(sys, lsr_feats, DRS[i, 0], bmTbp)
        if pose_trig_and_add(sys, DRS[i, 0], distrule, timerule, yawrule):
            fdict = {}
            for f in sys.trackers.trackers.values():
                mpt = f.bel.points.mean(dim=0).cpu().numpy()
                r, b = c2p(mpt)
                last3 = f.lastz[2] if len(f.lastz) > 2 else 0.0
                fdict[f.id] = np.array([r, b, last3])
            sys.FeatAssc[sys.poseid] = fdict
        sys.T0 = DRS[i, 0]
    return sys.dOdo, sys.FeatAssc


# reference-style aliases
makeInSituSys = make_in_situ_system
makeGenericInSituSys = make_generic_in_situ_system
poseTrigAndAdd = pose_trig_and_add
advOdoByRules = adv_odo_by_rules
uteOdomEasy = ute_odom_easy
compensateRawDRS = compensate_raw_drs
getFeatsAtT = get_feats_at_t
