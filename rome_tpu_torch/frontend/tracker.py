"""Nonparametric 2D feature tracker (BayesTracker), counterpart of
``rome_tpu/frontend/tracker.py``.

Reference: BayesTracker.jl — per-feature BallTreeDensity beliefs propagated
by odometry with noise via Distributed ``remotecall`` fan-out (:44-65,
:294-325) and updated by KDE products (:260-285), with likelihood-matrix
hard association (:194-244).

Every tracker is a float32 particle tensor on T(2) on the tracker's device
(``device="cuda"`` unless the caller asks for the CPU). Propagation of all
features is one batch over the stacked (F, N, 2) particles, bandwidths
included; the likelihood matrix is one KDE evaluation per feature; a
measurement update is a Gibbs KDE product (``kde.gibbs_product``), whose
label draws on T(2) launch K3's draw epilogue.

Random draws come from ``torch.Generator``s seeded with the integers the JAX
package seeds its keys with (the hash of a sighting, a running seed): the
streams differ from JAX's, the distributions do not.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from rome_tpu_torch.manifolds.base import T2
from rome_tpu_torch.solvers.multimodal.kde import (
    ManifoldKernelDensity,
    gibbs_product,
    silverman_bandwidth,
)
from rome_tpu_torch.utils.device import entry_device


# --------------------------- polar <-> cartesian ----------------------------

def p2c(z):
    """[range, bearing] -> ([x, y], R(bearing)) (BayesTracker.jl:69-73)."""
    z = np.asarray(z, dtype=np.float64)
    c, s = np.cos(z[1]), np.sin(z[1])
    R = np.array([[c, -s], [s, c]])
    return R @ np.array([z[0], 0.0]), R


def c2p(x):
    """[x, y] -> (range, bearing) (BayesTracker.jl:76-81)."""
    x = np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(x)), float(np.arctan2(x[1], x[0]))


def _sqrtm_psd(P):
    w, V = np.linalg.eigh(0.5 * (P + P.T))
    return V @ np.diag(np.sqrt(np.maximum(w, 0.0))) @ V.T


def pol2cart(z, s):
    """Polar measurement + std-devs -> cartesian mean + sqrt-covariance
    (BayesTracker.jl:84-89)."""
    u, R = p2c(z)
    Pp2 = np.diag(np.asarray(s, dtype=np.float64) ** 2)
    P = np.abs(_sqrtm_psd(R @ Pp2 @ R.T))
    return u, P


def cart2pol(z, s):
    """Cartesian point + std-devs -> polar + sqrt-covariance
    (BayesTracker.jl:92-99)."""
    r, b = c2p(z)
    c, sn = np.cos(b), np.sin(b)
    R = np.array([[c, -sn], [sn, c]])
    Pp2 = np.diag(np.asarray(s, dtype=np.float64) ** 2)
    P = np.abs(_sqrtm_psd(R.T @ Pp2 @ R))
    return np.array([b, r]), P


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def p2c_pts_kde(z, s, N: int = 50, generator=None, device="cuda") -> ManifoldKernelDensity:
    """Polar measurement -> cartesian float32 particle KDE on ``device``
    (BayesTracker.jl:102-107). Without a generator, one seeded from the
    sighting's hash, as the JAX package seeds its key."""
    entry_device(device)
    u, P = pol2cart(z[:2], s)
    if generator is None:
        generator = _generator(abs(hash((float(z[0]), float(z[1])))) % (2**31), device)
    eps = torch.randn((N, 2), generator=generator, dtype=torch.float32, device=device)
    pts = torch.as_tensor(u, dtype=torch.float32, device=device) + eps @ torch.as_tensor(
        P.T, dtype=torch.float32, device=device)
    return ManifoldKernelDensity.from_points(T2, pts)


# ------------------------------- features -----------------------------------

@dataclass
class Feature:
    """BayesTracker.jl:1-7 Feature."""

    id: int
    age: int
    lastzage: int
    lastz: np.ndarray
    bel: ManifoldKernelDensity


@dataclass
class FeatureTracker:
    """The tracker pool (Dict{Int,Feature} + featid analogue), with the
    batched propagate/associate/update cycle on ``device``."""

    trackers: dict = field(default_factory=dict)  # id -> Feature
    featid: int = 0
    max_zage: int = 30
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        entry_device(self.device)

    def _generator(self):
        self.seed += 1
        return _generator(self.seed, self.device)

    # -- creation ------------------------------------------------------------
    def add_new_feature(self, z, s=(0.4, 0.02)) -> int:
        """addNewFeatTrk! (BayesTracker.jl:111-120)."""
        self.featid += 1
        z = np.asarray(z, dtype=np.float64)
        self.trackers[self.featid] = Feature(
            self.featid, 0, 0, z,
            p2c_pts_kde(z, np.asarray(s), generator=self._generator(), device=self.device),
        )
        return self.featid

    @classmethod
    def init_from(cls, bearan, seed: int = 0, device="cuda") -> "FeatureTracker":
        """initTrackersFrom (BayesTracker.jl:122-131): columns are [range,
        bearing(, ...)] sightings."""
        tr = cls(seed=seed, device=device)
        bearan = np.asarray(bearan, dtype=np.float64)
        for i in range(bearan.shape[1]):
            tr.add_new_feature(bearan[:, i], (0.5, 0.03))
        return tr

    # -- prediction ----------------------------------------------------------
    def discard_old_features(self):
        """discardOldFeatures! (BayesTracker.jl:34-43)."""
        for fid in [f.id for f in self.trackers.values() if f.lastzage > self.max_zage]:
            del self.trackers[fid]

    def propagate_all(self, bDxb1, s=(0.05, 0.05, 0.004)):
        """propAllTrackers! (BayesTracker.jl:44-65): move every feature's
        particles by the inverse noisy odometry, one batch over all features
        instead of remotecall fan-out; the new bandwidths in one batch too."""
        self.discard_old_features()
        if not self.trackers:
            return
        feats = list(self.trackers.values())
        pts = torch.stack([f.bel.points for f in feats])  # (F, N, 2)
        F, N, _ = pts.shape
        dev = pts.device
        ent = torch.randn((F, N, 3), generator=self._generator(), dtype=torch.float32,
                          device=dev) * torch.tensor(s, dtype=torch.float32, device=dev)
        d = torch.as_tensor(np.asarray(bDxb1, dtype=np.float32), device=dev) + ent
        # b1Tb = inv(SE2(d)); new = (b1Tb ∘ (x, y, 0))[:2]
        c, sn = torch.cos(d[..., 2]), torch.sin(d[..., 2])
        rel = pts - d[..., :2]
        newx = c * rel[..., 0] + sn * rel[..., 1]
        newy = -sn * rel[..., 0] + c * rel[..., 1]
        new_pts = torch.stack([newx, newy], dim=-1)
        bws = silverman_bandwidth(T2, new_pts)                # (F, 2)
        for k, f in enumerate(feats):
            f.bel = ManifoldKernelDensity.from_points(T2, new_pts[k], bandwidth=bws[k])
            f.age += 1
            f.lastzage += 1

    # -- association ---------------------------------------------------------
    def eval_all_likelihoods(self, sight_feats):
        """evalAllLikelihoods (BayesTracker.jl:147-161): (numz, numfeat)
        likelihoods of each polar sighting under each tracker belief."""
        feats = list(self.trackers.values())
        numz = sight_feats.shape[1]
        if not feats:
            return np.zeros((numz, 0)), []
        cart = np.stack([p2c(sight_feats[:2, i])[0] for i in range(numz)])
        cart = torch.as_tensor(cart, dtype=torch.float32, device=self.device)  # (numz, 2)
        lk = torch.stack([f.bel.logpdf(cart) for f in feats], dim=1)  # (numz, F)
        return np.exp(lk.cpu().numpy()), [f.id for f in feats]

    @staticmethod
    def _div_max_across(lk):
        """divMaxAcross (BayesTracker.jl:196-201)."""
        rlk = np.round(lk, 5)
        m = rlk.max(axis=0, keepdims=True)
        m[m == 0.0] = 1.0
        return rlk / m

    @staticmethod
    def _div_max_along(lk):
        """divMaxAlong (BayesTracker.jl:204-209)."""
        rlk = np.round(lk, 5)
        m = rlk.max(axis=1, keepdims=True)
        m[m == 0.0] = 1.0
        return rlk / m

    def find_matches(self, lk, lkpidx, allmeas):
        """findMatches + hardMatches! (BayesTracker.jl:211-240): a sighting
        and a feature hard-match when each is the other's unambiguous
        maximum."""
        dmdm = self._div_max_along(lk) + self._div_max_across(lk)
        hard = {}
        work = dmdm.copy()
        work[work == 2.0] = -1.0
        unambiguous = work.max(axis=0) < 0.1
        for col in range(work.shape[1]):
            if not unambiguous[col]:
                continue
            rows = np.where(work[:, col] == -1.0)[0]
            if len(rows):
                hard[lkpidx[col]] = np.asarray(allmeas[:, rows[0]], dtype=np.float64)
        return hard

    @staticmethod
    def find_new_feats(lk, thr: float = 1e-5):
        """findNewFeats (BayesTracker.jl:243-250)."""
        if lk.shape[1] == 0:
            return [-1]
        low = lk.max(axis=1) < thr
        return list(np.where(low)[0])

    def associate(self, fez):
        """assocMeasWFeats! (BayesTracker.jl:253-263): hard associations +
        spawn trackers for unexplained sightings."""
        fez = np.asarray(fez, dtype=np.float64)
        if fez.shape[1] == 0:
            return {}
        lk, lkpidx = self.eval_all_likelihoods(fez)
        hard = self.find_matches(lk, lkpidx, fez)
        nidx = self.find_new_feats(lk)
        newmeas = fez if (nidx and nidx[0] == -1) else fez[:, nidx]
        for i in range(newmeas.shape[1]):
            self.add_new_feature(newmeas[:, i], (0.4, 0.02))
        return hard

    # -- measurement update --------------------------------------------------
    def update_feature(self, feat: Feature, z, s=(0.5, 0.05)) -> Feature:
        """update (BayesTracker.jl:260-270): KDE product of predicted and
        measured beliefs via the Gibbs product (K3's draw on T(2))."""
        bXl = p2c_pts_kde(np.asarray(z), np.asarray(s), N=feat.bel.N,
                          generator=self._generator(), device=self.device)
        pts = gibbs_product(self._generator(), [feat.bel, bXl], n_out=feat.bel.N)
        return Feature(
            feat.id,
            feat.age,
            0,
            np.asarray(z, dtype=np.float64),
            ManifoldKernelDensity.from_points(T2, pts),
        )

    def meas_update(self, assoc: dict, s=(0.5, 0.05)):
        """measUpdateTrackers! (BayesTracker.jl:294-325)."""
        for fid, z in assoc.items():
            self.trackers[fid] = self.update_feature(self.trackers[fid], z, s)

    # -- one full cycle --------------------------------------------------------
    def step(self, bDxb1, sightings=None, prop_noise=(0.05, 0.05, 0.004), meas_noise=(0.5, 0.05)):
        """Propagate by odometry, then (optionally) associate + update."""
        self.propagate_all(bDxb1, prop_noise)
        if sightings is not None and np.asarray(sightings).size:
            assoc = self.associate(np.asarray(sightings))
            self.meas_update(assoc, meas_noise)
            return assoc
        return {}


# reference-style aliases
initTrackersFrom = FeatureTracker.init_from
