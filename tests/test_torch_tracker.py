"""The port's feature tracker and wheeled navigation front end
(rome_tpu_torch.frontend.tracker / navigation) on tests/test_tracker.py's
fixtures, on the CPU, and against the JAX package.

Tolerances: the polar/cartesian helpers, the Ackermann step and the pose
triggers at 1e-12 (float64 numpy in both); ``adv_odo_by_rules``'s dOdo
equal to JAX's at 1e-12 on chip_smoke's seeded 60 s drive (phase 18),
trackers off. The trackers draw from torch Generators seeded with the
integers JAX seeds its keys with, so their streams differ: on a short drive
the two packages make and keep the same trackers, and each belief mean is
within 0.3 m of JAX's.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rome_tpu.frontend.navigation as JN  # noqa: E402
import rome_tpu.frontend.tracker as JT  # noqa: E402

import rome_tpu_torch.frontend as TFE  # noqa: E402
import rome_tpu_torch.frontend.navigation as TN  # noqa: E402
import rome_tpu_torch.frontend.tracker as TT  # noqa: E402
from rome_tpu_torch.frontend import FeatureTracker, LaserFeatures  # noqa: E402

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir)))
import chip_smoke as C  # noqa: E402


def _mean(f):
    return np.asarray(torch.as_tensor(np.asarray(f.bel.points)).double().mean(0))


def test_polar_cartesian_roundtrip_matches_jax():
    z = np.array([5.0, 0.7])
    u, Rm = TT.p2c(z)
    np.testing.assert_allclose(u, [5 * np.cos(0.7), 5 * np.sin(0.7)], atol=1e-12)
    np.testing.assert_allclose([*TT.c2p(u)], z, atol=1e-12)
    for fn, args in ((TT.p2c, (z,)), (TT.pol2cart, (z, [0.5, 0.03])),
                     (TT.cart2pol, (u, [0.1, 0.1]))):
        for a, b in zip(fn(*args), getattr(JT, fn.__name__)(*args)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    br, P2 = TT.cart2pol(TT.pol2cart(z, [0.5, 0.03])[0], [0.1, 0.1])
    np.testing.assert_allclose(br, [0.7, 5.0], atol=1e-9)
    assert P2.shape == (2, 2)


def test_p2c_pts_kde_spread():
    kde = TT.p2c_pts_kde([10.0, 0.0], [0.5, 0.02], N=200, device="cpu")
    pts = kde.points.double().numpy()
    assert kde.points.dtype == torch.float32 and pts.shape == (200, 2)
    np.testing.assert_allclose(pts.mean(axis=0), [10, 0], atol=0.3)
    assert pts[:, 0].std() > pts[:, 1].std()   # range noise dominates x
    # seeded from the sighting, as JAX's key: the same call, the same particles
    again = TT.p2c_pts_kde([10.0, 0.0], [0.5, 0.02], N=200, device="cpu")
    assert torch.equal(again.points, kde.points)


def test_tracker_propagate_and_update():
    tr = FeatureTracker.init_from(np.array([[10.0], [0.0]]), device="cpu")
    assert len(tr.trackers) == 1
    np.testing.assert_allclose(_mean(tr.trackers[1]), [10, 0], atol=0.5)
    # the robot moves 1 m forward: the feature is 1 m closer in the body frame
    tr.step([1.0, 0, 0], sightings=None, prop_noise=(1e-3, 1e-3, 1e-4))
    np.testing.assert_allclose(_mean(tr.trackers[1]), [9, 0], atol=0.5)
    assert tr.trackers[1].lastzage == 1
    assoc = tr.step([0.0, 0, 0], sightings=np.array([[9.0], [0.0]]),
                    prop_noise=(1e-3, 1e-3, 1e-4))
    assert list(assoc) == [1]
    assert tr.trackers[1].lastzage == 0
    np.testing.assert_allclose(_mean(tr.trackers[1]), [9, 0], atol=0.5)


def test_tracker_new_features_and_discard():
    tr = FeatureTracker.init_from(np.array([[10.0], [0.0]]), device="cpu")
    tr.step([0.0, 0, 0], sightings=np.array([[10.0], [np.pi / 2]]),
            prop_noise=(1e-3, 1e-3, 1e-4))
    assert len(tr.trackers) == 2
    tr.max_zage = 2
    for _ in range(4):
        tr.step([0.0, 0, 0], sightings=None, prop_noise=(1e-3, 1e-3, 1e-4))
    assert len(tr.trackers) == 0


def test_propagation_bandwidths_are_each_features_own():
    """propagate_all computes every feature's bandwidth in one batch: the
    same as each feature's own Silverman bandwidth."""
    from rome_tpu_torch.manifolds.base import T2
    from rome_tpu_torch.solvers.multimodal.kde import silverman_bandwidth

    tr = FeatureTracker.init_from(np.array([[10.0, 5.0, 20.0], [0.0, 1.0, -0.5]]),
                                  device="cpu")
    tr.propagate_all([0.5, 0.1, 0.05])
    for f in tr.trackers.values():
        torch.testing.assert_close(f.bel.bandwidth,
                                   silverman_bandwidth(T2, f.bel.points).clamp_min(1e-5),
                                   rtol=1e-6, atol=1e-7)


def test_ute_odometry_and_pose_trigger_match_jax():
    x = TN.ute_odom_easy([0, 0, 0], 2.0, 0.0, 1.0)
    np.testing.assert_allclose(x, [2, 0, 0], atol=1e-9)
    for args in (([0, 0, 0], 2.0, 0.2, 1.0), ([1.0, -2.0, 0.3], 4.1, -0.1, 0.025)):
        np.testing.assert_allclose(TN.ute_odom_easy(*args), JN.ute_odom_easy(*args),
                                   rtol=0, atol=1e-12)
    assert TN.ute_odom_easy([0, 0, 0], 2.0, 0.2, 1.0)[2] > 0
    assert TN.compensate_raw_drs([0.0, 3.0, 0.1]) == JN.compensate_raw_drs([0.0, 3.0, 0.1])

    sys_ = TN.make_in_situ_system(np.zeros(3), np.array([[10.0], [0.0]]), device="cpu")
    sys_.x = np.array([25.0, 0, 0.0])
    assert TN.pose_trig_and_add(sys_, 1.0, 20.0, 30.0, np.pi / 3)
    assert sys_.poseid == 2
    np.testing.assert_allclose(sys_.x, 0.0)
    np.testing.assert_allclose(sys_.dOdo[2][:3], [25, 0, 0])
    assert sys_.dOdo[2][4] == 1.0


def test_get_feats_at_t_matches_jax():
    lsr = {i + 1: LaserFeatures(0.2 * (i + 1), np.zeros((2, 0))) for i in range(10)}
    for T_, prev in ((0, 1), (0.2, 1), (0.55, 1), (0.55, 3), (1.9, 4), (5.0, 1)):
        assert TN.get_feats_at_t(lsr, T_, prev) == JN.get_feats_at_t(lsr, T_, prev)


def test_adv_odo_by_rules_dodo_matches_jax_and_numpy():
    """chip_smoke's 60 s drive (phase 18), trackers off: the pose triggers
    and their deltas equal JAX's and the plain numpy integration's."""
    DRS, lsr, _poses, _trees = C.wheeled_drive()
    dp, _ = TN.adv_odo_by_rules(DRS, lsr, trkfeats=False, device="cpu")
    dj, _ = JN.adv_odo_by_rules(DRS, lsr, trkfeats=False)
    want = C.numpy_dodo(DRS)
    assert sorted(dp) == sorted(dj) == sorted(want) and len(dp) > 5
    for k in dp:
        np.testing.assert_allclose(dp[k], dj[k], rtol=0, atol=1e-12)
        np.testing.assert_allclose(dp[k], want[k], rtol=0, atol=1e-12)


def _tracked_drive(NAV, DRS, lsr, **kw):
    kept, make = [], NAV.make_in_situ_system

    def keep(*a, **k):
        kept.append(make(*a, **k))
        return kept[-1]

    NAV.make_in_situ_system = keep
    try:
        dodo, assoc = NAV.adv_odo_by_rules(DRS, lsr, **kw)
    finally:
        NAV.make_in_situ_system = make
    return dodo, assoc, kept[0].trackers


def test_adv_odo_by_rules_trackers_match_jax():
    """A 1.5 s drive past three trees, trackers on (JAX: ~1 s a tracker
    update on the CPU): the same trackers made and alive, each belief mean
    within 0.3 m of JAX's, and within 0.5 m of its tree."""
    DRS, lsr, poses, trees = C.wheeled_drive(seconds=1.5, trees=3)
    dp, ap, tp = _tracked_drive(TN, DRS, lsr, device="cpu")
    dj, aj, tj = _tracked_drive(JN, DRS, lsr)
    assert tp.featid == tj.featid and sorted(tp.trackers) == sorted(tj.trackers)
    assert len(tp.trackers) >= 2 and sorted(ap) == sorted(aj)
    p = poses[-1]
    c, s = np.cos(p[2]), np.sin(p[2])
    d = trees - p[:2]
    body = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], axis=1)
    for fid in tp.trackers:
        mp, mj = _mean(tp.trackers[fid]), _mean(tj.trackers[fid])
        assert np.linalg.norm(mp - mj) <= 0.3, (fid, mp, mj)
        assert np.min(np.linalg.norm(body - mp, axis=1)) <= 0.5


def test_frontend_exports_match_jax():
    import ast

    src = open(os.path.join(C.HERE, "rome_tpu", "frontend", "__init__.py")).read()
    names = next(ast.literal_eval(n.value) for n in ast.parse(src).body
                 if isinstance(n, ast.Assign) and n.targets[0].id == "__all__")
    assert sorted(TFE.__all__) == sorted(names)
    assert all(hasattr(TFE, n) for n in names)


def test_tracker_defaults_to_the_card():
    import inspect

    for fn in (TT.FeatureTracker, TT.FeatureTracker.init_from, TT.p2c_pts_kde,
               TN.make_in_situ_system, TN.adv_odo_by_rules):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TT.FeatureTracker()
