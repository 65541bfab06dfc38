"""The nonparametric engine on SE(3) and on a product manifold (the smoke
run's phase 13 at a small size, on the CPU).

- The Pose3 nullhypo fixture (tools/bench_multimodal.py:297-345, N = 400):
  its mass gates, which are distributional (the port's and the JAX
  package's random streams differ).
- The batched engine (``init=True``, N = 30) on the Pose3 hexagon, whose
  Gibbs products take the generic score and never K3, and on the Polar
  chain, whose products take K3's plain draw as many times as the smoke
  run expects (chip_smoke.PATH_DRAWS); each gated against the port's
  parametric optimum.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rome_tpu_torch as T  # noqa: E402
from rome_tpu_torch.ops import pairwise_cuda as K  # noqa: E402
from rome_tpu_torch.solvers.multimodal import kde as TK  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke as C  # noqa: E402


def test_pose3_nullhypo_mass():
    fg, flabel = C.nullhypo_pose3_graph()
    T.init_all_beliefs(fg, N=400, device="cpu")
    for seed in (0, 4):
        pts = T.approx_conv(fg, flabel, "x1", N=400, device="cpu", seed=seed).numpy()
        assert pts.shape == (400, 7) and np.isfinite(pts).all()
        at_meas, far = C.nullhypo_masses(pts)
        assert 0.25 < at_meas < 0.75 and far > 0.15, (at_meas, far)


@pytest.mark.parametrize("name", ["se3_hexagon", "polar_chain"])
def test_batched_engine_on_3d_and_product_manifolds(monkeypatch, name):
    """The smoke run's phase 13 solves at N = 30 on the CPU: the generic
    score for the Pose3 hexagon (no K3 draw), K3's plain draw for the Polar
    chain in the count the smoke run expects."""
    calls = {"k3": 0, "generic": 0}
    real_k3, real_gen = K.euclid_gibbs_draw, TK.generic_gibbs_draw

    def k3(*a):
        calls["k3"] += 1
        return real_k3(*a)

    def gen(*a):
        calls["generic"] += 1
        return real_gen(*a)

    monkeypatch.setattr(K, "euclid_gibbs_draw", k3)
    monkeypatch.setattr(TK, "generic_gibbs_draw", gen)
    build = C.se3_hexagon_graph if name == "se3_hexagon" else C.polar_chain_graph
    fg = build()
    truth = C._parametric_truth(fg, "cpu", pose2=False)
    T.solve_graph_nonparametric(fg, sweeps=3, N=30, engine="batched", init=True, device="cpu")
    C._check_beliefs(fg, 30)
    if name == "se3_hexagon":
        assert calls["k3"] == 0 and calls["generic"] > 0
        err = np.mean([np.linalg.norm(fg.get_point(l, "default")[:3] - truth[l][:3])
                       for l in fg._var_order])
        assert err < 1.0, err
    else:
        assert calls["generic"] == 0 and calls["k3"] == C.PATH_DRAWS["polar_chain"][1]
        for c in (0, 1):
            err = np.mean([abs(fg.get_point(l, "default")[c] - truth[l][c]) for l in fg._var_order])
            assert err < 0.5, (c, err)
