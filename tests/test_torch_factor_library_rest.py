"""chip_smoke.py's phase 15 (``factor_library_rest_path``) rehearsed on the
CPU at a small size: 3 s of the inertial stream (ODE, preintegration and
the Pose3VelPos3 split), 10 free-fall states, 12 DynPose2 states, the sonar
graph, MultipleFeatures2D, a 20-pose NN-mixture chain, and the
nonparametric DynPoint2 and mixture chains at N = 30, every gate of the
phase applied. The kernel wrappers count their CPU calls here as the card
counts launches, so the nonparametric chains are held to the smoke run's
draw counts (chip_smoke.PATH_DRAWS): K3's draw on the DynPoint2 chain, K2's
on the mixture chain, no logw epilogue and no generic score on either; the
mixture messages take the per-factor fallback. The new variable types
dispatch as the JAX package dispatches them: DynPoint2, VelPos3 and
IMUBias to K3, DynPose2, RotVelPos and InertialPose3 to the generic
score."""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import rome_tpu_torch as T  # noqa: E402
from rome_tpu_torch.ops import pairwise as TP  # noqa: E402
from rome_tpu_torch.ops import pairwise_cuda as K  # noqa: E402
from rome_tpu_torch.solvers.multimodal import kde as TK  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import chip_smoke as C  # noqa: E402


@pytest.mark.parametrize("vtype", ["DynPoint2", "DynPose2", "RotVelPos", "VelPos3", "IMUBias",
                                   "InertialPose3"])
def test_kernel_dispatch_of_the_new_manifolds(vtype):
    """The JAX package's static dispatch: per-dim manifolds of up to 8 dof
    (DynPoint2 = T(4), VelPos3 and IMUBias = T(3) x T(3)) take the per-dim
    kernel (K3), the others (DynPose2 = SE(2) x T(2), RotVelPos with its
    SO(3), the 15-dof InertialPose3) the generic score."""
    from rome_tpu.ops import pairwise as JP
    from rome_tpu.variables import get_variable_type as jax_vtype

    want = JP.pairwise_logw_for(jax_vtype(vtype).manifold) is not None
    assert (TP.pairwise_draw_for(T.get_variable_type(vtype).manifold) is not None) == want
    assert want == (vtype in ("DynPoint2", "VelPos3", "IMUBias"))


def test_factor_library_rest_rehearsal(monkeypatch):
    generic = {"calls": 0}

    def counted(name, fn):
        def call(*a):
            K.LAUNCHES[name] += 1
            return fn(*a)
        return call

    for name in ("se2_gibbs_draw", "euclid_gibbs_draw", "se2_pairwise_logw",
                 "euclid_pairwise_logw"):
        monkeypatch.setattr(K, name, counted(name, getattr(K, name)))
    real_generic = TK.generic_gibbs_draw

    def gen(*a):
        generic["calls"] += 1
        return real_generic(*a)

    monkeypatch.setattr(TK, "generic_gibbs_draw", gen)
    out, launches = C.factor_library_rest_path("cpu", device="cpu", seconds=3, N=30,
                                               freefall=10, dynpose2=12, fluxmix=20)
    for name in ("dynpoint2_chain", "fluxmix_pose2_chain"):
        l = launches[name]
        assert (l["se2_gibbs_draw"], l["euclid_gibbs_draw"]) == C.PATH_DRAWS[name], (name, l)
        assert l["se2_pairwise_logw"] == 0 and l["euclid_pairwise_logw"] == 0
    assert generic["calls"] == 0
    assert out["fluxmix_pose2_chain"]["fallback_convolutions"] > 0
    assert out["inertial_dynamic_30s"]["max_diff_to_imudelta_m"] < 0.02
    assert out["pose3velpos3_30s"]["max_diff_to_imudelta_m"] < 1e-6
