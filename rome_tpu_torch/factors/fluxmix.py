"""Neural-network mixture odometry factor, MixtureFluxPose2Pose2
(counterpart of ``rome_tpu/factors/fluxmix.py``; reference
ext/RoMEFluxExt.jl:18-141 and ext/services/Pose2OdoNN_01.jl:7-47).

A mixture of an MLP odometry predictor and conventional MvNormal(s) on the
Pose2Pose2 residual: the parametric solve sees the mixture's moment-matched
Gaussian (and so runs K1 like any Pose2Pose2 batch), the nonparametric
engine samples the mixture (the per-factor path, as for every non-Gaussian
measurement). The network is a torch forward pass over weights kept as
numpy; ``build_pose2_odo_nn_01_from_weights`` takes the tensorflow
``get_weights`` layout, the same arrays the JAX package takes.
"""

from __future__ import annotations

import numpy as np
import torch

from rome_tpu_torch.distributions import Distribution, Mixture, MvNormal, _on
from rome_tpu_torch.factors.base import Factor, gaussian_params
from rome_tpu_torch.factors.pose2 import POSE2POSE2


# ------------------------- Pose2OdoNN_01 model ------------------------------

def build_pose2_odo_nn_01(W1=None, b1=None, W2=None, b2=None, W3=None, b3=None):
    """buildPose2OdoNN_01_FromElements (Pose2OdoNN_01.jl:7-41): weights dict
    for the (25, 4) joystick+velocity window -> 2D odometry-delta MLP.

    Architecture: x(25,4) @ W1(4,8) + b1 -> relu -> maxpool(window 4 along
    time) -> flatten(48) -> dense(48->8, relu) -> dense(8->2) -> pad to 3.
    """
    return {
        "W1": np.zeros((4, 8)) if W1 is None else np.asarray(W1, np.float64),
        "b1": np.zeros(8) if b1 is None else np.asarray(b1, np.float64).reshape(-1),
        "W2": np.zeros((8, 48)) if W2 is None else np.asarray(W2, np.float64),
        "b2": np.zeros(8) if b2 is None else np.asarray(b2, np.float64).reshape(-1),
        "W3": np.zeros((2, 8)) if W3 is None else np.asarray(W3, np.float64),
        "b3": np.zeros(2) if b3 is None else np.asarray(b3, np.float64).reshape(-1),
    }


def build_pose2_odo_nn_01_from_weights(weights):
    """buildPose2OdoNN_01_FromWeights (Pose2OdoNN_01.jl:44-47): tensorflow
    get_weights layout."""
    w = [np.asarray(a, dtype=np.float64) for a in weights]
    return build_pose2_odo_nn_01(w[0], w[1], w[2].T, w[3], w[4].T, w[5])


def pose2_odo_nn_forward(nn, data):
    """One forward pass: data (25, 4) -> (3,) odometry delta (dtheta = 0);
    ``nn`` holds tensors of data's dtype and device."""
    h = torch.relu(data @ nn["W1"] + nn["b1"])                  # (25, 8)
    h = h[:24].reshape(6, 4, 8).amax(dim=1)                     # pool window 4
    h = torch.relu(nn["W2"] @ h.reshape(-1) + nn["b2"])         # (8,)
    out = nn["W3"] @ h + nn["b3"]                               # (2,)
    return torch.cat([out, torch.zeros_like(out[:1])])


class NNOdoPredictor(Distribution):
    """Measurement belief whose samples are network predictions over the
    joystick+velocity feature window (the fluxnn mixture component)."""

    def __init__(self, nn: dict, data, jitter: float = 1e-3):
        self.nn = {k: np.asarray(v, dtype=np.float64) for k, v in nn.items()}
        self.data = np.asarray(data, dtype=np.float64)
        self.jitter = float(jitter)
        self.dim = 3

    def _predict(self, device="cpu", dtype=torch.float64):
        nn = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in self.nn.items()}
        return pose2_odo_nn_forward(nn, torch.as_tensor(self.data, dtype=dtype, device=device))

    def mean(self):
        return self._predict().numpy()

    def cov(self):
        return np.eye(3) * self.jitter**2

    def sample(self, generator, n, device=None, dtype=torch.float32):
        device = _on(generator, device)
        pred = self._predict(device, dtype)
        eps = torch.randn((n, 3), generator=generator, device=device, dtype=dtype)
        return pred[None, :] + eps * self.jitter

    def __repr__(self):
        return "NNOdoPredictor(Pose2OdoNN_01)"


# --------------------------- the mixture factor -----------------------------

def calc_velocity_inter_pose2(factor: Factor, xi, xj):
    """calcVelocityInterPose2! (RoMEFluxExt.jl:81-103): fill the feature
    window's velocity columns (3:4) with the body-frame velocity implied by
    the two pose estimates and the cached ΔT."""
    xi = np.asarray(xi, dtype=np.float64)
    xj = np.asarray(xj, dtype=np.float64)
    DT = float(factor.params["DT"])
    nn_dist = factor.dists[0].components[0]
    d = (xj[:2] - xi[:2]) / max(DT, 1e-9)
    c, s = np.cos(xi[2]), np.sin(xi[2])
    body = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
    if not np.all(np.isfinite(body)):
        body = np.zeros(2)
    nn_dist.data[:, 2:4] = body
    return factor


def MixtureFluxPose2Pose2(
    fluxmodels=None,
    data=None,
    other_components=None,
    diversity=(0.5, 0.5),
    DT: float = 0.0,
    naive: Distribution = None,
) -> Factor:
    """Mixture of NN odometry prediction(s) and conventional belief(s)
    (RoMEFluxExt.jl:39-60). ``fluxmodels`` is one weights dict or a list of
    them (the first one predicts); ``data`` is the (25, 4) feature window."""
    nn = (
        fluxmodels[0]
        if isinstance(fluxmodels, (list, tuple)) and fluxmodels
        else (fluxmodels or build_pose2_odo_nn_01())
    )
    data = np.zeros((25, 4)) if data is None else np.asarray(data, np.float64)
    other = (
        list(other_components)
        if other_components is not None
        else [naive or MvNormal(np.zeros(3), np.eye(3))]
    )
    comps = [NNOdoPredictor(nn, data)] + other
    mix = Mixture(comps, np.asarray(diversity, dtype=np.float64)[: len(comps)])
    params = gaussian_params(mix.mean(), mix.cov())
    params["DT"] = np.float64(DT)
    return Factor(ftype=POSE2POSE2, variables=(), params=params, dists=(mix,))


# legacy alias (RoMEFluxExt.jl:153-169)
FluxModelsPose2Pose2 = MixtureFluxPose2Pose2
