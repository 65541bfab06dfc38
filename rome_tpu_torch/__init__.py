"""rome_tpu_torch — the PyTorch / CUDA port of rome_tpu.

A second package beside the JAX reference ``rome_tpu``; it imports torch and
numpy, never jax and never rome_tpu. Module paths mirror ``rome_tpu/``.
Ported so far:
- slice A: the batch SE(2) pose-graph solve — g2o load, lowering to factor
  batches, chordal initialization and Levenberg-Marquardt with the
  nested-dissection sparse Cholesky (``linear="ndchol"``) or the dense
  solver, with the Pose2Pose2 linearize as a hand-written CUDA kernel (K1);
- slice C, batched path: the nonparametric (multimodal) solve of a beehive
  graph with the points init, with the Gibbs pairwise scores as hand-written
  CUDA kernels (K2 for SE(2), K3 for per-dim manifolds).

Every tensor lives on the device the caller names (``device="cpu"`` or
``"cuda"``); nothing here picks a device by itself.
"""

from rome_tpu_torch.variables import (
    Point2,
    Pose2,
    get_variable_type,
    list_variable_types,
    register_variable_type,
)
from rome_tpu_torch.distributions import MvNormal, Normal
from rome_tpu_torch.graph.graph import FactorGraph, SolverParams
from rome_tpu_torch.factors import *  # noqa: F401,F403 — registers + exports factor ctors
from rome_tpu_torch.io import import_g2o, load_g2o
from rome_tpu_torch.solvers.gauss_newton import GNOptions
from rome_tpu_torch.solvers.parametric import solve_graph_parametric
from rome_tpu_torch.solvers.multimodal.solve import solve_graph_nonparametric
from rome_tpu_torch.canonical import generate_graph_beehive

__version__ = "0.1.0"
