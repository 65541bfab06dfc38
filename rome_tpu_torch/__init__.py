"""rome_tpu_torch — the PyTorch / CUDA port of rome_tpu.

A second package beside the JAX reference ``rome_tpu``; it imports torch and
numpy, never jax and never rome_tpu. Module paths mirror ``rome_tpu/``.
Ported so far:
- slice A: the batch SE(2) pose-graph solve — g2o load, lowering to factor
  batches, chordal initialization and Levenberg-Marquardt with the
  nested-dissection sparse Cholesky (``linear="ndchol"``) or the dense
  solver, with the Pose2Pose2 linearize as a hand-written CUDA kernel (K1);
- slice B1/B2: the rest of the parametric solver — the dense32, pcg and
  mixed linear solvers, the speculative-accept and lazy-preconditioner
  loops, the structure cache, and marginal covariances (dense inverse or
  Takahashi selected inverse);
- slice C: the nonparametric (multimodal) engine — the particle graph init
  and ``approx_conv`` with multihypo/nullhypo, the batched engine (Gauss-
  Seidel passes, Jacobi sweeps, the per-factor fallback), the loop engine
  and the Bayes-tree solve with clique recycling — with the Gibbs pairwise
  scores as hand-written CUDA kernels (K2 for SE(2), K3 for per-dim
  manifolds and their products);
- slice B3, first part: SO(3) / SE(3) (unit quaternions) and product
  manifolds, every variable type, the 3-D and partial factor library
  (Pose3, Point3, Polar, the partial Pose2/Pose3 factors), g2o SE3 and
  LANDMARK lines and ``export_g2o``, and the generic Gibbs score for the
  manifolds no kernel covers (SO(3), SE(3), ...);
- slice B3, the rest: SGal(3) and IMU preintegration (``IMUDeltaFactor``
  and its support factors), the legacy InertialPose3 factor, the RK4 ODE
  factor ``InertialDynamic``, the velocity-augmented 2D factors (DynPoint2,
  DynPose2), the sonar and multi-feature sensor factors, and the NN mixture
  odometry ``MixtureFluxPose2Pose2``;
- slices B4/B5 and the front end: the fixed-lag and live-SLAM utilities
  (``frontend``: fixed-lag freezing, odometry accumulation and the dead-reckon
  tether, the background solve manager, the feature tracker and the wheeled
  navigation front end), graph persistence (``save_dfg``/``load_dfg``, the
  JAX package's document; blob stores) and the scalar-field services.

Every entry point runs on the card (``device="cuda"``, its default) unless
the caller asks for the CPU with ``device="cpu"``, as the tests do; nothing
probes for a device and nothing falls back: without CUDA, an entry point
called without ``device=`` raises.
"""

from rome_tpu_torch.variables import (
    BearingRange2,
    DynPoint2,
    DynPose2,
    IMUBias,
    Point2,
    Point3,
    Polar,
    Pose2,
    Pose3,
    Rotation3,
    RotVelPos,
    VelPos3,
    get_variable_type,
    list_variable_types,
    register_variable_type,
)
from rome_tpu_torch.distributions import (
    Categorical,
    Mixture,
    MvNormal,
    Normal,
    Uniform,
    dist_mean_cov,
)
from rome_tpu_torch.graph.graph import FactorGraph, SolverParams
from rome_tpu_torch.factors import *  # noqa: F401,F403 — registers + exports factor ctors
from rome_tpu_torch.io import (
    export_g2o,
    import_g2o,
    load_dfg,
    load_g2o,
    loadDFG,
    save_dfg,
    saveDFG,
)
from rome_tpu_torch.solvers.gauss_newton import GNOptions
from rome_tpu_torch.solvers.parametric import solve_graph_parametric, solveGraphParametric
from rome_tpu_torch.solvers.multimodal import (
    approx_conv,
    build_tree_from_ordering,
    calc_cliques_recycled,
    get_elimination_order,
    init_all_beliefs,
    predict_belief,
    solve_graph_nonparametric,
    solve_tree,
)
from rome_tpu_torch.canonical import (
    build_graph_chain,
    generate_graph_beehive,
    generate_graph_circle,
    generate_graph_hexagonal,
    generate_graph_honeycomb,
    generate_graph_two_pose_odo,
    generate_graph_zero_pose,
)

__version__ = "0.1.0"
