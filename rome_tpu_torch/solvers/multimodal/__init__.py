"""Nonparametric multimodal solver subpackage."""
from rome_tpu_torch.solvers.multimodal.kde import (
    ManifoldKernelDensity,
    gibbs_product,
    manifold_mean,
    silverman_bandwidth,
)
from rome_tpu_torch.solvers.multimodal.convolve import approx_conv, approxConv
from rome_tpu_torch.solvers.multimodal.solve import (
    init_all_beliefs,
    predict_belief,
    solve_graph_nonparametric,
)
from rome_tpu_torch.solvers.multimodal.batched import (
    BatchedNonparametricSolver,
    build_propagator,
)
from rome_tpu_torch.solvers.multimodal.tree import (
    BayesTree,
    Clique,
    build_tree_from_ordering,
    buildTreeFromOrdering,
    calc_cliques_recycled,
    calcCliquesRecycled,
    get_elimination_order,
    getEliminationOrder,
    solve_tree,
    solveTree,
)
