"""canonical subpackage of rome_tpu_torch: fixture graph generators."""

from rome_tpu_torch.canonical.generators import (
    build_graph_chain,
    generate_graph_circle,
    generate_graph_hexagonal,
    generate_graph_two_pose_odo,
    generate_graph_zero_pose,
)
from rome_tpu_torch.canonical.patterns import generate_graph_beehive, generate_graph_honeycomb

__all__ = [
    "build_graph_chain",
    "generate_graph_beehive",
    "generate_graph_circle",
    "generate_graph_hexagonal",
    "generate_graph_honeycomb",
    "generate_graph_two_pose_odo",
    "generate_graph_zero_pose",
]
