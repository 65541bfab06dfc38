"""canonical subpackage of rome_tpu_torch: fixture graph generators."""

from rome_tpu_torch.canonical.generators import generate_graph_zero_pose
from rome_tpu_torch.canonical.patterns import generate_graph_beehive

__all__ = ["generate_graph_zero_pose", "generate_graph_beehive"]
