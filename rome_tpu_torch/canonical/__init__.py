"""canonical subpackage of rome_tpu_torch: fixture graph generators."""

from rome_tpu_torch.canonical.generators import (
    build_graph_chain,
    generate_graph_circle,
    generate_graph_hexagonal,
    generate_graph_two_pose_odo,
    generate_graph_zero_pose,
)
from rome_tpu_torch.canonical.inertial_sim import (
    generate_field_inertial_measurement,
    generate_field_inertial_measurement_noise,
)
from rome_tpu_torch.canonical.patterns import (
    calc_helix_T,
    drive_leg,
    drive_one_box,
    generate_graph_beehive,
    generate_graph_boxes2d,
    generate_graph_helix2d,
    generate_graph_helix2d_slew,
    generate_graph_helix2d_spiral,
    generate_graph_honeycomb,
)

__all__ = [
    "build_graph_chain",
    "calc_helix_T",
    "drive_leg",
    "drive_one_box",
    "generate_field_inertial_measurement",
    "generate_field_inertial_measurement_noise",
    "generate_graph_beehive",
    "generate_graph_boxes2d",
    "generate_graph_circle",
    "generate_graph_helix2d",
    "generate_graph_helix2d_slew",
    "generate_graph_helix2d_spiral",
    "generate_graph_hexagonal",
    "generate_graph_honeycomb",
    "generate_graph_two_pose_odo",
    "generate_graph_zero_pose",
]
