"""services subpackage of rome_tpu_torch: analysis, simulation, scalar
fields.

(The g2o parser lives in rome_tpu_torch.io; odometry accumulation and
fixed-lag helpers live in rome_tpu_torch.frontend.)
"""

from rome_tpu_torch.services.analysis import (
    calc_pose_point_bearing_range,
    compare_density,
    coordinates_to_homography,
    homography_to_coordinates,
    mahalanobis_br,
    malahanobis_br,
    predict_body_br,
    predict_variable_by_factor,
    range_comp_all_poses,
    range_err_max_point2,
    sim_odo,
)
from rome_tpu_torch.services.scalar_fields import (
    LevelSetGridNormal,
    PartialPriorPassThrough,
    build_graph_scalar_field,
    dem_interp,
    generate_field_canyon_dem,
    load_dem_image,
)

__all__ = [
    "predict_body_br",
    "mahalanobis_br",
    "malahanobis_br",
    "calc_pose_point_bearing_range",
    "predict_variable_by_factor",
    "sim_odo",
    "range_err_max_point2",
    "range_comp_all_poses",
    "compare_density",
    "homography_to_coordinates",
    "coordinates_to_homography",
    "LevelSetGridNormal",
    "PartialPriorPassThrough",
    "build_graph_scalar_field",
    "dem_interp",
    "generate_field_canyon_dem",
    "load_dem_image",
]
