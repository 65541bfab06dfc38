"""frontend subpackage of rome_tpu_torch: odometry accumulation, fixed-lag
management, async solve runtime, feature tracking, navigation."""

from rome_tpu_torch.frontend.navigation import (
    GenericInSituSystem,
    LaserFeatures,
    adv_odo_by_rules,
    compensate_raw_drs,
    get_feats_at_t,
    make_generic_in_situ_system,
    make_in_situ_system,
    pose_trig_and_add,
    process_tree_trackers_updates,
    ute_odom_easy,
)
from rome_tpu_torch.frontend.tracker import (
    Feature,
    FeatureTracker,
    c2p,
    cart2pol,
    p2c,
    p2c_pts_kde,
    pol2cart,
)

__all__ = [
    "FeatureTracker",
    "Feature",
    "p2c",
    "c2p",
    "pol2cart",
    "cart2pol",
    "p2c_pts_kde",
    "GenericInSituSystem",
    "LaserFeatures",
    "make_in_situ_system",
    "make_generic_in_situ_system",
    "pose_trig_and_add",
    "process_tree_trackers_updates",
    "adv_odo_by_rules",
    "ute_odom_easy",
    "compensate_raw_drs",
    "get_feats_at_t",
]
