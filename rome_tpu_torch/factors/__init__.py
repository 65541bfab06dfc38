"""Factor library — importing this package registers every ported factor type."""

from rome_tpu_torch.factors.base import (
    Factor,
    FactorType,
    gaussian_params,
    get_factor_type,
    list_factor_types,
    make_gaussian_factor,
    register_factor_type,
)
from rome_tpu_torch.factors.bearing_range import (
    Pose2Point2Bearing,
    Pose2Point2BearingRange,
    Pose2Point2Range,
)
from rome_tpu_torch.factors.point2 import (
    Point2Point2,
    Point2Point2Range,
    PriorPoint2,
)
from rome_tpu_torch.factors.pose2 import (
    MutablePose2Pose2Gaussian,
    PartialPriorYawPose2,
    Pose2Point2,
    Pose2Pose2,
    PriorPose2,
    update_mutable_odo,
)
from rome_tpu_torch.factors.point3 import Point3Point3, PriorPoint3
from rome_tpu_torch.factors.pose3 import (
    Pose3Pose3,
    Pose3Pose3RotOffset,
    Pose3Pose3Rotation,
    Pose3Pose3Transform,
    Pose3Pose3UnitTrans,
    Pose3Pose3XYYaw,
    PriorPose3,
    PriorPose3ZRP,
    PriorRotation3,
)
from rome_tpu_torch.factors.polar import PolarPolar, PriorPolar

__all__ = [
    "Factor",
    "FactorType",
    "gaussian_params",
    "get_factor_type",
    "list_factor_types",
    "make_gaussian_factor",
    "register_factor_type",
    "PriorPoint2",
    "Point2Point2",
    "Point2Point2Range",
    "PriorPose2",
    "Pose2Pose2",
    "PartialPriorYawPose2",
    "MutablePose2Pose2Gaussian",
    "update_mutable_odo",
    "Pose2Point2",
    "Pose2Point2Bearing",
    "Pose2Point2Range",
    "Pose2Point2BearingRange",
    "PriorPoint3",
    "Point3Point3",
    "PriorPose3",
    "Pose3Pose3",
    "Pose3Pose3RotOffset",
    "Pose3Pose3Transform",
    "Pose3Pose3UnitTrans",
    "PriorPose3ZRP",
    "Pose3Pose3XYYaw",
    "Pose3Pose3Rotation",
    "PriorRotation3",
    "PriorPolar",
    "PolarPolar",
]
