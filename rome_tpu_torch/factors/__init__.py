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
    Pose2Pose2,
    PriorPose2,
)

__all__ = [
    "Factor",
    "FactorType",
    "gaussian_params",
    "get_factor_type",
    "list_factor_types",
    "make_gaussian_factor",
    "register_factor_type",
    "MutablePose2Pose2Gaussian",
    "Point2Point2",
    "Point2Point2Range",
    "Pose2Point2Bearing",
    "Pose2Point2BearingRange",
    "Pose2Point2Range",
    "Pose2Pose2",
    "PriorPoint2",
    "PriorPose2",
]
