"""Variable types (counterpart of ``rome_tpu/variables.py``): each type is a
named manifold with flat-vector points, so all variables of one type live in
one dense ``(n, point_dim)`` tensor."""

from __future__ import annotations

from dataclasses import dataclass

from rome_tpu_torch.manifolds.base import (
    SE2_,
    SE3_,
    SO2_,
    SO3_,
    T1,
    T2,
    T3,
    T4,
    Manifold,
    ProductGroup,
)


@dataclass(frozen=True)
class VariableType:
    """A named variable type bound to a manifold."""

    name: str
    manifold: Manifold

    @property
    def point_dim(self) -> int:
        return self.manifold.point_dim

    @property
    def dof(self) -> int:
        return self.manifold.dof

    def __repr__(self):
        return self.name


# XY Euclidean point
Point2 = VariableType("Point2", T2)
# XYZ Euclidean point
Point3 = VariableType("Point3", T3)
# SE(2) pose (hybrid tangent representation)
Pose2 = VariableType("Pose2", SE2_)
# SE(3) pose
Pose3 = VariableType("Pose3", SE3_)
# SO(3) rotation
Rotation3 = VariableType("Rotation3", SO3_)
# SO(3) x T(3) x T(3): rotation, velocity, position
RotVelPos = VariableType("RotVelPos", ProductGroup([SO3_, T3, T3], name="RotVelPos_M"))
# T(3) x T(3): velocity, position
VelPos3 = VariableType("VelPos3", ProductGroup([T3, T3], name="VelPos3_M"))
# (x, y, dx/dt, dy/dt)
DynPoint2 = VariableType("DynPoint2", T4)
# SE(2) x T(2): (x, y, theta, dx/dt, dy/dt)
DynPose2 = VariableType("DynPose2", ProductGroup([SE2_, T2], name="DynPose2_M"))
# Circle x R: (bearing, range)
BearingRange2 = VariableType("BearingRange2", ProductGroup([SO2_, T1], name="BearingRange_M"))
# polar coordinates (range, angle)
Polar = VariableType("Polar", ProductGroup([T1, SO2_], name="Polar_M"))
# IMU bias state (accelerometer bias [3], gyroscope bias [3])
IMUBias = VariableType("IMUBias", ProductGroup([T3, T3], name="IMUBias_M"))

_REGISTRY = {
    v.name: v
    for v in [
        Point2,
        Point3,
        Pose2,
        Pose3,
        Rotation3,
        RotVelPos,
        VelPos3,
        DynPoint2,
        DynPose2,
        BearingRange2,
        Polar,
        IMUBias,
    ]
}


def get_variable_type(name_or_type) -> VariableType:
    if isinstance(name_or_type, VariableType):
        return name_or_type
    return _REGISTRY[str(name_or_type)]


def register_variable_type(vt: VariableType):
    _REGISTRY[vt.name] = vt
    return vt


def list_variable_types():
    return sorted(_REGISTRY)
