"""Variable types (counterpart of ``rome_tpu/variables.py``): each type is a
named manifold with flat-vector points, so all variables of one type live in
one dense ``(n, point_dim)`` tensor. The port has Pose2 and Point2 so far."""

from __future__ import annotations

from dataclasses import dataclass

from rome_tpu_torch.manifolds.base import SE2_, T2, Manifold


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


Point2 = VariableType("Point2", T2)
Pose2 = VariableType("Pose2", SE2_)

_REGISTRY = {v.name: v for v in [Point2, Pose2]}


def get_variable_type(name_or_type) -> VariableType:
    if isinstance(name_or_type, VariableType):
        return name_or_type
    return _REGISTRY[str(name_or_type)]


def register_variable_type(vt: VariableType):
    _REGISTRY[vt.name] = vt
    return vt


def list_variable_types():
    return sorted(_REGISTRY)
