"""Orthonormal coordinate systems (Cartesian only).

Port of the Cartesian part of :mod:`pde_tpu.grids.coordinates`: host-side
metadata describing the axes of a grid.
"""

from __future__ import annotations


class DimensionError(ValueError):
    """Exception indicating that dimensions were inconsistent."""


class CoordinatesBase:
    """Base class for orthonormal coordinate systems."""

    dim: int
    axes: list[str]

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    def __eq__(self, other) -> bool:
        return self.__class__ is other.__class__ and getattr(
            self, "dim", None
        ) == getattr(other, "dim", None)

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, getattr(self, "dim", None)))


class CartesianCoordinates(CoordinatesBase):
    """n-dimensional Cartesian coordinates."""

    def __init__(self, dim: int):
        self.dim = dim
        if dim <= 3:
            self.axes = list("xyz"[:dim])
        else:
            self.axes = [f"x{i}" for i in range(dim)]

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(dim={self.dim})"
