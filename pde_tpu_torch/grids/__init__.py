"""Grids and boundary conditions."""

from .base import (
    DomainError,
    GridBase,
    OperatorInfo,
    PeriodicityError,
    discretize_interval,
    registered_grids,
    registered_operators,
)
from .boundaries import BoundariesBase, BoundariesList, BoundariesSetter, set_default_bc
from .cartesian import CartesianGrid, UnitGrid
from .coordinates import CartesianCoordinates, DimensionError
from .cylindrical import CylindricalSymGrid
from .spherical import PolarSymGrid, SphericalSymGrid
