"""Grids and boundary conditions."""

from .base import DomainError, GridBase, PeriodicityError, registered_grids, registered_operators
from .cartesian import CartesianGrid, UnitGrid
from .coordinates import CartesianCoordinates, DimensionError
from .cylindrical import CylindricalSymGrid
from .spherical import PolarSymGrid, SphericalSymGrid
