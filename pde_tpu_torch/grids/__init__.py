"""Grids and boundary conditions."""

from .base import GridBase, PeriodicityError
from .cartesian import CartesianGrid, UnitGrid
from .coordinates import CartesianCoordinates, DimensionError
from .cylindrical import CylindricalSymGrid
from .spherical import PolarSymGrid, SphericalSymGrid
