"""Differential operators: the plain PyTorch path and the CUDA kernels.

Importing this package registers the operators with the grid classes.
"""

from . import cartesian, cylindrical, poisson, polar, spherical  # noqa: F401
from .common import make_derivative, make_derivative2, wrap_with_bcs
from .cuda_cartesian import KernelUnsupportedError
