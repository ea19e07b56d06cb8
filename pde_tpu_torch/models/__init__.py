"""Partial differential equations."""

from .base import PDEBase, SDEBase
from .cahn_hilliard import CahnHilliardPDE
from .diffusion import DiffusionPDE
from .pde import PDE
