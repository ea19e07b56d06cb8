"""Partial differential equations."""

from .base import PDEBase, SDEBase
from .diffusion import DiffusionPDE
