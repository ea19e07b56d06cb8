"""Partial differential equations."""

from .allen_cahn import AllenCahnPDE
from .base import PDEBase, SDEBase
from .cahn_hilliard import CahnHilliardPDE
from .diffusion import DiffusionPDE
from .klein_gordon import KleinGordonPDE
from .kpz_interface import KPZInterfacePDE
from .kuramoto_sivashinsky import KuramotoSivashinskyPDE
from .laplace import helmholtz_decomposition, solve_laplace_equation, solve_poisson_equation
from .pde import PDE
from .reaction_diffusion import ReactionDiffusionPDE
from .swift_hohenberg import SwiftHohenbergPDE
from .wave import WavePDE
