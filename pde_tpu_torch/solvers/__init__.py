"""Solvers advancing PDE states in time."""

from .base import AdaptiveSolverBase, SolverBase, registered_solvers
from .controller import Controller
from .euler import EulerSolver, ExplicitSolver
from .explicit_sharded import ExplicitMPISolver, ExplicitShardedSolver
