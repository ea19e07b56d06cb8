"""Solvers advancing PDE states in time."""

from .adams_bashforth import AdamsBashforthSolver
from .base import AdaptiveSolverBase, SolverBase, adjust_dt, registered_solvers
from .controller import Controller
from .euler import EulerSolver, ExplicitSolver
from .explicit_sharded import ExplicitMPISolver, ExplicitShardedSolver
from .runge_kutta import RungeKuttaSolver
