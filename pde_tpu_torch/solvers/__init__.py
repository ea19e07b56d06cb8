"""Solvers advancing PDE states in time."""

from .adams_bashforth import AdamsBashforthSolver
from .base import (
    AdaptiveSolverBase,
    ConvergenceError,
    SolverBase,
    adjust_dt,
    registered_solvers,
)
from .controller import Controller
from .crank_nicolson import CrankNicolsonSolver
from .etdrk import ETDRK4Solver
from .euler import EulerSolver, ExplicitSolver
from .explicit_sharded import ExplicitMPISolver, ExplicitShardedSolver
from .implicit import ImplicitSolver
from .milstein import MilsteinSolver
from .runge_kutta import RungeKuttaSolver
from .scipy import ScipySolver
