"""Explicit Euler solver (fixed dt).

Port of :mod:`pde_tpu.solvers.euler`. PDEs may provide a fused,
temporally blocked kernel window (``make_fused_euler_window``); the
inherited :meth:`SolverBase._try_fused_window_stepper` applies the engine's
policy before falling back to the plain step loop.
"""

from __future__ import annotations

from .base import AdaptiveSolverBase


class EulerSolver(AdaptiveSolverBase):
    """Explicit Euler solver with a fixed time step."""

    name = "euler"
    _fused_window_hook = "make_fused_euler_window"
