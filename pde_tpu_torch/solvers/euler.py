"""Explicit Euler solver: deterministic and Euler-Maruyama, fixed or
adaptive dt.

Port of :mod:`pde_tpu.solvers.euler`. PDEs may provide a fused,
temporally blocked kernel window (``make_fused_euler_window``) for fixed-dt
steps; the inherited :meth:`SolverBase._try_fused_window_stepper` applies
the engine's policy before falling back to the plain step loop. Adaptive
steps (step doubling, :class:`~.base.AdaptiveSolverBase`) are plain torch on
the state's device; SDEs refuse them.
"""

from __future__ import annotations

from typing import Callable

from ..fields.base import FieldBase
from ..models.base import PDEBase
from .base import AdaptiveSolverBase


class EulerSolver(AdaptiveSolverBase):
    """Explicit (adaptive) Euler solver; solves SDEs by Euler-Maruyama."""

    name = "euler"
    _fused_window_hook = "make_fused_euler_window"

    def __init__(self, pde: PDEBase, *, backend: str = "auto", adaptive: bool = False,
                 tolerance: float = 1e-4, decomposition=None):
        if adaptive and getattr(pde, "is_sde", False):
            raise RuntimeError("Cannot use adaptive stepping with stochastic equations")
        super().__init__(pde, backend=backend, adaptive=adaptive, tolerance=tolerance,
                         decomposition=decomposition)

    def _make_single_step_fixed_dt(self, state: FieldBase, dt: float) -> Callable:
        if not getattr(self.pde, "is_sde", False):
            return super()._make_single_step_fixed_dt(state, dt)
        rhs = self._make_rhs(state)
        noise_step = self.pde.make_sde_noise_step(state)
        if self._blocks is not None:  # the whole grid's increments, split into blocks
            noise_step = self._blocks.noise_step(noise_step)

        def single_step_sde(leaves, t, generator=None):
            rates = rhs(leaves, t)
            noise = noise_step(leaves, t, generator, dt)
            return [y + dt * r + n for y, r, n in zip(leaves, rates, noise, strict=True)]

        return single_step_sde


class ExplicitSolver(EulerSolver):
    """Alias of :class:`EulerSolver` under ``pde_tpu``'s deprecated name."""

    name = "explicit"
