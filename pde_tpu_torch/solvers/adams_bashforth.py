"""Second-order Adams-Bashforth multistep solver.

Port of :mod:`pde_tpu.solvers.adams_bashforth`. Fixed-dt runs take the PDE's
fused AB2 window where it has one (``make_fused_ab2_window``: the previous
rates ride as ``n_aux`` extra planes of the generated kernels, which the
solver bootstraps and keeps between tracker windows, see
:meth:`~.base.SolverBase._wrap_fused_window`; on a mesh, the ext kernels'
window, its rate planes split into blocks); otherwise the plain step loop,
whose previous rates persist between windows the same way (on a mesh, the
plain sharded stepper's, per block).
"""

from __future__ import annotations

from typing import Callable

from ..fields.base import FieldBase
from .base import SolverBase


class AdamsBashforthSolver(SolverBase):
    """Explicit second-order Adams-Bashforth solver, bootstrapped from the
    rate at a backward-Euler guess of the previous level."""

    name = "adams-bashforth"
    _fused_window_hook = "make_fused_ab2_window"

    def _make_fixed_stepper(self, state: FieldBase, dt: float) -> Callable:
        if getattr(self.pde, "is_sde", False):
            raise RuntimeError("Adams-Bashforth does not support stochastic equations")
        return super()._make_fixed_stepper(state, dt)

    @staticmethod
    def _bootstrap_rates(rhs: Callable, leaves: list, t0: float, dt: float) -> list:
        """The previous rates of the first step: the rate at a backward-Euler
        guess ``y - dt * rhs(y, t0)`` of the level before `leaves`."""
        rate0 = rhs(leaves, t0)
        prev = [y - dt * r for y, r in zip(leaves, rate0, strict=True)]
        return list(rhs(prev, t0 - dt))

    def _make_fixed_stepper_eager(self, state: FieldBase, dt: float) -> Callable:
        """The plain loop; ``_rate_prev`` carries the previous rates from one
        window to the next (on a mesh, every block's: the plain sharded
        stepper runs this loop on the blocks' leaves)."""
        rhs = self._make_rhs(state)
        post_hook = self._make_post_step_hook(state)
        split, combine = self._leaf_maps()
        self._rate_prev = None

        def fixed_stepper(state_obj: FieldBase, t_start: float, t_end: float):
            leaves = split(state_obj)
            if self._rate_prev is None:
                self._rate_prev = self._bootstrap_rates(rhs, leaves, t_start, dt)
            steps = max(1, round((t_end - t_start) / dt))
            rate_prev = self._rate_prev
            for i in range(steps):
                t = t_start + i * dt
                rate_cur = rhs(leaves, t)
                leaves = [
                    y + dt * (1.5 * rc - 0.5 * rp)
                    for y, rc, rp in zip(leaves, rate_cur, rate_prev, strict=True)
                ]
                if post_hook is not None:
                    leaves, self.info["post_step_data"] = post_hook(
                        leaves, t + dt, self.info["post_step_data"]
                    )
                rate_prev = rate_cur
            self._rate_prev = rate_prev
            self.info["steps"] += steps
            return combine(state_obj, leaves), t_start + steps * dt

        return fixed_stepper
