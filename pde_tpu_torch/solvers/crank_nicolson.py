"""Crank-Nicolson solver with fixed-point iteration.

Port of :mod:`pde_tpu.solvers.crank_nicolson`: the fixed-point iteration of
:mod:`.implicit` (device-side, gated, one host read per
:data:`~.implicit.FIXED_POINT_CHUNK` iterations), on the state's leaves or,
with ``decomposition=``, every block's (the plain sharded stepper).
"""

from __future__ import annotations

from typing import Callable

from ..fields.base import FieldBase
from ..models.base import PDEBase
from .implicit import _FixedPointSolver


class CrankNicolsonSolver(_FixedPointSolver):
    """Crank-Nicolson solver, optionally blended with an explicit step."""

    name = "crank-nicolson"
    _failure_message = "Crank-Nicolson step did not converge"

    def __init__(self, pde: PDEBase, *, maxiter: int = 100, maxerror: float = 1e-4,
                 explicit_fraction: float = 0, backend: str = "auto",
                 decomposition=None):
        super().__init__(pde, maxiter=maxiter, maxerror=maxerror, backend=backend,
                         decomposition=decomposition)
        self.explicit_fraction = explicit_fraction

    def _make_single_step_fixed_dt(self, state: FieldBase, dt: float) -> Callable:
        if getattr(self.pde, "is_sde", False):
            raise RuntimeError(
                "Deterministic Crank-Nicolson does not support stochastic equations"
            )
        rhs = self._make_rhs(state)
        alpha = self.explicit_fraction

        def single_step(leaves, t, generator=None):
            y_t = leaves
            rate_t = rhs(y_t, t)

            def update(current):
                rate_new = rhs(current, t + dt)
                cn = [
                    y0 + 0.5 * dt * (rn + r0)
                    for y0, rn, r0 in zip(y_t, rate_new, rate_t, strict=True)
                ]
                return [
                    alpha * c_cur + (1 - alpha) * c_cn
                    for c_cur, c_cn in zip(current, cn, strict=True)
                ]

            return self._solve_fixed_point(update, leaves)

        return single_step
