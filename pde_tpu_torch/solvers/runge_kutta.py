"""Runge-Kutta solvers: classic RK4 (fixed dt) and Runge-Kutta-Fehlberg 4(5)
(adaptive).

Port of :mod:`pde_tpu.solvers.runge_kutta`. Fixed-dt runs take the PDE's
fused RK4 window where it has one (``make_fused_rk4_window``: the four rhs
stages of k steps per pass through the generated kernels). Adaptive RK45
cannot block in time, since each step's accept test is a global reduction:
it runs the plain torch loop of :class:`~.base.AdaptiveSolverBase` on the
state's device, with Fehlberg's coefficients (formula 2, Table III).
"""

from __future__ import annotations

from typing import Callable

from ..fields.base import FieldBase
from .base import AdaptiveSolverBase, _max_abs


class RungeKuttaSolver(AdaptiveSolverBase):
    """Explicit Runge-Kutta solver of order 5(4)."""

    name = "runge-kutta"
    _fused_window_hook = "make_fused_rk4_window"

    def _deterministic_rhs(self, state: FieldBase) -> Callable:
        if getattr(self.pde, "is_sde", False):
            raise RuntimeError("Deterministic Runge-Kutta does not support stochastic equations")
        return self._make_rhs(state)

    def _make_single_step_fixed_dt(self, state: FieldBase, dt: float) -> Callable:
        rhs = self._deterministic_rhs(state)

        def single_step(leaves, t, generator=None):
            k1 = rhs(leaves, t)
            y2 = [y + 0.5 * dt * k for y, k in zip(leaves, k1, strict=True)]
            k2 = rhs(y2, t + 0.5 * dt)
            y3 = [y + 0.5 * dt * k for y, k in zip(leaves, k2, strict=True)]
            k3 = rhs(y3, t + 0.5 * dt)
            y4 = [y + dt * k for y, k in zip(leaves, k3, strict=True)]
            k4 = rhs(y4, t + dt)
            return [
                y + dt / 6.0 * (a + 2 * b + 2 * c + d)
                for y, a, b, c, d in zip(leaves, k1, k2, k3, k4, strict=True)
            ]

        return single_step

    def _make_single_step_error_estimate(self, state: FieldBase) -> Callable:
        """Embedded Runge-Kutta-Fehlberg 4(5) step with its error estimate."""
        rhs = self._deterministic_rhs(state)

        # Fehlberg's coefficients (formula 2, Table III)
        a2, a3, a4, a5, a6 = 1 / 4, 3 / 8, 12 / 13, 1.0, 1 / 2
        b21 = 1 / 4
        b31, b32 = 3 / 32, 9 / 32
        b41, b42, b43 = 1932 / 2197, -7200 / 2197, 7296 / 2197
        b51, b52, b53, b54 = 439 / 216, -8.0, 3680 / 513, -845 / 4104
        b61, b62, b63, b64, b65 = -8 / 27, 2.0, -3544 / 2565, 1859 / 4104, -11 / 40
        r1, r3, r4, r5, r6 = 1 / 360, -128 / 4275, -2197 / 75240, 1 / 50, 2 / 55
        c1, c3, c4, c5 = 25 / 216, 1408 / 2565, 2197 / 4104, -1 / 5

        def lc(ys, coeffs_ks):
            """leaves + sum(coeff * k), leaf by leaf."""
            out = []
            for i, y in enumerate(ys):
                acc = y
                for coeff, ks in coeffs_ks:
                    acc = acc + coeff * ks[i]
                out.append(acc)
            return out

        def estimate(leaves, t, dt):
            def stage(a, coeffs_ks):
                return [dt * r for r in rhs(lc(leaves, coeffs_ks), t + a * dt)]

            k1 = stage(0.0, [])
            k2 = stage(a2, [(b21, k1)])
            k3 = stage(a3, [(b31, k1), (b32, k2)])
            k4 = stage(a4, [(b41, k1), (b42, k2), (b43, k3)])
            k5 = stage(a5, [(b51, k1), (b52, k2), (b53, k3), (b54, k4)])
            k6 = stage(a6, [(b61, k1), (b62, k2), (b63, k3), (b64, k4), (b65, k5)])
            error = _max_abs(
                r1 * k1[i] + r3 * k3[i] + r4 * k4[i] + r5 * k5[i] + r6 * k6[i]
                for i in range(len(leaves))
            )
            return lc(leaves, [(c1, k1), (c3, k3), (c4, k4), (c5, k5)]), error

        return estimate
