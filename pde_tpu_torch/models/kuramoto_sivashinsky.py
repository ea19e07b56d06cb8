"""Kuramoto-Sivashinsky equation.

Port of :mod:`pde_tpu.models.kuramoto_sivashinsky`. Its rhs is two-deep,
``laplace(laplace(c))``, like Cahn-Hilliard's. The fixed-dt Euler window goes
through the expression compiler's stencil lowering into the generated 2D
kernel (#7); with noise, the Euler-Maruyama windows (#10 with staged
increments, #9 with an in-kernel law), as for KPZ. The ETDRK split goes
through the expression compiler too. Both routes need ``bc_lap == bc``, as
in ``pde_tpu``.
"""

from __future__ import annotations

import numpy as np

from ..fields.scalar import ScalarField
from ..grids.boundaries import set_default_bc
from .base import SDEBase, expr_prod


class KuramotoSivashinskyPDE(SDEBase):
    r"""KS equation :math:`\partial_t c = -\nu \nabla^4 c - \nabla^2 c - \frac12 (\nabla c)^2`."""

    explicit_time_dependence = False
    default_bc = "auto_periodic_neumann"

    def __init__(self, nu: float = 1, *, bc=None, bc_lap=None, noise: float = 0,
                 rng: np.random.Generator | None = None):
        super().__init__(noise=noise, rng=rng)
        self.nu = nu
        self.bc = set_default_bc(bc, self.default_bc)
        self.bc_lap = self.bc if bc_lap is None else bc_lap

    @property
    def expression(self) -> str:
        return f"-{expr_prod(self.nu, '∇⁴c')} - ∇²c - ½|∇c|²"

    def evolution_rate(self, state: ScalarField, t: float = 0) -> ScalarField:
        if not isinstance(state, ScalarField):
            raise TypeError("`state` must be ScalarField")
        state_lap = state.laplace(bc=self.bc, args={"t": t})
        result = (
            -self.nu * state_lap.laplace(bc=self.bc_lap, args={"t": t})
            - state_lap
            - 0.5 * state.gradient_squared(bc=self.bc, args={"t": t})
        )
        result.label = "evolution rate"
        return result

    def _fused_rhs(self):
        """``(rhs expression, bc)`` of the expression-routed windows."""
        if self.bc_lap != self.bc:
            # the expression routes one condition to every operator; a distinct
            # bc_lap would integrate other conditions than evolution_rate
            raise NotImplementedError("Expression routing requires bc_lap == bc")
        rhs = f"-{self.nu!r} * laplace(laplace(c)) - laplace(c) - 0.5 * gradient_squared(c)"
        return rhs, self.bc

    def make_fused_euler_window(self, state: ScalarField, dt: float, mesh=None):
        """Fused Euler (or Euler-Maruyama) window via the expression stencil
        lowering (with `mesh`, the decomposed window; noise there raises);
        raises :class:`~pde_tpu_torch.ops.KernelUnsupportedError` (a
        ``NotImplementedError``) where the kernels do not apply."""
        from .base import make_fused_window_via_expression

        rhs, bc = self._fused_rhs()
        return make_fused_window_via_expression(self, state, dt, rhs, bc, mesh=mesh)

    def make_etdrk_parts(self, state, rhs_state=None):
        """Spectral linear/nonlinear split for the ETDRK4 solver."""
        from .base import make_etdrk_parts_via_expression

        rhs, bc = self._fused_rhs()
        return make_etdrk_parts_via_expression(self, state, rhs, bc, rhs_state=rhs_state)
