"""Kardar-Parisi-Zhang interface equation.

Port of :mod:`pde_tpu.models.kpz_interface`. With noise, the fixed-dt Euler
window is an Euler-Maruyama window through the expression compiler, run by
the generated CUDA kernels of :mod:`pde_tpu_torch.ops.cuda_sde_2d`. The ETDRK
split (deterministic runs only) goes through the expression compiler.
"""

from __future__ import annotations

import numpy as np

from ..fields.scalar import ScalarField
from ..grids.boundaries import set_default_bc
from .base import SDEBase, expr_prod


class KPZInterfacePDE(SDEBase):
    r"""KPZ equation :math:`\partial_t h = \nu \nabla^2 h + \frac{\lambda}{2}(\nabla h)^2 + \eta`."""

    explicit_time_dependence = False
    default_bc = "auto_periodic_neumann"

    def __init__(self, nu: float = 0.5, lmbda: float = 1, *, bc=None,
                 noise: float = 0, rng: np.random.Generator | None = None):
        super().__init__(noise=noise, rng=rng)
        self.nu = nu
        self.lmbda = lmbda
        self.bc = set_default_bc(bc, self.default_bc)

    @property
    def expression(self) -> str:
        return expr_prod(self.nu, "∇²c") + " + " + expr_prod(self.lmbda, "|∇c|²")

    def evolution_rate(self, state: ScalarField, t: float = 0) -> ScalarField:
        if not isinstance(state, ScalarField):
            raise TypeError("`state` must be ScalarField")
        result = self.nu * state.laplace(bc=self.bc, args={"t": t})
        result = result + self.lmbda * state.gradient_squared(bc=self.bc, args={"t": t})
        result.label = "evolution rate"
        return result

    def _fused_rhs(self):
        rhs = f"{self.nu!r} * laplace(c) + {self.lmbda!r} * gradient_squared(c)"
        return rhs, self.bc

    def make_fused_euler_window(self, state: ScalarField, dt: float, mesh=None):
        """Fused Euler (or Euler-Maruyama) window via the expression stencil
        lowering (with `mesh`, the decomposed window; noise there raises);
        raises :class:`~pde_tpu_torch.ops.KernelUnsupportedError` where the
        kernels do not apply."""
        from .base import make_fused_window_via_expression

        rhs, bc = self._fused_rhs()
        return make_fused_window_via_expression(self, state, dt, rhs, bc, mesh=mesh)

    def make_etdrk_parts(self, state, rhs_state=None):
        """Spectral linear/nonlinear split for the ETDRK4 solver."""
        from .base import make_etdrk_parts_via_expression

        rhs, bc = self._fused_rhs()
        return make_etdrk_parts_via_expression(self, state, rhs, bc, rhs_state=rhs_state)
