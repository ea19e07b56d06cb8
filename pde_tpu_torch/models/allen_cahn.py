"""Allen-Cahn equation.

Port of :mod:`pde_tpu.models.allen_cahn` for the single-device case. The
fixed-dt Euler window runs through the expression compiler's generated
multi-field CUDA kernel of the grid's rank (2D or 3D); the ETDRK split goes
through the expression compiler.
"""

from __future__ import annotations

import numpy as np

from ..fields.scalar import ScalarField
from ..grids.boundaries import set_default_bc
from .base import PDEBase, expr_prod


class AllenCahnPDE(PDEBase):
    r"""Allen-Cahn equation :math:`\partial_t c = \mu(\gamma \nabla^2 c - c^3 + c)`."""

    explicit_time_dependence = False
    default_bc = "auto_periodic_neumann"

    def __init__(self, interface_width: float = 1, mobility: float = 1, *, bc=None):
        super().__init__()
        self.interface_width = interface_width
        self.mobility = mobility
        self.bc = set_default_bc(bc, self.default_bc)

    @property
    def expression(self) -> str:
        expr = f"{expr_prod(self.interface_width, '∇²c')} - c³ + c"
        if np.isclose(self.mobility, 1):
            return expr
        return expr_prod(self.mobility, f"({expr})")

    def evolution_rate(self, state: ScalarField, t: float = 0) -> ScalarField:
        if not isinstance(state, ScalarField):
            raise TypeError("`state` must be ScalarField")
        laplace = state.laplace(bc=self.bc, label="evolution rate", args={"t": t})
        return self.mobility * (self.interface_width * laplace - state**3 + state)

    def _fused_rhs(self):
        """``(rhs expression, bc)`` of the expression-routed window."""
        rhs = f"{self.mobility!r} * ({self.interface_width!r} * laplace(c) - c**3 + c)"
        return rhs, self.bc

    def make_fused_euler_window(self, state: ScalarField, dt: float, mesh=None):
        """Fused Euler window via the expression stencil lowering; raises
        :class:`~pde_tpu_torch.ops.KernelUnsupportedError` where the kernels
        do not apply."""
        from .base import make_fused_window_via_expression

        rhs, bc = self._fused_rhs()
        return make_fused_window_via_expression(self, state, dt, rhs, bc, mesh=mesh)

    def make_etdrk_parts(self, state, rhs_state=None):
        """Spectral linear/nonlinear split for the ETDRK4 solver."""
        from .base import make_etdrk_parts_via_expression

        rhs, bc = self._fused_rhs()
        return make_etdrk_parts_via_expression(self, state, rhs, bc, rhs_state=rhs_state)
