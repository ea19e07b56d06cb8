"""Swift-Hohenberg equation.

Port of :mod:`pde_tpu.models.swift_hohenberg`. The fixed-dt Euler, RK4 and
Adams-Bashforth windows run through the expression compiler's generated
multi-field kernels (:func:`~.base.make_fused_window_via_expression`; a
two-deep rhs: the RK4 windows take one step a pass, the 3D one cut at its
RK stages into four passes of kernels #5 and #6); adaptive
runs are plain torch. The ETDRK split goes through the
expression compiler (:func:`~.base.make_etdrk_parts_via_expression`).
"""

from __future__ import annotations

from ..fields.scalar import ScalarField
from ..grids.boundaries import set_default_bc
from .base import PDEBase, expr_prod, make_fused_window_via_expression


class SwiftHohenbergPDE(PDEBase):
    r"""Swift-Hohenberg equation
    :math:`\partial_t c = [\epsilon - (k_c^2 + \nabla^2)^2] c + \delta c^2 - c^3`."""

    explicit_time_dependence = False
    default_bc = "auto_periodic_neumann"

    def __init__(self, rate: float = 0.1, kc2: float = 1.0, delta: float = 1.0, *,
                 bc=None, bc_lap=None):
        super().__init__()
        self.rate = rate
        self.kc2 = kc2
        self.delta = delta
        self.bc = set_default_bc(bc, self.default_bc)
        self.bc_lap = self.bc if bc_lap is None else bc_lap

    @property
    def expression(self) -> str:
        return (
            f"{expr_prod(self.rate - self.kc2**2, 'c')} - c³"
            f" + {expr_prod(self.delta, 'c²')}"
            f" - ∇²({expr_prod(2 * self.kc2, 'c')} + ∇²c)"
        )

    def evolution_rate(self, state: ScalarField, t: float = 0) -> ScalarField:
        if not isinstance(state, ScalarField):
            raise TypeError("`state` must be ScalarField")
        state_laplace = state.laplace(bc=self.bc, args={"t": t})
        state_laplace2 = state_laplace.laplace(bc=self.bc_lap, args={"t": t})
        result = (
            (self.rate - self.kc2**2) * state
            - 2 * self.kc2 * state_laplace
            - state_laplace2
            + self.delta * state**2
            - state**3
        )
        result.label = "evolution rate"
        return result

    def _fused_rhs(self):
        """``(rhs expression, bc)`` of the expression-routed windows."""
        if self.bc_lap != self.bc:
            # the expression routes one bc everywhere, so a distinct bc_lap
            # must not silently vanish
            raise NotImplementedError("Expression routing requires bc_lap == bc")
        rhs = (
            f"({self.rate!r} - {self.kc2!r}**2) * c"
            f" - 2 * {self.kc2!r} * laplace(c) - laplace(laplace(c))"
            f" + {self.delta!r} * c**2 - c**3"
        )
        return rhs, self.bc

    def make_fused_euler_window(self, state: ScalarField, dt: float, mesh=None):
        """Fused Euler window via the expression stencil lowering; raises
        :class:`~pde_tpu_torch.ops.KernelUnsupportedError` where the kernels
        do not apply."""
        rhs, bc = self._fused_rhs()
        return make_fused_window_via_expression(self, state, dt, rhs, bc, mesh=mesh)

    def make_etdrk_parts(self, state, rhs_state=None):
        """Spectral linear/nonlinear split for the ETDRK4 solver."""
        from .base import make_etdrk_parts_via_expression

        rhs, bc = self._fused_rhs()
        return make_etdrk_parts_via_expression(self, state, rhs, bc, rhs_state=rhs_state)
