"""Cahn-Hilliard equation.

Port of :mod:`pde_tpu.models.cahn_hilliard` for the single-device case. The
fixed-dt Euler window runs the whole step (two Laplacians and the cubic
chemical potential) through the generated multi-field CUDA kernel of the
grid's rank (2D or 3D), several steps per pass over device memory; the ETDRK
split goes through the expression compiler.
"""

from __future__ import annotations

from ..fields.scalar import ScalarField
from ..grids.boundaries import set_default_bc
from .base import PDEBase, expr_prod


class CahnHilliardPDE(PDEBase):
    r"""Cahn-Hilliard equation :math:`\partial_t c = \nabla^2(c^3 - c - \gamma\nabla^2 c)`."""

    explicit_time_dependence = False
    default_bc_c = "auto_periodic_neumann"
    default_bc_mu = "auto_periodic_neumann"

    def __init__(self, interface_width: float = 1, *, bc_c=None, bc_mu=None):
        super().__init__()
        self.interface_width = interface_width
        self.bc_c = set_default_bc(bc_c, self.default_bc_c)
        self.bc_mu = set_default_bc(bc_mu, self.default_bc_mu)

    @property
    def expression(self) -> str:
        return f"∇²(c³ - c - {expr_prod(self.interface_width, '∇²c')})"

    def evolution_rate(self, state: ScalarField, t: float = 0) -> ScalarField:
        if not isinstance(state, ScalarField):
            raise TypeError("`state` must be ScalarField")
        c_laplace = state.laplace(bc=self.bc_c, label="evolution rate", args={"t": t})
        mu = state**3 - state - self.interface_width * c_laplace
        return mu.laplace(bc=self.bc_mu, args={"t": t})

    def _fused_rhs(self):
        """``(rhs expression, bc)`` of the expression-routed windows."""
        if self.bc_c != self.bc_mu:
            # the expression routing cannot distinguish the inner from the outer laplace
            raise NotImplementedError("Expression routing requires bc_c == bc_mu")
        return f"laplace(c**3 - c - {float(self.interface_width)!r} * laplace(c))", self.bc_c

    def make_fused_euler_window(self, state: ScalarField, dt: float, mesh=None):
        """Temporally blocked Euler window (``window(datas, steps) -> datas``;
        with `mesh`, the decomposed ``window(blocks, steps) -> blocks``).

        Raises :class:`~pde_tpu_torch.ops.KernelUnsupportedError` (a
        ``NotImplementedError``) where the kernel does not apply; ``bc_c`` and
        ``bc_mu`` may differ. Per-point and time-dependent side values reach
        the 2D and 3D kernels as side inputs (B2(b), serial; A9.3, on a mesh; the
        window then takes ``(datas, t0, steps)`` where they depend on time).
        """
        from ..grids.boundaries.axes import BoundariesList
        from ..ops.cuda_cartesian import KernelUnsupportedError, affine_bc_specs
        from ..ops.cuda_stencil_3d import make_chunked_multi_window
        from .pde import require_default_laplace_stencil, side_inputs_for

        require_default_laplace_stencil()
        params = []
        for bc in (self.bc_c, self.bc_mu):
            bcs = state.grid.get_boundary_conditions(bc)
            if not isinstance(bcs, BoundariesList):
                raise KernelUnsupportedError("Fused window requires per-axis BCs")
            params.append(affine_bc_specs(state.grid, bcs))
        bc_c, bc_mu = params
        sides = side_inputs_for(state.grid, {("c", "c"): bc_c, ("c", "mu"): bc_mu})
        gamma = float(self.interface_width)

        def make_step(ops):
            def step(works):
                (work,) = works
                lap_c = ops.lap(work, bc=bc_c)
                c = ops.trim(work, 1)
                mu = c * c * c - c - gamma * lap_c
                return [ops.trim(work, 2) + dt * ops.lap(mu, bc=bc_mu)]

            return step

        if mesh is not None:
            from ..parallel.fused import make_fused_multi_window_sharded

            return make_fused_multi_window_sharded(mesh, make_step, 2, 1, dtype=state.dtype,
                                                   sides=sides, dt=dt)
        return make_chunked_multi_window(state.grid, make_step, 2, 1, dtype=state.dtype,
                                         sides=sides, dt=dt)

    def make_etdrk_parts(self, state, rhs_state=None):
        """Spectral linear/nonlinear split for the ETDRK4 solver."""
        from .base import make_etdrk_parts_via_expression

        if self.bc_c != self.bc_mu:
            raise NotImplementedError("ETDRK split requires bc_c == bc_mu")
        gamma = float(self.interface_width)
        rhs = f"laplace(c**3 - c - {gamma!r} * laplace(c))"
        return make_etdrk_parts_via_expression(self, state, rhs, self.bc_c, rhs_state=rhs_state)
