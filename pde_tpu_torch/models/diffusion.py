"""Simple diffusion equation.

Port of :mod:`pde_tpu.models.diffusion` for the single-device case, with
optional additive noise.
"""

from __future__ import annotations

import numpy as np

from ..fields.scalar import ScalarField
from ..grids.boundaries import set_default_bc
from .base import SDEBase, expr_prod


def _expression_window_takes(grid, bcs) -> bool:
    """Whether the expression window takes a run the affine kernels refuse,
    as ``pde_tpu``'s routing says (``pde_tpu/models/diffusion.py:90-123``):
    on a 2D grid a side that varies in space and time, or has a per-point or
    time-dependent ghost factor (kernel #1 refuses those, #7 stages them;
    per-point and time-dependent consts stay with #1, on a cylinder in its
    radial mode's side inputs, or #12's on a mesh); on a 3D grid any face
    that is not a constant scalar (#3 takes scalar faces only, #5/#4 stage
    the rest)."""
    from ..ops.cuda_cartesian import KernelUnsupportedError, affine_bc_specs

    try:
        specs = affine_bc_specs(grid, bcs)
    except KernelUnsupportedError:
        return False
    sides = [side for pair in specs or () if pair is not None for side in pair]
    if grid.num_axes == 3:
        return any(not side.is_scalar for side in sides)
    return any(
        side.const_xt is not None or np.ndim(side.f1) or np.ndim(side.f2) or side.f1_t is not None
        for side in sides
    )


class DiffusionPDE(SDEBase):
    r"""Diffusion equation :math:`\partial_t c = D \nabla^2 c` (+ optional noise)."""

    explicit_time_dependence = False
    default_bc = "auto_periodic_neumann"

    def __init__(self, diffusivity: float = 1, *, bc=None, noise: float = 0,
                 rng: np.random.Generator | None = None):
        super().__init__(noise=noise, rng=rng)
        self.diffusivity = diffusivity
        self.bc = set_default_bc(bc, self.default_bc)

    @property
    def expression(self) -> str:
        return expr_prod(self.diffusivity, "∇²(c)")

    def evolution_rate(self, state: ScalarField, t: float = 0) -> ScalarField:
        if not isinstance(state, ScalarField):
            raise TypeError("`state` must be ScalarField")
        return self.diffusivity * state.laplace(
            bc=self.bc, label="evolution rate", args={"t": t}
        )

    def _fused_rhs(self):
        """``(rhs expression, bc)`` of the expression-routed windows (RK4,
        AB2 and the Euler-Maruyama window)."""
        return f"{self.diffusivity!r} * laplace(c)", self.bc

    def make_fused_euler_window(self, state: ScalarField, dt: float, mesh=None):
        """Temporally blocked Euler window: up to 16 steps per kernel pass on
        2D grids (``affine_laplace_2d``; on a ``CylindricalSymGrid`` its radial
        mode, whose r axis always carries conditions; under a 2D corner
        weight its 9-point mode, periodic grids only, up to 8 steps), 4 on
        3D grids (``affine_laplace_3d``).

        Returns ``window(data, steps) -> data``; with `mesh` (a
        :class:`~pde_tpu_torch.parallel.GridMesh`), the decomposed window
        ``window(blocks, steps) -> blocks`` through ``affine_laplace_ext_2d``
        (its radial mode on a cylindrical grid, as in ``pde_tpu``) or
        ``affine_laplace_ext_3d`` (2D and 3D grids). Raises
        :class:`~pde_tpu_torch.ops.KernelUnsupportedError` (a
        ``NotImplementedError``) for configurations the kernel does not take,
        before anything is built; solvers then use the plain step loop.
        Stochastic diffusion fuses as an Euler-Maruyama window through the
        expression compiler (the route of KPZ; 2D grids only, as in ``pde_tpu``; on
        a mesh, as in ``pde_tpu``, the ``torch`` engine runs it through the
        plain sharded stepper instead). Per-point and time-dependent side
        values go to kernel #1's side inputs (B1(c); on a mesh #12's, A9.3),
        on a ``CylindricalSymGrid`` to those of its radial mode (of #1's
        serially, of #12's on a mesh, as ``pde_tpu`` passes ``radial=`` with
        the side inputs); where a side varies in space and time, or its
        ghost factor varies, a 2D run takes the expression window (kernel #7,
        B2(b); on a mesh #8) instead, as ``pde_tpu`` routes it. A 3D run with any face that is not
        a constant scalar takes the 3D expression window (#5/#4; on a mesh
        #6), whose side inputs stage it, as ``pde_tpu`` routes it too.
        """
        from ..grids.boundaries.axes import BoundariesList
        from ..ops.cuda_cartesian import KernelUnsupportedError, make_fused_euler_window_2d
        from ..ops.cuda_cartesian_3d import make_fused_euler_window_3d

        if self.is_sde:
            from .base import make_fused_window_via_expression

            return make_fused_window_via_expression(self, state, dt, *self._fused_rhs(), mesh=mesh)

        bcs = state.grid.get_boundary_conditions(self.bc)
        if not isinstance(bcs, BoundariesList):  # a BoundariesSetter
            raise KernelUnsupportedError("Fused window requires per-axis BCs")
        # anti-periodic axes go to the kernel's gates, which refuse them
        fully_periodic = all(b.periodic and not b.low.flip_sign for b in bcs)
        if mesh is not None:
            from ..parallel.fused import make_fused_euler_window_sharded

            factory, args = make_fused_euler_window_sharded, (mesh,)
        else:
            factory = make_fused_euler_window_3d if state.grid.num_axes == 3 else \
                make_fused_euler_window_2d
            args = (state.grid,)
        try:
            return factory(
                *args, diffusivity=self.diffusivity, dt=dt, dtype=state.dtype,
                bcs=None if fully_periodic else bcs,
            )
        except KernelUnsupportedError:
            if _expression_window_takes(state.grid, bcs):
                from .base import make_fused_window_via_expression

                return make_fused_window_via_expression(self, state, dt, *self._fused_rhs(),
                                                        mesh=mesh)
            raise

    def make_etdrk_parts(self, state, rhs_state=None):
        """Spectral linear/nonlinear split for the ETDRK4 solver."""
        from .base import make_etdrk_parts_via_expression

        rhs = f"{self.diffusivity!r} * laplace(c)"
        return make_etdrk_parts_via_expression(self, state, rhs, self.bc, rhs_state=rhs_state)
