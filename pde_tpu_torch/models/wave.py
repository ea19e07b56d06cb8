"""Wave equation as a two-field system.

Port of :mod:`pde_tpu.models.wave`. Like ``pde_tpu``'s, the model has no
one-field expression form, so it has no fused window of its own: its
fixed-dt runs take the plain step loop, and ``PDE({"u": "v", "v":
"laplace(u)"})`` states the same system for the expression windows.
"""

from __future__ import annotations

from ..fields.collection import FieldCollection
from ..fields.scalar import ScalarField
from ..grids.boundaries import set_default_bc
from .base import PDEBase, expr_prod


class WavePDE(PDEBase):
    r"""Wave equation :math:`\partial_t^2 u = c^2 \nabla^2 u` as the system
    :math:`\partial_t u = v`, :math:`\partial_t v = c^2 \nabla^2 u`."""

    explicit_time_dependence = False
    default_bc = "auto_periodic_neumann"

    def __init__(self, speed: float = 1, *, bc=None):
        super().__init__()
        self.speed = speed
        self.bc = set_default_bc(bc, self.default_bc)

    def get_initial_condition(self, u: ScalarField, v: ScalarField | None = None):
        """A two-field initial condition from the amplitude `u` (and the
        rate `v`, zero by default, on `u`'s device and dtype)."""
        if v is None:
            v = ScalarField(u.grid, dtype=u.dtype, device=u.device)
        return FieldCollection([u, v], labels=["u", "v"])

    @property
    def expressions(self) -> dict[str, str]:
        return {"u": "v", "v": expr_prod(self.speed**2, "∇²u")}

    def evolution_rate(self, state: FieldCollection, t: float = 0) -> FieldCollection:
        if not isinstance(state, FieldCollection):
            raise TypeError("`state` must be FieldCollection")
        if len(state) != 2:
            raise ValueError("`state` must contain two fields")
        u, v = state
        u_t = v.copy()
        v_t = self.speed**2 * u.laplace(self.bc, args={"t": t})
        return FieldCollection([u_t, v_t])
