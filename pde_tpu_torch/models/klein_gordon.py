"""Klein-Gordon equation as a two-field system.

Port of :mod:`pde_tpu.models.klein_gordon`: plain torch on the state's
device, as ``pde_tpu``'s has no fused route.
"""

from __future__ import annotations

from ..fields.collection import FieldCollection
from ..fields.scalar import ScalarField
from ..grids.boundaries import set_default_bc
from .base import PDEBase, expr_prod


class KleinGordonPDE(PDEBase):
    r"""Klein-Gordon equation :math:`\partial_t^2 u = c^2 \nabla^2 u - m^2 u`."""

    explicit_time_dependence = False
    default_bc = "auto_periodic_neumann"

    def __init__(self, speed: float = 1, mass: float = 1, *, bc=None):
        super().__init__()
        self.speed = speed
        self.mass = mass
        self.bc = set_default_bc(bc, self.default_bc)

    def get_initial_condition(self, u: ScalarField, v: ScalarField | None = None):
        """The state ``(u, v = du/dt)``, ``v`` zero unless given."""
        if v is None:
            v = ScalarField(u.grid, dtype=u.dtype, device=u.device)
        return FieldCollection([u, v], labels=["u", "v"])

    @property
    def expressions(self) -> dict[str, str]:
        return {"u": "v",
                "v": f"{expr_prod(self.speed**2, '∇²u')} - {expr_prod(self.mass**2, 'u')}"}

    def evolution_rate(self, state: FieldCollection, t: float = 0) -> FieldCollection:
        if not isinstance(state, FieldCollection):
            raise TypeError("`state` must be FieldCollection")
        if len(state) != 2:
            raise ValueError("`state` must contain two fields")
        u, v = state
        u_t = v.copy()
        v_t = self.speed**2 * u.laplace(self.bc, args={"t": t}) - self.mass**2 * u
        return FieldCollection([u_t, v_t])
