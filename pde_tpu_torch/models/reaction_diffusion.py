"""Reaction-diffusion systems.

Port of :mod:`pde_tpu.models.reaction_diffusion`: plain torch on the state's
device, as ``pde_tpu``'s has no fused route. The sources are expression
strings lowered once by :class:`~pde_tpu_torch.utils.expressions.ScalarExpression`
to torch functions of the fields' data and the time.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..fields.collection import FieldCollection
from ..grids.boundaries import set_default_bc
from .base import PDEBase, expr_prod


class ReactionDiffusionPDE(PDEBase):
    r"""System of reaction-diffusion equations
    :math:`\partial_t c_i = D_i \nabla^2 c_i + f_i(c_1, ..., c_n, t)`."""

    default_bc = "auto_periodic_neumann"

    def __init__(self, variables: Sequence[str], diffusivity, sources, *, bc=None,
                 bc_ops=None, post_step_hook=None):
        from ..utils.expressions import ScalarExpression

        super().__init__()
        self.variables = list(variables)
        self.diffusivity = np.broadcast_to(
            np.asarray(diffusivity, dtype=float), (len(self.variables),))
        if isinstance(sources, dict):
            sources = [sources.get(v, 0) for v in self.variables]
        if len(sources) != len(self.variables):
            raise ValueError("Number of sources must match number of variables")
        self.sources = list(sources)
        self.bc = set_default_bc(bc, self.default_bc)
        self.bc_ops = bc_ops or {}
        self._post_step_hook = post_step_hook
        signature = [*self.variables, "t"]
        self._source_funcs = [ScalarExpression(src, signature=signature)._get_function()
                              for src in self.sources]

    @property
    def expressions(self) -> dict[str, str]:
        return {var: f"{expr_prod(float(D), f'∇²{var}')} + {src}"
                for var, D, src in zip(self.variables, self.diffusivity, self.sources,
                                       strict=True)}

    def make_post_step_hook(self, state):
        """The user's ``hook(leaves, t, data) -> (leaves, data)``, initial data 0."""
        if self._post_step_hook is None:
            raise NotImplementedError
        hook = self._post_step_hook

        def post_step_hook(leaves, t, data):
            return hook(leaves, t, data)

        return post_step_hook, 0.0

    def evolution_rate(self, state: FieldCollection, t: float = 0) -> FieldCollection:
        if not isinstance(state, FieldCollection):
            raise TypeError("`state` must be FieldCollection")
        if len(state) != len(self.variables):
            raise ValueError(f"`state` must contain {len(self.variables)} fields")
        values = [f.data for f in state]
        rates = []
        for i, field in enumerate(state):
            bc = self.bc_ops.get(self.variables[i], self.bc)
            rate = float(self.diffusivity[i]) * field.laplace(bc=bc, args={"t": t})
            rates.append(rate + self._source_funcs[i](*values, t))
        return FieldCollection(rates, labels=list(self.variables))
