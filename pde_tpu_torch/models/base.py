"""Base classes for PDEs.

Port of :mod:`pde_tpu.models.base` for deterministic equations. A PDE
describes its evolution rate on the field level; :meth:`PDEBase.make_pde_rhs`
lowers it to a function on the raw data tensors, which the solvers' plain
step loop calls. Stochastic equations are ROADMAP A7.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import numpy as np

from ..fields.base import FieldBase


def state_leaves(state: FieldBase) -> list:
    """The raw data tensors of a field, one per field of a collection."""
    from ..fields.collection import FieldCollection

    if isinstance(state, FieldCollection):
        return [f.data for f in state]
    return [state.data]


def state_from_leaves(template: FieldBase, leaves) -> FieldBase:
    """A field (or collection) like `template` holding the given data tensors."""
    from ..fields.collection import FieldCollection

    if isinstance(template, FieldCollection):
        return template.with_data(leaves)
    (data,) = leaves
    return template.with_data(data)


def expr_prod(factor: float, expression: str) -> str:
    """Helper for building expression strings with prefactors."""
    if factor == 0:
        return "0"
    if factor == 1:
        return expression
    if factor == -1:
        return f"-{expression}"
    return f"{factor:g} * {expression}"


class PDEBase:
    """Abstract base class for partial differential equations."""

    def __init__(self):
        self._logger = logging.getLogger(self.__class__.__name__)
        self.diagnostics: dict[str, Any] = {}

    def evolution_rate(self, state: FieldBase, t: float = 0) -> FieldBase:
        """Evaluate the right hand side of the PDE."""
        raise NotImplementedError

    def make_post_step_hook(self, state: FieldBase):
        """Return ``(hook(leaves, t, data) -> (leaves, data), initial data)``;
        raises ``NotImplementedError`` (the default) when there is no hook."""
        raise NotImplementedError

    def make_pde_rhs(self, state: FieldBase) -> Callable:
        """Return ``rhs(leaves, t) -> leaves`` operating on raw data tensors,
        one rate per leaf."""
        def rhs(leaves, t):
            return state_leaves(self.evolution_rate(state_from_leaves(state, leaves), t))

        return rhs

    def solve(
        self,
        state: FieldBase,
        t_range,
        dt: float | None = None,
        tracker="auto",
        *,
        backend: str = "auto",
        solver: str = "euler",
        **kwargs,
    ):
        """Solve the PDE: construct solver + controller and run the time loop.

        Without `dt` the Euler solver steps adaptively, which is not ported
        yet and raises.
        """
        from ..solvers import Controller
        from ..solvers.base import SolverBase

        if solver == "euler":
            kwargs.setdefault("adaptive", dt is None)
        solver_obj = SolverBase.from_name(solver, pde=self, backend=backend, **kwargs)
        controller = Controller(solver_obj, t_range=t_range, tracker=tracker)
        try:
            return controller.run(state, dt)
        finally:
            self.diagnostics.update(controller.diagnostics)


class SDEBase(PDEBase):
    """Base class of equations that may carry noise; only ``noise=0`` is
    ported (stochastic stepping is ROADMAP A7)."""

    def __init__(self, *, noise=0):
        super().__init__()
        if not np.allclose(np.asarray(noise, dtype=float), 0, atol=1e-14):
            raise NotImplementedError("Stochastic equations are not ported yet (ROADMAP A7)")
        self.noise = np.asanyarray(noise)
