"""Solver wrapping :func:`scipy.integrate.solve_ivp` (host execution).

Port of :mod:`pde_tpu.solvers.scipy`: scipy integrates the flattened leaves
on the host, and every rhs evaluation runs on the state's device, with one
copy each way. scipy is imported when a stepper is made.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..fields.base import FieldBase, to_host
from ..models.base import PDEBase, state_from_leaves, state_leaves
from .base import SolverBase


class ScipySolver(SolverBase):
    """Solver using scipy.integrate.solve_ivp; the rhs runs on the state's device."""

    name = "scipy"

    def __init__(self, pde: PDEBase, *, backend: str = "auto", **kwargs):
        super().__init__(pde, backend=backend)
        self.solver_params = kwargs

    def make_stepper(self, state: FieldBase, dt: float | None = None) -> Callable:
        if getattr(self.pde, "is_sde", False):
            raise RuntimeError("Cannot use scipy stepper with stochastic equations")
        from scipy import integrate

        leaves_template = state_leaves(state)
        shapes = [x.shape for x in leaves_template]
        sizes = [x.numel() for x in leaves_template]
        splits = np.cumsum(sizes)[:-1]
        rhs = self.pde.make_pde_rhs(state)

        def to_leaves(y_flat, like):
            pieces = np.split(y_flat, splits)
            return [torch.as_tensor(p.reshape(s), dtype=x.dtype, device=x.device)
                    for p, s, x in zip(pieces, shapes, like, strict=True)]

        def flatten(leaves):
            return to_host(torch.cat([x.reshape(-1) for x in leaves]))

        solver_params = dict(self.solver_params)
        if dt is not None:
            solver_params.setdefault("first_step", min(dt, 1e-2))
        self.info["dt"] = dt
        self.info["stochastic"] = False

        def stepper(state_obj: FieldBase, t_start: float, t_end: float):
            leaves = state_leaves(state_obj)

            def rhs_flat(t, y_flat):
                return flatten(rhs(to_leaves(y_flat, leaves), t))

            sol = integrate.solve_ivp(
                rhs_flat, t_span=(t_start, t_end), y0=flatten(leaves), t_eval=np.array([t_end]),
                **solver_params,
            )
            if not sol.success:
                raise RuntimeError(f"solve_ivp failed: {sol.message}")
            self.info["steps"] += int(sol.nfev)
            new_leaves = to_leaves(sol.y[:, 0], leaves)
            return state_from_leaves(state_obj, new_leaves), float(sol.t[-1])

        return stepper
