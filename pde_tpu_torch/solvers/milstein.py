"""Milstein method for stochastic differential equations.

Port of :mod:`pde_tpu.solvers.milstein`. The plain step adds the correction
``0.25 * d(var)/dc / V * (dW**2 - dt)`` of a state-dependent variance to the
Euler-Maruyama step. The fused path is the inherited Euler window: the
Euler-Maruyama kernels take additive scalar Itô noise only, where the
correction is identically zero and the scheme is Euler-Maruyama; a model
that overrides ``make_noise_variance`` never reaches them
(:func:`~pde_tpu_torch.models.base.require_fusable_noise`), so the fused path
cannot drop the correction.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..fields.base import FieldBase
from ..models.base import PDEBase, _host_factor, _on_leaf
from .euler import EulerSolver


class MilsteinSolver(EulerSolver):
    """Milstein method including the derivative-of-variance correction term.

    The unit increments are standard normal draws from the solver's
    generator, the draws of the Euler-Maruyama plain loop under the default
    ``sde.increment_dist``; the staged window of additive noise adds the same
    increments, so it equals this loop up to rounding. As in ``pde_tpu``, the
    loop draws normal increments whatever ``sde.increment_dist`` says, while
    the fused window follows it. On a mesh the plain sharded stepper runs the
    step: each block's rates on its halo-extended view, the noise terms on
    the combined leaves (their cell volumes, variances and derivatives are
    the serial run's), so a decomposed run equals the serial one.
    """

    name = "milstein"

    def __init__(self, pde: PDEBase, *, backend: str = "auto", adaptive: bool = False,
                 tolerance: float = 1e-4, decomposition=None):
        super().__init__(pde, backend=backend, adaptive=adaptive, tolerance=tolerance,
                         decomposition=decomposition)
        if not getattr(pde, "use_noise_variance", False):
            raise RuntimeError("Milstein solver requires `use_noise_variance` enabled")

    def _make_single_step_fixed_dt(self, state: FieldBase, dt: float) -> Callable:
        if not getattr(self.pde, "is_sde", False):
            return super()._make_single_step_fixed_dt(state, dt)
        rhs = self._make_rhs(state)
        noise_step = self._make_noise_terms(state)
        if self._blocks is not None:  # the whole grid's noise terms, split into blocks
            noise_step = self._blocks.noise_step(noise_step)

        def single_step(leaves, t, generator=None):
            rates = rhs(leaves, t)
            noise = noise_step(leaves, t, generator, dt)
            return [y + dt * r + n for y, r, n in zip(leaves, rates, noise, strict=True)]

        return single_step

    def _make_noise_terms(self, state: FieldBase) -> Callable:
        """``terms(leaves, t, generator, dt) -> increments``: everything the
        Milstein step adds besides ``dt * rate``, in ``pde_tpu``'s order of
        operations: the realization (its draws after the increments'), the
        drift term, ``sqrt(var / V) dW`` and the correction."""
        pde = self.pde
        drift_factor = pde._noise_drift_factor
        inv_cell = 1.0 / _host_factor(state.grid.cell_volumes)
        noise_var = pde.make_noise_variance(state, ret_diff=True)
        realization_fn = pde.make_noise_realization(state) if pde.use_noise_realization else None

        def terms(leaves, t, generator, dt):
            dt_sqrt = math.sqrt(dt)
            variances, diffs = noise_var(leaves, t)
            draws = [torch.empty_like(y).normal_(generator=generator) for y in leaves]
            extra = None if realization_fn is None else realization_fn(leaves, t, generator)
            out = []
            for i, (y, z, var, diff) in enumerate(
                zip(leaves, draws, variances, diffs, strict=True)
            ):
                var = torch.as_tensor(var, dtype=y.dtype, device=y.device)
                diff = torch.as_tensor(diff, dtype=y.dtype, device=y.device)
                inv = _on_leaf(inv_cell, y)
                dW = dt_sqrt * z
                inc = (
                    0.5 * dt * drift_factor * diff * inv
                    + torch.sqrt(var * inv) * dW
                    + 0.25 * diff * inv * (dW**2 - dt)
                )
                out.append(inc if extra is None else dt_sqrt * extra[i] + inc)
            return out

        return terms

