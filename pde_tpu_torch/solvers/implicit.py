"""Implicit Euler solver using fixed-point iteration.

Port of :mod:`pde_tpu.solvers.implicit`, plain torch on the state's device,
as ``pde_tpu``'s ``while_loop`` is plain XLA. The iteration's carry stays on
the device and every update is gated by ``torch.where`` on the stop test of
the iterate it starts from, so the result is the iterate at which
``pde_tpu``'s loop stops; the host reads the stop flag once per
:data:`FIXED_POINT_CHUNK` iterations. The rhs and the leaves are the
solver's (:meth:`~.base.SolverBase._make_rhs`, :meth:`~.base.SolverBase._leaf_maps`),
so decomposed runs take the plain sharded stepper: the mean squared error
then sums every block's leaves, with the same divisor.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..fields.base import FieldBase
from ..models.base import PDEBase, state_leaves
from .base import ConvergenceError, SolverBase

#: fixed-point iterations between two host reads of the stop flag; iterations
#: past the stop change nothing (every update is gated)
FIXED_POINT_CHUNK = 4


def _mse(leaves_a, leaves_b) -> torch.Tensor:
    """Mean squared difference over all leaves, a 0-d tensor."""
    err = None
    size = 0
    for a, b in zip(leaves_a, leaves_b, strict=True):
        diff = a - b
        term = torch.sum((diff.conj() * diff).real) if diff.is_complex() else torch.sum(diff * diff)
        err = term if err is None else err + term
        size += a.numel()
    return err / size


def _fixed_point(update: Callable, leaves_init, maxiter: int, maxerror2: float):
    """Iterate `update` until the mean squared change falls below `maxerror2`
    or `maxiter` iterations ran; returns ``(leaves, converged, iterations,
    host reads)``, the middle two 0-d tensors."""
    leaves = update(leaves_init)
    err2 = _mse(leaves, leaves_init)
    n = torch.ones((), dtype=torch.int64, device=err2.device)

    def running(n, err2):
        return (n < maxiter) & (err2 >= maxerror2)

    reads = 0
    while True:
        for _ in range(FIXED_POINT_CHUNK):
            go = running(n, err2)
            new_leaves = update(leaves)
            err2 = torch.where(go, _mse(new_leaves, leaves), err2)
            leaves = [torch.where(go, a, b) for a, b in zip(new_leaves, leaves, strict=True)]
            n = n + go
        reads += 1
        if not bool(running(n, err2)):
            break
    return leaves, err2 < maxerror2, n, reads


class _FixedPointSolver(SolverBase):
    """Fixed-dt steps whose new state is a fixed point: a failed iteration
    turns the state into NaN and the window raises :class:`ConvergenceError`.
    ``info["fixed_point_iterations"]`` counts the iterations of every step,
    ``info["host_syncs"]`` the host reads of their stop flags."""

    _failure_message = ""

    def __init__(self, pde: PDEBase, *, maxiter: int = 100, maxerror: float = 1e-4,
                 backend: str = "auto", decomposition=None):
        super().__init__(pde, backend=backend, decomposition=decomposition)
        self.maxiter = maxiter
        self.maxerror = maxerror
        self._iterations = None

    def _solve_fixed_point(self, update: Callable, leaves):
        """The converged fixed point of `update` from `leaves`, NaN where the
        iteration did not converge (so trackers and the window's check see it)."""
        new_leaves, converged, n, reads = _fixed_point(
            update, leaves, int(self.maxiter), self.maxerror**2)
        self._iterations = n if self._iterations is None else self._iterations + n
        self.info["host_syncs"] = self.info.get("host_syncs", 0) + reads
        return [torch.where(converged, y, torch.full_like(y, torch.nan)) for y in new_leaves]

    def _make_fixed_stepper(self, state: FieldBase, dt: float) -> Callable:
        stepper = super()._make_fixed_stepper(state, dt)
        self.info.setdefault("fixed_point_iterations", 0)
        self.info.setdefault("host_syncs", 0)

        def checked_stepper(state_obj: FieldBase, t_start: float, t_end: float):
            self._iterations = None
            new_state, t = stepper(state_obj, t_start, t_end)
            data0 = state_leaves(new_state)[0]
            finite, iterations = torch.stack([
                torch.isfinite(data0).all().to(torch.int64), self._iterations]).tolist()
            self.info["fixed_point_iterations"] += iterations
            self.info["host_syncs"] += 1
            if not finite:
                # a convergence failure cannot be told from a blow-up after the
                # fact; report it as one, as pde_tpu does
                raise ConvergenceError(self._failure_message)
            return new_state, t

        return checked_stepper


class ImplicitSolver(_FixedPointSolver):
    """Implicit Euler solver with fixed-point iteration per step."""

    name = "implicit"
    _failure_message = "Implicit Euler step did not converge"

    def _make_single_step_fixed_dt(self, state: FieldBase, dt: float) -> Callable:
        rhs = self._make_rhs(state)
        is_sde = getattr(self.pde, "is_sde", False)
        if is_sde:
            noise_step = self.pde.make_sde_noise_step(state)
            if self._blocks is not None:  # the whole grid's increments, split into blocks
                noise_step = self._blocks.noise_step(noise_step)

        def single_step(leaves, t, generator=None):
            if is_sde:
                noise = noise_step(leaves, t, generator, dt)
                leaves = [y + n for y, n in zip(leaves, noise, strict=True)]
            y_t = leaves

            def update(current):
                rates = rhs(current, t + dt)
                return [y0 + dt * r for y0, r in zip(y_t, rates, strict=True)]

            return self._solve_fixed_point(update, leaves)

        return single_step
