"""Shared helpers for building differential operators.

Port of :mod:`pde_tpu.ops.common`. An operator factory has the signature
``factory(grid, bcs=None, **kwargs)`` and returns ``op(data, t=0.0,
args=None)`` mapping valid data to valid data.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..grids.base import GridBase, radial_factor


def wrap_with_bcs(grid: GridBase, bcs, rank_in: int, stencil: Callable) -> Callable:
    """Compose padding + ghost-cell setting + a stencil into one operator.

    `stencil` maps a padded array (one ghost layer per axis) to a
    valid-shaped result. ``wrap_with_bcs.calls`` counts the operators'
    applications: each reads one cell beyond its operand, so the calls of one
    rhs evaluation bound the halo it needs (the plain decomposed stepper sizes
    its halo by them where the rhs has no stencil lowering).
    """
    ghost_setter = bcs.make_ghost_setter()
    pads = [1, 1] * grid.num_axes  # torch.nn.functional.pad order: last axis first

    def op(data, t=0.0, args=None):
        # t and args are part of the operator signature; the ported
        # conditions do not depend on them
        wrap_with_bcs.calls += 1
        full = torch.nn.functional.pad(data, pads)
        return stencil(ghost_setter(full))

    return op


wrap_with_bcs.calls = 0


def radial_factor_on(grid: GridBase, compute: Callable, axis: int = 0) -> Callable:
    """``on(like) -> tensor``: the host factor :func:`~..grids.base.radial_factor`
    of `grid` as a tensor of `like`'s dtype on its device (made once per
    dtype and device), so that every operator application multiplies by the
    same precomputed values."""
    values = radial_factor(grid, compute, axis)
    cache: dict = {}

    def on(like: torch.Tensor) -> torch.Tensor:
        key = (like.dtype, like.device)
        tensor = cache.get(key)
        if tensor is None:
            tensor = cache[key] = torch.as_tensor(np.asarray(values), dtype=like.dtype,
                                                  device=like.device)
        return tensor

    return on


def require_default(name: str, value, default) -> None:
    """Raise :class:`NotImplementedError` unless an option ``pde_tpu`` takes
    has its default, the only value the port implements so far."""
    if value != default:
        raise NotImplementedError(
            f"`{name}={value!r}` is not ported yet (ROADMAP A4); only the default "
            f"`{name}={default!r}` is"
        )
