"""Differential operators on polar (angularly symmetric 2D) grids.

Port of :mod:`pde_tpu.ops.polar`: plain PyTorch stencils over the one radial
axis, in the same order of operations. Vector components are ordered
(r, φ). Factors that depend on r are computed on the host, as ``pde_tpu``
computes them (:func:`~.common.radial_factor_on`).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..grids.spherical import PolarSymGrid
from .common import radial_factor_on, wrap_with_bcs

# the lower neighbours, the centres and the upper neighbours along r of a padded array
_LO, _MID, _HI = (..., slice(0, -2)), (..., slice(1, -1)), (..., slice(2, None))


def radial_diff(full, method: str, scale: float):
    """The derivative along r of a padded array: central differences times
    `scale`, or one-sided ones times ``2 * scale``."""
    if method == "central":
        return (full[_HI] - full[_LO]) * scale
    if method == "forward":
        return (full[_HI] - full[_MID]) * (2 * scale)
    if method == "backward":
        return (full[_MID] - full[_LO]) * (2 * scale)
    raise ValueError(f"Unknown derivative method `{method}`")


def gradient_squared_stencil(dr: float, central: bool) -> Callable:
    """The squared radial derivative: from central differences, or the mean
    of the squared one-sided ones."""
    if central:
        scale = 0.25 / dr**2

        def stencil(full):
            return (full[_HI] - full[_LO]) ** 2 * scale

    else:
        scale = 0.5 / dr**2

        def stencil(full):
            return ((full[_HI] - full[_MID]) ** 2 + (full[_MID] - full[_LO]) ** 2) * scale

    return stencil


@PolarSymGrid.register_operator("laplace", rank_in=0, rank_out=0)
def make_laplace(grid: PolarSymGrid, bcs) -> Callable:
    """Polar Laplacian: f'' + f'/r."""
    dr = grid.discretization[0]
    dr_2 = 1 / dr**2
    factor_r = radial_factor_on(grid, lambda rs: 1 / (2 * rs * dr))

    def stencil(full):
        return (full[_HI] - 2 * full[_MID] + full[_LO]) * dr_2 + (
            full[_HI] - full[_LO]) * factor_r(full)

    return wrap_with_bcs(grid, bcs, 0, stencil)


@PolarSymGrid.register_operator("gradient", rank_in=0, rank_out=1)
def make_gradient(grid: PolarSymGrid, bcs, *, method: str = "central") -> Callable:
    """Polar gradient: (∂_r f, 0)."""
    scale = 0.5 / grid.discretization[0]

    def stencil(full):
        grad_r = radial_diff(full, method, scale)
        return torch.stack([grad_r, torch.zeros_like(grad_r)])

    return wrap_with_bcs(grid, bcs, 0, stencil)


@PolarSymGrid.register_operator("gradient_squared", rank_in=0, rank_out=0)
def make_gradient_squared(grid: PolarSymGrid, bcs, *, central: bool = True) -> Callable:
    return wrap_with_bcs(grid, bcs, 0, gradient_squared_stencil(grid.discretization[0], central))


@PolarSymGrid.register_operator("divergence", rank_in=1, rank_out=0)
def make_divergence(grid: PolarSymGrid, bcs) -> Callable:
    """Polar divergence: ∂_r v_r + v_r / r."""
    scale_r = 1 / (2 * grid.discretization[0])
    inv_r = radial_factor_on(grid, lambda rs: 1 / rs)

    def stencil(full):
        v_r = full[0]
        return (v_r[_HI] - v_r[_LO]) * scale_r + v_r[_MID] * inv_r(full)

    return wrap_with_bcs(grid, bcs, 1, stencil)


@PolarSymGrid.register_operator("vector_gradient", rank_in=1, rank_out=2)
def make_vector_gradient(grid: PolarSymGrid, bcs) -> Callable:
    """Polar vector gradient (a 2x2 tensor)."""
    scale_r = 1 / (2 * grid.discretization[0])
    inv_r = radial_factor_on(grid, lambda rs: 1 / rs)

    def stencil(full):
        factor = inv_r(full)
        v_r, v_p = full[0], full[1]
        out_rr = (v_r[_HI] - v_r[_LO]) * scale_r
        out_rp = -v_p[_MID] * factor
        out_pr = (v_p[_HI] - v_p[_LO]) * scale_r
        out_pp = v_r[_MID] * factor
        return torch.stack([torch.stack([out_rr, out_rp]), torch.stack([out_pr, out_pp])])

    return wrap_with_bcs(grid, bcs, 1, stencil)


@PolarSymGrid.register_operator("tensor_divergence", rank_in=2, rank_out=1)
def make_tensor_divergence(grid: PolarSymGrid, bcs) -> Callable:
    """Polar tensor divergence."""
    scale_r = 1 / (2 * grid.discretization[0])
    inv_r = radial_factor_on(grid, lambda rs: 1 / rs)

    def stencil(full):
        factor = inv_r(full)
        t_rr, t_rp = full[0, 0], full[0, 1]
        t_pr, t_pp = full[1, 0], full[1, 1]
        out_r = (t_rr[_HI] - t_rr[_LO]) * scale_r + (t_rr[_MID] - t_pp[_MID]) * factor
        out_p = (t_pr[_HI] - t_pr[_LO]) * scale_r + (t_rp[_MID] + t_pr[_MID]) * factor
        return torch.stack([out_r, out_p])

    return wrap_with_bcs(grid, bcs, 2, stencil)
