"""Differential operators on axially symmetric cylindrical (r, z) grids.

Port of :mod:`pde_tpu.ops.cylindrical`: plain PyTorch 2D stencils in the
same order of operations. Vector and tensor components are ordered
(r, z, φ). Factors that depend on r are computed on the host, as
``pde_tpu`` computes them (:func:`~.common.radial_factor_on`), as columns
over the rows (r is axis 0).

This module is also the plain version of the cylindrical Laplacian that
kernel #1's radial mode (:mod:`.cuda_cartesian`) steps k times.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..grids.cylindrical import CylindricalSymGrid
from .common import radial_factor_on, wrap_with_bcs

# the lower neighbours, the centres and the upper neighbours along each axis of a padded array
_L, _M, _H = slice(0, -2), slice(1, -1), slice(2, None)


def _dr(full, scale):
    return (full[..., _H, _M] - full[..., _L, _M]) * scale


def _dz(full, scale):
    return (full[..., _M, _H] - full[..., _M, _L]) * scale


def _column(grid, compute: Callable) -> Callable:
    """``on(like)``: a factor of r as a column over the rows."""
    on = radial_factor_on(grid, compute)
    return lambda like: on(like)[:, None]


def laplace_stencil(grid: CylindricalSymGrid) -> Callable:
    """The cylindrical Laplacian ∂²_r + (1/r) ∂_r + ∂²_z of a padded array."""
    dr, dz = grid.discretization
    dr_2, dz_2 = 1 / dr**2, 1 / dz**2
    factor_r = _column(grid, lambda rs: 1 / (2 * rs * dr))

    def stencil(full):
        center = full[..., _M, _M]
        lap_r = (full[..., _H, _M] - 2 * center + full[..., _L, _M]) * dr_2
        lap_r = lap_r + (full[..., _H, _M] - full[..., _L, _M]) * factor_r(full)
        lap_z = (full[..., _M, _L] - 2 * center + full[..., _M, _H]) * dz_2
        return lap_r + lap_z

    return stencil


@CylindricalSymGrid.register_operator("laplace", rank_in=0, rank_out=0)
def make_laplace(grid: CylindricalSymGrid, bcs) -> Callable:
    """Cylindrical Laplacian: ∂²_r + (1/r)∂_r + ∂²_z."""
    return wrap_with_bcs(grid, bcs, 0, laplace_stencil(grid))


@CylindricalSymGrid.register_operator("gradient", rank_in=0, rank_out=1)
def make_gradient(grid: CylindricalSymGrid, bcs) -> Callable:
    """Cylindrical gradient: (∂_r f, ∂_z f, 0)."""
    scale_r, scale_z = (1 / (2 * grid.discretization)).tolist()

    def stencil(full):
        grad_r = _dr(full, scale_r)
        return torch.stack([grad_r, _dz(full, scale_z), torch.zeros_like(grad_r)])

    return wrap_with_bcs(grid, bcs, 0, stencil)


@CylindricalSymGrid.register_operator("gradient_squared", rank_in=0, rank_out=0)
def make_gradient_squared(grid: CylindricalSymGrid, bcs, *, central: bool = True) -> Callable:
    if central:
        scale_r, scale_z = (0.25 / grid.discretization**2).tolist()

        def stencil(full):
            term_r = (full[_H, _M] - full[_L, _M]) ** 2
            term_z = (full[_M, _H] - full[_M, _L]) ** 2
            return term_r * scale_r + term_z * scale_z

    else:
        scale_r, scale_z = (0.5 / grid.discretization**2).tolist()

        def stencil(full):
            center = full[_M, _M]
            term_r = (full[_H, _M] - center) ** 2 + (center - full[_L, _M]) ** 2
            term_z = (full[_M, _H] - center) ** 2 + (center - full[_M, _L]) ** 2
            return term_r * scale_r + term_z * scale_z

    return wrap_with_bcs(grid, bcs, 0, stencil)


@CylindricalSymGrid.register_operator("divergence", rank_in=1, rank_out=0)
def make_divergence(grid: CylindricalSymGrid, bcs) -> Callable:
    """Cylindrical divergence: v_r/r + ∂_r v_r + ∂_z v_z."""
    scale_r, scale_z = (1 / (2 * grid.discretization)).tolist()
    inv_r = _column(grid, lambda rs: 1 / rs)

    def stencil(full):
        v_r, v_z = full[0], full[1]
        return v_r[_M, _M] * inv_r(full) + _dr(v_r, scale_r) + _dz(v_z, scale_z)

    return wrap_with_bcs(grid, bcs, 1, stencil)


@CylindricalSymGrid.register_operator("vector_gradient", rank_in=1, rank_out=2)
def make_vector_gradient(grid: CylindricalSymGrid, bcs) -> Callable:
    """Cylindrical vector gradient (a 3x3 tensor, components (r, z, φ))."""
    scale_r, scale_z = (1 / (2 * grid.discretization)).tolist()
    inv_r = _column(grid, lambda rs: 1 / rs)

    def stencil(full):
        factor = inv_r(full)
        v_r, v_z, v_p = full[0], full[1], full[2]
        zero = torch.zeros_like(v_r[_M, _M])
        return torch.stack([
            torch.stack([_dr(v_r, scale_r), _dz(v_r, scale_z), -v_p[_M, _M] * factor]),
            torch.stack([_dr(v_z, scale_r), _dz(v_z, scale_z), zero]),
            torch.stack([_dr(v_p, scale_r), _dz(v_p, scale_z), v_r[_M, _M] * factor]),
        ])

    return wrap_with_bcs(grid, bcs, 1, stencil)


@CylindricalSymGrid.register_operator("vector_laplace", rank_in=1, rank_out=1)
def make_vector_laplace(grid: CylindricalSymGrid, bcs) -> Callable:
    """Cylindrical vector Laplacian, with the -v/r² terms of v_r and v_φ."""
    dr, dz = grid.discretization
    s1, s2 = 1 / (2 * dr), 1 / dr**2
    scale_z = 1 / dz**2
    factor_r = _column(grid, lambda rs: s1 / rs)
    inv_r2 = _column(grid, lambda rs: 1 / rs**2)

    def scalar_lap(f_r, f_2, comp, curvature: bool):
        center = comp[_M, _M]
        lap = (
            (comp[_M, _H] - 2 * center + comp[_M, _L]) * scale_z
            + (comp[_H, _M] - comp[_L, _M]) * f_r
            + (comp[_H, _M] - 2 * center + comp[_L, _M]) * s2
        )
        if curvature:
            lap = lap - center * f_2
        return lap

    def stencil(full):
        f_r, f_2 = factor_r(full), inv_r2(full)
        v_r, v_z, v_p = full[0], full[1], full[2]
        return torch.stack([scalar_lap(f_r, f_2, v_r, True), scalar_lap(f_r, f_2, v_z, False),
                            scalar_lap(f_r, f_2, v_p, True)])

    return wrap_with_bcs(grid, bcs, 1, stencil)


@CylindricalSymGrid.register_operator("tensor_divergence", rank_in=2, rank_out=1)
def make_tensor_divergence(grid: CylindricalSymGrid, bcs) -> Callable:
    """Cylindrical tensor divergence (components (r, z, φ))."""
    scale_r, scale_z = (1 / (2 * grid.discretization)).tolist()
    inv_r = _column(grid, lambda rs: 1 / rs)

    def stencil(full):
        factor = inv_r(full)
        t_rr, t_rz, t_rp = full[0, 0], full[0, 1], full[0, 2]
        t_zr, t_zz = full[1, 0], full[1, 1]
        t_pr, t_pz, t_pp = full[2, 0], full[2, 1], full[2, 2]
        out_r = (_dz(t_rz, scale_z) + _dr(t_rr, scale_r)
                 + (t_rr[_M, _M] - t_pp[_M, _M]) * factor)
        out_p = (_dz(t_pz, scale_z) + _dr(t_pr, scale_r)
                 + (t_rp[_M, _M] + t_pr[_M, _M]) * factor)
        out_z = _dz(t_zz, scale_z) + _dr(t_zr, scale_r) + t_zr[_M, _M] * factor
        return torch.stack([out_r, out_z, out_p])

    return wrap_with_bcs(grid, bcs, 2, stencil)
