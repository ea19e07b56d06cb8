"""Cartesian differential operators as plain PyTorch slicing stencils.

Port of :mod:`pde_tpu.ops.cartesian` on 1D, 2D and 3D grids: the Laplacian
(3-point in 1D, 5-point or 9-point in 2D, 7-point in 3D, or spectral on
periodic grids), the gradient, its squared magnitude, the divergence, and the
rank-generic vector gradient, vector Laplacian and tensor divergence, with
``pde_tpu``'s options (central, forward or backward differences; the
squared gradient's one-sided form). This is the unfused operator path: the
solvers' plain step loop and the ``torch`` engine's operators run it, and it
is the in-port oracle for the CUDA kernels of
:mod:`pde_tpu_torch.ops.cuda_cartesian`,
:mod:`pde_tpu_torch.ops.cuda_cartesian_3d`,
:mod:`pde_tpu_torch.ops.cuda_stencil_op_2d`,
:mod:`pde_tpu_torch.ops.cuda_stencil_2d` and
:mod:`pde_tpu_torch.ops.cuda_stencil_3d`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..grids.cartesian import CartesianGrid
from ..utils.config import config
from .common import host_values_on, wrap_with_bcs


def _sl(*offsets: int) -> tuple[slice, ...]:
    """Valid-region slice of a padded array shifted by one offset per axis."""
    return tuple(slice(1 + o, (-1 + o) or None) for o in offsets)


def _axis_sl(num_axes: int, axis: int, offset: int) -> tuple[slice, ...]:
    """Valid-region slice shifted by `offset` along `axis` only."""
    return _sl(*(offset if ax == axis else 0 for ax in range(num_axes)))


def _set_corner_points_2d(grid: CartesianGrid) -> Callable:
    """Corner-ghost setter for the 9-point stencil (in place)."""
    periodic_x, periodic_y = grid.periodic

    def set_corners(full):
        if periodic_x:
            full[0, 0], full[-1, 0] = full[-2, 0], full[1, 0]
            full[0, -1], full[-1, -1] = full[-2, -1], full[1, -1]
        elif periodic_y:
            full[0, 0], full[-1, 0] = full[0, -2], full[-1, -2]
            full[0, -1], full[-1, -1] = full[0, 1], full[-1, 1]
        else:
            full[0, 0] = 0.5 * (full[0, 1] + full[1, 0])
            full[-1, 0] = 0.5 * (full[-1, 1] + full[-2, 0])
            full[0, -1] = 0.5 * (full[0, -2] + full[1, -1])
            full[-1, -1] = 0.5 * (full[-1, -2] + full[-2, -1])
        return full

    return set_corners


def _make_laplace_stencil(grid: CartesianGrid, corner_weight: float | None = None):
    """Stencil mapping a padded 1D, 2D or 3D array to the Laplacian of its
    valid part (the corner weight applies to 2D grids only)."""
    if grid.num_axes == 1:
        (sx,) = (grid.discretization**-2).tolist()

        def stencil_1d(full):
            return (full[_sl(-1)] - 2 * full[_sl(0)] + full[_sl(1)]) * sx

        return stencil_1d
    if grid.num_axes == 3:
        sx, sy, sz = (grid.discretization**-2).tolist()

        def stencil_3d(full):
            center = 2 * full[_sl(0, 0, 0)]
            lap_x = (full[_sl(-1, 0, 0)] - center + full[_sl(1, 0, 0)]) * sx
            lap_y = (full[_sl(0, -1, 0)] - center + full[_sl(0, 1, 0)]) * sy
            lap_z = (full[_sl(0, 0, -1)] - center + full[_sl(0, 0, 1)]) * sz
            return lap_x + lap_y + lap_z

        return stencil_3d
    sx, sy = (grid.discretization**-2).tolist()
    if corner_weight is None:
        corner_weight = config["operators.cartesian.laplacian_2d_corner_weight"]
    if corner_weight == 0:

        def stencil(full):
            center = full[_sl(0, 0)]
            lap_x = (full[_sl(-1, 0)] - 2 * center + full[_sl(1, 0)]) * sx
            lap_y = (full[_sl(0, -1)] - 2 * center + full[_sl(0, 1)]) * sy
            return lap_x + lap_y

        return stencil

    # 9-point stencil (w=1/2: Oono-Puri, w=1/3: Patra-Karttunen)
    w = float(corner_weight)
    dm2 = sx + sy
    weights = np.array(
        [
            [0.25 * dm2 * w, sx * (1 - w), 0.25 * dm2 * w],
            [sy * (1 - w), (sx + sy) * (w - 2), sy * (1 - w)],
            [0.25 * dm2 * w, sx * (1 - w), 0.25 * dm2 * w],
        ]
    ).tolist()
    set_corners = _set_corner_points_2d(grid)

    def stencil(full):
        full = set_corners(full)
        total = None
        for i in range(3):
            for j in range(3):
                term = weights[i][j] * full[_sl(i - 1, j - 1)]
                total = term if total is None else total + term
        return total

    return stencil


def _make_laplace_spectral(grid: CartesianGrid) -> Callable:
    """The Fourier-space Laplacian (the continuous spectrum ``-|k|²``) on a
    fully periodic grid, through ``torch.fft`` (``pde_tpu``'s
    ``_make_laplace_spectral``); the conditions are not read."""
    if not all(grid.periodic):
        raise ValueError("Spectral Laplacian requires a fully periodic grid")
    k2 = np.zeros(grid.shape)
    for ax in range(grid.num_axes):
        ks = 2 * np.pi * np.fft.fftfreq(grid.shape[ax], grid.discretization[ax])
        shape = [1] * grid.num_axes
        shape[ax] = grid.shape[ax]
        k2 = k2 + (ks**2).reshape(shape)
    factor = host_values_on(-k2)
    dims = tuple(range(-grid.num_axes, 0))

    def op(data, t=0.0, args=None):
        result = torch.fft.ifftn(factor(data.real) * torch.fft.fftn(data, dim=dims), dim=dims)
        return result if data.is_complex() else result.real.to(data.dtype)

    return op


@CartesianGrid.register_operator("laplace", rank_in=0, rank_out=0)
def make_laplace(grid: CartesianGrid, bcs, *, corner_weight=None, spectral: bool = False
                 ) -> Callable:
    """Laplacian with ghost-cell boundary conditions; with ``spectral=True``
    (fully periodic grids only) the exact Fourier-space Laplacian instead of
    the finite-difference stencil."""
    if spectral:
        return _make_laplace_spectral(grid)
    return wrap_with_bcs(grid, bcs, 0, _make_laplace_stencil(grid, corner_weight))


def _axis_diffs(grid: CartesianGrid, method: str = "central") -> list[Callable]:
    """Differences along each axis of a padded array, returning valid-shaped
    data: central, forward or backward (``pde_tpu``'s ``_make_axis_diff``)."""
    n = grid.num_axes
    if method == "central":
        hi, lo, scales = 1, -1, (0.5 / grid.discretization).tolist()
    elif method == "forward":
        hi, lo, scales = 1, 0, (1.0 / grid.discretization).tolist()
    elif method == "backward":
        hi, lo, scales = 0, -1, (1.0 / grid.discretization).tolist()
    else:
        raise ValueError(f"Unknown derivative method `{method}`")
    return [
        (lambda full, _hi=_axis_sl(n, ax, hi), _lo=_axis_sl(n, ax, lo), _s=s:
         (full[_hi] - full[_lo]) * _s)
        for ax, s in enumerate(scales)
    ]


@CartesianGrid.register_operator("gradient", rank_in=0, rank_out=1)
def make_gradient(grid: CartesianGrid, bcs, *, method: str = "central") -> Callable:
    """Gradient ``out[i] = d_i f`` with central, forward or backward
    differences, shape ``(num_axes, *grid.shape)``."""
    diffs = _axis_diffs(grid, method)

    def stencil(full):
        return torch.stack([d(full) for d in diffs])

    return wrap_with_bcs(grid, bcs, 0, stencil)


@CartesianGrid.register_operator("gradient_squared", rank_in=0, rank_out=0)
def make_gradient_squared(grid: CartesianGrid, bcs, *, central: bool = True) -> Callable:
    """Squared magnitude of the gradient: of central differences, or with
    ``central=False`` the mean of the squared forward and backward ones."""
    n = grid.num_axes
    scales = ((0.25 if central else 0.5) / grid.discretization**2).tolist()
    shifts = [(_axis_sl(n, ax, 1), _axis_sl(n, ax, -1)) for ax in range(n)]
    center = _sl(*([0] * n))

    def stencil(full):
        total = None
        for (hi, lo), s in zip(shifts, scales, strict=True):
            if central:
                term = (full[hi] - full[lo]) ** 2 * s
            else:
                c = full[center]
                term = ((full[hi] - c) ** 2 + (c - full[lo]) ** 2) * s
            total = term if total is None else total + term
        return total

    return wrap_with_bcs(grid, bcs, 0, stencil)


@CartesianGrid.register_operator("divergence", rank_in=1, rank_out=0)
def make_divergence(grid: CartesianGrid, bcs, *, method: str = "central") -> Callable:
    """Divergence of a ``(num_axes, *grid.shape)`` vector with central,
    forward or backward differences; the (rank-1) conditions apply to every
    component."""
    return wrap_with_bcs(grid, bcs, 1, _divergence_stencil(_axis_diffs(grid, method)))


def _divergence_stencil(diffs: list[Callable]) -> Callable:
    """``sum_j d_j full[j]`` of a padded array with a leading component axis."""

    def stencil(full):
        total = None
        for ax, diff in enumerate(diffs):
            term = diff(full[ax])
            total = term if total is None else total + term
        return total

    return stencil


def _vectorize(stencil: Callable, dim: int) -> Callable:
    """Apply a stencil to each of the `dim` leading components, stacked."""

    def vectorized(full):
        return torch.stack([stencil(full[i]) for i in range(dim)])

    return vectorized


@CartesianGrid.register_operator("vector_gradient", rank_in=1, rank_out=2)
def make_vector_gradient(grid: CartesianGrid, bcs, *, method: str = "central") -> Callable:
    """Vector gradient ``out[i, j] = d_j v_i`` with central, forward or
    backward differences, shape ``(dim, dim, *grid.shape)``; the (rank-1)
    conditions apply to every component."""
    diffs = _axis_diffs(grid, method)

    def grad_scalar(full):
        return torch.stack([d(full) for d in diffs])

    return wrap_with_bcs(grid, bcs, 1, _vectorize(grad_scalar, grid.dim))


@CartesianGrid.register_operator("vector_laplace", rank_in=1, rank_out=1)
def make_vector_laplace(grid: CartesianGrid, bcs, *, corner_weight=None) -> Callable:
    """Vector Laplacian ``out[i] = lap v_i``: the scalar Laplacian (with its
    corner-weight rule in 2D) on every component."""
    stencil = _make_laplace_stencil(grid, corner_weight)
    return wrap_with_bcs(grid, bcs, 1, _vectorize(stencil, grid.dim))


@CartesianGrid.register_operator("tensor_divergence", rank_in=2, rank_out=1)
def make_tensor_divergence(grid: CartesianGrid, bcs, *, method: str = "central") -> Callable:
    """Tensor divergence ``out[i] = sum_j d_j t_ij`` with central, forward
    or backward differences; the (rank-2) conditions apply to every
    component."""
    div_vector = _divergence_stencil(_axis_diffs(grid, method))
    return wrap_with_bcs(grid, bcs, 2, _vectorize(div_vector, grid.dim))
