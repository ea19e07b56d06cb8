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


def make_full_padder(grid: GridBase, rank: int) -> Callable:
    """Return a function padding valid data (a tensor, or anything
    ``torch.as_tensor`` takes) with one layer of zero ghost cells along each
    of the grid's axes, its `rank` leading component axes untouched."""
    pads = [1, 1] * grid.num_axes  # torch.nn.functional.pad order: last axis first

    def pad(data):
        data = torch.as_tensor(data)
        if data.dim() != rank + grid.num_axes:
            raise ValueError(f"Expected data of rank {rank} on a {grid.num_axes}D grid, not "
                             f"shape {tuple(data.shape)}")
        return torch.nn.functional.pad(data, pads)

    return pad


def wrap_with_bcs(grid: GridBase, bcs, rank_in: int, stencil: Callable) -> Callable:
    """Compose padding + ghost-cell setting + a stencil into one operator.

    `stencil` maps a padded array (one ghost layer per axis) to a
    valid-shaped result. ``wrap_with_bcs.calls`` counts the operators'
    applications: each reads one cell beyond its operand, so the calls of one
    rhs evaluation bound the halo it needs (the plain decomposed stepper sizes
    its halo by them where the rhs has no stencil lowering). Without `bcs`
    (``None``, :meth:`~pde_tpu_torch.grids.base.GridBase.make_operator_no_bc`)
    the operator takes data that already holds its ghost cells.
    """
    if bcs is None:

        def op_no_bc(full, t=0.0, args=None):
            return stencil(full)

        return op_no_bc

    ghost_setter = bcs.make_ghost_setter()
    pads = [1, 1] * grid.num_axes  # torch.nn.functional.pad order: last axis first
    # a decomposed block's view across the wrap of a cut anti-periodic axis:
    # the stencil reads the far side's cells negated there, and its result
    # there is negated back (ShardedBoundaries.flip)
    flip = getattr(bcs, "flip", None)
    signs: dict = {}

    def op(data, t=0.0, args=None):
        if isinstance(args, dict) and "t" in args:
            t = args["t"]  # the time may come as `args={"t": t}`, as in pde_tpu
        wrap_with_bcs.calls += 1
        sign = None
        if flip is not None:
            key = (data.dtype, data.device)
            if key not in signs:
                signs[key] = torch.as_tensor(flip, dtype=data.dtype, device=data.device)
            sign = signs[key]
            data = data * sign
        full = torch.nn.functional.pad(data, pads)
        out = stencil(ghost_setter(full, t, args))
        return out if sign is None else out * sign

    return op


wrap_with_bcs.calls = 0


def _axis_slice(num_axes: int, axis: int, lo: int, hi: int) -> tuple[slice, ...]:
    """The valid region of a padded array, `axis` cut to ``lo:hi`` (hi 0: to the end)."""
    idx = [slice(1, -1)] * num_axes
    idx[axis] = slice(lo, hi if hi != 0 else None)
    return tuple(idx)


def make_derivative(grid: GridBase, axis: int = 0, method: str = "central", bcs=None
                    ) -> Callable:
    """A first derivative along one axis (``pde_tpu``'s ``make_derivative``):
    central, forward or backward differences of the grid's spacing along it,
    on every grid class."""
    if method not in {"central", "forward", "backward"}:
        raise ValueError(f"Unknown derivative method `{method}`")
    dx = float(grid.discretization[axis])
    n = grid.num_axes
    if method == "central":
        scale = 0.5 / dx
        hi_idx, lo_idx = _axis_slice(n, axis, 2, 0), _axis_slice(n, axis, 0, -2)
    elif method == "forward":
        scale = 1.0 / dx
        hi_idx, lo_idx = _axis_slice(n, axis, 2, 0), _axis_slice(n, axis, 1, -1)
    else:
        scale = 1.0 / dx
        hi_idx, lo_idx = _axis_slice(n, axis, 1, -1), _axis_slice(n, axis, 0, -2)

    def stencil(full):
        return (full[hi_idx] - full[lo_idx]) * scale

    return wrap_with_bcs(grid, bcs, 0, stencil)


def make_derivative2(grid: GridBase, axis: int = 0, bcs=None) -> Callable:
    """A second derivative along one axis (``pde_tpu``'s ``make_derivative2``)."""
    scale = float(grid.discretization[axis]) ** -2
    n = grid.num_axes
    hi_idx, mid_idx = _axis_slice(n, axis, 2, 0), _axis_slice(n, axis, 1, -1)
    lo_idx = _axis_slice(n, axis, 0, -2)

    def stencil(full):
        return (full[hi_idx] - 2 * full[mid_idx] + full[lo_idx]) * scale

    return wrap_with_bcs(grid, bcs, 0, stencil)


def host_values_on(values) -> Callable:
    """``on(like) -> tensor``: host `values` as a tensor of `like`'s dtype on
    its device, made once per dtype and device, so that every application
    multiplies by the same precomputed values."""
    cache: dict = {}

    def on(like: torch.Tensor) -> torch.Tensor:
        key = (like.dtype, like.device)
        tensor = cache.get(key)
        if tensor is None:
            tensor = cache[key] = torch.as_tensor(np.asarray(values), dtype=like.dtype,
                                                  device=like.device)
        return tensor

    return on


def radial_factor_on(grid: GridBase, compute: Callable, axis: int = 0) -> Callable:
    """``on(like) -> tensor``: the host factor :func:`~..grids.base.radial_factor`
    of `grid` as a tensor of `like`'s dtype on its device (:func:`host_values_on`)."""
    return host_values_on(radial_factor(grid, compute, axis))


# -- the discrete spectra and modal bases of the FD Laplacian (host numpy) -------------------
def laplace_eigenvalues_1d(n: int, dx: float, *, real_half: bool = False) -> np.ndarray:
    """Eigenvalues of the periodic 1D finite-difference Laplacian.

    ``-4 sin²(π k / n) / dx²`` over the fft (or, with ``real_half``, rfft)
    modes: the discrete spectrum shared by the FFT Poisson solver and the
    ETDRK exponential integrator, so both advance or solve exactly the
    semi-discretization of the stencil operators.
    """
    f_cyc = np.fft.rfftfreq(n, d=dx) if real_half else np.fft.fftfreq(n, d=dx)
    return -4.0 * np.sin(np.pi * f_cyc * dx) ** 2 / dx**2


def neumann_laplace_eigenvalues_1d(n: int, dx: float) -> np.ndarray:
    """Eigenvalues of the cell-centered FD Laplacian with homogeneous no-flux
    conditions (ghost = edge): ``-4 sin²(π k / (2n)) / dx²`` for the DCT-II
    modes ``cos(π k (i + ½) / n)``, k = 0..n-1."""
    k = np.arange(n)
    return -4.0 * np.sin(np.pi * k / (2 * n)) ** 2 / dx**2


def dirichlet_laplace_eigenvalues_1d(n: int, dx: float) -> np.ndarray:
    """Eigenvalues of the cell-centered FD Laplacian with homogeneous
    Dirichlet conditions (ghost = -edge): ``-4 sin²(π k / (2n)) / dx²`` for
    the DST-II modes ``sin(π k (i + ½) / n)``, k = 1..n."""
    k = np.arange(1, n + 1)
    return -4.0 * np.sin(np.pi * k / (2 * n)) ** 2 / dx**2


def dct2_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II analysis matrix ``M`` whose rows are the
    eigenvectors of the no-flux Laplacian: ``M @ x`` are the modal
    coefficients and ``M.T`` is the exact inverse. It is applied as a matrix
    product along its axis, which also serves axes whose conditions rule out
    plain FFTs."""
    i = np.arange(n)
    k = np.arange(n)[:, None]
    m = np.cos(np.pi * k * (i + 0.5) / n)
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return m


def dst2_matrix(n: int) -> np.ndarray:
    """Orthonormal DST-II analysis matrix (homogeneous-Dirichlet modes
    ``sin(π k (i + ½) / n)``, k = 1..n); its inverse is the transpose."""
    i = np.arange(n)
    k = np.arange(1, n + 1)[:, None]
    m = np.sin(np.pi * k * (i + 0.5) / n)
    m[:-1] *= np.sqrt(2.0 / n)
    m[-1] *= np.sqrt(1.0 / n)
    return m
