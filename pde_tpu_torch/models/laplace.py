"""Solvers for Poisson's and Laplace's equations.

Port of :mod:`pde_tpu.models.laplace`: the grid's ``poisson_solver``
operator (:mod:`pde_tpu_torch.ops.poisson`) on the field's device, its
solution checked against the rhs through the grid's ``laplace``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.scalar import ScalarField
from ..fields.vectorial import VectorField
from ..grids.base import GridBase


def solve_poisson_equation(
    rhs: ScalarField,
    bc,
    *,
    backend: str = "auto",
    label: str = "Solution to Poisson's equation",
    **kwargs,
) -> ScalarField:
    r"""Solve :math:`\nabla^2 u = f` for `u` given `f` and boundary conditions.

    For purely periodic or Neumann boundary conditions the integral of `f` must
    vanish (up to the boundary fluxes) for a solution to exist.
    """
    solver = rhs.grid.make_operator("poisson_solver", bc=bc, **kwargs)
    data = solver(rhs.data)
    # verify the solution (iterative solves of incompatible problems, e.g. a
    # non-neutral rhs with pure Neumann conditions, return spurious results)
    lap = rhs.grid.make_operator("laplace", bc=bc)
    residual, scale, finite = torch.stack([
        (lap(data) - rhs.data).abs().max(), rhs.data.abs().max(),
        torch.isfinite(data).all().to(rhs.data.real.dtype)]).tolist()
    scale = max(scale, 1.0)
    if not finite or residual > 1e-5 * scale:
        magnitude = abs(float(rhs.average))
        if magnitude > 1e-10:
            raise RuntimeError(
                "Could not solve the Poisson problem. One possible reason is that "
                "only periodic or Neumann conditions are applied although the "
                f"magnitude of the field is {magnitude} and thus non-zero."
            )
        raise RuntimeError("Could not solve the Poisson problem")
    return ScalarField(rhs.grid, data=data, label=label)


def solve_laplace_equation(
    grid: GridBase, bc, *, backend: str = "auto",
    label: str = "Solution to Laplace's equation",
) -> ScalarField:
    """Solve Laplace's equation on `grid` subject to the boundary conditions
    (a field of the default dtype on the config key ``device``)."""
    rhs = ScalarField(grid, data=0)
    return solve_poisson_equation(rhs, bc=bc, label=label)


def helmholtz_decomposition(field: VectorField, bc):
    r"""Decompose `field` into a gradient part and a divergence-free part.

    Returns (potential, solenoidal) with field = grad(potential) + solenoidal.

    On fully periodic Cartesian grids the projection is computed in Fourier
    space with the *discrete* central-difference symbols
    ``i sin(k dx) / dx``, so the solenoidal part is divergence-free under the
    same discrete divergence operator that produced the source (composing the
    compact-stencil Poisson solve with ``gradient`` would leave an O(1)
    residual because ``div(grad(·))`` is the wide 2h-stencil Laplacian).
    """
    from ..grids.cartesian import CartesianGrid

    grid = field.grid
    if isinstance(grid, CartesianGrid) and all(grid.periodic):
        data = field.data
        shape = grid.shape
        dx = np.asarray(grid.discretization)
        complex_dtype = (data.real.dtype if data.is_complex() else data.dtype).to_complex()
        # discrete spectral symbol of the central first derivative per axis
        ik = []
        for ax, (n, d) in enumerate(zip(shape, dx)):
            k = 2 * np.pi * np.fft.fftfreq(n, d=d)
            sym = 1j * np.sin(k * d) / d
            if n % 2 == 0:
                sym[n // 2] = 0.0  # sin(pi) evaluates to ~1e-16, not 0
            sh = [1] * len(shape)
            sh[ax] = n
            ik.append(torch.as_tensor(sym.reshape(sh), dtype=complex_dtype, device=data.device))
        spatial = tuple(range(1, data.ndim))
        f_hat = torch.fft.fftn(data, dim=spatial)
        div_hat = sum(ik[ax] * f_hat[ax] for ax in range(len(shape)))
        denom = sum(ik[ax] * ik[ax] for ax in range(len(shape)))
        singular = denom == 0
        phi_hat = torch.where(singular, 0.0, div_hat / torch.where(singular, 1.0, denom))
        grad_hat = torch.stack([ik[ax] * phi_hat for ax in range(len(shape))])
        phi = torch.real(torch.fft.ifftn(phi_hat)).contiguous()
        grad_phi = torch.real(torch.fft.ifftn(grad_hat, dim=spatial))
        potential = ScalarField(grid, data=phi, label="potential")
        solenoidal = VectorField(grid, data=data - grad_phi, label="solenoidal")
        return potential, solenoidal

    bcs = field.grid.get_boundary_conditions(bc)
    source = field.divergence(bcs)
    potential = solve_poisson_equation(source, bcs)
    solenoidal = field - potential.gradient(bcs)
    return potential, solenoidal
