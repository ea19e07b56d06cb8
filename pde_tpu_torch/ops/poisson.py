"""Matrix-free elliptic (Poisson) solvers.

Port of :mod:`pde_tpu.ops.poisson`, plain torch on the data's device, as
``pde_tpu``'s is plain XLA: fully periodic Cartesian grids invert the
*discrete* 5/7-point Laplacian eigenvalues in Fourier space (exact,
``torch.fft``), every other case runs BiCGStab against the grid's own
``laplace`` operator, so the boundary conditions are those of every other
operator. The BiCGStab recurrence is the port's own copy of the one JAX's
``jax.scipy.sparse.linalg.bicgstab`` runs (the same stop test, early exit and
breakdown codes); its loop stays on the device, every update gated by
``torch.where``, and the host reads the stop flag once per
:data:`BICGSTAB_CHUNK` iterations.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..grids.base import GridBase
from ..grids.boundaries.local import DirichletBC, MixedBC
from ..grids.cartesian import CartesianGrid
from ..grids.cylindrical import CylindricalSymGrid
from ..grids.spherical import PolarSymGrid, SphericalSymGrid
from .common import host_values_on, laplace_eigenvalues_1d

#: BiCGStab iterations between two host reads of the stop flag; iterations
#: past the stop change nothing (every update is gated)
BICGSTAB_CHUNK = 16

#: ``k`` of a BiCGStab run that broke down: ``rho = 0``, or ``omega = 0`` or
#: ``alpha = 0`` (JAX's codes)
BREAKDOWN_RHO, BREAKDOWN_OMEGA_ALPHA = -10, -11


def _is_singular(bcs) -> bool:
    """Whether the Laplacian with these conditions has the constant nullspace."""
    for pair in bcs:
        for bc in (pair.low, pair.high):
            if isinstance(bc, (DirichletBC, MixedBC)):
                return False
    return True


def _make_fft_poisson_solver(grid: CartesianGrid) -> Callable:
    """Exact solver of the discrete periodic Poisson problem via FFT."""
    # eigenvalues of the 5/7-point Laplacian: -4 sin^2(pi k / N) / dx^2 per axis
    eig = np.zeros(grid.shape)
    for ax in range(grid.num_axes):
        n = grid.shape[ax]
        lam = laplace_eigenvalues_1d(n, float(grid.discretization[ax]))
        shape = [1] * grid.num_axes
        shape[ax] = n
        eig = eig + lam.reshape(shape)
    eig_safe = np.where(eig == 0, 1.0, eig)
    inv_eig = host_values_on(np.where(eig == 0, 0.0, 1.0 / eig_safe))

    def solve(rhs, t=0.0, args=None):
        rhs = torch.as_tensor(rhs)
        rhs_hat = torch.fft.fftn(rhs)
        u_hat = rhs_hat * inv_eig(rhs)  # zero mode pinned to zero mean
        return torch.real(torch.fft.ifftn(u_hat)).contiguous()

    return solve


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.vdot``: the sum of ``conj(a) * b``."""
    return torch.sum(a.conj() * b) if a.is_complex() else torch.sum(a * b)


def _vdot_real(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The real part of ``vdot(a, b)`` without the real-imaginary cross terms."""
    if a.is_complex() and b.is_complex():
        return torch.sum(a.real * b.real) + torch.sum(a.imag * b.imag)
    return torch.sum(a.real * b.real) if a.is_complex() or b.is_complex() else torch.sum(a * b)


def bicgstab(matvec: Callable, b: torch.Tensor, *, tol: float = 1e-5, atol: float = 0.0,
             maxiter: int):
    """Solve ``matvec(x) = b`` from ``x0 = 0`` by unpreconditioned BiCGStab.

    JAX's recurrence (``_bicgstab_solve``): stop once ``|r|² <= max(tol²
    |b|², atol²)``, after `maxiter` iterations, or at a breakdown (``k``
    becomes :data:`BREAKDOWN_RHO` or :data:`BREAKDOWN_OMEGA_ALPHA`); an
    iteration whose ``s`` already passes the test takes the half step. Each
    iteration is gated by the stop test of the state it starts from, so the
    result is the iterate at which JAX's ``while_loop`` stops. Returns ``(x,
    stats)``: ``stats`` holds the ``iterations`` run, the final ``k`` (``code``)
    and the ``host_reads`` of the stop flag.
    """
    device = b.device
    atol2 = torch.maximum(tol**2 * _vdot_real(b, b),
                          torch.tensor(atol**2, dtype=b.real.dtype, device=device))
    x = torch.zeros_like(b)
    r = b - matvec(x)
    rhat = r
    one = torch.ones((), dtype=b.dtype, device=device)
    alpha = omega = rho = one
    p = q = r
    k = torch.zeros((), dtype=torch.int64, device=device)
    iterations = torch.zeros((), dtype=torch.int64, device=device)

    def running(r, k):
        return (_vdot_real(r, r) > atol2) & (k < maxiter) & (k >= 0)

    def iterate(x, r, alpha, omega, rho, p, q, k):
        rho_ = _vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        q_ = matvec(p_)
        alpha_ = rho_ / _vdot(rhat, q_)
        s = r - alpha_ * q_
        exit_early = _vdot_real(s, s) < atol2
        t = matvec(s)
        omega_ = _vdot(t, s) / _vdot(t, t)
        x_ = torch.where(exit_early, x + alpha_ * p_, x + (alpha_ * p_ + omega_ * s))
        r_ = torch.where(exit_early, s, s - omega_ * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), BREAKDOWN_OMEGA_ALPHA, k + 1)
        k_ = torch.where(rho_ == 0, BREAKDOWN_RHO, k_)
        return x_, r_, alpha_, omega_, rho_, p_, q_, k_

    reads = 0
    while True:
        for _ in range(BICGSTAB_CHUNK):
            go = running(r, k)
            new = iterate(x, r, alpha, omega, rho, p, q, k)
            x, r, alpha, omega, rho, p, q, k = (
                torch.where(go, n, o) for n, o in zip(new, (x, r, alpha, omega, rho, p, q, k),
                                                      strict=True))
            iterations = iterations + go
        reads += 1
        if not bool(running(r, k)):
            break
    its, code = torch.stack([iterations, k]).tolist()  # one more read
    return x, {"iterations": its, "code": code, "host_reads": reads + 1}


def _make_iterative_poisson_solver(
    grid: GridBase, bcs, *, tol: float = 1e-10, maxiter: int | None = None
) -> Callable:
    """BiCGStab against the (affine) laplace operator of the conditions.

    The solver function's ``info`` holds the last solve's BiCGStab
    statistics (:func:`bicgstab`)."""
    lap = grid.make_operator("laplace", bc=bcs)
    singular = _is_singular(bcs)
    volumes = host_values_on(np.broadcast_to(grid.cell_volumes, grid.shape) / grid.volume)
    if maxiter is None:
        maxiter = 4 * int(np.prod(grid.shape))

    def solve(rhs, t=0.0, args=None):
        rhs = torch.as_tensor(rhs)
        # laplace with inhomogeneous conditions is affine: lap(u) = A u + b
        b = lap(torch.zeros_like(rhs), t, args)

        if singular:
            # regularize the constant nullspace: (A + <.>)(u) = rhs' with the
            # volume-weighted mean; a compatible rhs' has zero mean
            weights = volumes(rhs)

            def matvec(u):
                return lap(u, t, args) - b + torch.sum(u * weights)

            target = rhs - b
            target = target - torch.sum(target * weights)
        else:

            def matvec(u):
                return lap(u, t, args) - b

            target = rhs - b

        u, solve.info = bicgstab(matvec, target, tol=tol, maxiter=maxiter)
        return u

    solve.info = {}
    return solve


def _register_poisson(grid_cls):
    @grid_cls.register_operator("poisson_solver", rank_in=0, rank_out=0)
    def make_poisson_solver(grid, bcs=None, *, method: str = "auto", tol: float = 1e-10,
                            maxiter: int | None = None) -> Callable:
        """Solve lap(u) = rhs for u with the given boundary conditions."""
        if bcs is None:
            raise ValueError("Poisson solver requires boundary conditions")
        mesh = getattr(grid, "mesh", None)
        if mesh is not None and any(n > 1 for n in mesh.decomposition):
            # a per-block FFT/BiCGStab would solve on local data only; a
            # distributed elliptic solve needs global transforms/reductions
            raise NotImplementedError(
                "Poisson solves are not supported on decomposed grids"
            )
        if method == "auto":
            use_fft = isinstance(grid, CartesianGrid) and all(grid.periodic)
        else:
            use_fft = method == "fft"
        if use_fft:
            return _make_fft_poisson_solver(grid)
        return _make_iterative_poisson_solver(grid, bcs, tol=tol, maxiter=maxiter)

    return make_poisson_solver


for _cls in (CartesianGrid, PolarSymGrid, SphericalSymGrid, CylindricalSymGrid):
    _register_poisson(_cls)
