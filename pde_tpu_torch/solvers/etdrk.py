"""Exponential time differencing RK4 (ETDRK4) for stiff semilinear PDEs.

Port of :mod:`pde_tpu.solvers.etdrk`, plain torch on the state's device, as
``pde_tpu``'s is plain XLA. For ``u_t = L u + N(u)`` with a stiff linear part
that is diagonal in a separable modal basis (laplace chains on Cartesian
grids: diffusion, Cahn-Hilliard, Kuramoto-Sivashinsky, Swift-Hohenberg,
coupled reaction-diffusion systems), the linear part is integrated exactly
through ``exp(h L)`` and only the nonlinearity takes a fourth-order
Runge-Kutta scheme (Cox & Matthews 2002): dt is limited by accuracy on the
nonlinearity alone, not by the stability of the stiff operator.

The modal basis is per axis: rfft modes on periodic axes (``torch.fft``),
DCT-II modes on homogeneous-Neumann axes and DST-II modes on
homogeneous-Dirichlet axes, applied as orthonormal matrix products along
the axis (``torch.matmul``; the inverse is the transpose). TF32 must stay
off for them (``torch.backends.cuda.matmul.allow_tf32``, False by default):
it would cost an fp32 matrix axis about three digits. Coupled N-field systems
diagonalize each mode's ``(N, N)`` coupling matrix on the host (numpy's
batched eigendecomposition, as ``pde_tpu``) and evaluate the phi functions on
its eigenvalues.

The phi coefficients are the Kassam & Trefethen (2005) contour quadrature
(:data:`PHI_POINTS` points), evaluated in torch in float64 on the state's
device (the host formula costs tens of seconds of numpy per stepper at
4096²), and only then cast to the state's dtype.

Decomposed runs (``decomposition=``) keep the state whole on its device:
every transform runs on the global leaves, the coefficients stay global, and
the nonlinear remainder evaluates over the mesh's blocks on their
halo-extended views (:class:`~pde_tpu_torch.parallel.stepper.BlockedRun`),
so a decomposed run equals the serial run bit for bit on every axis kind.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..fields.base import FieldBase
from ..models.base import state_leaves
from .base import SolverBase

#: points of the contour quadrature of the phi functions
PHI_POINTS = 64


def _phi_scalars(mu: torch.Tensor):
    """ETDRK4 phi values on (possibly complex) ``mu = dt * eigenvalue``.

    Contour quadrature on a unit circle around each value (Kassam &
    Trefethen 2005, eq. 2.5); the closed forms lose all precision for
    ``|mu|`` near 0. Returns the RAW phi quadratures (call sites scale by
    ``dt``), complex for complex input; ``E``/``E2`` are exact exponentials.
    The points, formulas and order of the sums are ``pde_tpu``'s host ones.
    """
    complex_in = mu.is_complex()
    E = torch.exp(mu)
    E2 = torch.exp(mu / 2)
    cdtype = torch.complex128
    Q = torch.zeros(mu.shape, dtype=cdtype, device=mu.device)
    f1, f2, f3 = (torch.zeros_like(Q) for _ in range(3))
    # real input: points on the upper half circle and the real part are
    # equivalent to (and half the cost of) the full circle
    for m in range(PHI_POINTS):
        if complex_in:
            r = complex(np.exp(2j * np.pi * (m + 0.5) / PHI_POINTS))
        else:
            r = complex(np.exp(1j * np.pi * (m + 0.5) / PHI_POINTS))
        z = mu + r
        ez = torch.exp(z)
        Q += (torch.exp(z / 2) - 1) / z
        z2 = z * z
        z3 = z * z2
        f1 += (-4 - z + ez * (4 - 3 * z + z2)) / z3
        f2 += (2 + z + ez * (-2 + z)) / z3
        f3 += (-4 - 3 * z - z2 + ez * (4 - z)) / z3
    scale = 1.0 / PHI_POINTS
    out = (Q * scale, f1 * scale, f2 * scale, f3 * scale)
    if not complex_in:
        out = tuple(o.real for o in out)
    return (E, E2, *out)


def _phi_coefficients(L: np.ndarray, dt: float, device):
    """Scalar-field coefficient tensors: real float64 on `device`, scaled by dt."""
    mu = dt * torch.as_tensor(np.asarray(L, dtype=np.float64), device=device)
    E, E2, Q, f1, f2, f3 = _phi_scalars(mu)
    return E, E2, dt * Q, dt * f1, dt * f2, dt * f3


def _phi_coefficient_matrices(L: np.ndarray, dt: float, device):
    """Coupled-system coefficients: per-mode matrix functions of ``dt L``.

    ``L`` has shape ``(*modes, N, N)`` (real). Diagonalizes every mode with
    numpy's batched eigendecomposition on the host and assembles ``V f(dt
    µ) V⁻¹`` on `device`; raises NotImplementedError for (numerically)
    defective coupling matrices, where the eigenvector basis cannot
    represent the matrix functions.
    """
    shape = L.shape
    N = shape[-1]
    M = (dt * np.asarray(L, dtype=np.float64)).reshape(-1, N, N)
    mu, V = np.linalg.eig(M)
    cond = np.linalg.cond(V)
    if not np.all(np.isfinite(cond)) or np.max(cond) > 1e8:
        raise NotImplementedError(
            "ETDRK4: the linear coupling matrix is (near-)defective; its "
            "matrix exponential cannot be computed by diagonalization"
        )
    Vinv = torch.as_tensor(np.linalg.inv(V), dtype=torch.complex128, device=device)
    V = torch.as_tensor(V, dtype=torch.complex128, device=device)
    mu = torch.as_tensor(mu, dtype=torch.complex128, device=device)
    E_e, E2_e, Q_e, f1_e, f2_e, f3_e = _phi_scalars(mu)

    def assemble(diag_vals, scale=1.0):
        mats = torch.einsum("kij,kj,kjl->kil", V, scale * diag_vals, Vinv)
        return mats.real.reshape(shape)

    return (
        assemble(E_e),
        assemble(E2_e),
        assemble(Q_e, dt),
        assemble(f1_e, dt),
        assemble(f2_e, dt),
        assemble(f3_e, dt),
    )


def _make_transforms(grid, axis_kinds, real_dtype, device):
    """``(forward, inverse)`` of the per-axis modal bases on the global data.

    Periodic axes take one ``rfftn`` (the real half on the LAST periodic
    axis, matching the eigenvalue layout of ``make_etdrk_parts``);
    Neumann/Dirichlet axes take the orthonormal DCT-II/DST-II matrices as
    matrix products along the axis (inverse = transpose).
    """
    from ..ops.common import dct2_matrix, dst2_matrix

    periodic_axes = [ax for ax, kind in enumerate(axis_kinds) if kind == "periodic"]
    matrix_axes = [(ax, kind) for ax, kind in enumerate(axis_kinds) if kind != "periodic"]
    fft_sizes = [grid.shape[ax] for ax in periodic_axes]
    mats = {}
    for ax, kind in matrix_axes:
        n = grid.shape[ax]
        m = dct2_matrix(n) if kind == "neumann" else dst2_matrix(n)
        mats[ax] = torch.as_tensor(m, dtype=real_dtype, device=device)

    def apply_matrix(m, u, ax):  # u is real: matrix axes go before the rfft, after the irfft
        return torch.movedim(torch.movedim(u, ax, -1) @ m.T, -1, ax)

    def forward(u):
        for ax, _ in matrix_axes:
            u = apply_matrix(mats[ax], u, ax)
        if periodic_axes:
            u = torch.fft.rfftn(u, dim=periodic_axes)
        return u

    def inverse(v):
        if periodic_axes:
            v = torch.fft.irfftn(v, s=fft_sizes, dim=periodic_axes)
        for ax, _ in matrix_axes:
            v = apply_matrix(mats[ax].T, v, ax)
        return v

    return forward, inverse


class ETDRK4Solver(SolverBase):
    """Exponential time differencing RK4 for stiff semilinear PDEs.

    Requires a PDE exposing ``make_etdrk_parts`` (the expression
    :class:`~pde_tpu_torch.models.pde.PDE` and the predefined scalar models
    do) with scalar fields, a single field or a coupled FieldCollection, on
    a CartesianGrid whose axes are periodic or carry homogeneous
    Neumann/Dirichlet conditions. Deterministic and fixed-dt. ``info`` holds
    the split's host seconds (``etdrk_split_seconds``) and the coefficients'
    (``etdrk_coefficient_seconds``, device work included).
    """

    name = "etdrk4"
    dt_default = 1e-2

    def __init__(self, pde, *, backend: str = "auto", decomposition=None):
        super().__init__(pde, backend=backend, decomposition=decomposition)
        if self.info["stochastic"]:
            raise RuntimeError("ETDRK4 is deterministic; use an SDE solver")
        self._sharded_mesh = None

    def _make_fixed_stepper_sharded(self, state: FieldBase, dt: float, mesh) -> Callable:
        """Decomposed ETDRK4: the serial step on the global leaves, whose
        nonlinear remainder evaluates over the mesh's blocks (see
        :meth:`_make_single_step_fixed_dt`)."""
        self._sharded_mesh = mesh
        try:
            return self._make_fixed_stepper_eager(state, dt)
        finally:
            self._sharded_mesh = None

    def _make_single_step_fixed_dt(self, state: FieldBase, dt: float) -> Callable:
        if not hasattr(self.pde, "make_etdrk_parts"):
            raise NotImplementedError(
                f"{self.pde.__class__.__name__} does not expose the spectral "
                "linear/nonlinear split required by ETDRK4 "
                "(make_etdrk_parts); use an expression PDE"
            )
        grid = state.grid
        device = state.device
        start = time.perf_counter()
        parts = self.pde.make_etdrk_parts(state)
        self.info["etdrk_split_seconds"] = time.perf_counter() - start
        L_vals = parts.L_vals if hasattr(parts, "L_vals") else parts[0]
        nonlinear_rhs = parts.nonlinear_rhs if hasattr(parts, "nonlinear_rhs") else parts[1]
        axis_kinds = getattr(parts, "axis_kinds", None)
        n_fields = getattr(parts, "n_fields", 1)
        if axis_kinds is None:
            axis_kinds = ("periodic",) * grid.num_axes
        leaves0 = state_leaves(state)
        if len(leaves0) != n_fields:
            raise NotImplementedError(
                "ETDRK4 state does not match the PDE's field count"
            )
        # coefficients are real; they take the state's dtype, so that fp32
        # states stay fp32/complex64 throughout
        real_dtype = leaves0[0].dtype
        if any(x.is_complex() for x in leaves0):
            raise NotImplementedError(
                "ETDRK4 operates on real fields; complex states "
                "are not supported"
            )
        if self._sharded_mesh is not None:
            from ..parallel.stepper import BlockedRun

            blocks = BlockedRun(self._sharded_mesh, parts.nonlinear_pde, state)
            self.info["sharded_halo"] = blocks.halo
            self.info["etdrk_sharding"] = "global transforms, blocked remainder"

            def nonlinear_rhs(leaves, t):
                return blocks.combine_leaves(blocks.rhs(blocks.split_leaves(leaves), t))

        forward, inverse = _make_transforms(grid, axis_kinds, real_dtype, device)
        start = time.perf_counter()
        if n_fields == 1:
            coeffs = _phi_coefficients(L_vals, dt, device)
        else:
            coeffs = _phi_coefficient_matrices(L_vals, dt, device)
        E, E2, Q, f1, f2, f3 = (c.to(real_dtype) for c in coeffs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.info["etdrk_coefficient_seconds"] = time.perf_counter() - start
        self.info["solver_scheme"] = "etdrk4 (Cox-Matthews / Kassam-Trefethen)"
        self.info["etdrk_axis_kinds"] = tuple(axis_kinds)

        if n_fields == 1:

            def N_hat(u, t):
                (rate,) = nonlinear_rhs([u], t)
                return forward(rate)

            def single_step(leaves, t, generator=None):
                (u,) = leaves
                v = forward(u)
                Nv = N_hat(u, t)
                a = E2 * v + Q * Nv
                Na = N_hat(inverse(a), t + dt / 2)
                b = E2 * v + Q * Na
                Nb = N_hat(inverse(b), t + dt / 2)
                c = E2 * a + Q * (2 * Nb - Nv)
                Nc = N_hat(inverse(c), t + dt)
                v = E * v + f1 * Nv + 2 * f2 * (Na + Nb) + f3 * Nc
                return [inverse(v)]

            return single_step

        # coupled system: the spectral state is (*modes, N); coefficients apply
        # as per-mode (N, N) matrix-vector products, summed over j in order
        def mat(C, v):
            rows = []
            for i in range(n_fields):
                row = C[..., i, 0] * v[..., 0]
                for j in range(1, n_fields):
                    row = row + C[..., i, j] * v[..., j]
                rows.append(row)
            return torch.stack(rows, dim=-1)

        def fwd_stack(leaves):
            return torch.stack([forward(x) for x in leaves], dim=-1)

        def inv_unstack(v):
            return [inverse(v[..., i]) for i in range(n_fields)]

        def N_hat_multi(leaves, t):
            rates = nonlinear_rhs(leaves, t)
            return torch.stack([forward(r) for r in rates], dim=-1)

        def single_step_multi(leaves, t, generator=None):
            v = fwd_stack(leaves)
            Nv = N_hat_multi(leaves, t)
            a = mat(E2, v) + mat(Q, Nv)
            Na = N_hat_multi(inv_unstack(a), t + dt / 2)
            b = mat(E2, v) + mat(Q, Na)
            Nb = N_hat_multi(inv_unstack(b), t + dt / 2)
            c = mat(E2, a) + mat(Q, 2 * Nb - Nv)
            Nc = N_hat_multi(inv_unstack(c), t + dt)
            v = mat(E, v) + mat(f1, Nv) + 2 * mat(f2, Na + Nb) + mat(f3, Nc)
            return inv_unstack(v)

        return single_step_multi
