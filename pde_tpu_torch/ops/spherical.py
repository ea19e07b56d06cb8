"""Differential operators on spherically symmetric (3D) grids.

Port of :mod:`pde_tpu.ops.spherical`: plain PyTorch stencils over the one
radial axis, in the same order of operations. The config key
``operators.conservative_stencil`` (default True) picks the conservative
flux form, whose shell-volume weights conserve mass exactly, or the naive
finite differences. Vector components are ordered (r, θ, φ). Factors that
depend on r are computed on the host, as ``pde_tpu`` computes them
(:func:`~.common.radial_factor_on`).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..grids.spherical import SphericalSymGrid
from ..utils.config import config
from .common import radial_factor_on, wrap_with_bcs
from .polar import _HI, _LO, _MID, gradient_squared_stencil


def _shell_parts(rs, dr):
    """Inner and outer shell radii and the shell volumes (over 4π) of
    cell-centred radii (numpy)."""
    rl = rs - dr / 2
    rh = rs + dr / 2
    return rl, rh, (rh**3 - rl**3) / 3


def _shell_factor(grid, dr: float, term: Callable) -> Callable:
    """:func:`~.common.radial_factor_on` of ``term(rl, rh, volumes)``."""
    return radial_factor_on(grid, lambda rs: term(*_shell_parts(rs, dr)))


def _conservative(value) -> bool:
    return config["operators.conservative_stencil"] if value is None else value


def _one_sided(v, method: str, dr: float):
    """The derivative along r of a padded array (central, forward or backward)."""
    if method == "central":
        return (v[_HI] - v[_LO]) * (0.5 / dr)
    if method == "forward":
        return (v[_HI] - v[_MID]) / dr
    if method == "backward":
        return (v[_MID] - v[_LO]) / dr
    raise ValueError(f"Unknown derivative method `{method}`")


@SphericalSymGrid.register_operator("laplace", rank_in=0, rank_out=0)
def make_laplace(grid: SphericalSymGrid, bcs, *, conservative=None) -> Callable:
    """Spherical Laplacian; conservative (flux form) by default."""
    dr = grid.discretization[0]
    if _conservative(conservative):
        f_l = _shell_factor(grid, dr, lambda rl, rh, vol: rl**2 / (dr * vol))
        f_h = _shell_factor(grid, dr, lambda rl, rh, vol: rh**2 / (dr * vol))

        def stencil(full):
            term_h = f_h(full) * (full[_HI] - full[_MID])
            term_l = f_l(full) * (full[_MID] - full[_LO])
            return term_h - term_l

    else:
        dr2 = 1 / dr**2
        inv_rdr = radial_factor_on(grid, lambda rs: 1 / (rs * dr))

        def stencil(full):
            diff_2 = (full[_HI] - 2 * full[_MID] + full[_LO]) * dr2
            diff_1 = (full[_HI] - full[_LO]) * inv_rdr(full)
            return diff_2 + diff_1

    return wrap_with_bcs(grid, bcs, 0, stencil)


@SphericalSymGrid.register_operator("gradient", rank_in=0, rank_out=1)
def make_gradient(grid: SphericalSymGrid, bcs, *, method: str = "central") -> Callable:
    """Spherical gradient: (∂_r f, 0, 0)."""
    dr = grid.discretization[0]

    def stencil(full):
        grad_r = _one_sided(full, method, dr)
        zero = torch.zeros_like(grad_r)
        return torch.stack([grad_r, zero, zero])

    return wrap_with_bcs(grid, bcs, 0, stencil)


@SphericalSymGrid.register_operator("gradient_squared", rank_in=0, rank_out=0)
def make_gradient_squared(grid: SphericalSymGrid, bcs, *, central: bool = True) -> Callable:
    return wrap_with_bcs(grid, bcs, 0, gradient_squared_stencil(grid.discretization[0], central))


@SphericalSymGrid.register_operator("divergence", rank_in=1, rank_out=0)
def make_divergence(grid: SphericalSymGrid, bcs, *, safe=None, conservative=None,
                    method: str = "central") -> Callable:
    """Spherical divergence of the radial component: ∂_r v_r + 2 v_r / r
    (the θ and φ components cannot change an angularly symmetric scalar)."""
    dr = grid.discretization[0]
    if method not in ("central", "forward", "backward"):
        raise ValueError(f"Unknown derivative method `{method}`")
    if _conservative(conservative):
        f_l = _shell_factor(grid, dr, lambda rl, rh, vol: rl**2 / (2 * vol))
        f_h = _shell_factor(grid, dr, lambda rl, rh, vol: rh**2 / (2 * vol))

        def stencil(full):
            fl, fh = f_l(full), f_h(full)
            v_r = full[0]
            if method == "central":
                term_h = fh * (v_r[_MID] + v_r[_HI])
                term_l = fl * (v_r[_LO] + v_r[_MID])
            elif method == "forward":
                term_h = 2 * fh * v_r[_HI]
                term_l = 2 * fl * v_r[_MID]
            else:
                term_h = 2 * fh * v_r[_MID]
                term_l = 2 * fl * v_r[_LO]
            return term_h - term_l

    else:
        inv_r2 = radial_factor_on(grid, lambda rs: 2 / rs)

        def stencil(full):
            v_r = full[0]
            if method == "central":
                diff_r = (v_r[_HI] - v_r[_LO]) / (2 * dr)
            else:
                diff_r = _one_sided(v_r, method, dr)
            return diff_r + v_r[_MID] * inv_r2(full)

    return wrap_with_bcs(grid, bcs, 1, stencil)


@SphericalSymGrid.register_operator("vector_gradient", rank_in=1, rank_out=2)
def make_vector_gradient(grid: SphericalSymGrid, bcs, *, safe=None,
                         method: str = "central") -> Callable:
    """Spherical vector gradient (a 3x3 tensor; only rr, θθ and φφ are nonzero)."""
    dr = grid.discretization[0]
    inv_r = radial_factor_on(grid, lambda rs: 1 / rs)

    def stencil(full):
        v_r = full[0]
        out_rr = _one_sided(v_r, method, dr)
        diag = v_r[_MID] * inv_r(full)
        zero = torch.zeros_like(out_rr)
        return torch.stack([torch.stack([out_rr, zero, zero]), torch.stack([zero, diag, zero]),
                            torch.stack([zero, zero, diag])])

    return wrap_with_bcs(grid, bcs, 1, stencil)


@SphericalSymGrid.register_operator("tensor_divergence", rank_in=2, rank_out=1)
def make_tensor_divergence(grid: SphericalSymGrid, bcs, *, safe=None,
                           conservative=None) -> Callable:
    """Spherical tensor divergence."""
    dr = grid.discretization[0]
    if _conservative(conservative):
        f_l = _shell_factor(grid, dr, lambda rl, rh, vol: rl**2 / (2 * vol))
        f_h = _shell_factor(grid, dr, lambda rl, rh, vol: rh**2 / (2 * vol))
        f_area = _shell_factor(grid, dr, lambda rl, rh, vol: (rh**2 - rl**2) / vol)

        def stencil(full):
            t_rr, t_pp = full[0, 0], full[2, 2]
            term_h = f_h(full) * (t_rr[_MID] + t_rr[_HI])
            term_l = f_l(full) * (t_rr[_LO] + t_rr[_MID])
            out_r = term_h - term_l - f_area(full) * t_pp[_MID]
            zero = torch.zeros_like(out_r)
            return torch.stack([out_r, zero, zero])

    else:
        scale_r = 1 / (2 * dr)
        inv_r2 = radial_factor_on(grid, lambda rs: 2 / rs)
        inv_r = radial_factor_on(grid, lambda rs: 1 / rs)

        def stencil(full):
            f2, f1 = inv_r2(full), inv_r(full)
            t_rr, t_rp = full[0, 0], full[0, 2]
            t_tr = full[1, 0]
            t_pr, t_pp = full[2, 0], full[2, 2]
            out_r = (t_rr[_HI] - t_rr[_LO]) * scale_r + (t_rr[_MID] - t_pp[_MID]) * f2
            out_t = (t_tr[_HI] - t_tr[_LO]) * scale_r + t_tr[_MID] * f2
            out_p = (t_pr[_HI] - t_pr[_LO]) * scale_r + (2 * t_pr[_MID] + t_rp[_MID]) * f1
            return torch.stack([out_r, out_t, out_p])

    return wrap_with_bcs(grid, bcs, 2, stencil)


@SphericalSymGrid.register_operator("tensor_double_divergence", rank_in=2, rank_out=0)
def make_tensor_double_divergence(grid: SphericalSymGrid, bcs, *, safe=None,
                                  conservative=None) -> Callable:
    """Spherical tensor double divergence ∇·(∇·T)."""
    dr = grid.discretization[0]
    if _conservative(conservative):
        f_l = _shell_factor(grid, dr, lambda rl, rh, vol: rl / vol)
        f_h = _shell_factor(grid, dr, lambda rl, rh, vol: rh / vol)
        f2_l = _shell_factor(grid, dr, lambda rl, rh, vol: rl**2 / (dr * vol))
        f2_h = _shell_factor(grid, dr, lambda rl, rh, vol: rh**2 / (dr * vol))

        def stencil(full):
            fl, fh, f2l, f2h = f_l(full), f_h(full), f2_l(full), f2_h(full)
            t_rr, t_pp = full[0, 0], full[2, 2]
            rr_h = t_rr[_MID] + t_rr[_HI]
            rr_l = t_rr[_LO] + t_rr[_MID]
            rr_dr_h = t_rr[_HI] - t_rr[_MID]
            rr_dr_l = t_rr[_MID] - t_rr[_LO]
            div2_rr = (fh * rr_h + f2h * rr_dr_h) - (fl * rr_l + f2l * rr_dr_l)
            pp_h = t_pp[_MID] + t_pp[_HI]
            pp_l = t_pp[_LO] + t_pp[_MID]
            div2_pp = fh * pp_h - fl * pp_l
            return div2_rr - div2_pp

    else:
        dr2 = 1 / dr**2
        scale_r = 1 / (2 * dr)
        inv_rdr = radial_factor_on(grid, lambda rs: 1 / (rs * dr))
        inv_r = radial_factor_on(grid, lambda rs: 1 / rs)
        inv_r2 = radial_factor_on(grid, lambda rs: 2 / rs)

        def stencil(full):
            t_rr, t_pp = full[0, 0], full[2, 2]
            rr_dr = (t_rr[_HI] - t_rr[_LO]) * scale_r
            pp_dr = (t_pp[_HI] - t_pp[_LO]) * scale_r
            lap_rr = (t_rr[_HI] - t_rr[_LO]) * inv_rdr(full) + (
                t_rr[_HI] - 2 * t_rr[_MID] + t_rr[_LO]) * dr2
            enum = (t_rr[_MID] - t_pp[_MID]) * inv_r(full) + rr_dr - pp_dr
            return lap_rr + enum * inv_r2(full)

    return wrap_with_bcs(grid, bcs, 2, stencil)
