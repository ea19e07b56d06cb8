"""Scalar (rank-0) fields.

Port of :mod:`pde_tpu.fields.scalar`: numpy ufuncs on fields (as torch
functions on the field's device), fields from expressions of the
coordinates, the differential operators (Laplacian, gradient, squared
gradient), the scalar conversions, projections, slices and boundary fields,
and fields read from image files (``from_image``, through matplotlib).
"""

from __future__ import annotations

import numbers
from typing import Any

import numpy as np
import torch

from ..grids.base import GridBase
from ..grids.cartesian import CartesianGrid
from .datafield_base import DataFieldBase

#: numpy ufuncs whose torch function has another name (the others share theirs)
_UFUNC_ALIASES = {"power": "pow", "conjugate": "conj", "fabs": "abs", "absolute": "abs",
                  "rint": "round", "mod": "remainder", "invert": "bitwise_not"}


class ScalarField(DataFieldBase):
    """Scalar field discretized on a grid."""

    rank = 0

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """numpy ufuncs on fields (``np.sin(field)``, ``np.add(f, 2)``), as
        ``pde_tpu`` maps them, computed by the torch function of the same
        name on the field's device (never a copy to the host). A ufunc without
        a torch counterpart raises ``NotImplementedError``; ``out=`` fields
        take the result through their ``data`` setter."""
        if method != "__call__" or ufunc.nout != 1:
            return NotImplemented
        name = _UFUNC_ALIASES.get(ufunc.__name__, ufunc.__name__)
        func = getattr(torch, name, None)
        if not callable(func):
            raise NotImplementedError(
                f"The numpy ufunc `{ufunc.__name__}` has no torch counterpart for fields")
        args = []
        for arg in inputs:
            if isinstance(arg, numbers.Number):
                args.append(torch.as_tensor(arg, device=self.device))
            elif isinstance(arg, (np.ndarray, torch.Tensor)):
                if tuple(arg.shape) not in ((), tuple(self.data.shape)):
                    raise RuntimeError(
                        f"Data shapes incompatible ({arg.shape} != {self.data.shape})")
                args.append(torch.as_tensor(arg, device=self.device))
            elif isinstance(arg, self.__class__):
                self.assert_field_compatible(arg)
                args.append(arg.data)
            else:
                return NotImplemented
        out = kwargs.pop("out", None)
        if kwargs:  # unsupported ufunc keywords, such as `where`
            return NotImplemented
        data = func(*args)
        if out is not None:
            if len(out) != 1:
                return NotImplemented
            (out_field,) = out
            self.assert_field_compatible(out_field)
            out_field.data = data
            return out_field
        return self.__class__(self.grid, data=data)

    @classmethod
    def from_expression(
        cls, grid: GridBase, expression: str, *, user_funcs=None, consts=None,
        label: str | None = None, dtype: torch.dtype | None = None, device=None,
    ) -> ScalarField:
        """A field from an expression of the grid's coordinates, evaluated in
        numpy on the host and copied to `device` once. On curvilinear grids
        the Cartesian coordinates of each cell are ``cartesian[i]``."""
        from ..utils.expressions import ScalarExpression

        if "cartesian" in str(expression):
            consts = dict(consts or {})
            if "cartesian" not in consts:
                coords_cart = grid.point_to_cartesian(grid.cell_coords)
                consts["cartesian"] = np.moveaxis(coords_cart, -1, 0)
        expr = ScalarExpression(expression, signature=grid.axes, user_funcs=user_funcs,
                                consts=consts, allow_indexed=True)
        coords = [np.asarray(c) for c in grid.coordinate_arrays]
        values = np.array(np.broadcast_to(expr(*coords), grid.shape))
        return cls(grid, data=values, label=label, dtype=dtype, device=device)

    @classmethod
    def from_image(cls, path, bounds=None, periodic=False, *, label=None, device=None
                   ) -> ScalarField:
        """A scalar field from a grayscale image file (color images are
        averaged over their RGB channels), read by matplotlib on the host and
        copied to `device` once, in the image's dtype."""
        import matplotlib.pyplot as plt

        img = plt.imread(path)
        if img.ndim == 3:
            img = img[..., :3].mean(axis=-1)  # convert RGB(A) to luminance
        data = img.T[:, ::-1]  # convert to (x, y) index order
        if bounds is None:
            grid = CartesianGrid(
                [(0, data.shape[0]), (0, data.shape[1])], data.shape, periodic=periodic
            )
        else:
            grid = CartesianGrid(bounds, data.shape, periodic=periodic)
        return cls(grid, data=np.ascontiguousarray(data), label=label, device=device)

    def laplace(self, bc, out=None, **kwargs) -> ScalarField:
        """Apply the Laplace operator; returns a :class:`ScalarField`."""
        return self.apply_operator("laplace", bc=bc, out=out, **kwargs)

    def gradient(self, bc, out=None, **kwargs):
        """Apply the gradient operator; returns a :class:`VectorField`."""
        return self.apply_operator("gradient", bc=bc, out=out, **kwargs)

    def gradient_squared(self, bc, out=None, **kwargs) -> ScalarField:
        """Squared gradient magnitude; returns a :class:`ScalarField`."""
        return self.apply_operator("gradient_squared", bc=bc, out=out, **kwargs)

    def to_scalar(self, scalar="auto", *, label: str | None = None) -> ScalarField:
        """A scalar field derived from this one: ``auto`` (a copy, the modulus
        of complex data), ``abs``/``norm``, ``real``, ``imag``,
        ``norm_squared``/``squared_sum``, or a callable on the data."""
        data = self._data
        if scalar == "auto":
            data = data.abs() if self.is_complex else data.clone()
        elif scalar in ("abs", "norm"):
            data = data.abs()
        elif scalar == "real":
            data = torch.real(data).clone()
        elif scalar == "imag":
            data = torch.imag(data) if self.is_complex else torch.zeros_like(data)
        elif scalar in ("norm_squared", "squared_sum"):
            data = data.abs() ** 2
        elif callable(scalar):
            data = scalar(data)
        else:
            raise ValueError(f"Unknown scalar conversion `{scalar}`")
        return ScalarField(self.grid, data=data, label=label)

    # -- geometry -----------------------------------------------------------------------------
    def project(self, axes, method: str = "integral", *, label: str | None = None
                ) -> ScalarField:
        """The field integrated (``integral``), averaged (``average``,
        ``mean``) or maximized/minimized over `axes` of a Cartesian grid."""
        if isinstance(axes, (str, int)):
            axes = [axes]
        axes_idx = sorted(self.grid.get_axis_index(a) for a in axes)
        if not isinstance(self.grid, CartesianGrid):
            raise NotImplementedError("Projection requires a Cartesian grid")
        remaining = [a for a in range(self.grid.num_axes) if a not in axes_idx]
        if not remaining:
            raise ValueError("Cannot project out all axes")
        subgrid = self.grid.slice(remaining)
        if method == "max":
            data = self._data.amax(dim=tuple(axes_idx))
        elif method == "min":
            data = self._data.amin(dim=tuple(axes_idx))
        elif method in ("integral", "average", "mean"):
            data = self.grid.integrate(self._data, axes=axes_idx)
            if method != "integral":
                data = data / np.prod([self.grid.axes_bounds[a][1] - self.grid.axes_bounds[a][0]
                                       for a in axes_idx])
        else:
            raise ValueError(f"Unknown projection method `{method}`")
        return ScalarField(subgrid, data=data, label=label or self.label)

    def slice(self, position: dict[str, float], *, method: str = "nearest",
              label: str | None = None) -> ScalarField:
        """The field at the cells nearest to fixed positions of some axes of
        a Cartesian grid."""
        if not isinstance(self.grid, CartesianGrid):
            raise NotImplementedError("Slicing requires a Cartesian grid")
        if method != "nearest":
            raise ValueError(f"Unknown slicing method `{method}`")
        fixed = {self.grid.get_axis_index(k): v for k, v in position.items()}
        remaining = [a for a in range(self.grid.num_axes) if a not in fixed]
        if not remaining:
            raise ValueError("Cannot slice out all axes")
        idx: list[Any] = [slice(None)] * self.grid.num_axes
        for ax, pos in fixed.items():
            lo, hi = self.grid.axes_bounds[ax]
            if not lo <= pos <= hi:
                raise ValueError(f"Slice position {pos} outside axis bounds [{lo}, {hi}]")
            idx[ax] = int(np.argmin(np.abs(np.asarray(self.grid.axes_coords[ax]) - pos)))
        return ScalarField(self.grid.slice(remaining), data=self._data[tuple(idx)],
                           label=label or self.label)

    def get_boundary_field(self, index, bc=None, *, label: str | None = None) -> ScalarField:
        """The values on one side (``"left"``, ``"x+"``, ``(axis, upper)``)
        as a field on the side's grid (a one-cell grid in 1D)."""
        from ..grids.cartesian import UnitGrid

        axis, upper = self.grid._get_boundary_index(index)
        values = self.get_boundary_values(axis, upper, bc)
        if self.grid.num_axes == 1:
            return ScalarField(UnitGrid([1]), data=values.reshape(1), label=label)
        if isinstance(self.grid, CartesianGrid):
            remaining = [a for a in range(self.grid.num_axes) if a != axis]
            return ScalarField(self.grid.slice(remaining), data=values, label=label)
        raise NotImplementedError("Boundary fields require Cartesian grids")
