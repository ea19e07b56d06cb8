"""Vector (rank-1) fields.

Port of :mod:`pde_tpu.fields.vectorial`: construction from scalar fields and
from expressions, dot and outer products (and the raw-data operators the
expression compiler uses), the divergence, vector gradient and vector
Laplacian, scalar conversions and component access, and vector plots (quiver
and streamlines). The data is a ``(dim, *grid.shape)`` tensor.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .base import FieldBase
from .datafield_base import DataFieldBase
from .scalar import ScalarField


def vector_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_i a_i b_i`` over the leading component axis."""
    return (a * b).sum(dim=0)


def vector_outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = a_i b_j``."""
    return torch.einsum("i...,j...->ij...", a, b)


class VectorField(DataFieldBase):
    """Vector field discretized on a grid."""

    rank = 1

    @classmethod
    def from_scalars(cls, fields, *, label: str | None = None, dtype=None) -> VectorField:
        """Combine ``grid.dim`` scalar fields into a vector field."""
        grid = fields[0].grid
        if len(fields) != grid.dim:
            raise ValueError(f"Need {grid.dim} scalar fields, got {len(fields)}")
        for f in fields:
            grid.assert_grid_compatible(f.grid)
        data = torch.stack([f.data for f in fields])
        return cls(grid, data=data, label=label, dtype=dtype)

    @classmethod
    def from_expression(
        cls, grid, expressions, *, user_funcs=None, consts=None, label: str | None = None,
        dtype: torch.dtype | None = None, device=None,
    ) -> VectorField:
        """A vector field from one expression of the coordinates per component."""
        if isinstance(expressions, str) or len(expressions) != grid.dim:
            raise ValueError(f"Need {grid.dim} expressions for a vector field")
        scalars = [ScalarField.from_expression(grid, expr, user_funcs=user_funcs, consts=consts,
                                               dtype=dtype, device=device)
                   for expr in expressions]
        return cls.from_scalars(scalars, label=label, dtype=dtype)

    # -- algebra ---------------------------------------------------------------------------
    def dot(self, other, out=None, *, conjugate: bool = True, label: str = "dot product"):
        """Dot product with a vector field (a :class:`ScalarField`) or a
        tensor field (a :class:`VectorField`, ``sum_i v_i t_ij``)."""
        from .tensorial import Tensor2Field

        self.grid.assert_grid_compatible(other.grid)
        this = self._data.conj() if conjugate and self.is_complex else self._data
        if isinstance(other, VectorField):
            result = ScalarField(self.grid, data=vector_dot(this, other.data), label=label)
        elif isinstance(other, Tensor2Field):
            data = torch.einsum("i...,ij...->j...", this, other.data)
            result = VectorField(self.grid, data=data, label=label)
        else:
            raise TypeError(f"Cannot calculate dot product with {other.__class__.__name__}")
        if out is not None:
            out._data = result.data
            return out
        return result

    __matmul__ = dot

    def outer_product(self, other: VectorField, out=None, *, label: str | None = None):
        """Outer product with another vector field: a :class:`Tensor2Field`."""
        from .tensorial import Tensor2Field

        if not isinstance(other, VectorField):
            raise TypeError(f"Cannot calculate outer product with {other.__class__.__name__}")
        self.grid.assert_grid_compatible(other.grid)
        result = Tensor2Field(self.grid, data=vector_outer(self._data, other.data), label=label)
        if out is not None:
            out._data = result.data
            return out
        return result

    def make_outer_prod_operator(self, backend: str = "torch") -> Callable:
        """``outer(a, b, out=None)`` on raw ``(dim, *shape)`` data (`backend`
        accepted for API compatibility, as in ``pde_tpu``)."""

        def outer(a, b, out=None):
            return vector_outer(a, b)

        return outer

    def make_dot_operator(self, backend: str = "torch", *, conjugate: bool = True) -> Callable:
        """``dot(a, b, out=None)`` on raw ``(dim, *shape)`` data (`backend`
        accepted for API compatibility, as in ``pde_tpu``)."""

        def dot(a, b, out=None):
            if conjugate and a.is_complex():
                a = a.conj()
            return vector_dot(a, b)

        return dot

    # -- differential operators ---------------------------------------------------------------
    def divergence(self, bc, out=None, **kwargs) -> ScalarField:
        """Apply the divergence operator; returns a :class:`ScalarField`."""
        return self.apply_operator("divergence", bc=bc, out=out, **kwargs)

    def gradient(self, bc, out=None, **kwargs):
        """Apply the vector gradient (``out[i, j] = d_j v_i``); returns a
        :class:`Tensor2Field`."""
        return self.apply_operator("vector_gradient", bc=bc, out=out, **kwargs)

    def laplace(self, bc, out=None, **kwargs) -> VectorField:
        """Apply the vector Laplacian; returns a :class:`VectorField`."""
        return self.apply_operator("vector_laplace", bc=bc, out=out, **kwargs)

    # -- conversions -----------------------------------------------------------------------------
    def to_scalar(self, scalar="auto", *, label: str | None = None) -> ScalarField:
        """Reduce to a scalar field: ``auto``/``norm``, ``max``, ``min``,
        ``squared_sum``, ``norm_squared``, a component index, or a callable
        on the data."""
        data = self._data
        if scalar in ("auto", "norm"):
            data = torch.linalg.vector_norm(data, dim=0)
        elif scalar == "max":
            data = torch.real(data).amax(dim=0)
        elif scalar == "min":
            data = torch.real(data).amin(dim=0)
        elif scalar == "squared_sum":
            data = (data**2).sum(dim=0)
        elif scalar == "norm_squared":
            data = (data.abs() ** 2).sum(dim=0)
        elif isinstance(scalar, int):
            data = data[scalar].clone()
        elif callable(scalar):
            data = scalar(data)
        else:
            raise ValueError(f"Unknown scalar conversion `{scalar}`")
        return ScalarField(self.grid, data=data, label=label)

    def _index(self, key):
        """An axis name as its index; an integer indexes the data directly, so
        ``-1`` is the last component."""
        return self.grid.get_axis_index(key) if isinstance(key, str) else key

    def __getitem__(self, key) -> ScalarField:
        """A component, by index or axis name, as a scalar field."""
        return ScalarField(self.grid, data=self._data[self._index(key)])

    def __setitem__(self, key, value):
        """Set a component, by index or axis name, from a field or data."""
        if isinstance(value, FieldBase):
            value = value.data
        data = self._data.clone()
        data[self._index(key)] = torch.as_tensor(value, device=data.device)
        self._data = data

    # -- plotting ---------------------------------------------------------------------------
    def get_vector_data(self, *, max_points=None, **kwargs) -> dict:
        """The components as host numpy images, subsampled to at most about
        `max_points` along each axis."""
        data = self.grid.get_vector_data(self.to_numpy(), **kwargs)
        if max_points is not None:
            nx, ny = data["data_x"].shape
            sx, sy = max(1, nx // max_points), max(1, ny // max_points)
            data["x"] = data["x"][::sy] if data["x"].ndim else data["x"]
            data["data_x"] = data["data_x"][::sx, ::sy]
            data["data_y"] = data["data_y"][::sx, ::sy]
        data["title"] = self.label
        return data

    def _plot_vector(self, ax, *, method: str = "quiver", **kwargs):
        data = self.get_vector_data()
        if method == "quiver":
            return ax.quiver(data["x"], data["y"], data["data_x"], data["data_y"], **kwargs)
        if method == "streamplot":
            return ax.streamplot(np.asarray(data["x"]), np.asarray(data["y"]),
                                 np.asarray(data["data_x"]), np.asarray(data["data_y"]),
                                 **kwargs)
        raise ValueError(f"Unknown vector plot method `{method}`")

    def plot(self, kind: str = "auto", *args, **kwargs):
        if kind == "auto":
            kind = "vector" if self.grid.num_axes == 2 else "image"
        return super().plot(kind, *args, **kwargs)
