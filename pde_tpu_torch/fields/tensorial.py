"""Rank-2 tensor fields.

Port of :mod:`pde_tpu.fields.tensorial`: fields from
expressions, dot products, transposition, symmetrisation, the trace,
the tensor divergence, the double divergence (registered for spherical
grids only, as in ``pde_tpu``), scalar conversions, component access and
plots of the components.
The data is a ``(dim, dim, *grid.shape)`` tensor, ``dim`` the dimension of
the space the grid lies in (3 on the two axes of a cylindrical grid).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .base import FieldBase
from .datafield_base import DataFieldBase
from .scalar import ScalarField
from .vectorial import VectorField


def _dot_tensor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` per cell, with `b` a tensor (``ik``) or a vector (``i``)."""
    if b.dim() == a.dim():
        return torch.einsum("ij...,jk...->ik...", a, b)
    return torch.einsum("ij...,j...->i...", a, b)


def _trace(a: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ii...->...", a)


class Tensor2Field(DataFieldBase):
    """Rank-2 tensor field discretized on a grid."""

    rank = 2

    @classmethod
    def from_expression(
        cls, grid, expressions, *, user_funcs=None, consts=None, label: str | None = None,
        dtype: torch.dtype | None = None, device=None,
    ) -> Tensor2Field:
        """A tensor field from a ``dim x dim`` nested list of expressions."""
        dim = grid.dim
        if len(expressions) != dim or any(len(row) != dim for row in expressions):
            raise ValueError(f"Need a {dim}x{dim} matrix of expressions")
        rows = [torch.stack([
            ScalarField.from_expression(grid, e, user_funcs=user_funcs, consts=consts,
                                        dtype=dtype, device=device).data for e in row])
            for row in expressions]
        return cls(grid, data=torch.stack(rows), label=label)

    # -- algebra -------------------------------------------------------------------------------
    def dot(self, other, out=None, *, conjugate: bool = True, label: str = "dot product"):
        """Dot product with a vector field (a :class:`VectorField`,
        ``sum_j t_ij v_j``) or a tensor field (a :class:`Tensor2Field`)."""
        self.grid.assert_grid_compatible(other.grid)
        if not isinstance(other, (VectorField, Tensor2Field)):
            raise TypeError(f"Cannot calculate dot product with {other.__class__.__name__}")
        this = self._data.conj() if conjugate and self.is_complex else self._data
        result = other.__class__(self.grid, data=_dot_tensor(this, other.data), label=label)
        if out is not None:
            out._data = result.data
            return out
        return result

    __matmul__ = dot

    def make_dot_operator(self, backend: str = "torch", *, conjugate: bool = True) -> Callable:
        """``dot(a, b, out=None)`` on raw data: `a` a tensor, `b` a tensor or
        a vector (`backend` accepted for API compatibility, as in ``pde_tpu``)."""

        def dot(a, b, out=None):
            if conjugate and a.is_complex():
                a = a.conj()
            return _dot_tensor(a, b)

        return dot

    # -- tensor structure ---------------------------------------------------------------------
    @property
    def transpose(self) -> Tensor2Field:
        """The transposed field (kept for parity; use :meth:`transposed`)."""
        return self.transposed()

    def transposed(self, *, label: str | None = None) -> Tensor2Field:
        data = self._data.transpose(0, 1).contiguous()
        return Tensor2Field(self.grid, data=data, label=label or self.label)

    def symmetrize(self, make_traceless: bool = False, inplace: bool = False) -> Tensor2Field:
        """The symmetric part ``(t + t^T) / 2``, optionally made traceless."""
        data = 0.5 * (self._data + self._data.transpose(0, 1))
        if make_traceless:
            dim = self.grid.dim
            eye = torch.eye(dim, dtype=data.dtype, device=data.device)
            eye = eye.reshape((dim, dim) + (1,) * self.grid.num_axes)
            data = data - eye * (_trace(data) / dim)
        if inplace:
            self._data = data
            return self
        return Tensor2Field(self.grid, data=data, label=self.label)

    def trace(self, label: str | None = None) -> ScalarField:
        """The trace ``sum_i t_ii`` as a scalar field."""
        return ScalarField(self.grid, data=_trace(self._data), label=label)

    # -- differential operators ------------------------------------------------------------------
    def divergence(self, bc, out=None, **kwargs) -> VectorField:
        """Apply the tensor divergence (``out[i] = sum_j d_j t_ij``); returns a
        :class:`VectorField`."""
        return self.apply_operator("tensor_divergence", bc=bc, out=out, **kwargs)

    def double_divergence(self, bc, out=None, **kwargs) -> ScalarField:
        """Apply the tensor double divergence; returns a :class:`ScalarField`."""
        return self.apply_operator("tensor_double_divergence", bc=bc, out=out, **kwargs)

    # -- conversions ------------------------------------------------------------------------
    def to_scalar(self, scalar="auto", *, label: str | None = None) -> ScalarField:
        """Reduce to a scalar field: ``auto``/``norm`` (Frobenius), ``min``,
        ``max``, ``squared_sum``, ``norm_squared``, ``trace``/``invariant1``,
        ``invariant2``, ``determinant``/``invariant3``, or a callable."""
        data = self._data
        if scalar in ("auto", "norm"):
            data = torch.linalg.vector_norm(data.abs(), dim=(0, 1))
        elif scalar == "min":
            data = torch.real(data).amin(dim=(0, 1))
        elif scalar == "max":
            data = torch.real(data).amax(dim=(0, 1))
        elif scalar == "squared_sum":
            data = (data**2).sum(dim=(0, 1))
        elif scalar == "norm_squared":
            data = (data.abs() ** 2).sum(dim=(0, 1))
        elif scalar in ("trace", "invariant1"):
            data = _trace(data)
        elif scalar == "invariant2":
            squares = torch.einsum("ij...,ji...->...", data, data)
            data = 0.5 * (_trace(data) ** 2 - squares)
        elif scalar in ("determinant", "invariant3"):
            data = torch.linalg.det(torch.movedim(data, (0, 1), (-2, -1)))
        elif callable(scalar):
            data = scalar(data)
        else:
            raise ValueError(f"Unknown scalar conversion `{scalar}`")
        return ScalarField(self.grid, data=data, label=label)

    def _index(self, key) -> tuple[int, int]:
        """Axis names as indices; integers index the data directly, so ``-1``
        is the last component."""
        return tuple(self.grid.get_axis_index(i) if isinstance(i, str) else i for i in key)

    def __getitem__(self, key) -> ScalarField:
        """Component ``(i, j)``, by indices or axis names, as a scalar field."""
        return ScalarField(self.grid, data=self._data[self._index(key)])

    def __setitem__(self, key, value):
        """Set component ``(i, j)`` from a field or data."""
        if isinstance(value, FieldBase):
            value = value.data
        data = self._data.clone()
        data[self._index(key)] = torch.as_tensor(value, device=data.device)
        self._data = data

    # -- plotting ---------------------------------------------------------------------------
    def plot_components(self, kind: str = "auto", *args, **kwargs):
        """Plot all tensor components in a grid of panels."""
        import matplotlib.pyplot as plt

        dim = self.grid.dim
        fig, axes = plt.subplots(dim, dim, figsize=(4 * dim, 4 * dim))
        refs = []
        for i in range(dim):
            for j in range(dim):
                comp = self[i, j]
                comp.label = f"{self.label or 'tensor'}[{i},{j}]"
                refs.append(comp.plot(kind, *args, ax=np.atleast_2d(axes)[i][j], **kwargs))
        return refs
