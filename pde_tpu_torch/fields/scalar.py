"""Scalar (rank-0) fields.

Port of :mod:`pde_tpu.fields.scalar` restricted to the differential operators
(Laplacian, gradient, squared gradient) and the scalar conversions.
"""

from __future__ import annotations

import torch

from .datafield_base import DataFieldBase


class ScalarField(DataFieldBase):
    """Scalar field discretized on a grid."""

    rank = 0

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
