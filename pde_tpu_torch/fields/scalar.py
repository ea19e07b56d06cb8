"""Scalar (rank-0) fields.

Port of :mod:`pde_tpu.fields.scalar` restricted to the Laplacian and the
squared gradient.
"""

from __future__ import annotations

from .datafield_base import DataFieldBase


class ScalarField(DataFieldBase):
    """Scalar field discretized on a grid."""

    rank = 0

    def laplace(self, bc, out=None, **kwargs) -> ScalarField:
        """Apply the Laplace operator; returns a :class:`ScalarField`."""
        return self.apply_operator("laplace", bc=bc, out=out, **kwargs)

    def gradient_squared(self, bc, out=None, **kwargs) -> ScalarField:
        """Squared gradient magnitude; returns a :class:`ScalarField`."""
        return self.apply_operator("gradient_squared", bc=bc, out=out, **kwargs)
