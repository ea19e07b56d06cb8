"""Carrying states over from the JAX package.

The "parameters" of a PDE run are the grid, the boundary conditions and the
field data. A ``pde_tpu`` field is fully described by its serialized
attributes (``field.attributes_serialized``: json-encoded class, label and
dtype, and the grid's serialized state) and its data array, which is what
its HDF5 and movie writers store. A ``FieldCollection`` is described by its
serialized attributes (which hold those of each field) and its stacked data.
:func:`field_from_state` rebuilds the same field or collection in this
package, on a chosen device and dtype, without importing JAX.
"""

from __future__ import annotations

import torch

from .fields.base import FieldBase


def field_from_state(
    attributes: dict, data, *, device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> FieldBase:
    """Rebuild a field or a collection from serialized attributes and array data.

    Args:
        attributes: the field's serialized attributes; the grid entry may
            also be a grid object exposing ``state_serialized``. For a
            collection, ``jax_collection.attributes_serialized``.
        data: array-like field data (e.g. ``np.asarray(jax_field.data)``); for
            a collection, the stacked data of its fields
            (``np.asarray(jax_collection.data)``).
        device: where the field's tensor lives; the config key ``device``
            (the card by default) when None.
        dtype: the tensor's dtype; the serialized dtype when None.
    """
    return FieldBase.from_state(attributes, data, device=device, dtype=dtype)
