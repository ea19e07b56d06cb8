"""Base class for fields: a ``torch.Tensor`` on a device paired with a grid.

Port of :mod:`pde_tpu.fields.base`. A field holds the *valid* data (no ghost
cells); operators add ghost layers themselves. Fields are rebuilt from the
JAX package's serialized attributes (:meth:`FieldBase.from_state`).
"""

from __future__ import annotations

import json
from typing import Any, Callable

import numpy as np
import torch

from ..grids.base import GridBase
from ..utils.config import default_device


class RankError(TypeError):
    """Error indicating that a field has the wrong rank."""


def _unserialize_scalar(value):
    """Decode one json-encoded attribute value (plain strings pass through)."""
    if isinstance(value, str):
        try:
            return json.loads(value)
        except ValueError:
            return value
    return value


def numpy_dtype_to_torch(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or of its name)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _data_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same values (``np.array_equal``): equal
    shapes, values compared in their common dtype, on the CPU if their
    devices differ."""
    if a.shape != b.shape:
        return False
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    common = torch.promote_types(a.dtype, b.dtype)
    return bool(torch.equal(a.to(common), b.to(common)))


class FieldBase:
    """Abstract base class for discretized fields."""

    _subclasses: dict[str, type[FieldBase]] = {}

    def __init__(self, grid: GridBase, data: torch.Tensor, *, label: str | None = None):
        self._grid = grid
        self._data = data
        self.label = label

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        FieldBase._subclasses[cls.__name__] = cls

    # -- basic accessors ---------------------------------------------------------------
    @property
    def grid(self) -> GridBase:
        return self._grid

    @property
    def data(self) -> torch.Tensor:
        """Discretized field values at the cell centers."""
        return self._data

    @property
    def label(self) -> str | None:
        return self._label

    @label.setter
    def label(self, value: str | None):
        if value is not None and not isinstance(value, str):
            raise TypeError("Label must be a string or None")
        self._label = value

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    # -- comparison ----------------------------------------------------------------------
    def __eq__(self, other) -> bool:
        """Whether `other` is a field of the same class on an equal grid with
        equal data, as in ``pde_tpu``. Data are compared by value, as numpy
        compares arrays there: data of different dtypes after promotion to a
        common dtype, data on different devices on the CPU, and NaN equals
        nothing. ``!=`` answers the opposite; the hash stays the identity."""
        if not isinstance(other, FieldBase):
            return NotImplemented
        return (
            self.__class__ is other.__class__
            and self.grid == other.grid
            and _data_equal(self._data, other._data)
        )

    def __hash__(self):
        return id(self)

    def __repr__(self) -> str:
        result = (
            f"{self.__class__.__name__}(grid={self.grid!r}, "
            f"data=Tensor{list(self._data.shape)}, device={self.device}"
        )
        if self.label:
            result += f', label="{self.label}"'
        return result + ")"

    # -- copies ---------------------------------------------------------------------------
    def copy(self, *, label: str | None = None, dtype=None, device=None) -> FieldBase:
        """Return a copy of the field, optionally cast and moved."""
        data = self._data.to(dtype=dtype or self.dtype, device=device or self.device, copy=True)
        return self.__class__(self.grid, data=data, label=label or self.label)

    def with_data(self, data: torch.Tensor) -> FieldBase:
        """A field of the same class, grid and label holding `data` (no copy)."""
        return self.__class__(self.grid, data=data, label=self.label)

    # -- serialization ---------------------------------------------------------------------
    @classmethod
    def from_state(
        cls, attributes: dict[str, Any], data=None, *, device=None, dtype=None
    ) -> FieldBase:
        """Recreate a field from serialized attributes and data.

        The grid may be given as its serialized state string, as a state
        dictionary naming its class, or as an object with a
        ``state_serialized`` attribute. Without `dtype`, the serialized
        dtype is used; without `device`, array data goes to the config key
        ``device`` and a tensor keeps its own. A class with its own
        ``from_state`` (a collection) rebuilds itself.
        """
        attributes = dict(attributes)
        field_cls = FieldBase._subclasses[_unserialize_scalar(attributes.pop("class"))]
        if field_cls is not cls and "from_state" in vars(field_cls):
            return field_cls.from_state(attributes, data, device=device, dtype=dtype)
        grid = attributes.pop("grid")
        if not isinstance(grid, (str, dict, GridBase)):
            grid = grid.state_serialized
        if not isinstance(grid, GridBase):
            grid = GridBase.from_state(grid)
        label = _unserialize_scalar(attributes.pop("label", "null"))
        stored = attributes.pop("dtype", None)
        if dtype is None and stored is not None:
            dtype = numpy_dtype_to_torch(_unserialize_scalar(stored))
        if data is None:
            data = "zeros"
        elif not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.array(data))
            device = default_device(device)
        return field_cls(grid, data=data, label=label, dtype=dtype, device=device)

    # -- arithmetic --------------------------------------------------------------------------
    def _binary_operation(self, other, op: Callable) -> FieldBase:
        if isinstance(other, FieldBase):
            self.grid.assert_grid_compatible(other.grid)
            other = other.data
        return self.__class__(self.grid, data=op(self._data, other))

    def __mul__(self, other):
        return self._binary_operation(other, torch.mul)

    __rmul__ = __mul__

    def __add__(self, other):
        return self._binary_operation(other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary_operation(other, torch.sub)

    def __rsub__(self, other):
        return self._binary_operation(other, lambda a, b: b - a)

    def __truediv__(self, other):
        return self._binary_operation(other, torch.div)

    def __pow__(self, exponent):
        return self._binary_operation(exponent, torch.pow)

    def __neg__(self):
        return self.__class__(self.grid, data=-self._data)
