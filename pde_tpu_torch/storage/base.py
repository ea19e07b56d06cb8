"""Base classes for storing simulation time series.

Port of :mod:`pde_tpu.storage.base`. A storage keeps each frame as a host
numpy array (as ``pde_tpu`` and py-pde do): writing a frame is one copy from
the state's device to the host. A frame read back becomes a field on the
config key ``device``'s device, as every field made from an array does.
"""

from __future__ import annotations

import inspect
from typing import Any, Iterator

import numpy as np
import torch

from ..fields.base import FieldBase, from_host, torch_dtype_to_numpy
from ..fields.collection import FieldCollection
from ..fields.datafield_base import DataFieldBase
from ..trackers.base import InfoDict, TrackerBase, TransformedTrackerBase
from ..utils.config import default_device


def field_shape_dtype(field: FieldBase) -> tuple[tuple[int, ...], np.dtype]:
    """Shape and numpy dtype of a field's (stacked) data, without copying it."""
    if isinstance(field, FieldCollection):
        planes = sum(field.grid.dim ** f.rank for f in field)
        return (planes,) + tuple(field.grid.shape), torch_dtype_to_numpy(field.dtype)
    return tuple(field.data.shape), torch_dtype_to_numpy(field.dtype)


def field_to_host(field: FieldBase) -> np.ndarray:
    """A field's (stacked) data as a new host numpy array: one copy from the
    field's device (each field of a collection straight into its planes)."""
    shape, dtype = field_shape_dtype(field)
    host = torch.from_numpy(np.empty(shape, dtype=dtype))
    if isinstance(field, FieldCollection):
        for block, f in zip(field.split_stacked(host), field, strict=True):
            block.copy_(f.data)
    else:
        host.copy_(field.data)
    return host.numpy()


class StorageBase:
    """Base class for storing time series of discretized fields."""

    times: Any
    data: Any

    def __init__(self, info: InfoDict | None = None, write_mode: str = "truncate_once"):
        self.info = dict(info or {})
        self.write_mode = write_mode
        self._data_shape: tuple[int, ...] | None = None
        self._dtype = None
        self._field: FieldBase | None = None
        self._grid = None

    @property
    def data_shape(self) -> tuple[int, ...]:
        if self._data_shape is None:
            raise RuntimeError("data_shape was not set")
        return self._data_shape

    @property
    def dtype(self):
        if self._dtype is None:
            raise RuntimeError("dtype was not set")
        return self._dtype

    @property
    def grid(self):
        if self._grid is None and self._field is not None:
            self._grid = self._field.grid
        return self._grid

    @property
    def has_collection(self) -> bool:
        if self._field is not None:
            return isinstance(self._field, FieldCollection)
        if len(self) > 0:
            return isinstance(self._get_field(0), FieldCollection)
        return False

    @property
    def shape(self) -> tuple[int, ...] | None:
        if self._data_shape is None:
            return None
        return (len(self),) + self._data_shape

    def _init_field_info(self, field: FieldBase) -> None:
        self._field = field.copy()
        self._grid = field.grid
        self._data_shape, self._dtype = field_shape_dtype(field)
        self.info.setdefault("field_attributes", field.attributes_serialized)

    def _restore_field_from_attrs(self, attributes: dict) -> None:
        """Rebuild the template field from serialized attributes."""
        self._field = FieldBase.from_state(attributes)
        self._grid = self._field.grid

    # -- writing -------------------------------------------------------------------------
    def start_writing(self, field: FieldBase, info: InfoDict | None = None) -> None:
        if info:
            self.info.update(info)
        if self._field is None:
            self._init_field_info(field)

    def append(self, field: FieldBase, time: float | None = None) -> None:
        raise NotImplementedError

    def end_writing(self) -> None:
        pass

    def clear(self, clear_data_shape: bool = False) -> None:
        if clear_data_shape:
            self._data_shape = None
            self._dtype = None

    def __len__(self) -> int:
        return len(self.times)

    # -- element access ------------------------------------------------------------------
    def _reconstruct_field(self, data) -> FieldBase:
        if self._field is None:
            attrs = self.info.get("field_attributes")
            if attrs:
                self._restore_field_from_attrs(attrs)
            else:
                raise RuntimeError("Storage does not contain field information")
        # a frame holds bfloat16 data as float32 (exactly): back to the field's dtype
        tensor = torch.as_tensor(from_host(np.array(data)), device=default_device()).to(
            self._field.dtype)
        if isinstance(self._field, FieldCollection):
            return self._field.with_data(self._field.split_stacked(tensor))
        return self._field.with_data(tensor)

    def _get_field(self, t_index: int) -> FieldBase:
        return self._reconstruct_field(self.data[t_index])

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            index = int(key)
            if index < 0:
                index += len(self)
            if not 0 <= index < len(self):
                raise IndexError("Index out of range")
            return self._get_field(index)
        if isinstance(key, slice):
            return [self._get_field(i) for i in range(*key.indices(len(self)))]
        raise TypeError(f"Unsupported index type {type(key)}")

    def __iter__(self) -> Iterator[FieldBase]:
        for i in range(len(self)):
            yield self._get_field(i)

    def items(self) -> Iterator[tuple[float, FieldBase]]:
        for i in range(len(self)):
            yield float(self.times[i]), self._get_field(i)

    # -- derived data --------------------------------------------------------------------
    def extract_field(self, field_id: int | str, label: str | None = None) -> StorageBase:
        """Extract one field of a stored FieldCollection as a new MemoryStorage."""
        from .memory import MemoryStorage

        if not self.has_collection:
            raise RuntimeError("Storage does not contain field collections")
        result = MemoryStorage()
        for t, collection in self.items():
            field = collection[field_id]
            if label:
                field = field.copy(label=label)
            result.append(field, t)
        return result

    def extract_time_range(self, t_range=None) -> StorageBase:
        """Extract a new MemoryStorage restricted to a time interval: all of it
        for None, up to a number, or within a pair."""
        from .memory import MemoryStorage

        if t_range is None:
            t_start, t_end = -np.inf, np.inf
        elif np.isscalar(t_range):
            t_start, t_end = -np.inf, float(t_range)
        else:
            t_start, t_end = t_range
        result = MemoryStorage()
        for t, field in self.items():
            if t_start <= t <= t_end:
                result.append(field, t)
        return result

    def apply(self, func, out: StorageBase | None = None, *, progress: bool = False
              ) -> StorageBase:
        """Apply ``func(field)`` or ``func(field, t)`` to every frame, storing
        the fields it returns in `out` (a new MemoryStorage by default)."""
        from .memory import MemoryStorage

        if out is None:
            out = MemoryStorage()
        two_args = _accepts_two_args(func)
        writing = False
        for t, field in self.items():
            transformed = func(field, t) if two_args else func(field)
            if isinstance(transformed, FieldBase):
                if not writing:
                    out.start_writing(transformed)
                    writing = True
                out.append(transformed, t)
        if writing:
            out.end_writing()
        return out

    def copy(self, out: StorageBase | None = None, *, progress: bool = False) -> StorageBase:
        return self.apply(lambda field: field, out=out, progress=progress)

    # -- tracker -------------------------------------------------------------------------
    def tracker(self, interrupts=1, *, transformation=None, interval=None) -> StorageTracker:
        """Create a tracker that stores the field at given interrupts."""
        return StorageTracker(
            storage=self,
            interrupts=interval if interval is not None else interrupts,
            transformation=transformation,
        )

    def view_field(self, field_id: int | str) -> StorageView:
        return StorageView(self, field=field_id)


def _accepts_two_args(func) -> bool:
    try:
        params = inspect.signature(func).parameters
    except (TypeError, ValueError):
        return False
    positional = [p for p in params.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 2


class StorageTracker(TransformedTrackerBase):
    """Tracker that appends the (transformed) state to a storage at each
    interrupt. As in ``pde_tpu``, the initial field is transformed at t = 0."""

    def __init__(self, storage: StorageBase, interrupts=1, *, transformation=None):
        super().__init__(interrupts=interrupts, transformation=transformation)
        self.storage = storage

    def initialize(self, field: FieldBase, info: InfoDict | None = None) -> float:
        result = super().initialize(field, info)
        self.storage.start_writing(self._transform(field, 0), info)
        return result

    def handle(self, field: FieldBase, t: float) -> None:
        self.storage.append(self._transform(field, t), time=t)

    def finalize(self, info: InfoDict | None = None) -> None:
        super().finalize(info)
        self.storage.end_writing()


class StorageView:
    """View into a storage exposing a single field of a collection."""

    def __init__(self, storage: StorageBase, *, field: int | str):
        self.storage = storage
        if not storage.has_collection:
            raise RuntimeError("Can only create views into collection storages")
        self.field_index = field

    @property
    def times(self):
        return self.storage.times

    @property
    def grid(self):
        return self.storage.grid

    def __len__(self) -> int:
        return len(self.storage)

    def __getitem__(self, index: int) -> DataFieldBase:
        return self.storage[index][self.field_index]

    def __iter__(self):
        for fields in self.storage:
            yield fields[self.field_index]

    def items(self):
        for t, fields in self.storage.items():
            yield t, fields[self.field_index]
