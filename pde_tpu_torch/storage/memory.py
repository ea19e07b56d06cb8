"""In-memory storage of field time series.

Port of :mod:`pde_tpu.storage.memory`: :attr:`MemoryStorage.data` is a list
of host numpy arrays, one per frame, each made by one copy from the state's
device.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np

from ..fields.base import FieldBase
from ..trackers.base import InfoDict
from .base import StorageBase, field_to_host


class MemoryStorage(StorageBase):
    """Stores the simulation time series in memory (host numpy arrays)."""

    def __init__(
        self,
        times=None,
        data=None,
        field_obj: FieldBase | None = None,
        info: InfoDict | None = None,
        write_mode: str = "truncate_once",
    ):
        super().__init__(info=info, write_mode=write_mode)
        self.times: list[float] = list(times) if times is not None else []
        self.data: list[Any] = list(data) if data is not None else []
        if field_obj is not None:
            self._init_field_info(field_obj)
        if len(self.times) != len(self.data):
            raise ValueError("Length of times and data differ")

    @classmethod
    def from_fields(cls, times=None, fields=None, info=None) -> MemoryStorage:
        """Create a MemoryStorage from a sequence of fields (times 0, 1, ...
        when not given)."""
        fields = list(fields or [])
        if times is None:
            times = list(range(len(fields)))
        storage = cls(info=info)
        for t, field in zip(times, fields, strict=True):
            storage.append(field, t)
        return storage

    @classmethod
    def from_collection(cls, storages, label=None, *, rtol=1e-5, atol=1e-8) -> MemoryStorage:
        """Combine storages of fields at the same times into one storage of
        collections."""
        from ..fields.collection import FieldCollection

        if len(storages) == 0:
            return cls()
        times = storages[0].times
        for s in storages[1:]:
            if not np.allclose(s.times, times, rtol=rtol, atol=atol):
                raise ValueError("Storages have incompatible times")
        result = cls()
        for i, t in enumerate(times):
            fields = [s[i] for s in storages]
            result.append(FieldCollection(fields, label=label), float(t))
        return result

    def clear(self, clear_data_shape: bool = False) -> None:
        self.times = []
        self.data = []
        super().clear(clear_data_shape=clear_data_shape)

    def start_writing(self, field: FieldBase, info: InfoDict | None = None) -> None:
        if self.write_mode in ("truncate", "truncate_once"):
            self.clear()
            if self.write_mode == "truncate_once":
                self.write_mode = "append"
        elif self.write_mode == "readonly":
            raise RuntimeError("Cannot write to readonly storage")
        super().start_writing(field, info)

    def append(self, field: FieldBase, time: float | None = None) -> None:
        if self._field is None:
            self._init_field_info(field)
        self.data.append(field_to_host(field))
        if time is None:
            time = 0 if len(self.times) == 0 else self.times[-1] + 1
        self.times.append(float(time))


@contextlib.contextmanager
def get_memory_storage(field: FieldBase, info: InfoDict | None = None):
    """Context manager yielding an empty MemoryStorage initialized for `field`."""
    storage = MemoryStorage(field_obj=field, info=info)
    yield storage
