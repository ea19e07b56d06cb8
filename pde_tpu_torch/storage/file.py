"""HDF5-backed storage of field time series.

Port of :mod:`pde_tpu.storage.file`, with its file layout (datasets ``data``
and ``times``, the field's serialized attributes and a json ``info`` as file
attributes), so files written by either package read in the other. h5py is
imported when a file is opened.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any

from ..fields.base import FieldBase
from ..trackers.base import InfoDict
from .base import StorageBase, field_shape_dtype, field_to_host


class FileStorage(StorageBase):
    """Stores the simulation time series in an HDF5 file with dynamic resizing.

    `write_mode` is ``"truncate_once"`` (the default), ``"truncate"``,
    ``"append"`` or ``"readonly"``; an existing file is opened for reading
    unless it is truncated.
    """

    def __init__(
        self,
        filename: str,
        info: InfoDict | None = None,
        *,
        write_mode: str = "truncate_once",
        max_length: int | None = None,
        compression: bool = True,
        keep_opened: bool = True,
    ):
        super().__init__(info=info, write_mode=write_mode)
        self.filename = str(filename)
        self.compression = compression
        self.keep_opened = keep_opened
        self.max_length = max_length
        self._file = None
        self._is_writing = False
        self._data_length = 0
        if os.path.exists(self.filename) and write_mode != "truncate":
            self._open("reading")
            self._restore_field_info()

    # -- file handling -------------------------------------------------------------------
    def _open(self, mode: str = "reading") -> None:
        import h5py

        if mode == "reading":
            if self._file is not None:
                return
            self._file = h5py.File(self.filename, "r")
        elif mode == "appending":
            if self._file is not None and self._file.mode == "r+":
                return
            self.close()
            self._file = h5py.File(self.filename, "a")
        elif mode == "writing":
            self.close()
            self._file = h5py.File(self.filename, "w")
        else:
            raise ValueError(f"Unknown file mode `{mode}`")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _restore_field_info(self) -> None:
        if self._file is None or "times" not in self._file:
            return
        self._data_length = len(self._file["times"])
        attrs = {k: self._file.attrs[k] for k in self._file.attrs if k != "info"}
        if "class" in attrs:
            try:
                self._restore_field_from_attrs(attrs)
                self._data_shape = tuple(self._file["data"].shape[1:])
                self._dtype = self._file["data"].dtype
            except Exception:
                logging.getLogger(__name__).warning(
                    "Could not reconstruct field from attributes %s", sorted(attrs))
        if "info" in self._file.attrs:
            try:
                self.info.update(json.loads(self._file.attrs["info"]))
            except (TypeError, ValueError):
                pass

    # -- data access ---------------------------------------------------------------------
    @property
    def times(self):
        import numpy as np

        self._open("reading")
        if self._file is None or "times" not in self._file:
            return np.empty(0)
        return np.asarray(self._file["times"][: self._data_length])

    @property
    def data(self):
        import numpy as np

        self._open("reading")
        if self._file is None or "data" not in self._file:
            return np.empty(0)
        return self._file["data"]

    def __len__(self) -> int:
        return self._data_length

    def clear(self, clear_data_shape: bool = False) -> None:
        self._data_length = 0
        if self._file is not None and "times" in self._file:
            self._open("appending")
            self._file["times"].resize((0,))
            self._file["data"].resize((0,) + self.data_shape)
        super().clear(clear_data_shape=clear_data_shape)

    # -- writing -------------------------------------------------------------------------
    def start_writing(self, field: FieldBase, info: InfoDict | None = None) -> None:
        if self.write_mode == "readonly":
            raise RuntimeError("Cannot write to readonly storage")
        if self.write_mode in ("truncate", "truncate_once"):
            self._open("writing")
            self._data_length = 0
            if self.write_mode == "truncate_once":
                self.write_mode = "append"
        else:
            self._open("appending")
        super().start_writing(field, info)

        if "data" not in self._file:
            shape, dtype = field_shape_dtype(field)
            # max_length=None keeps the dataset arbitrarily resizable
            kwargs: dict[str, Any] = {"compression": "gzip"} if self.compression else {}
            self._file.create_dataset("data", shape=(0,) + shape,
                                      maxshape=(self.max_length,) + shape, dtype=dtype,
                                      chunks=(1,) + shape, **kwargs)
            self._file.create_dataset("times", shape=(0,), maxshape=(self.max_length,),
                                      dtype=float)
            for k, v in field.attributes_serialized.items():
                self._file.attrs[k] = v
        self._is_writing = True

    def append(self, field: FieldBase, time: float | None = None) -> None:
        if not self._is_writing:
            self.start_writing(field)
        if self._field is None:
            self._init_field_info(field)
        data = field_to_host(field)
        n = self._data_length
        self._file["data"].resize((n + 1,) + data.shape)
        self._file["data"][n] = data
        self._file["times"].resize((n + 1,))
        self._file["times"][n] = time if time is not None else n
        self._data_length = n + 1

    def end_writing(self) -> None:
        if not self._is_writing:
            return
        self._file.attrs["info"] = json.dumps(
            {k: v for k, v in self.info.items() if _json_safe(v)})
        self._file.flush()
        self._is_writing = False
        if not self.keep_opened:
            self.close()


def _json_safe(value) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
