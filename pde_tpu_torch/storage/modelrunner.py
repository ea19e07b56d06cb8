"""Storage in a group of the optional ``py-modelrunner`` package.

Port of :mod:`pde_tpu.storage.modelrunner`: the class imports without the
package; its ``storage`` argument is a modelrunner storage group, used
through its ``read_attrs``, ``read_array`` and ``write_array`` methods.
"""

from __future__ import annotations

import numpy as np

from ..fields.base import FieldBase
from ..trackers.base import InfoDict
from .base import StorageBase, field_to_host


class ModelrunnerStorage(StorageBase):
    """Stores time series in a :mod:`modelrunner` storage group."""

    def __init__(self, storage, *, loc: str = "trajectory",
                 info: InfoDict | None = None, write_mode: str = "truncate_once"):
        super().__init__(info=info, write_mode=write_mode)
        self.storage = storage
        self.loc = loc

    @property
    def times(self):
        try:
            return list(self.storage.read_attrs(self.loc).get("times", []))
        except KeyError:
            return []

    @property
    def data(self):
        return self.storage.read_array(self.loc + "/data")

    def start_writing(self, field: FieldBase, info: InfoDict | None = None) -> None:
        super().start_writing(field, info)
        self._times: list[float] = []
        self._frames: list[np.ndarray] = []

    def append(self, field: FieldBase, time: float | None = None) -> None:
        self._frames.append(field_to_host(field))
        self._times.append(float(time) if time is not None else len(self._times))

    def end_writing(self) -> None:
        self.storage.write_array(
            self.loc + "/data", np.stack(self._frames), attrs={"times": self._times})
