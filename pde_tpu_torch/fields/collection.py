"""Collections of fields: coupled multi-field states.

Port of :mod:`pde_tpu.fields.collection`: construction (also from scalar
expressions and dicts), access and assignment, copies, arithmetic (in-place
operators keep the collection and its fields, each field taking a new
tensor), integrals, expressions and functions applied, smoothing,
interpolation, serialization and the HDF5 file form. The collection holds
one field per component; :attr:`FieldCollection.data` stacks their tensors.
A plot draws one panel a field, each from one host copy of its data.
"""

from __future__ import annotations

import json
from typing import Any, Iterator

import numpy as np
import torch

from ..grids.base import GridBase
from .base import FieldBase, _unserialize_scalar, to_host
from .datafield_base import DataFieldBase
from .scalar import ScalarField


class FieldCollection(FieldBase):
    """Collection of fields defined on the same grid."""

    def __init__(self, fields, *, copy_fields: bool = False, label: str | None = None,
                 labels=None, dtype=None):
        if isinstance(fields, FieldCollection):
            fields = fields.fields
        if isinstance(fields, dict):
            labels = list(fields.keys()) if labels is None else labels
            fields = list(fields.values())
        fields = list(fields)
        if len(fields) == 0:
            raise ValueError("At least one field must be defined")
        grid = fields[0].grid
        for f in fields:
            if not isinstance(f, DataFieldBase):
                raise RuntimeError("Field collections only support DataFieldBase instances")
            if f.grid != grid:
                raise RuntimeError("Fields are not defined on the same grid")
        if copy_fields or dtype is not None:
            fields = [f.copy(dtype=dtype) for f in fields]
        self._fields = tuple(fields)
        self._grid = grid
        self._label = label
        if labels is not None:
            self.labels = labels

    # -- container protocol -------------------------------------------------------------
    @property
    def fields(self) -> tuple[DataFieldBase, ...]:
        return self._fields

    def __len__(self) -> int:
        return len(self._fields)

    def __eq__(self, other) -> bool:
        """Whether `other` is a collection of as many fields, each equal to
        this one's (:meth:`FieldBase.__eq__`), as in ``pde_tpu``."""
        if not isinstance(other, FieldCollection):
            return NotImplemented
        return len(self) == len(other) and all(
            a == b for a, b in zip(self._fields, other._fields, strict=True)
        )

    def __hash__(self):
        return id(self)

    def __iter__(self) -> Iterator[DataFieldBase]:
        return iter(self._fields)

    def __getitem__(self, index) -> DataFieldBase:
        if isinstance(index, str):
            for f in self._fields:
                if f.label == index:
                    return f
            raise KeyError(f"No field with label `{index}`")
        return self._fields[index]

    def __setitem__(self, index, value):
        """Replace a field (by index or label): by `value` if it is a field,
        else by a field of the same class, grid and label holding a copy of
        `value` broadcast to its shape, on its device in its dtype."""
        fields = list(self._fields)
        if isinstance(index, str):
            for i, f in enumerate(fields):
                if f.label == index:
                    index = i
                    break
            else:
                raise KeyError(f"No field with label `{index}`")
        if isinstance(value, DataFieldBase):
            fields[index] = value
        else:
            new = fields[index].copy()
            new.data = value
            fields[index] = new
        self._fields = tuple(fields)

    def append(self, *fields, label: str | None = None) -> FieldCollection:
        """A new collection of copies of these fields and the given fields
        (or collections)."""
        new_fields = list(self._fields)
        for field in fields:
            if isinstance(field, FieldCollection):
                new_fields.extend(field.fields)
            else:
                new_fields.append(field)
        return FieldCollection(new_fields, copy_fields=True,
                               label=self.label if label is None else label)

    @property
    def labels(self) -> list[str | None]:
        return [f.label for f in self._fields]

    @labels.setter
    def labels(self, values):
        if len(values) != len(self._fields):
            raise ValueError("Number of labels must equal number of fields")
        for f, label in zip(self._fields, values, strict=True):
            f.label = label

    # -- data views ---------------------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """All field components stacked into one tensor (a copy)."""
        blocks = [f.data.reshape((-1,) + tuple(self.grid.shape)) for f in self._fields]
        return torch.cat(blocks, dim=0)

    @data.setter
    def data(self, value):
        """Set every field from stacked data (:attr:`data`'s layout), each
        taking a copy on its device in its dtype."""
        value = torch.as_tensor(value, device=self.device)
        for field, block in zip(self._fields, self.split_stacked(value), strict=True):
            field.data = block

    @property
    def dtype(self) -> torch.dtype:
        dtype = self._fields[0].dtype
        for f in self._fields[1:]:
            dtype = torch.promote_types(dtype, f.dtype)
        return dtype

    @property
    def device(self) -> torch.device:
        return self._fields[0].device

    # -- constructors -------------------------------------------------------------------
    @classmethod
    def from_scalar_expressions(
        cls, grid: GridBase, expressions, *, user_funcs=None, consts=None,
        label: str | None = None, labels=None, dtype: torch.dtype | None = None, device=None,
    ) -> FieldCollection:
        """A collection of scalar fields, one per expression of the coordinates."""
        if isinstance(expressions, str):
            expressions = [expressions]
        fields = [ScalarField.from_expression(grid, expr, user_funcs=user_funcs, consts=consts,
                                              dtype=dtype, device=device)
                  for expr in expressions]
        return cls(fields, label=label, labels=labels)

    @classmethod
    def from_dict(cls, fields: dict[str, DataFieldBase], *, label=None, dtype=None
                  ) -> FieldCollection:
        """A collection of the dict's fields, labelled by its keys."""
        return cls(list(fields.values()), labels=list(fields.keys()), label=label, dtype=dtype)

    @classmethod
    def scalar_random_uniform(
        cls, num_fields: int, grid: GridBase, vmin: float = 0, vmax: float = 1, *,
        label: str | None = None, labels=None, dtype: torch.dtype | None = None,
        device=None, rng: np.random.Generator | None = None,
    ) -> FieldCollection:
        """A collection of uniformly random scalar fields, drawn from one
        ``numpy.random.Generator`` in order."""
        rng = np.random.default_rng(rng)
        fields = [
            ScalarField.random_uniform(grid, vmin, vmax, dtype=dtype, device=device, rng=rng)
            for _ in range(num_fields)
        ]
        return cls(fields, label=label, labels=labels)

    def split_stacked(self, data) -> list:
        """The blocks of each field in stacked data (:attr:`data`'s layout:
        a rank-r field takes dim**r consecutive planes), shaped as its data."""
        blocks, offset = [], 0
        for f in self._fields:
            n = self.grid.dim ** f.rank
            blocks.append(data[offset : offset + n].reshape(f.data.shape))
            offset += n
        return blocks

    # -- serialization ------------------------------------------------------------------
    @property
    def attributes(self) -> dict[str, Any]:
        return {
            "class": self.__class__.__name__,
            "fields": [f.attributes for f in self._fields],
            "label": self.label,
        }

    @property
    def attributes_serialized(self) -> dict[str, str]:
        return {
            "class": json.dumps(self.__class__.__name__),
            "fields": json.dumps([f.attributes_serialized for f in self._fields]),
            "label": json.dumps(self.label),
        }

    @classmethod
    def unserialize_attributes(cls, attributes: dict[str, str]) -> dict[str, Any]:
        result: dict[str, Any] = {}
        for key, value in attributes.items():
            if key == "fields":
                result[key] = [
                    FieldBase._subclasses[_unserialize_scalar(a["class"])]
                    .unserialize_attributes(a)
                    for a in json.loads(value)
                ]
            elif key == "label":
                result[key] = json.loads(value)
            else:
                result[key] = value
        return result

    @classmethod
    def from_state(cls, attributes: dict[str, Any], data=None, *, device=None, dtype=None):
        """Recreate a collection from its attributes (those of
        :attr:`attributes_serialized`, or plain) and the stacked data of its
        fields."""
        attributes = dict(attributes)
        attributes.pop("class", None)
        field_attrs = attributes.pop("fields")
        if isinstance(field_attrs, str):
            field_attrs = json.loads(field_attrs)
        label = _unserialize_scalar(attributes.pop("label", "null"))
        stacked = None if data is None else np.asarray(data)
        fields = []
        offset = 0
        for attrs in field_attrs:
            field_cls = FieldBase._subclasses[_unserialize_scalar(attrs["class"])]
            grid = attrs["grid"]
            if isinstance(grid, (str, dict)):
                grid = GridBase.from_state(grid)
            # a rank-r field occupies dim**r consecutive planes of the stacked data
            tensor_shape = (grid.dim,) * field_cls.rank
            n = int(np.prod(tensor_shape, dtype=int))
            block = None
            if stacked is not None:
                block = stacked[offset : offset + n].reshape(tensor_shape + stacked.shape[1:])
            fields.append(FieldBase.from_state(attrs, block, device=device, dtype=dtype))
            offset += n
        return cls(fields, label=label)

    def _write_hdf_dataset(self, hdf_path, **kwargs) -> None:
        for i, f in enumerate(self._fields):
            f._write_hdf_dataset(hdf_path, key=f"field_{i}")
        hdf_path.attrs["class"] = self.__class__.__name__
        hdf_path.attrs["label"] = json.dumps(self.label)
        hdf_path.attrs["count"] = len(self._fields)

    def copy(self, *, label: str | None = None, dtype=None, device=None) -> FieldCollection:
        result = FieldCollection(
            [f.copy(dtype=dtype, device=device) for f in self._fields],
            label=label or self.label,
        )
        if hasattr(self, "mesh") and result.device == self.device:
            result.mesh = self.mesh
        return result

    def with_data(self, datas) -> FieldCollection:
        """A collection like this one holding one tensor per field (no copy)."""
        datas = list(datas)
        if len(datas) != len(self._fields):
            raise ValueError(f"Expected {len(self._fields)} tensors, got {len(datas)}")
        fields = [f.with_data(d) for f, d in zip(self._fields, datas, strict=True)]
        return FieldCollection(fields, label=self.label)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({', '.join(repr(f) for f in self._fields)})"

    # -- arithmetic ---------------------------------------------------------------------
    def _binary_operation(self, other, op) -> FieldCollection:
        if isinstance(other, FieldCollection):
            if len(self) != len(other):
                raise ValueError("Collections have different number of fields")
            fields = [a._binary_operation(b, op) for a, b in zip(self, other, strict=True)]
        else:
            fields = [f._binary_operation(other, op) for f in self._fields]
        for f, old in zip(fields, self._fields, strict=True):
            f.label = old.label
        return FieldCollection(fields, label=self.label)

    def _unary_operation(self, op) -> FieldCollection:
        return FieldCollection([f._unary_operation(op) for f in self._fields], label=self.label)

    def _inplace(self, other, op) -> FieldCollection:
        """In place: each field of the collection takes its new tensor (unlike
        ``pde_tpu``, whose collections raise there)."""
        result = op(self, other)
        if result is NotImplemented:
            return NotImplemented
        for field, new in zip(self._fields, result, strict=True):
            field._data = new.data
        return self

    def apply(self, func, out=None, *, label: str | None = None, evaluate_args=None):
        """An expression string evaluated over the labelled fields (one
        field), or a function of the stacked data (a collection)."""
        if isinstance(func, str):
            from ..utils.expressions_eval import evaluate

            fields = {f.label: f for f in self._fields if f.label is not None}
            result = evaluate(func, fields, **(evaluate_args or {}))
            if label is not None:
                result.label = label
        else:
            result = self.copy(label=label or self.label)
            result.data = func(self.data)
        if out is not None:
            out.data = result.data
            return out
        return result

    def smooth(self, sigma: float = 1, *, out=None, label=None) -> FieldCollection:
        """Every field smoothed (:meth:`DataFieldBase.smooth`)."""
        result = FieldCollection([f.smooth(sigma) for f in self._fields],
                                 label=label or self.label)
        if out is not None:
            out._fields = result._fields
            return out
        return result

    def interpolate_to_grid(self, grid: GridBase, *, fill=None, label=None) -> FieldCollection:
        return FieldCollection([f.interpolate_to_grid(grid, fill=fill) for f in self._fields],
                               label=label or self.label)

    # -- reductions ---------------------------------------------------------------------
    @property
    def integrals(self) -> list[torch.Tensor]:
        return [f.integral for f in self._fields]

    @property
    def averages(self) -> list[torch.Tensor]:
        return [f.average for f in self._fields]

    @property
    def magnitudes(self) -> np.ndarray:
        """Each field's :attr:`~DataFieldBase.magnitude` (one host read each)."""
        return np.fromiter((f.magnitude for f in self._fields), dtype=float)

    def to_numpy(self) -> np.ndarray:
        """The stacked data, copied to the host (bfloat16 as float32)."""
        return to_host(self.data)

    # -- plotting -----------------------------------------------------------------------
    def plot(self, kind: str = "auto", *args, filename=None, ax=None, fig=None, **kwargs):
        """Plot all fields in a row of panels.

        A caller-supplied ``ax`` (the plot trackers' figure) is replaced by a
        row of panels in its figure: a collection needs one axes per field.
        """
        import matplotlib.pyplot as plt

        n = len(self._fields)
        if ax is not None and fig is None:
            fig = ax.figure
            ax.remove()
        if fig is not None:
            axes = fig.subplots(1, n)
        else:
            fig, axes = plt.subplots(1, n, figsize=(4 * n, 3.5))
        if n == 1:
            axes = [axes]
        refs = []
        for i, (f, ax) in enumerate(zip(self._fields, axes, strict=True)):
            k = kind[i] if isinstance(kind, (list, tuple)) else kind
            refs.append(f.plot(k, *args, ax=ax, **kwargs))
        if self.label:
            fig.suptitle(self.label)
        if filename:
            fig.savefig(filename)
        return refs

    def _update_plot(self, references) -> None:
        """Update a multi-panel plot produced by :meth:`plot` in place."""
        for field, ref in zip(self._fields, references, strict=True):
            field._update_plot(ref)

    def _get_napari_data(self, **kwargs):
        result = {}
        for f in self._fields:
            result.update(f._get_napari_data(**kwargs))
        return result
