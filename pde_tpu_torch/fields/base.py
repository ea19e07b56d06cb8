"""Base class for fields: a ``torch.Tensor`` on a device paired with a grid.

Port of :mod:`pde_tpu.fields.base`. A field holds the *valid* data (no ghost
cells); operators add ghost layers themselves. A field's serialized
attributes (:attr:`FieldBase.attributes_serialized`) are ``pde_tpu``'s, string
for string, so fields are rebuilt from either package's attributes
(:meth:`FieldBase.from_state`) and HDF5 files interchange.
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


#: how ``pde_tpu`` names bfloat16 (numpy's ``ml_dtypes.bfloat16``, which this
#: package does not need): a dtype's name, and its ``str`` in serialized
#: attributes, a two-byte void
BF16_NAME, BF16_STR = "bfloat16", "<V2"


def is_bf16_numpy(dtype) -> bool:
    """Whether a numpy dtype (or its name or ``str``) is ``pde_tpu``'s
    bfloat16: named ``bfloat16``, or a two-byte void (how a serialized
    attribute or an HDF5 file gives it back)."""
    if isinstance(dtype, str):
        return dtype == BF16_NAME or dtype.lstrip("<>|=") == "V2"
    dtype = np.dtype(dtype)
    return dtype.name == BF16_NAME or (dtype.kind == "V" and dtype.itemsize == 2)


def numpy_dtype_to_torch(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or of its name); ``pde_tpu``'s
    bfloat16 (:func:`is_bf16_numpy`) is ``torch.bfloat16``."""
    if is_bf16_numpy(dtype):
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def torch_dtype_to_numpy(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of the host copies of a torch dtype (complex
    included): bfloat16 goes to the host as float32, which holds every
    bfloat16 value exactly (numpy has no bfloat16 of its own)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty(0, dtype=dtype).numpy().dtype


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype as ``pde_tpu`` names its numpy dtype (``bfloat16`` too)."""
    return BF16_NAME if dtype == torch.bfloat16 else str(torch_dtype_to_numpy(dtype))


def dtype_str(dtype: torch.dtype) -> str:
    """A torch dtype as ``pde_tpu`` serializes it, numpy's ``dtype.str``
    (``"<V2"`` for bfloat16)."""
    return BF16_STR if dtype == torch.bfloat16 else torch_dtype_to_numpy(dtype).str


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array (bfloat16 as float32, exactly)."""
    tensor = tensor.detach().cpu()
    if tensor.dtype == torch.bfloat16:
        tensor = tensor.float()
    return tensor.numpy()


def from_host(data):
    """`data` ready for ``torch.as_tensor``: a numpy array of ``pde_tpu``'s
    bfloat16 (:func:`is_bf16_numpy`) becomes a CPU ``torch.bfloat16`` tensor
    of the same bits, through a ``uint16`` view; anything else is returned as
    it is."""
    if isinstance(data, np.ndarray) and is_bf16_numpy(data.dtype):
        bits = np.ascontiguousarray(data).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return data


def field_from_serialized_attributes(attributes: dict, data=None, *, device=None,
                                     dtype=None) -> FieldBase:
    """Reconstruct a field (or a collection) from serialized attributes, those
    of :attr:`FieldBase.attributes_serialized`, and its data."""
    return FieldBase.from_state(attributes, data, device=device, dtype=dtype)


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
    #: fields are never read-only (``pde_tpu``'s flag, kept for its API)
    readonly = False

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

    @data.setter
    def data(self, value):
        """Replace the field's data by a copy of `value` (a field, a tensor, an
        array or a number) broadcast to its shape, on its device in its dtype.
        The field takes a new tensor, as ``pde_tpu`` rebinds its array: other
        holders of the old tensor keep the old values."""
        if isinstance(value, FieldBase):
            value = value.data
        value = torch.as_tensor(value, device=self.device).to(self.dtype)
        self._data = torch.broadcast_to(value, self._data.shape).clone()

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

    @property
    def is_complex(self) -> bool:
        return self.dtype.is_complex

    @property
    def writeable(self) -> bool:
        return not self.readonly

    # -- comparison ----------------------------------------------------------------------
    def assert_field_compatible(self, other: FieldBase, accept_scalar: bool = False):
        """Raise unless `other` is a field of the same class (or, with
        `accept_scalar`, either is a scalar field) on a compatible grid."""
        from .scalar import ScalarField

        if not isinstance(other, FieldBase):
            raise TypeError(f"Cannot combine field with {type(other)}")
        is_scalar = accept_scalar and (
            isinstance(self, ScalarField) or isinstance(other, ScalarField))
        if self.__class__ is not other.__class__ and not is_scalar:
            raise TypeError(f"Fields {self.__class__.__name__} and "
                            f"{other.__class__.__name__} are incompatible")
        self.grid.assert_grid_compatible(other.grid)

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
        """Return a copy of the field, optionally cast and moved (a field
        placed on a mesh by :meth:`split_mpi` keeps its ``mesh``, as
        ``pde_tpu``'s copy keeps its sharding)."""
        data = self._data.to(dtype=dtype or self.dtype, device=device or self.device, copy=True)
        result = self.__class__(self.grid, data=data, label=label or self.label)
        if hasattr(self, "mesh") and result.device == self.device:
            result.mesh = self.mesh
        return result

    def with_data(self, data: torch.Tensor) -> FieldBase:
        """A field of the same class, grid and label holding `data` (no copy)."""
        return self.__class__(self.grid, data=data, label=self.label)

    # -- serialization ---------------------------------------------------------------------
    @property
    def attributes(self) -> dict[str, Any]:
        """The attributes that describe the field besides its data."""
        return {
            "class": self.__class__.__name__,
            "grid": self.grid,
            "label": self.label,
            "dtype": dtype_name(self.dtype),
        }

    @property
    def attributes_serialized(self) -> dict[str, str]:
        """:attr:`attributes` as strings: every value json-encoded but the
        grid's state string, as ``pde_tpu`` (and py-pde) write them."""
        return {
            "class": json.dumps(self.__class__.__name__),
            "grid": self.grid.state_serialized,
            "label": json.dumps(self.label),
            "dtype": json.dumps(dtype_str(self.dtype)),
        }

    @classmethod
    def unserialize_attributes(cls, attributes: dict[str, str]) -> dict[str, Any]:
        """The attributes of :attr:`attributes_serialized`, decoded."""
        if cls is FieldBase:
            field_cls = cls._subclasses[_unserialize_scalar(attributes["class"])]
            return field_cls.unserialize_attributes(attributes)
        result: dict[str, Any] = {}
        for key, value in attributes.items():
            if key == "grid":
                result[key] = GridBase.from_state(value)
            elif key == "label":
                result[key] = json.loads(value)
            elif key == "dtype":
                result[key] = np.dtype(_unserialize_scalar(value))
            elif key == "class":
                result[key] = _unserialize_scalar(value)
            else:
                result[key] = value
        return result

    @classmethod
    def from_state(
        cls, attributes: dict[str, Any] | str, data=None, *, device=None, dtype=None
    ) -> FieldBase:
        """Recreate a field from its attributes (serialized, as a json string,
        or plain) and data.

        The grid may be given as its serialized state string, as a state
        dictionary naming its class, or as an object with a
        ``state_serialized`` attribute. Without `dtype`, the stored dtype is
        used; without `device`, array data goes to the config key ``device``
        and a tensor keeps its own. A class with its own ``from_state`` (a
        collection) rebuilds itself.
        """
        if isinstance(attributes, str):
            attributes = json.loads(attributes)
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
            data = torch.as_tensor(from_host(np.array(data)))
            device = default_device(device)
        return field_cls(grid, data=data, label=label, dtype=dtype, device=device)

    @classmethod
    def from_state_data(cls, attributes: dict[str, Any], data=None, *, device=None
                        ) -> FieldBase:
        """A field of this class from plain attributes (a grid object, a
        label) and its data, as ``pde_tpu``'s; the stored dtype is dropped."""
        attributes = dict(attributes)
        grid = attributes.pop("grid")
        attributes.pop("dtype", None)
        if data is None:
            data = "zeros"
        return cls(grid, data=data, device=device, **attributes)

    # -- file I/O ----------------------------------------------------------------------------
    def to_file(self, filename: str, **kwargs) -> None:
        """Store the field in an HDF5 file (``pde_tpu``'s layout; needs h5py)."""
        import h5py

        with h5py.File(filename, "w") as fp:
            self._write_hdf_dataset(fp, **kwargs)

    def _write_hdf_dataset(self, hdf_path, key: str = "data", **kwargs) -> None:
        dataset = hdf_path.create_dataset(key, data=to_host(self._data))
        for k, v in self.attributes_serialized.items():
            dataset.attrs[k] = v

    @classmethod
    def _from_hdf_dataset(cls, dataset, *, device=None) -> FieldBase:
        """Rebuild a field from a dataset written by :meth:`_write_hdf_dataset`."""
        attributes = {k: dataset.attrs[k] for k in dataset.attrs}
        return FieldBase.from_state(attributes, np.array(dataset), device=device)

    @classmethod
    def from_file(cls, filename: str, *, device=None) -> FieldBase:
        """Read a field (or a collection) written by :meth:`to_file`, by this
        package or by ``pde_tpu``; it lands on `device`, by default the config
        key ``device``."""
        import h5py

        with h5py.File(filename, "r") as fp:
            if fp.attrs.get("class") == "FieldCollection":
                from .collection import FieldCollection

                count = int(fp.attrs["count"])
                fields = [cls._from_hdf_dataset(fp[f"field_{i}"], device=device)
                          for i in range(count)]
                label = json.loads(fp.attrs["label"]) if "label" in fp.attrs else None
                return FieldCollection(fields, label=label)
            return cls._from_hdf_dataset(fp["data"], device=device)

    # -- arithmetic --------------------------------------------------------------------------
    def _unary_operation(self, op: Callable) -> FieldBase:
        return self.__class__(self.grid, data=op(self._data), label=self.label)

    @property
    def real(self) -> FieldBase:
        return self._unary_operation(torch.real)

    @property
    def imag(self) -> FieldBase:
        return self._unary_operation(
            lambda data: torch.imag(data) if data.is_complex() else torch.zeros_like(data))

    def conjugate(self) -> FieldBase:
        return self._unary_operation(torch.conj_physical)

    def __neg__(self):
        return self._unary_operation(torch.neg)

    def _binary_operation(self, other, op: Callable) -> FieldBase:
        """``op(self.data, other)`` as a field: of this class, or, for a scalar
        field and a field of higher rank, of the higher rank's, as in
        ``pde_tpu``; a collection takes the operation itself (reflected)."""
        from .collection import FieldCollection
        from .scalar import ScalarField

        if isinstance(other, FieldCollection):
            return NotImplemented
        result_cls = self.__class__
        if isinstance(other, FieldBase):
            self.grid.assert_grid_compatible(other.grid)
            if other.__class__ is not result_cls:
                if isinstance(self, ScalarField):
                    result_cls = other.__class__
                elif not isinstance(other, ScalarField):
                    raise TypeError(f"Unsupported operation between {self.__class__.__name__} "
                                    f"and {other.__class__.__name__}")
            other = other.data
        elif isinstance(other, np.ndarray):
            other = torch.as_tensor(other, device=self.device)
        return result_cls(self.grid, data=op(self._data, other))

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

    def __rtruediv__(self, other):
        return self._binary_operation(other, lambda a, b: b / a)

    def __pow__(self, exponent):
        return self._binary_operation(exponent, torch.pow)

    # in-place operators keep the field and rebind its tensor, as pde_tpu rebinds
    # its array: other holders of the old tensor keep the old values
    def _inplace(self, other, op: Callable) -> FieldBase:
        result = op(self, other)
        if result is NotImplemented:
            return NotImplemented
        self._data = result.data
        return self

    def __iadd__(self, other):
        return self._inplace(other, FieldBase.__add__)

    def __isub__(self, other):
        return self._inplace(other, FieldBase.__sub__)

    def __imul__(self, other):
        return self._inplace(other, FieldBase.__mul__)

    def __itruediv__(self, other):
        return self._inplace(other, FieldBase.__truediv__)

    def split_mpi(self, decomposition="auto") -> FieldBase:
        """A copy of the field placed over a device mesh (``pde_tpu``'s
        ``split_mpi``, which returns one array sharded over its mesh): the
        mesh is :meth:`GridMesh.from_grid(self.grid, decomposition)
        <pde_tpu_torch.parallel.GridMesh.from_grid>` (``"auto"`` and a device
        count choose ``pde_tpu``'s decomposition), the copy lies on the
        mesh's first device with data equal to this field's, on the same
        grid, and holds the mesh as ``mesh`` (each field of a collection
        too): :meth:`GridMesh.combine_field` takes the copy back, and a
        solver with ``decomposition="auto"`` runs on that mesh."""
        from ..parallel.mesh import GridMesh

        return GridMesh.from_grid(self.grid, decomposition).place_field(self)

    def apply(self, func, out=None, *, label: str | None = None, evaluate_args=None
              ) -> FieldBase:
        """Apply a function of the data, or an expression string evaluated
        with :func:`~pde_tpu_torch.utils.expressions_eval.evaluate`, in which
        the field's label (``c`` without one) names it."""
        if isinstance(func, str):
            from ..utils.expressions_eval import evaluate

            result = evaluate(func, {self.label or "c": self}, **(evaluate_args or {}))
            result.label = label or result.label
        else:
            result = self.__class__(self.grid, data=func(self._data), label=label or self.label)
        if out is not None:
            out._data = result.data
            return out
        return result

    # -- plotting (implemented in subclasses) ------------------------------------------
    def plot(self, *args, **kwargs):
        raise NotImplementedError

    def _get_napari_data(self, **kwargs):
        raise NotImplementedError

    def plot_interactive(self, viewer_args: dict | None = None, **kwargs):
        """Show the field in an interactive napari viewer (optional dependency);
        its layers are host copies of the data."""
        if self.grid.num_axes == 1:
            raise RuntimeError("Interactive plotting needs at least 2 spatial dimensions")
        try:
            import napari
        except ImportError as err:
            raise ImportError(
                "plot_interactive requires the optional `napari` package"
            ) from err
        viewer = napari.Viewer(**(viewer_args or {}))
        for name, layer_data in self._get_napari_data(**kwargs).items():
            layer_data = dict(layer_data)
            layer_type = layer_data.pop("type", "image")
            getattr(viewer, f"add_{layer_type}")(name=name, **layer_data)
        napari.run()
        return viewer
