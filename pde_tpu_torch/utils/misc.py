"""Miscellaneous utilities.

The port's own copy of :mod:`pde_tpu.utils.misc`; where ``pde_tpu``
dispatches on JAX arrays, the port dispatches on torch tensors.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import time
from typing import Callable

import numpy as np
import torch


def module_available(module_name: str) -> bool:
    """Check whether a python module is available without importing it fully."""
    try:
        importlib.import_module(module_name)
    except ImportError:
        return False
    return True


def ensure_directory_exists(folder) -> None:
    os.makedirs(str(folder), exist_ok=True)


def preserve_scalars(method: Callable) -> Callable:
    """Decorator that makes methods return scalars for scalar input."""

    @functools.wraps(method)
    def wrapper(self, *args):
        args = [np.asanyarray(a) for a in args]
        if args and args[0].ndim == 0:
            args = [a[None] for a in args]
            result = method(self, *args)
            return result[0]
        return method(self, *args)

    return wrapper


def decorator_arguments(decorator: Callable) -> Callable:
    """Make a decorator usable with and without arguments."""

    @functools.wraps(decorator)
    def new_decorator(*args, **kwargs):
        if len(args) == 1 and callable(args[0]) and not kwargs:
            return decorator()(args[0])
        return decorator(*args, **kwargs)

    return new_decorator


def skipUnlessModule(module_names):
    """Unittest decorator skipping a test when a module is unavailable."""
    import unittest

    if isinstance(module_names, str):
        module_names = [module_names]
    for name in module_names:
        if not module_available(name):
            return unittest.skip(f"requires {name}")
    return lambda f: f


def import_class(identifier: str):
    """Import a class or module given an identifier like `pkg.module.Class`."""
    module_path, _, class_name = identifier.rpartition(".")
    if module_path:
        module = importlib.import_module(module_path)
        return getattr(module, class_name)
    return importlib.import_module(class_name)


class classproperty(property):
    """Decorator turning a method into a class-level property."""

    def __get__(self, obj, owner=None):
        return self.fget(owner)


class hybridmethod:
    """Descriptor implementing methods dispatching on class vs instance."""

    def __init__(self, fclass, finstance=None, doc=None):
        self.fclass = fclass
        self.finstance = finstance
        self.__doc__ = doc or fclass.__doc__

    def classmethod(self, fclass):
        return type(self)(fclass, self.finstance, None)

    def instancemethod(self, finstance):
        return type(self)(self.fclass, finstance, self.__doc__)

    def __get__(self, instance, cls):
        if instance is None or self.finstance is None:
            return self.fclass.__get__(cls, None)
        return self.finstance.__get__(instance, cls)


def estimate_computation_speed(func: Callable, *args, **kwargs) -> float:
    """Estimate how many times per second `func` can be evaluated (its calls
    may return before a device finishes them; synchronize inside `func` to
    time a device's work)."""
    test_duration = kwargs.pop("test_duration", 1)
    func(*args, **kwargs)  # warm up
    number, duration = 1, 0.0
    while duration < 0.1 * test_duration:
        number *= 10
        start = time.perf_counter()
        for _ in range(number):
            func(*args, **kwargs)
        duration = time.perf_counter() - start
    return number / duration


def hdf_write_attributes(hdf_path, attributes=None, raise_serialization_error=False):
    """Write a dictionary of JSON-serialized attributes to an HDF node (an
    ``h5py`` group or dataset, opened by the caller: h5py is never imported
    here, so that the card's machine needs none)."""
    for key, value in (attributes or {}).items():
        try:
            value_serialized = json.dumps(value)
        except TypeError:
            if raise_serialization_error:
                raise
        else:
            hdf_path.attrs[key] = value_serialized


def number(value):
    """Convert a value to an int or float (or complex)."""
    fval = complex(value)
    if fval.imag != 0:
        return fval
    if fval.real == int(fval.real):
        return int(fval.real)
    return fval.real


def _numpy_dtype(arg):
    """The numpy dtype of an argument (a torch tensor's as numpy names it)."""
    dtype = getattr(arg, "dtype", type(arg))
    if isinstance(dtype, torch.dtype):
        from ..fields.base import torch_dtype_to_numpy

        return torch_dtype_to_numpy(dtype)
    return dtype


def get_common_dtype(*args):
    """Return a common numpy dtype of all arguments (numbers, numpy arrays
    and torch tensors)."""
    return np.result_type(*[_numpy_dtype(a) for a in args])


def number_array(data, dtype=None, copy: bool = True) -> np.ndarray:
    """Convert data into a numeric numpy array."""
    if isinstance(data, torch.Tensor):
        from ..fields.base import to_host

        data = to_host(data)
    if dtype is None:
        arr = np.asarray(data)
        if not np.issubdtype(arr.dtype, np.number):
            arr = np.asarray(data, dtype=float)
        elif np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(float)
    else:
        arr = np.asarray(data, dtype=dtype)
    return np.array(arr, copy=True) if copy else arr


def get_array_namespace(arr):
    """Array namespace dispatch: torch tensors get ``torch``, the rest numpy
    (``pde_tpu`` gives JAX arrays ``jax.numpy``)."""
    return torch if isinstance(arr, torch.Tensor) else np
