"""Caching decorators hashing mutable arguments.

The port's own copy of :mod:`pde_tpu.utils.cache`; torch tensors hash and
compare by their values, as numpy arrays do.
"""

from __future__ import annotations

import functools
import numbers
from typing import Callable

import numpy as np
import torch


def _host(value):
    """A tensor's values as host numpy data; anything else as it is."""
    if isinstance(value, torch.Tensor):
        from ..fields.base import to_host

        return to_host(value)
    return value


def objects_equal(a, b) -> bool:
    """Compare two objects, descending into containers, arrays and tensors."""
    a, b = _host(a), _host(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(objects_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            objects_equal(x, y) for x, y in zip(a, b, strict=True)
        )
    return bool(a == b)


def hash_mutable(obj) -> int:
    """Return a hash also for (nested) mutable objects (a tensor by its
    values, read to the host)."""
    obj = _host(obj)
    if hasattr(obj, "_cache_hash"):
        return int(obj._cache_hash())
    if isinstance(obj, (str, bytes, numbers.Number, type(None), bool)):
        return hash(obj)
    if isinstance(obj, np.ndarray):
        return hash((obj.shape, str(obj.dtype), obj.tobytes()))
    if isinstance(obj, (list, tuple)):
        return hash(tuple(hash_mutable(x) for x in obj))
    if isinstance(obj, (set, frozenset)):
        return hash(frozenset(hash_mutable(x) for x in obj))
    if isinstance(obj, dict):
        return hash(
            frozenset((hash_mutable(k), hash_mutable(v)) for k, v in obj.items())
        )
    for attr in ("__getstate__", "__dict__"):
        if hasattr(obj, attr):
            try:
                state = getattr(obj, attr)
                state = state() if callable(state) else state
                if isinstance(state, dict):
                    return hash_mutable(state)
            except TypeError:
                pass
    return hash(obj)


def make_serializer(method: str) -> Callable:
    """Return a function serializing objects with the given method."""
    if method in (None, "none"):
        return lambda s: s
    if method == "hash":
        return hash
    if method == "hash_mutable":
        return hash_mutable
    if method == "hash_readable":
        return lambda s: repr(_hashable(s))
    if method == "json":
        import json

        return lambda s: json.dumps(_hashable(s), sort_keys=True).encode()
    if method == "pickle":
        import pickle

        return lambda s: pickle.dumps(s)
    raise ValueError(f"Unknown serializer method `{method}`")


def _hashable(obj):
    obj = _host(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {str(k): _hashable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_hashable(x) for x in obj]
    return obj


def make_unserializer(method: str) -> Callable:
    """Return the inverse of :func:`make_serializer` where possible."""
    if method in (None, "none"):
        return lambda s: s
    if method == "json":
        import json

        return lambda s: json.loads(s.decode() if isinstance(s, bytes) else s)
    if method == "pickle":
        import pickle

        return lambda s: pickle.loads(s)
    raise ValueError(f"Cannot unserialize method `{method}`")


class cached_property:
    """A property whose value is computed once per instance."""

    def __init__(self, *args, **kwargs):
        self.extra_args = kwargs
        if args and callable(args[0]):
            self._set_func(args[0])

    def __call__(self, func):
        self._set_func(func)
        return self

    def _set_func(self, func):
        self.func = func
        self.__doc__ = func.__doc__
        self.name = func.__name__

    def __get__(self, obj, owner):
        if obj is None:
            return self
        cache = obj.__dict__.setdefault("_cache_properties", {})
        if self.name not in cache:
            cache[self.name] = self.func(obj)
        return cache[self.name]


class cached_method:
    """Decorator caching method results, hashing mutable arguments."""

    def __init__(self, *args, **kwargs):
        self.extra_args = kwargs
        self.func = None
        if args and callable(args[0]):
            self.func = args[0]

    def __call__(self, *args, **kwargs):
        if self.func is None:
            self.func = args[0]
            return self
        raise TypeError("cached_method must decorate a function")

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, owner):
        if obj is None:
            return self
        func = self.func

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            cache = obj.__dict__.setdefault("_cache_methods", {})
            key = (
                self.name,
                tuple(hash_mutable(a) for a in args),
                hash_mutable(kwargs),
            )
            if key not in cache:
                cache[key] = func(obj, *args, **kwargs)
            return cache[key]

        return wrapper


class DictFiniteCapacity(dict):
    """Dictionary with a maximum number of entries (FIFO eviction)."""

    default_capacity = 100

    def __init__(self, *args, capacity: int | None = None, **kwargs):
        self.capacity = capacity or self.default_capacity
        super().__init__(*args, **kwargs)

    def _check_length(self):
        while len(self) > self.capacity:
            del self[next(iter(self))]

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._check_length()

    def update(self, *args, **kwargs):
        super().update(*args, **kwargs)
        self._check_length()
