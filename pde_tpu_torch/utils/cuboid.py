"""Axis-aligned cuboid geometry.

The port's own copy of :mod:`pde_tpu.utils.cuboid`, a standalone numpy class
(no module of either package imports it).
"""

from __future__ import annotations

import numpy as np


class Cuboid:
    """An n-dimensional axis-aligned box defined by position and size."""

    def __init__(self, pos, size, mutable: bool = True):
        pos = np.asarray(pos, dtype=float)
        size = np.asarray(size, dtype=float)
        if pos.shape != size.shape or pos.ndim != 1:
            raise ValueError("`pos` and `size` must be 1d arrays of equal length")
        # normalize negative sizes
        corrected_pos = np.where(size < 0, pos + size, pos)
        self._pos = corrected_pos
        self._size = np.abs(size)
        self.mutable = mutable

    @classmethod
    def from_points(cls, p1, p2, **kwargs) -> Cuboid:
        p1 = np.asarray(p1, dtype=float)
        p2 = np.asarray(p2, dtype=float)
        return cls(np.minimum(p1, p2), np.abs(p2 - p1), **kwargs)

    @classmethod
    def from_bounds(cls, bounds, **kwargs) -> Cuboid:
        bounds = np.asarray(bounds, dtype=float)
        return cls(bounds[:, 0], bounds[:, 1] - bounds[:, 0], **kwargs)

    @classmethod
    def from_centerpoint(cls, centerpoint, size, **kwargs) -> Cuboid:
        centerpoint = np.asarray(centerpoint, dtype=float)
        size = np.abs(np.asarray(size, dtype=float))
        return cls(centerpoint - size / 2, size, **kwargs)

    @property
    def pos(self) -> np.ndarray:
        return self._pos

    @pos.setter
    def pos(self, value):
        if not self.mutable:
            raise RuntimeError("Cuboid is immutable")
        self._pos = np.asarray(value, dtype=float)

    @property
    def size(self) -> np.ndarray:
        return self._size

    @size.setter
    def size(self, value):
        if not self.mutable:
            raise RuntimeError("Cuboid is immutable")
        self._size = np.abs(np.asarray(value, dtype=float))

    @property
    def dim(self) -> int:
        return len(self._pos)

    @property
    def corners(self) -> tuple[np.ndarray, np.ndarray]:
        return self._pos.copy(), self._pos + self._size

    @property
    def bounds(self) -> tuple[tuple[float, float], ...]:
        return tuple(
            (float(lo), float(lo + s))
            for lo, s in zip(self._pos, self._size, strict=True)
        )

    @property
    def vertices(self) -> list[list[float]]:
        import itertools

        low, high = self.corners
        return [
            [high[i] if bit else low[i] for i, bit in enumerate(bits)]
            for bits in itertools.product([0, 1], repeat=self.dim)
        ]

    @property
    def diagonal(self) -> float:
        return float(np.linalg.norm(self._size))

    @property
    def surface_area(self) -> float:
        if self.dim == 1:
            return 2.0
        total = 0.0
        for i in range(self.dim):
            face = np.prod(np.delete(self._size, i))
            total += 2 * face
        return float(total)

    @property
    def centroid(self) -> np.ndarray:
        return self._pos + self._size / 2

    @property
    def volume(self) -> float:
        return float(np.prod(self._size))

    def copy(self) -> Cuboid:
        return Cuboid(self._pos.copy(), self._size.copy(), mutable=self.mutable)

    def __repr__(self) -> str:
        return f"Cuboid(pos={self._pos.tolist()}, size={self._size.tolist()})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, Cuboid):
            return NotImplemented
        return np.array_equal(self._pos, other._pos) and np.array_equal(
            self._size, other._size
        )

    def __add__(self, other: Cuboid) -> Cuboid:
        """Smallest cuboid enclosing both."""
        low = np.minimum(self._pos, other._pos)
        high = np.maximum(self._pos + self._size, other._pos + other._size)
        return Cuboid(low, high - low)

    def buffer(self, amount: float = 0, inplace: bool = False) -> Cuboid:
        """Grow the cuboid by `amount` in all directions."""
        if inplace:
            self.pos = self._pos - amount
            self.size = self._size + 2 * amount
            return self
        return Cuboid(self._pos - amount, self._size + 2 * amount)

    def contains_point(self, points) -> np.ndarray:
        points = np.atleast_1d(np.asarray(points, dtype=float))
        if points.shape[-1] != self.dim:
            raise ValueError(f"Points must have dimension {self.dim}")
        low, high = self.corners
        return np.all((points >= low) & (points <= high), axis=-1)
