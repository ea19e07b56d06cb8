"""Math helpers: online statistics and data smoothing.

The port's own copy of :mod:`pde_tpu.utils.math`: ``OnlineStatistics`` (the
adaptive steppers' dt statistics, ``info["dt_statistics"]``) and
``SmoothData1D`` (host numpy, as in ``pde_tpu``; tensors are read to the
host).
"""

from __future__ import annotations

import math

import numpy as np


class OnlineStatistics:
    """Accumulates statistics (count/mean/min/max/std) of streamed values."""

    def __init__(self) -> None:
        self.count: int = 0
        self.mean: float = 0.0
        self._m2: float = 0.0
        self.min: float = math.inf
        self.max: float = -math.inf

    @property
    def var(self) -> float:
        return self._m2 / self.count if self.count > 0 else math.nan

    @property
    def std(self) -> float:
        return math.sqrt(self.var)

    def add(self, value: float) -> None:
        self.count += 1
        delta = value - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (value - self.mean)
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def add_batch(self, count: int, total: float, vmin: float, vmax: float) -> None:
        """Merge pre-aggregated batch statistics (count, sum, min, max)."""
        if count <= 0:
            return
        new_count = self.count + count
        delta = total / count - self.mean
        self.mean += delta * count / new_count
        self.count = new_count
        self.min = min(self.min, vmin)
        self.max = max(self.max, vmax)

    def to_dict(self) -> dict:
        return {
            "min": self.min if self.count else math.nan,
            "max": self.max if self.count else math.nan,
            "mean": self.mean if self.count else math.nan,
            "std": self.std,
            "count": self.count,
        }

    def __repr__(self) -> str:
        return f"OnlineStatistics({self.to_dict()})"


def _host(values) -> np.ndarray:
    """`values` (numbers, numpy data or a tensor on any device) as host float64."""
    if hasattr(values, "detach"):
        from ..fields.base import to_host

        values = to_host(values)
    return np.asarray(values, dtype=float)


class SmoothData1D:
    """Smooths scattered 1d data via a Gaussian kernel estimate."""

    sigma_auto_scale: float = 10.0

    def __init__(self, x, y, sigma: float | None = None):
        self.x = np.ravel(_host(x))
        self.y = np.ravel(_host(y))
        if self.x.shape != self.y.shape:
            raise ValueError("x and y must have the same length")
        if sigma is None:
            sigma = self.sigma_auto_scale * np.ptp(self.x) / len(self.x)
        self.sigma = float(sigma)

    @property
    def bounds(self) -> tuple[float, float]:
        return float(self.x.min()), float(self.x.max())

    def __call__(self, xs):
        xs = _host(xs)
        scalar = xs.ndim == 0
        xs_flat = np.atleast_1d(xs)
        weights = np.exp(-0.5 * ((xs_flat[:, None] - self.x[None, :]) / self.sigma) ** 2)
        norm = weights.sum(axis=1)
        with np.errstate(invalid="ignore"):
            result = weights @ self.y / norm
        result = np.where(norm > 0, result, np.nan)
        return float(result[0]) if scalar else result.reshape(xs.shape)

    def derivative(self, xs):
        xs = _host(xs)
        scalar = xs.ndim == 0
        xs_flat = np.atleast_1d(xs)
        eps = 1e-5 * max(self.sigma, 1e-10)
        result = (self(xs_flat + eps) - self(xs_flat - eps)) / (2 * eps)
        return float(result[0]) if scalar else result.reshape(xs.shape)
