"""Online statistics of streamed values.

The port's own copy of ``OnlineStatistics`` from :mod:`pde_tpu.utils.math`
(the adaptive steppers' dt statistics, ``info["dt_statistics"]``).
"""

from __future__ import annotations

import math


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
