"""Base classes for trackers.

Port of :mod:`pde_tpu.trackers.base`.
"""

from __future__ import annotations

import logging
import math

from ..fields.base import FieldBase
from .interrupts import parse_interrupt


class FinishedSimulation(StopIteration):
    """Exception signaling that the simulation finished successfully."""


class TrackerBase:
    """Base class for trackers that analyze the simulation state at interrupts."""

    _subclasses: dict[str, type[TrackerBase]] = {}
    name: str | None = None

    def __init__(self, interrupts=1):
        self.interrupts = parse_interrupt(interrupts)
        self._logger = logging.getLogger(self.__class__.__name__)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if getattr(cls, "name", None):
            TrackerBase._subclasses[cls.name] = cls

    @classmethod
    def from_data(cls, data, **kwargs) -> TrackerBase:
        """Create a tracker from a registered name or pass an instance through."""
        if isinstance(data, TrackerBase):
            return data
        if isinstance(data, str):
            from . import trackers  # noqa: F401  (registers the named trackers)

            try:
                return cls._subclasses[data](**kwargs)
            except KeyError:
                raise ValueError(
                    f"Unknown tracker `{data}`; registered: {sorted(cls._subclasses)}"
                ) from None
        raise ValueError(f"Unsupported tracker format: `{data}`")

    def initialize(self, field: FieldBase, info: dict | None = None) -> float:
        """Initialize the tracker; returns the first interrupt time."""
        return self.interrupts.initialize(0.0)

    def handle(self, field: FieldBase, t: float) -> None:
        """Analyze the field at time `t`."""

    def finalize(self, info: dict | None = None) -> None:
        """Finalize the tracker after the simulation."""


class TrackerCollection:
    """Collection of trackers sharing a simulation."""

    def __init__(self, trackers: list[TrackerBase] | None = None):
        self.trackers = trackers or []
        self.time_next_action = math.inf
        self.times: list[float] = []

    def __len__(self) -> int:
        return len(self.trackers)

    def __iter__(self):
        return iter(self.trackers)

    @classmethod
    def from_data(cls, data, **kwargs) -> TrackerCollection:
        """Create a tracker collection: None, "auto", a tracker or a list."""
        if data is None:
            return cls([])
        if isinstance(data, TrackerCollection):
            return data
        if isinstance(data, str) and data == "auto":
            from .trackers import ConsistencyTracker, ProgressTracker

            trackers: list[TrackerBase] = []
            try:
                import tqdm  # noqa: F401
            except ImportError:
                pass
            else:
                trackers.append(ProgressTracker())
            trackers.append(ConsistencyTracker())
            return cls(trackers)
        if isinstance(data, (TrackerBase, str)):
            return cls([TrackerBase.from_data(data, **kwargs)])
        if hasattr(data, "__iter__"):
            return cls([TrackerBase.from_data(d, **kwargs) for d in data])
        raise ValueError(f"Cannot initialize trackers from `{data}`")

    def initialize(self, field: FieldBase, info: dict | None = None) -> float:
        self.times = [t.initialize(field, info) for t in self.trackers]
        self.time_next_action = min(self.times, default=math.inf)
        return self.time_next_action

    def handle(self, state: FieldBase, t: float, atol: float = 1e-8) -> float:
        """Handle all trackers whose interrupt is due; returns next action time."""
        for i, tracker in enumerate(self.trackers):
            if t + atol >= self.times[i]:
                tracker.handle(state, t)
                self.times[i] = tracker.interrupts.next(t)
        self.time_next_action = min(self.times, default=math.inf)
        return self.time_next_action

    def finalize(self, info: dict | None = None) -> None:
        for tracker in self.trackers:
            tracker.finalize(info)
