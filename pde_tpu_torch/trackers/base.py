"""Base classes for trackers.

Port of :mod:`pde_tpu.trackers.base`.
"""

from __future__ import annotations

import logging
import math
from typing import Callable

from ..fields.base import FieldBase
from .interrupts import parse_interrupt

InfoDict = dict


class FinishedSimulation(StopIteration):
    """Exception signaling that the simulation finished successfully."""


class TrackerBase:
    """Base class for trackers that analyze the simulation state at interrupts.

    The controller hands a tracker the state of each interrupt; the windows
    never write a state they were given, so a tracker may keep it.
    """

    _subclasses: dict[str, type[TrackerBase]] = {}
    name: str | None = None

    def __init__(self, interrupts=1, *, interval=None):
        if interval is not None:  # legacy alias
            interrupts = interval
        self.interrupts = parse_interrupt(interrupts)
        self._logger = logging.getLogger(self.__class__.__name__)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if getattr(cls, "name", None):
            TrackerBase._subclasses[cls.name] = cls

    @classmethod
    def from_data(cls, data, **kwargs) -> TrackerBase:
        """Create a tracker from a registered name or a callable (a
        :class:`~pde_tpu_torch.trackers.CallbackTracker`), or pass an
        instance through."""
        if isinstance(data, TrackerBase):
            return data
        if callable(data):
            from .trackers import CallbackTracker

            return CallbackTracker(data, **kwargs)
        if isinstance(data, str):
            try:
                tracker_cls = get_named_trackers()[data]
            except KeyError:
                raise ValueError(
                    f"Unknown tracker `{data}`; registered: {registered_trackers()}"
                ) from None
            return tracker_cls(**kwargs)
        raise ValueError(f"Unsupported tracker format: `{data}`")

    def initialize(self, field: FieldBase, info: InfoDict | None = None) -> float:
        """Initialize the tracker; returns the first interrupt time. The
        schedule starts at 0, not at the run's start, as in ``pde_tpu``."""
        return self.interrupts.initialize(0.0)

    def handle(self, field: FieldBase, t: float) -> None:
        """Analyze the field at time `t`."""

    def finalize(self, info: InfoDict | None = None) -> None:
        """Finalize the tracker after the simulation."""


class TransformedTrackerBase(TrackerBase):
    """Tracker that transforms the state before processing it."""

    def __init__(self, interrupts=1, *, transformation: Callable | None = None,
                 interval=None):
        super().__init__(interrupts=interrupts, interval=interval)
        if transformation is not None and not callable(transformation):
            raise TypeError("`transformation` must be callable")
        self.transformation = transformation

    def _transform(self, field: FieldBase, t: float) -> FieldBase:
        if self.transformation is None:
            return field
        try:
            return self.transformation(field, t)
        except TypeError:
            return self.transformation(field)


class TrackerCollection:
    """Collection of trackers sharing a simulation."""

    time_next_action: float

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
        """Create a tracker collection: None, "auto", a tracker, a name, a
        callable or a list of them."""
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
        if isinstance(data, (TrackerBase, str)) or callable(data):
            return cls([TrackerBase.from_data(data, **kwargs)])
        if hasattr(data, "__iter__"):
            return cls([TrackerBase.from_data(d, **kwargs) for d in data])
        raise ValueError(f"Cannot initialize trackers from `{data}`")

    def initialize(self, field: FieldBase, info: InfoDict | None = None) -> float:
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

    def finalize(self, info: InfoDict | None = None) -> None:
        for tracker in self.trackers:
            tracker.finalize(info)


def get_named_trackers() -> dict[str, type[TrackerBase]]:
    """All named trackers (importing the tracker modules registers them)."""
    from . import trackers  # noqa: F401

    return dict(TrackerBase._subclasses)


def registered_trackers() -> list[str]:
    """Names of all registered trackers."""
    return sorted(get_named_trackers())
