"""Interrupt schedules determining when trackers fire.

Port of :mod:`pde_tpu.trackers.interrupts`: the schedules are host-side
Python float arithmetic, the same as ``pde_tpu``'s, so both packages
interrupt at equal times.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Sequence

import numpy as np


class InterruptsBase:
    """Base class for tracker interrupt schedules."""

    dt: float = 0.0

    def copy(self):
        return copy.copy(self)

    def initialize(self, t: float) -> float:
        """Return the first interrupt time at or after `t`."""
        raise NotImplementedError

    def next(self, t: float) -> float:
        """Return the next interrupt time after `t`."""
        raise NotImplementedError


class FixedInterrupts(InterruptsBase):
    """Interrupts at explicitly given time points."""

    def __init__(self, interrupts: Sequence[float]):
        self.interrupts = np.atleast_1d(np.asarray(interrupts, dtype=float))
        if self.interrupts.ndim != 1:
            raise ValueError("interrupts must be a 1d sequence")
        self._index = -1

    def __repr__(self):
        return f"{self.__class__.__name__}(interrupts={self.interrupts})"

    def copy(self):
        obj = self.__class__(self.interrupts.copy())
        obj._index = self._index
        return obj

    def initialize(self, t: float) -> float:
        self._index = -1
        return self.next(t)

    def next(self, t: float) -> float:
        while True:
            self._index += 1
            if self._index >= len(self.interrupts):
                return math.inf
            t_next = float(self.interrupts[self._index])
            if t_next >= t:
                if self._index + 1 < len(self.interrupts):
                    self.dt = float(self.interrupts[self._index + 1]) - t_next
                return t_next


class ConstantInterrupts(InterruptsBase):
    """Interrupts equidistant in simulation time."""

    def __init__(self, dt: float = 1, t_start: float | None = None):
        self.dt = float(dt)
        self.t_start = t_start
        self._t_next: float | None = None

    def __repr__(self):
        return f"{self.__class__.__name__}(dt={self.dt}, t_start={self.t_start})"

    def initialize(self, t: float) -> float:
        self._t_next = t if self.t_start is None else max(t, self.t_start)
        return self._t_next

    def next(self, t: float) -> float:
        if self._t_next is None:
            return self.initialize(t)
        self._t_next += self.dt
        while self._t_next <= t:
            self._t_next += self.dt
        return self._t_next


class LogarithmicInterrupts(ConstantInterrupts):
    """Interrupts with geometrically increasing durations between them."""

    def __init__(self, dt_initial: float = 1, factor: float = 1.1,
                 t_start: float | None = None):
        super().__init__(dt=float(dt_initial) / float(factor), t_start=t_start)
        self.factor = float(factor)

    def __repr__(self):
        return (f"{self.__class__.__name__}(dt={self.dt}, factor={self.factor}, "
                f"t_start={self.t_start})")

    def next(self, t: float) -> float:
        self.dt *= self.factor
        return super().next(t)


class GeometricInterrupts(InterruptsBase):
    """Interrupts at times ``scale * factor**n`` for n = 0, 1, 2, ..."""

    def __init__(self, scale: float, factor: float):
        self.scale = float(scale)
        self.factor = float(factor)
        self._iteration = -1

    def __repr__(self):
        return f"{self.__class__.__name__}(scale={self.scale}, factor={self.factor})"

    def value(self, iteration: int) -> float:
        return self.scale * self.factor**iteration

    def initialize(self, t: float) -> float:
        self._iteration = -1
        return self.next(t)

    def next(self, t: float) -> float:
        while True:
            self._iteration += 1
            t_next = self.value(self._iteration)
            if t_next >= t:
                self.dt = self.value(self._iteration + 1) - t_next
                return t_next


class RealtimeInterrupts(ConstantInterrupts):
    """Interrupts roughly every `duration` seconds of wall-clock time (a
    number, or a duration string such as ``"0:01:30"``)."""

    def __init__(self, duration: float | str, dt_initial: float = 0.01):
        super().__init__(dt=dt_initial)
        if isinstance(duration, str):
            from ..utils.parse_duration import parse_duration

            duration = parse_duration(duration).total_seconds()
        self.duration = float(duration)
        self._last_time: float | None = None

    def __repr__(self):
        return f"{self.__class__.__name__}(duration={self.duration})"

    def initialize(self, t: float) -> float:
        self._last_time = time.monotonic()
        return super().initialize(t)

    def next(self, t: float) -> float:
        if self._last_time is None:
            return self.initialize(t)
        now = time.monotonic()
        elapsed = now - self._last_time
        # adapt the simulated window so ~`duration` seconds pass between
        # interrupts; grow rather than shrink, since each window has a fixed cost
        if elapsed > 1.5 * self.duration:
            self.dt *= 2.0
        elif 0 < elapsed < 0.5 * self.duration:
            self.dt *= min(self.duration / elapsed, 100.0)
        self._last_time = now
        return super().next(t)


def parse_interrupt(data) -> InterruptsBase:
    """Create an interrupt schedule from flexible data.

    A schedule is copied; None gives ``ConstantInterrupts(1)``, a number
    :class:`ConstantInterrupts`, a duration string :class:`RealtimeInterrupts`
    and a sequence :class:`FixedInterrupts`.
    """
    if isinstance(data, InterruptsBase):
        return data.copy()
    if data is None:
        return ConstantInterrupts(1)
    if np.isscalar(data) and not isinstance(data, str):
        return ConstantInterrupts(float(data))
    if isinstance(data, str):
        return RealtimeInterrupts(data)
    if hasattr(data, "__iter__"):
        return FixedInterrupts(list(data))
    raise TypeError(f"Cannot parse interrupt data `{data}`")


# the alias of pde_tpu (and of py-pde's documentation)
interval_to_interrupts = parse_interrupt
