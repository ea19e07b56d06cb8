"""Interrupt schedules determining when trackers fire.

Port of :mod:`pde_tpu.trackers.interrupts` restricted to constant and
wall-clock schedules.
"""

from __future__ import annotations

import copy
import time


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


class ConstantInterrupts(InterruptsBase):
    """Interrupts equidistant in simulation time."""

    def __init__(self, dt: float = 1, t_start: float | None = None):
        self.dt = float(dt)
        self.t_start = t_start
        self._t_next: float | None = None

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


class RealtimeInterrupts(ConstantInterrupts):
    """Interrupts roughly every `duration` seconds of wall-clock time."""

    def __init__(self, duration: float, dt_initial: float = 0.01):
        super().__init__(dt=dt_initial)
        self.duration = float(duration)
        self._last_time: float | None = None

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
    """Interrupt schedule from a schedule or a number (constant interval)."""
    if isinstance(data, InterruptsBase):
        return data.copy()
    if isinstance(data, (int, float)):
        return ConstantInterrupts(float(data))
    raise NotImplementedError(
        f"Interrupts `{data}` are not ported yet (ROADMAP A8); give a number"
    )
