"""Trackers analysing the state at interrupts of the time loop."""

from .base import FinishedSimulation, TrackerBase, TrackerCollection
from .interrupts import ConstantInterrupts, RealtimeInterrupts
from .trackers import ConsistencyTracker, ProgressTracker
