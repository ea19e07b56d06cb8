"""Trackers analysing the state at interrupts of the time loop."""

from .base import (
    FinishedSimulation,
    TrackerBase,
    TrackerCollection,
    TransformedTrackerBase,
    get_named_trackers,
    registered_trackers,
)
from .interrupts import (
    ConstantInterrupts,
    FixedInterrupts,
    GeometricInterrupts,
    InterruptsBase,
    LogarithmicInterrupts,
    RealtimeInterrupts,
    parse_interrupt,
)
from .trackers import (
    CallbackTracker,
    ConsistencyTracker,
    DataTracker,
    LivePlotTracker,
    MaterialConservationTracker,
    MaxRuntimeTracker,
    PlotTracker,
    PrintTracker,
    ProgressTracker,
    RuntimeTracker,
    SteadyStateTracker,
    WalltimeTracker,
)
from .interactive import InteractivePlotTracker
