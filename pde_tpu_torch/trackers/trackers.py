"""Concrete trackers.

Port of :mod:`pde_tpu.trackers.trackers`. Trackers that judge the state
(consistency, steady state, conservation) compute on the state's device and
read one value back per interrupt: a bool, or one float per field. The plot
trackers copy the (transformed) state to the host once per interrupt and draw
that copy with matplotlib, imported when a tracker starts.
"""

from __future__ import annotations

import inspect
import sys
import time
from typing import IO, Any, Callable

import numpy as np
import torch

from ..fields.base import FieldBase
from ..fields.collection import FieldCollection
from ..fields.datafield_base import DataFieldBase
from .base import FinishedSimulation, InfoDict, TrackerBase, TransformedTrackerBase
from .interrupts import ConstantInterrupts, RealtimeInterrupts


def _leaves(field: FieldBase) -> list[torch.Tensor]:
    """The tensors of a field: its data, or each field's of a collection."""
    if isinstance(field, FieldCollection):
        return [f.data for f in field]
    return [field.data]


def _positional_args(func: Callable) -> int:
    """Number of positional parameters of `func` without a default."""
    return len([p for p in inspect.signature(func).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty])


class CallbackTracker(TrackerBase):
    """Tracker calling a user function ``func(field)`` or ``func(field, t)``
    at each interrupt."""

    def __init__(self, func: Callable, interrupts=1, *, interval=None):
        super().__init__(interrupts=interrupts, interval=interval)
        self._callback = func
        self._num_args = _positional_args(func)

    def handle(self, field: FieldBase, t: float) -> None:
        if self._num_args == 1:
            self._callback(field)
        else:
            self._callback(field, t)


class ProgressTracker(TrackerBase):
    """Tracker showing a progress bar via tqdm."""

    name = "progress"

    def __init__(self, interrupts=None, *, fancy: bool = True, ndigits: int = 5,
                 leave: bool = True, interval=None):
        if interrupts is None:
            interrupts = RealtimeInterrupts(duration=1, dt_initial=1e-3)
        super().__init__(interrupts=interrupts, interval=interval)
        self.fancy = fancy
        self.ndigits = ndigits
        self.leave = leave
        self.progress_bar = None

    def initialize(self, field: FieldBase, info: InfoDict | None = None) -> float:
        from tqdm.auto import tqdm

        controller_info = (info or {}).get("controller", {})
        self._t_start = controller_info.get("t_start", 0)
        t_end = controller_info.get("t_end", 1)
        self.progress_bar = tqdm(total=round(t_end - self._t_start, self.ndigits),
                                 leave=self.leave)
        self.progress_bar.set_description("Initializing")
        return super().initialize(field, info)

    def handle(self, field: FieldBase, t: float) -> None:
        if self.progress_bar is not None:
            progress = round(t - self._t_start, self.ndigits)
            self.progress_bar.n = min(progress, self.progress_bar.total)
            self.progress_bar.set_description("")
            self.progress_bar.refresh()

    def finalize(self, info: InfoDict | None = None) -> None:
        if self.progress_bar is not None:
            if (info or {}).get("controller", {}).get("successful", True):
                self.progress_bar.n = self.progress_bar.total
            self.progress_bar.refresh()
            self.progress_bar.close()


class PrintTracker(TrackerBase):
    """Tracker printing the field's average to a stream."""

    name = "print"

    def __init__(self, interrupts=1, stream: IO[str] = sys.stdout, *, interval=None):
        super().__init__(interrupts=interrupts, interval=interval)
        self.stream = stream

    def handle(self, field: FieldBase, t: float) -> None:
        if isinstance(field, DataFieldBase):
            if field.is_complex:
                average = f"{complex(field.average):g}".replace("j", "i")
            else:
                average = f"{float(field.average):g}"
            data = f"Field with average {average}"
        else:
            data = f"Collection with {len(field)} fields"
        self.stream.write(f"t={t:g}, {data}\n")
        self.stream.flush()


def _on_host(field: FieldBase) -> FieldBase:
    """The field itself if it lies on the CPU, else one copy of it there."""
    leaves = _leaves(field)
    if all(leaf.device.type == "cpu" for leaf in leaves):
        return field
    return field.copy(device="cpu")


class PlotTracker(TransformedTrackerBase):
    """Tracker plotting the state at interrupts (optionally writing files).

    Each drawn interrupt copies the (transformed) state to the host once; a
    later interrupt updates the artists of the first plot in place where the
    plot allows it, else redraws."""

    def __init__(
        self, interrupts=1, *, transformation=None, title="Time: {time:g}",
        output_file=None, movie=None, show=None, tight_layout=False,
        max_fps: float = np.inf, plot_args=None, interval=None,
    ):
        super().__init__(interrupts=interrupts, transformation=transformation,
                         interval=interval)
        self.title = title
        self.output_file = output_file
        self.movie = movie
        self.show = False if show is None else show
        self.tight_layout = tight_layout
        self.max_fps = max_fps
        self.plot_args = plot_args or {}
        self._figure = None
        self._plot_ref = None
        self._last_plot_time = -np.inf

    def initialize(self, state: FieldBase, info: InfoDict | None = None) -> float:
        import matplotlib.pyplot as plt

        self._plt = plt
        return super().initialize(state, info)

    def handle(self, state: FieldBase, t: float) -> None:
        if time.monotonic() - self._last_plot_time < 1 / self.max_fps:
            return
        state = _on_host(self._transform(state, t))
        plt = self._plt
        title = self.title.format(time=t) if isinstance(self.title, str) else self.title(state, t)
        # live updates: re-use the figure and update the artists in place
        if self._plot_ref is not None:
            try:
                state._update_plot(self._plot_ref)
                self._figure.suptitle(title)
                self._finish_frame()
                return
            except (NotImplementedError, AttributeError, ValueError):
                self._plot_ref = None  # fall back to a full redraw
        if self._figure is not None:
            plt.close(self._figure)
        self._figure = plt.figure()
        try:
            ref = state.plot(ax=self._figure.gca(), **self.plot_args)
        except TypeError:
            ref = state.plot(**self.plot_args)
            self._figure = plt.gcf()
        if hasattr(state, "_update_plot"):
            self._plot_ref = ref
        self._figure.suptitle(title)
        if self.tight_layout:
            self._figure.tight_layout()
        self._finish_frame()

    def _finish_frame(self) -> None:
        if self.output_file:
            self._figure.savefig(self.output_file)
        if self.show:
            self._plt.pause(0.001)
        self._last_plot_time = time.monotonic()

    def finalize(self, info: InfoDict | None = None) -> None:
        if self._figure is not None:
            self._plt.close(self._figure)


class LivePlotTracker(PlotTracker):
    """PlotTracker with defaults for live plotting."""

    name = "plot"

    def __init__(self, interrupts=1, *, show: bool = True, max_fps: float = 2, **kwargs):
        super().__init__(interrupts=interrupts, show=show, max_fps=max_fps, **kwargs)


class DataTracker(CallbackTracker):
    """Tracker storing the results of ``func(field)`` (or ``func(field, t)``)
    over time; exports to pandas and files."""

    def __init__(self, func: Callable, interrupts=1, *, filename: str | None = None,
                 interval=None):
        super().__init__(func, interrupts=interrupts, interval=interval)
        self.filename = filename
        self.times: list[float] = []
        self.data: list[Any] = []

    def handle(self, field: FieldBase, t: float) -> None:
        self.times.append(t)
        if self._num_args == 1:
            self.data.append(self._callback(field))
        else:
            self.data.append(self._callback(field, t))

    @property
    def dataframe(self):
        """The data as a :class:`pandas.DataFrame` with a ``time`` column."""
        import pandas as pd

        df = pd.DataFrame(self.data)
        df.insert(0, "time", self.times)
        return df

    def to_file(self, filename: str, **kwargs) -> None:
        """Write the data as ``.pickle``, ``.csv``, ``.xls`` or ``.xlsx``."""
        ext = filename.split(".")[-1].lower()
        if ext == "pickle":
            import pickle

            with open(filename, "wb") as fp:
                pickle.dump((self.times, self.data), fp, **kwargs)
        elif ext == "csv":
            self.dataframe.to_csv(filename, **kwargs)
        elif ext in ("xls", "xlsx"):
            self.dataframe.to_excel(filename, **kwargs)
        else:
            raise ValueError(f"Unsupported file extension `.{ext}`")

    def finalize(self, info: InfoDict | None = None) -> None:
        super().finalize(info)
        if self.filename:
            self.to_file(self.filename)


class SteadyStateTracker(TrackerBase):
    """Tracker interrupting the simulation once the state is stationary.

    The last state stays on its device as a clone; each interrupt compares
    with torch there and reads one bool back."""

    name = "steady_state"
    progress_bar_format = (
        "Convergence: {n:.2g} of {total:.2g} {bar} [{elapsed}<{remaining}]"
    )

    def __init__(self, interrupts=None, atol: float = 1e-8, rtol: float = 1e-5, *,
                 progress: bool = False, evolution_rate=None, interval=None):
        if interrupts is None:
            interrupts = ConstantInterrupts(1)
        super().__init__(interrupts=interrupts, interval=interval)
        self.atol = atol
        self.rtol = rtol
        self.progress = progress
        self.evolution_rate = evolution_rate
        self._last_data: list[torch.Tensor] | None = None

    def handle(self, field: FieldBase, t: float) -> None:
        if self.evolution_rate is not None:
            rate = self.evolution_rate(field, t)
            rates = [torch.as_tensor(x).reshape(-1) for x in _leaves(rate)]
            ref = torch.cat([x.reshape(-1) for x in _leaves(field)])
            rate_data = torch.cat([x.to(ref.device) for x in rates])
            if bool((rate_data.abs() <= self.atol + self.rtol * ref.abs()).all()):
                raise FinishedSimulation("Reached steady state")
            return
        data = _leaves(field)
        if self._last_data is not None:
            dt = self.interrupts.dt or 1.0
            close = [torch.isclose(a, b, rtol=self.rtol * dt, atol=self.atol * dt).all()
                     for a, b in zip(data, self._last_data, strict=True)]
            if bool(torch.stack(close).all()):
                raise FinishedSimulation("Reached steady state")
        self._last_data = [x.clone() for x in data]


class WalltimeTracker(TrackerBase):
    """Tracker recording the elapsed wall time in the diagnostics."""

    def __init__(self, interrupts=1, *, interval=None):
        super().__init__(interrupts=interrupts, interval=interval)

    def initialize(self, field: FieldBase, info: InfoDict | None = None) -> float:
        self._start = time.monotonic()
        self._info = info
        return super().initialize(field, info)

    def handle(self, field: FieldBase, t: float) -> None:
        if self._info is not None:
            self._info["profiler"] = self._info.get("profiler", {})
            self._info["profiler"]["walltime"] = time.monotonic() - self._start


class MaxRuntimeTracker(TrackerBase):
    """Tracker interrupting the simulation after a given wall time (seconds,
    or a duration string)."""

    def __init__(self, max_runtime: float | str, interrupts=1, *, interval=None):
        super().__init__(interrupts=interrupts, interval=interval)
        if isinstance(max_runtime, str):
            from ..utils.parse_duration import parse_duration

            max_runtime = parse_duration(max_runtime).total_seconds()
        self.max_runtime = float(max_runtime)

    def initialize(self, field: FieldBase, info: InfoDict | None = None) -> float:
        self._t_start = time.monotonic()
        return super().initialize(field, info)

    def handle(self, field: FieldBase, t: float) -> None:
        if time.monotonic() - self._t_start > self.max_runtime:
            raise FinishedSimulation("Reached maximal runtime")


class RuntimeTracker(MaxRuntimeTracker):
    """Deprecated alias of :class:`MaxRuntimeTracker`."""


class ConsistencyTracker(TrackerBase):
    """Tracker aborting the simulation when the state becomes non-finite (one
    bool read back per interrupt)."""

    name = "consistency"

    def __init__(self, interrupts=None, *, interval=None):
        if interrupts is None:
            interrupts = ConstantInterrupts(1)
        super().__init__(interrupts=interrupts, interval=interval)

    def handle(self, field: FieldBase, t: float) -> None:
        finite = [torch.isfinite(leaf).all() for leaf in _leaves(field)]
        if not bool(torch.stack(finite).all()):
            raise StopIteration("Field was not finite")


class MaterialConservationTracker(TrackerBase):
    """Tracker that checks conservation of each field's magnitude (one float
    read back per field and interrupt)."""

    name = "material_conservation"

    def __init__(self, interrupts=1, atol: float = 1e-4, rtol: float = 1e-4, *,
                 interval=None):
        super().__init__(interrupts=interrupts, interval=interval)
        self.atol = atol
        self.rtol = rtol

    @staticmethod
    def _magnitudes(field: FieldBase) -> np.ndarray:
        if isinstance(field, FieldCollection):
            return field.magnitudes
        return np.asarray(field.magnitude)

    def initialize(self, field: FieldBase, info: InfoDict | None = None) -> float:
        self._reference = self._magnitudes(field)
        return super().initialize(field, info)

    def handle(self, field: FieldBase, t: float) -> None:
        if not np.allclose(self._magnitudes(field), self._reference,
                           atol=self.atol, rtol=self.rtol):
            raise StopIteration("Material is not conserved")
