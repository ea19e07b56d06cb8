"""The trackers that ``tracker="auto"`` builds.

Port of ``ProgressTracker`` and ``ConsistencyTracker`` from
:mod:`pde_tpu.trackers.trackers`.
"""

from __future__ import annotations

import torch

from ..fields.base import FieldBase
from .base import TrackerBase
from .interrupts import ConstantInterrupts, RealtimeInterrupts


class ProgressTracker(TrackerBase):
    """Tracker showing a progress bar via tqdm."""

    name = "progress"

    def __init__(self, interrupts=None, *, ndigits: int = 5, leave: bool = True):
        if interrupts is None:
            interrupts = RealtimeInterrupts(duration=1, dt_initial=1e-3)
        super().__init__(interrupts=interrupts)
        self.ndigits = ndigits
        self.leave = leave
        self.progress_bar = None

    def initialize(self, field: FieldBase, info: dict | None = None) -> float:
        from tqdm.auto import tqdm

        controller_info = (info or {}).get("controller", {})
        self._t_start = controller_info.get("t_start", 0)
        t_end = controller_info.get("t_end", 1)
        self.progress_bar = tqdm(total=round(t_end - self._t_start, self.ndigits), leave=self.leave)
        self.progress_bar.set_description("Initializing")
        return super().initialize(field, info)

    def handle(self, field: FieldBase, t: float) -> None:
        if self.progress_bar is not None:
            progress = round(t - self._t_start, self.ndigits)
            self.progress_bar.n = min(progress, self.progress_bar.total)
            self.progress_bar.set_description("")
            self.progress_bar.refresh()

    def finalize(self, info: dict | None = None) -> None:
        if self.progress_bar is not None:
            if (info or {}).get("controller", {}).get("successful", True):
                self.progress_bar.n = self.progress_bar.total
            self.progress_bar.refresh()
            self.progress_bar.close()


class ConsistencyTracker(TrackerBase):
    """Tracker aborting the simulation when the state becomes non-finite."""

    name = "consistency"

    def __init__(self, interrupts=None):
        super().__init__(interrupts=ConstantInterrupts(1) if interrupts is None else interrupts)

    def handle(self, field: FieldBase, t: float) -> None:
        if not bool(torch.isfinite(field.data).all()):
            raise StopIteration("Field was not finite")
