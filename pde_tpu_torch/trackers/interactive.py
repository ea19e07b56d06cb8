"""Interactive napari tracker running the viewer in a separate process.

Port of :mod:`pde_tpu.trackers.interactive`. napari is an optional
dependency: the queue plumbing (NapariViewer, the tracker protocol) works
without it, and only launching the real viewer process requires napari.
Tests inject a fake ``process_target`` to exercise the queue protocol. Each
update sends host copies of the state's layers (one copy of each field). The
viewer's process is spawned (``pde_tpu`` forks it), so a target must be
importable by its module path.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
from typing import Any, Callable

import numpy as np

from ..fields.base import FieldBase
from .base import InfoDict, TrackerBase


def napari_available() -> bool:
    """Whether the optional `napari` package can be imported."""
    import importlib.util

    return importlib.util.find_spec("napari") is not None


def napari_process(data_channel: mp.Queue, initial_data: dict[str, Any]) -> None:
    """Runs the napari viewer in a separate process, fed from a queue."""
    import napari  # the optional dependency is only needed in this process

    viewer = napari.Viewer(show=True)
    layers = {}
    for name, layer_data in initial_data.items():
        layers[name] = viewer.add_image(layer_data["data"], name=name)

    def update(event=None):
        while True:
            try:
                action, payload = data_channel.get(block=False)
            except queue.Empty:
                break
            if action == "close":
                viewer.close()
                return
            if action == "update_data":
                for name, layer_data in payload.items():
                    if name in layers:
                        layers[name].data = layer_data["data"]

    timer = napari.qt.thread_worker(update)
    napari.run()


class NapariViewer:
    """Allows pushing field updates to a napari viewer in another process."""

    def __init__(
        self,
        state: FieldBase,
        t_initial: float = 0,
        process_target: Callable | None = None,
    ):
        if process_target is None:
            try:
                import napari  # noqa: F401
            except ImportError as err:
                raise ImportError(
                    "InteractivePlotTracker requires the optional `napari` "
                    "package"
                ) from err
            process_target = napari_process
        # a fresh interpreter, not a fork of this one: the solver's process has
        # threads (torch's and CUDA's), whose locks a forked child inherits as held
        context = mp.get_context("spawn")
        self._queue: mp.Queue = context.Queue()
        initial = {
            name: {"data": np.asarray(layer["data"])}
            for name, layer in state._get_napari_data().items()
        }
        self._process = context.Process(
            target=process_target, args=(self._queue, initial), daemon=True
        )
        self._process.start()

    def update(self, state: FieldBase, t: float) -> None:
        payload = {
            name: {"data": np.asarray(layer["data"])}
            for name, layer in state._get_napari_data().items()
        }
        self._queue.put(("update_data", payload))

    def close(self, force: bool = True) -> None:
        self._queue.put(("close", None))
        self._process.join(timeout=5)
        if force and self._process.is_alive():
            self._process.terminate()


class InteractivePlotTracker(TrackerBase):
    """Tracker streaming the state to an interactive napari viewer."""

    name = "interactive"

    def __init__(self, interrupts=1, *, close: bool = True, show_time: bool = False,
                 interval=None, _process_target: Callable | None = None):
        super().__init__(interrupts=interrupts, interval=interval)
        self.close = close
        self.show_time = show_time
        self._process_target = _process_target
        self._viewer: NapariViewer | None = None

    def initialize(self, state: FieldBase, info: InfoDict | None = None) -> float:
        self._viewer = NapariViewer(state, process_target=self._process_target)
        return super().initialize(state, info)

    def handle(self, state: FieldBase, t: float) -> None:
        if self._viewer is not None:
            self._viewer.update(state, t)

    def finalize(self, info: InfoDict | None = None) -> None:
        if self._viewer is not None and self.close:
            self._viewer.close()
