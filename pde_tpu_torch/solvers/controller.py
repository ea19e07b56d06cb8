"""Controller running the time loop between tracker interrupts.

Port of :mod:`pde_tpu.solvers.controller` for a single process: the
controller is a thin host loop, and each window between tracker interrupts is
one call of the solver's stepper.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Any, Callable

from .. import __version__
from ..fields.base import FieldBase
from ..trackers.base import FinishedSimulation, TrackerCollection


class Controller:
    """Class controlling a simulation."""

    def __init__(self, solver, t_range, tracker="auto", *, gather_mode: str = "all"):
        if gather_mode not in ("all", "main"):
            raise ValueError("gather_mode must be 'all' or 'main'")
        self.solver = solver
        self.t_range = t_range
        self.trackers = TrackerCollection.from_data(tracker)
        # one process holds every block of a decomposed run, so both modes
        # return the combined field
        self.gather_mode = gather_mode
        self._logger = logging.getLogger(self.__class__.__name__)
        self.info: dict[str, Any] = {"t_start": self.t_range[0], "t_end": self.t_range[1]}
        self.diagnostics: dict[str, Any] = {
            "controller": self.info,
            "package_version": __version__,
        }

    @property
    def t_range(self) -> tuple[float, float]:
        return self._t_range

    @t_range.setter
    def t_range(self, value):
        try:
            value = tuple(value)
        except TypeError:
            self._t_range = (0.0, float(value))
            return
        if len(value) != 2:
            raise ValueError("t_range must be a single number or a pair of numbers")
        self._t_range = (float(value[0]), float(value[1]))

    def _get_stop_handler(self) -> Callable:
        def handle_stop_iteration(err, t) -> tuple[int, str]:
            if isinstance(err, FinishedSimulation):
                msg = f"Simulation finished at t={t}"
                if err.args and err.args[0]:
                    msg += f" ({err.args[0]})"
                self.info["stop_reason"] = msg
                return 0, msg
            msg = f"Simulation aborted at t={t}"
            if err.args and err.args[0]:
                msg += f" ({err.args[0]})"
            self.info["stop_reason"] = msg
            return 1, msg

        return handle_stop_iteration

    def run(self, initial_state: FieldBase, dt: float | None = None) -> FieldBase:
        """Run the simulation; returns the final state."""
        t_start, t_end = self.t_range
        state = initial_state.copy()

        setup_start = time.monotonic()
        stepper = self.solver.make_stepper(state, dt)
        profiler = {"compilation": time.monotonic() - setup_start, "solver": 0.0, "tracker": 0.0}
        self.info["profiler"] = profiler
        self.info["solver_class"] = self.solver.__class__.__name__
        self.diagnostics["solver"] = self.solver.info
        handle_stop = self._get_stop_handler()

        tracker_start = time.monotonic()
        try:
            self.trackers.initialize(state, info=self.diagnostics)
        except StopIteration as err:
            status, _ = handle_stop(err, t_start)
            self.trackers.finalize(info=self.diagnostics)
            self.info["successful"] = status == 0
            return state
        profiler["tracker"] += time.monotonic() - tracker_start

        self.info["solver_start"] = str(datetime.datetime.now())
        solver_start = time.monotonic()
        t = t_start
        successful = True
        msg = None
        atol = 1e-12 * max(1.0, abs(t_end))
        try:
            while t < t_end - atol:
                tracker_start = time.monotonic()
                try:
                    t_tracker = self.trackers.handle(state, t)
                except StopIteration as err:
                    status, msg = handle_stop(err, t)
                    successful = status == 0
                    break
                profiler["tracker"] += time.monotonic() - tracker_start

                # advance to the next interrupt (one stepper call)
                t_break = min(t_tracker, t_end)
                if t_break <= t + atol:
                    t_break = t_end
                step_start = time.monotonic()
                state, t = stepper(state, t, t_break)
                profiler["solver"] += time.monotonic() - step_start
            else:
                tracker_start = time.monotonic()
                try:
                    self.trackers.handle(state, t)
                except StopIteration as err:
                    status, msg = handle_stop(err, t)
                    successful = status == 0
                profiler["tracker"] += time.monotonic() - tracker_start
        except KeyboardInterrupt:
            msg = f"Simulation interrupted at t={t}"
            successful = False
            self.diagnostics["last_state"] = state
        finally:
            self.info["solver_duration"] = str(
                datetime.timedelta(seconds=time.monotonic() - solver_start)
            )
            self.info["t_final"] = t
            self.info["successful"] = successful
            self.trackers.finalize(info=self.diagnostics)

        if msg:
            self._logger.info(msg)
        if profiler["tracker"] > max(profiler["solver"], 1) and profiler["solver"] > 0:
            self._logger.warning(
                "Spent more time on handling trackers (%.3g s) than on the actual "
                "simulation (%.3g s)", profiler["tracker"], profiler["solver"])
        return state
