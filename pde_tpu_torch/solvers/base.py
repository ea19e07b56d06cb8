"""Base classes for PDE solvers.

Port of :mod:`pde_tpu.solvers.base` for fixed-dt stepping. PyTorch runs
eagerly, so a window between tracker interrupts is either a plain Python
loop of single steps, or one fused kernel window
(``pde.make_fused_euler_window``) that advances several steps per pass over
device memory, over one field or every field of a collection. The engine
(:mod:`pde_tpu_torch.backends`) sets which is taken.

Noise: the solver holds a ``torch.Generator`` on the state's device, seeded
once from ``pde.rng`` (the JAX package's PRNG key), and draws one window seed
from it per window (its key split). Step i of a window draws its increments
from a generator seeded by (window seed, i) only (its ``fold_in``), so the
plain loop and the staged fused window add the same increments.

Decomposition: with ``decomposition=`` a solver splits the grid over a
:class:`~pde_tpu_torch.parallel.GridMesh` of blocks held by this process and
asks the PDE for a decomposed window (its hook takes ``mesh=``); a window
splits the state into blocks, runs the halo-extended kernels over them and
combines the result. Where no decomposed window applies, the run raises: the
plain decomposed stepper (``pde_tpu``'s ``ShardedBoundaries`` loop) is
ROADMAP A9.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Callable

import torch

from ..fields.base import FieldBase
from ..models.base import PDEBase, state_from_leaves, state_leaves
from ..ops.philox import step_seed


class SolverBase:
    """Base class for PDE solvers."""

    name: str | None = None
    dt_default: float = 1e-3

    #: PDE method providing a fused kernel window for this solver's fixed-dt
    #: scheme (None = no fused path)
    _fused_window_hook: str | None = None

    _subclasses: dict[str, type[SolverBase]] = {}

    def __init__(self, pde: PDEBase, *, backend: str = "auto", decomposition=None):
        from ..backends import get_backend, registered_backends

        self.pde = pde
        self.backend = backend
        try:
            self._backend_obj = get_backend(backend)
        except KeyError:
            raise ValueError(
                f"Unknown backend `{backend}`; registered backends: {registered_backends()}"
            ) from None
        if self._backend_obj.fused_windows == "require" and self._fused_window_hook is None:
            raise RuntimeError(
                f"backend='cuda' is not supported by {self.__class__.__name__}: "
                "no fused kernel path"
            )
        self.decomposition = decomposition  # domain decomposition over a mesh of blocks
        self._mesh = None
        self.info: dict[str, Any] = {
            "class": self.__class__.__name__,
            "pde_class": self.pde.__class__.__name__ if pde is not None else None,
            "dt": None,
            "steps": 0,
            "stochastic": getattr(pde, "is_sde", False) if pde is not None else False,
            "backend": self._backend_obj.name,
        }
        self._logger = logging.getLogger(self.__class__.__name__)
        self._generator: torch.Generator | None = None  # noise generator, created lazily

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        SolverBase._subclasses.setdefault(cls.__name__, cls)
        if cls.name:
            SolverBase._subclasses[cls.name] = cls

    @classmethod
    def from_name(cls, name: str, pde: PDEBase, **kwargs) -> SolverBase:
        """Create a solver from its registered name."""
        try:
            solver_cls = cls._subclasses[name]
        except KeyError:
            raise ValueError(
                f"Unknown solver method `{name}`; registered solvers: {registered_solvers()}"
            ) from None
        return solver_cls(pde, **kwargs)

    def _window_seed(self, state: FieldBase) -> int:
        """The next window's seed, from the solver's generator on the state's
        device (seeded from ``pde.rng`` at first use)."""
        if self._generator is None or self._generator.device != state.device:
            seed = int(self.pde.rng.integers(0, 2**31 - 1)) if self.pde is not None else 0
            self._generator = torch.Generator(device=state.device).manual_seed(seed)
        return int(torch.randint(2**32, (), generator=self._generator, device=state.device))

    # -- single-step constructors (overridden by concrete solvers) ---------------------------
    def _make_single_step_fixed_dt(self, state: FieldBase, dt: float) -> Callable:
        """Return ``step(leaves, t, generator=None) -> leaves`` for one
        explicit Euler step (`generator` draws the step's noise, if any)."""
        rhs = self.pde.make_pde_rhs(state)

        def single_step(leaves, t, generator=None):
            rates = rhs(leaves, t)
            return [y + dt * r for y, r in zip(leaves, rates, strict=True)]

        return single_step

    # -- domain decomposition -----------------------------------------------------------------
    def _get_mesh(self, state: FieldBase):
        """The :class:`~pde_tpu_torch.parallel.GridMesh` of a decomposed run
        (None without a decomposition); sets ``info["decomposition"]``."""
        if self.decomposition is None:
            return None
        if self._mesh is None:
            from ..parallel.mesh import GridMesh

            self._mesh = GridMesh.from_grid(state.grid, self.decomposition)
            self.info["decomposition"] = list(self._mesh.decomposition)
        if any(device.type != state.device.type for device in self._mesh.devices):
            raise ValueError(
                f"The mesh's blocks lie on {self._mesh.devices[0]}, the state on "
                f"{state.device}: set the config key `device` to the state's device type"
            )
        return self._mesh

    # -- fused kernel windows ----------------------------------------------------------------
    def _try_fused_window_stepper(self, state: FieldBase, dt: float):
        """Return a fused-window stepper, or None to use the plain loop.

        The engine sets the policy: "auto" takes a supported window and
        falls back, "require" (backend='cuda') makes anything else an error,
        "never" (backend='numpy') skips it.
        """
        fused_mode = self._backend_obj.fused_windows
        if fused_mode == "never":
            return None
        hook = self._fused_window_hook
        if hook is None or not hasattr(self.pde, hook):
            if fused_mode == "require":
                raise RuntimeError(
                    f"backend='cuda' requires a fused kernel window, but "
                    f"{self.pde.__class__.__name__} does not provide one"
                )
            return None
        if self._has_post_step_hook(state):
            self.info["fused_unsupported"] = "the PDE has a post-step hook"
            window = None
        else:
            window = self._build_fused_window(state, dt)
        if fused_mode == "require":
            if window is None:
                raise RuntimeError(
                    "backend='cuda' requires the fused kernel window, but this "
                    f"configuration does not support it: {self.info['fused_unsupported']}"
                )
            if state.device.type != "cuda":
                raise RuntimeError(
                    f"backend='cuda' requires the state on a CUDA device, not {state.device}"
                )
        if window is None:
            return None
        return self._wrap_fused_window(state, dt, window)

    def _has_post_step_hook(self, state: FieldBase) -> bool:
        try:
            self.pde.make_post_step_hook(state)
        except NotImplementedError:
            return False
        return True

    def _build_fused_window(self, state: FieldBase, dt: float):
        """The PDE's fused window (its decomposed variant on a mesh); None
        (reason in ``info``) when unsupported."""
        make_window = getattr(self.pde, self._fused_window_hook)
        mesh = self._get_mesh(state)
        try:
            if mesh is None:
                return make_window(state, dt)
            if "mesh" not in inspect.signature(make_window).parameters:
                self.info["fused_unsupported"] = "PDE has no sharded fused window"
                return None
            return make_window(state, dt, mesh=mesh)
        except NotImplementedError as err:
            self.info["fused_unsupported"] = str(err)
            return None

    def _wrap_fused_window(self, state: FieldBase, dt: float, window) -> Callable:
        """Stepper around a fused window: ``window(data, steps)`` of one field,
        ``window(leaves, steps)`` of every leaf (``window.multi_field``),
        ``window(data, window_seed, steps)`` of an Euler-Maruyama window
        (``window.needs_key``), or ``window(blocks, steps)`` over the mesh's
        blocks of every leaf (``window.sharded``)."""
        if getattr(window, "needs_t", False):
            raise NotImplementedError(
                "Fused windows with `needs_t` are not ported yet (ROADMAP B2(b))"
            )
        needs_key = getattr(window, "needs_key", False)
        if getattr(window, "n_aux", 0):
            raise NotImplementedError(
                "Fused windows with auxiliary planes are not ported yet (ROADMAP B2(d))"
            )
        multi = getattr(window, "multi_field", False)
        self._logger.info("Using fused kernel %s window", self.name)
        self.info["fused_step"] = True
        if getattr(window, "sharded", False):
            return self._wrap_sharded_window(dt, window)

        def fused_stepper(state_obj: FieldBase, t_start: float, t_end: float):
            steps = max(1, round((t_end - t_start) / dt))
            leaves = state_leaves(state_obj)
            if multi:
                leaves = list(window(leaves, steps))
            elif needs_key:
                (data,) = leaves
                leaves = [window(data, self._window_seed(state_obj), steps)]
            else:
                (data,) = leaves
                leaves = [window(data, steps)]
            self.info["steps"] += steps
            return state_from_leaves(state_obj, leaves), t_start + steps * dt

        return fused_stepper

    def _wrap_sharded_window(self, dt: float, window) -> Callable:
        """Stepper around a decomposed window: each call splits every leaf
        into the mesh's blocks, runs the window over them and combines the
        blocks on the leaf's device."""
        mesh = self._mesh

        def sharded_stepper(state_obj: FieldBase, t_start: float, t_end: float):
            steps = max(1, round((t_end - t_start) / dt))
            leaves = state_leaves(state_obj)
            split = [mesh.split_field_data(leaf) for leaf in leaves]
            blocks = window([list(planes) for planes in zip(*split)], steps)
            leaves = [
                mesh.combine_field_data([planes[i] for planes in blocks], device=leaf.device)
                for i, leaf in enumerate(leaves)
            ]
            self.info["steps"] += steps
            return state_from_leaves(state_obj, leaves), t_start + steps * dt

        return sharded_stepper

    # -- window steppers ---------------------------------------------------------------------
    def _make_fixed_stepper(self, state: FieldBase, dt: float) -> Callable:
        """Stepper performing N fixed steps per call: fused or plain; a
        decomposed run has no plain stepper yet and raises."""
        mesh = self._get_mesh(state)
        fused = self._try_fused_window_stepper(state, dt)
        if fused is not None:
            return fused
        if mesh is not None:
            if self._backend_obj.fused_windows == "never":
                raise RuntimeError(
                    "backend='numpy' (eager) cannot drive decomposed runs: they run "
                    "through the decomposed fused windows"
                )
            raise NotImplementedError(
                "This decomposed configuration has no fused window "
                f"({self.info.get('fused_unsupported', 'see logs')}), and the plain "
                "sharded stepper (`ShardedBoundaries`) is not ported yet (ROADMAP A9)"
            )
        return self._make_fixed_stepper_eager(state, dt)

    def _make_fixed_stepper_eager(self, state: FieldBase, dt: float) -> Callable:
        """Plain Python loop of single steps, each followed by the PDE's
        post-step hook where it has one. With noise, step i of a window draws
        from a generator reseeded by (window seed, i)."""
        single_step = self._make_single_step_fixed_dt(state, dt)
        stochastic = self.info["stochastic"]
        step_generator = torch.Generator(device=state.device) if stochastic else None
        if self._has_post_step_hook(state):
            post_hook, post_data = self.pde.make_post_step_hook(state)
            self.info.setdefault("post_step_data", post_data)
        else:
            post_hook = None

        def fixed_stepper(state_obj: FieldBase, t_start: float, t_end: float):
            steps = max(1, round((t_end - t_start) / dt))
            leaves = state_leaves(state_obj)
            window_seed = self._window_seed(state_obj) if stochastic else None
            for i in range(steps):
                t = t_start + i * dt
                if stochastic:
                    step_generator.manual_seed(step_seed(window_seed, i))
                leaves = single_step(leaves, t, step_generator)
                if post_hook is not None:
                    leaves, self.info["post_step_data"] = post_hook(
                        leaves, t + dt, self.info["post_step_data"]
                    )
            self.info["steps"] += steps
            return state_from_leaves(state_obj, leaves), t_start + steps * dt

        return fixed_stepper

    def make_stepper(self, state: FieldBase, dt: float | None = None) -> Callable:
        """Return ``stepper(state, t_start, t_end) -> (state, t_reached)``."""
        dt_float = float(dt) if dt is not None else self.dt_default
        self.info["dt"] = dt_float
        self.info["dt_adaptive"] = False
        return self._make_fixed_stepper(state, dt_float)


class AdaptiveSolverBase(SolverBase):
    """Base class for solvers that may step adaptively; only fixed-dt
    stepping is ported (adaptive stepping is ROADMAP A5)."""

    def __init__(
        self, pde: PDEBase, *, backend: str = "auto", adaptive: bool = False,
        tolerance: float = 1e-4, decomposition=None,
    ):
        if adaptive:
            raise NotImplementedError(
                "Adaptive time stepping is not ported yet (ROADMAP A5); pass a "
                "fixed dt"
            )
        super().__init__(pde, backend=backend, decomposition=decomposition)
        self.adaptive = adaptive
        self.tolerance = tolerance


def registered_solvers() -> list[str]:
    """List of all registered solver names."""
    return sorted(k for k in SolverBase._subclasses if k[0].islower())
