"""Base classes for PDE solvers.

Port of :mod:`pde_tpu.solvers.base`. PyTorch runs eagerly, so a fixed-dt
window between tracker interrupts is either a plain Python loop of single
steps, or one fused kernel window (the solver's ``_fused_window_hook``, e.g.
``pde.make_fused_euler_window``) that advances several steps per pass over
device memory, over one field or every field of a collection. The engine
(:mod:`pde_tpu_torch.backends`) sets which is taken. A multistep window
(Adams-Bashforth) carries ``n_aux`` planes beside the fields, which the
solver bootstraps and keeps between windows.

Adaptive stepping (:class:`AdaptiveSolverBase`) is plain torch on the
state's device, as ``pde_tpu``'s is plain XLA: each trial's accept test is a
global reduction, which no temporally blocked kernel can make. The loop's
carry (t, dt, the accepted steps, the dt statistics) stays on the device as
0-d tensors and every update is gated by ``torch.where``, so the host reads
one flag per :data:`ADAPTIVE_CHUNK` trials and the carry once per window.

Noise: the solver holds a ``torch.Generator`` on the state's device, seeded
once from ``pde.rng`` (the JAX package's PRNG key), and draws one window seed
from it per window (its key split). Step i of a window draws its increments
from a generator seeded by (window seed, i) only (its ``fold_in``), so the
plain loop and the staged fused window add the same increments.

Decomposition: with ``decomposition=`` a solver splits the grid over a
:class:`~pde_tpu_torch.parallel.GridMesh` of blocks held by this process and
asks the PDE for a decomposed window (its hook takes ``mesh=``); a window
splits the state into blocks, runs the halo-extended kernels over them and
combines the result. Where no decomposed window applies, the ``torch`` engine
runs the plain sharded stepper (``pde_tpu``'s ``ShardedBoundaries`` loop):
the serial stepping formulas on a flat list of every block's leaves, whose
rhs evaluates each block on its halo-extended view
(:class:`~pde_tpu_torch.parallel.stepper.BlockedRun`); adaptive steps take
the error maximum over the blocks the same way. The ``cuda`` engine raises
there instead.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Callable

import torch

from ..fields.base import FieldBase
from ..models.base import PDEBase, state_from_leaves, state_leaves
from ..ops.philox import step_seed
from ..utils.math import OnlineStatistics

#: trials an adaptive window runs between two host reads of its `active` flag;
#: trials past the window's end change nothing (every update is gated)
ADAPTIVE_CHUNK = 8


class ConvergenceError(RuntimeError):
    """Indicates that an implicit step did not converge."""


def adjust_dt(dt_step, error_rel):
    """Propose the next time step from the relative error of the last one:
    ``dt * clip(0.9 * error_rel**-0.2, 0.1, 4.0)``, on 0-d tensors.

    The 4x growth cap binds for ``error_rel < (0.9/4)**5``, the first
    branch; a non-finite error (NaN or inf state) shrinks dt by 4x.
    """
    finite = torch.isfinite(error_rel)
    return torch.where(
        error_rel < (0.9 / 4.0) ** 5,
        dt_step * 4.0,
        torch.where(
            ~finite,
            dt_step * 0.25,
            dt_step * torch.clamp(0.9 * error_rel.abs() ** -0.2, min=0.1),
        ),
    )


def _gated(go, new, old):
    """``torch.where(go, new, old)`` over post-step data: tensors, numbers and
    lists, tuples or dicts of them."""
    if isinstance(old, dict):
        return {key: _gated(go, new[key], old[key]) for key in old}
    if isinstance(old, (list, tuple)):
        return type(old)(_gated(go, n, o) for n, o in zip(new, old, strict=True))
    return torch.where(go, torch.as_tensor(new, device=go.device),
                       torch.as_tensor(old, device=go.device))


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
        #: the blocks of the plain sharded stepper being built (None: serial leaves)
        self._blocks = None

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

    # -- the leaves a plain stepper steps: the state's, or every block's ---------------------
    def _make_rhs(self, state: FieldBase) -> Callable:
        """``rhs(leaves, t) -> rates`` on the leaves of :meth:`_leaf_maps`."""
        if self._blocks is not None:
            return self._blocks.rhs
        return self.pde.make_pde_rhs(state)

    def _leaf_maps(self) -> tuple[Callable, Callable]:
        """``(split(state) -> leaves, combine(template, leaves) -> state)`` of
        the stepper being built: the state's data tensors, or on a mesh the
        flat list of every block's (:class:`BlockedRun`)."""
        if self._blocks is not None:
            return self._blocks.split, self._blocks.combine
        return state_leaves, state_from_leaves

    def _make_post_step_hook(self, state: FieldBase):
        """The PDE's post-step hook ``hook(leaves, t, data) -> (leaves, data)``
        on the leaves of :meth:`_leaf_maps` (on a mesh, per block), or None
        without one; its data start in ``info["post_step_data"]``."""
        if not self._has_post_step_hook(state):
            return None
        if self._blocks is not None:
            hook, data = self._blocks.post_step_hook(state)
        else:
            hook, data = self.pde.make_post_step_hook(state)
        self.info.setdefault("post_step_data", data)
        return hook

    # -- single-step constructors (overridden by concrete solvers) ---------------------------
    def _make_single_step_fixed_dt(self, state: FieldBase, dt: float) -> Callable:
        """Return ``step(leaves, t, generator=None) -> leaves`` for one
        explicit Euler step (`generator` draws the step's noise, if any)."""
        rhs = self._make_rhs(state)

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

            placed = getattr(state, "mesh", None)  # a field of FieldBase.split_mpi
            if self.decomposition == "auto" and placed is not None and \
                    placed.basegrid == state.grid:
                self._mesh = placed
            else:
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
        blocks of every leaf (``window.sharded``).

        A multistep window (``window.n_aux`` > 0, the PDE's
        ``make_fused_ab2_window``) takes and returns ``n_aux`` carried planes
        after the leaves: the solver bootstraps them as its plain stepper does
        (``_bootstrap_rates``) and keeps them between windows. A window whose
        boundary values depend on time (``window.needs_t``) also takes the
        time its steps start at, ``window(..., t_start, steps)``, as in
        ``pde_tpu``."""
        needs_t = getattr(window, "needs_t", False)
        needs_key = getattr(window, "needs_key", False)
        n_aux = getattr(window, "n_aux", 0)
        multi = getattr(window, "multi_field", False)
        if n_aux:
            rhs = self.pde.make_pde_rhs(state)
            self._fused_aux = None
        self._logger.info("Using fused kernel %s window", self.name)
        self.info["fused_step"] = True
        if getattr(window, "sharded", False):
            return self._wrap_sharded_window(dt, window, rhs if n_aux else None)

        def fused_stepper(state_obj: FieldBase, t_start: float, t_end: float):
            steps = max(1, round((t_end - t_start) / dt))
            leaves = state_leaves(state_obj)
            timed = (t_start, steps) if needs_t else (steps,)
            if n_aux:
                if self._fused_aux is None:
                    self._fused_aux = self._bootstrap_rates(rhs, leaves, t_start, dt)
                out = list(window(leaves + list(self._fused_aux), *timed))
                leaves, self._fused_aux = out[: len(leaves)], out[len(leaves):]
            elif multi:
                leaves = list(window(leaves, *timed))
            elif needs_key:
                (data,) = leaves
                leaves = [window(data, self._window_seed(state_obj), *timed)]
            else:
                (data,) = leaves
                leaves = [window(data, *timed)]
            self.info["steps"] += steps
            return state_from_leaves(state_obj, leaves), t_start + steps * dt

        return fused_stepper

    def _wrap_sharded_window(self, dt: float, window, rhs=None) -> Callable:
        """Stepper around a decomposed window: each call splits every leaf
        into the mesh's blocks, runs the window over them and combines the
        blocks on the leaf's device. A multistep window's ``n_aux`` rate
        planes are bootstrapped on the whole grid from the plain `rhs`, as
        the serial window's are, split into blocks and kept between calls."""
        mesh = self._mesh
        n_aux = getattr(window, "n_aux", 0)
        needs_t = getattr(window, "needs_t", False)

        def sharded_stepper(state_obj: FieldBase, t_start: float, t_end: float):
            steps = max(1, round((t_end - t_start) / dt))
            leaves = state_leaves(state_obj)
            if n_aux and self._fused_aux is None:
                self._fused_aux = [mesh.split_field_data(rate) for rate in
                                   self._bootstrap_rates(rhs, leaves, t_start, dt)]
            split = [mesh.split_field_data(leaf) for leaf in leaves]
            split += self._fused_aux if n_aux else []
            timed = (t_start, steps) if needs_t else (steps,)
            blocks = window([list(planes) for planes in zip(*split)], *timed)
            if n_aux:
                self._fused_aux = [[planes[len(leaves) + j] for planes in blocks]
                                   for j in range(n_aux)]
            leaves = [
                mesh.combine_field_data([planes[i] for planes in blocks], device=leaf.device)
                for i, leaf in enumerate(leaves)
            ]
            self.info["steps"] += steps
            return state_from_leaves(state_obj, leaves), t_start + steps * dt

        return sharded_stepper

    # -- window steppers ---------------------------------------------------------------------
    def _make_fixed_stepper(self, state: FieldBase, dt: float) -> Callable:
        """Stepper performing N fixed steps per call: fused or plain; on a
        mesh without a decomposed window, the plain sharded stepper."""
        self._blocks = None
        mesh = self._get_mesh(state)
        fused = self._try_fused_window_stepper(state, dt)
        if fused is not None:
            return fused
        if mesh is not None:
            if self._backend_obj.fused_windows == "never":
                raise RuntimeError(
                    "backend='numpy' (eager) cannot drive decomposed runs, as in pde_tpu "
                    "(the plain sharded stepper is the 'torch' engine's)"
                )
            return self._make_fixed_stepper_sharded(state, dt, mesh)
        return self._make_fixed_stepper_eager(state, dt)

    def _make_fixed_stepper_sharded(self, state: FieldBase, dt: float, mesh) -> Callable:
        """The plain sharded stepper: the plain loop of
        :meth:`_make_fixed_stepper_eager` on every block's leaves, each rhs
        evaluated on the blocks' halo-extended views
        (:class:`~pde_tpu_torch.parallel.stepper.BlockedRun`); noise is drawn
        on the whole grid from the serial loop's stream and the post-step
        hook runs per block. ``info["sharded_halo"]`` is the views' halo."""
        from ..parallel.stepper import BlockedRun

        self._blocks = BlockedRun(mesh, self.pde, state)
        self.info["sharded_halo"] = self._blocks.halo
        self._logger.info("Using the plain sharded %s stepper", self.name)
        return self._make_fixed_stepper_eager(state, dt)

    def _make_fixed_stepper_eager(self, state: FieldBase, dt: float) -> Callable:
        """Plain Python loop of single steps, each followed by the PDE's
        post-step hook where it has one. With noise, step i of a window draws
        from a generator reseeded by (window seed, i)."""
        single_step = self._make_single_step_fixed_dt(state, dt)
        stochastic = self.info["stochastic"]
        step_generator = torch.Generator(device=state.device) if stochastic else None
        post_hook = self._make_post_step_hook(state)
        split, combine = self._leaf_maps()

        def fixed_stepper(state_obj: FieldBase, t_start: float, t_end: float):
            steps = max(1, round((t_end - t_start) / dt))
            leaves = split(state_obj)
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
            return combine(state_obj, leaves), t_start + steps * dt

        return fixed_stepper

    def make_stepper(self, state: FieldBase, dt: float | None = None) -> Callable:
        """Return ``stepper(state, t_start, t_end) -> (state, t_reached)``."""
        dt_float = float(dt) if dt is not None else self.dt_default
        self.info["dt"] = dt_float
        self.info["dt_adaptive"] = False
        return self._make_fixed_stepper(state, dt_float)


class AdaptiveSolverBase(SolverBase):
    """Base class for solvers that may step adaptively (explicit Euler
    step doubling by default; Runge-Kutta-Fehlberg overrides the estimate)."""

    dt_min: float = 1e-10
    dt_max: float = 1e10

    def __init__(
        self, pde: PDEBase, *, backend: str = "auto", adaptive: bool = False,
        tolerance: float = 1e-4, decomposition=None,
    ):
        super().__init__(pde, backend=backend, decomposition=decomposition)
        self.adaptive = adaptive
        self.tolerance = tolerance

    def _make_single_step_error_estimate(self, state: FieldBase) -> Callable:
        """Return ``estimate(leaves, t, dt) -> (new_leaves, error)`` (`t`, `dt`
        and `error` 0-d tensors): explicit Euler step doubling."""
        if getattr(self.pde, "is_sde", False):
            raise RuntimeError("Cannot use adaptive stepping with stochastic equations")
        rhs = self._make_rhs(state)

        def estimate(leaves, t, dt):
            rate = rhs(leaves, t)
            step_large = [y + dt * r for y, r in zip(leaves, rate, strict=True)]
            half = [y + 0.5 * dt * r for y, r in zip(leaves, rate, strict=True)]
            rate_mid = rhs(half, t + 0.5 * dt)
            step_small = [y + 0.5 * dt * r for y, r in zip(half, rate_mid, strict=True)]
            return step_small, _max_abs(a - b for a, b in zip(step_large, step_small, strict=True))

        return estimate

    def _make_adaptive_stepper(self, state: FieldBase) -> Callable:
        """Stepper advancing adaptively from t_start to t_end: the trials of
        ``pde_tpu``'s ``while_loop``, each gated by ``active = (t < t_end) &
        ok`` so that a trial past the end changes nothing, read by the host
        once per :data:`ADAPTIVE_CHUNK` trials. ``info`` gains the dt
        statistics (``dt_statistics``), the trials run while active
        (``adaptive_trials``, accepted or not) and the host reads
        (``host_syncs``)."""
        mesh = self._get_mesh(state)
        if mesh is None:
            self._blocks = None
        else:  # the error maximum over the blocks (pde_tpu's pmax over the shards)
            from ..parallel.stepper import BlockedRun

            self._blocks = BlockedRun(mesh, self.pde, state)
            self.info["sharded_halo"] = self._blocks.halo
        estimate = self._make_single_step_error_estimate(state)
        post_hook = self._make_post_step_hook(state)
        split, combine = self._leaf_maps()
        tolerance, dt_min, dt_max = self.tolerance, self.dt_min, self.dt_max
        device = state.device
        f64 = torch.float64

        def trial(leaves, carry, t_end, post_data):
            t, dt_opt, ok, steps, trials, count, total, mn, mx = carry
            active = (t < t_end) & ok
            dt_step = torch.clamp(torch.minimum(dt_opt, t_end - t), min=dt_min)
            new_leaves, error = estimate(leaves, t, dt_step)
            error_rel = error.to(f64) / tolerance
            # a non-finite state fails the test too
            go = torch.isfinite(error_rel) & (error_rel <= 1.0) & active
            leaves = [torch.where(go, n, o) for n, o in zip(new_leaves, leaves, strict=True)]
            t = torch.where(go, t + dt_step, t)
            if post_hook is not None:
                hooked, post_new = post_hook(leaves, t, post_data)
                leaves = [torch.where(go, h, o) for h, o in zip(hooked, leaves, strict=True)]
                post_data = _gated(go, post_new, post_data)
            dt_adj = adjust_dt(dt_step, error_rel)
            carry = (
                t,
                torch.where(active, torch.clamp(dt_adj, dt_min, dt_max), dt_opt),
                torch.where(active, dt_adj >= dt_min, ok),
                steps + go,
                trials + active,
                count + go,
                total + torch.where(go, dt_step, 0.0),
                torch.where(go, torch.minimum(mn, dt_step), mn),
                torch.where(go, torch.maximum(mx, dt_step), mx),
            )
            return leaves, carry, post_data

        self.info["dt_statistics"] = OnlineStatistics()
        self.info.setdefault("adaptive_trials", 0)
        self.info.setdefault("host_syncs", 0)

        def adaptive_stepper(state_obj: FieldBase, t_start: float, t_end: float):
            leaves = split(state_obj)
            dt_init = self.info["dt"] or self.dt_default
            zero = torch.zeros((), dtype=torch.int64, device=device)
            carry = (
                torch.tensor(t_start, dtype=f64, device=device),
                torch.tensor(dt_init, dtype=f64, device=device),
                torch.ones((), dtype=torch.bool, device=device),
                zero, zero, zero,
                torch.zeros((), dtype=f64, device=device),
                torch.full((), torch.inf, dtype=f64, device=device),
                torch.full((), -torch.inf, dtype=f64, device=device),
            )
            end = torch.tensor(t_end, dtype=f64, device=device)
            post_data = self.info.get("post_step_data")
            syncs = 0
            while True:
                for _ in range(ADAPTIVE_CHUNK):
                    leaves, carry, post_data = trial(leaves, carry, end, post_data)
                syncs += 1
                if not bool((carry[0] < end) & carry[2]):
                    break
            t, dt_opt, ok, steps, trials, count, total, mn, mx = torch.stack(
                [x.to(f64) for x in carry]).tolist()
            self.info["host_syncs"] += syncs + 1
            if not ok:
                raise RuntimeError(f"Time step below dt_min={self.dt_min}")
            self.info["dt"] = dt_opt
            self.info["steps"] += int(steps)
            self.info["adaptive_trials"] += int(trials)
            if post_hook is not None:
                self.info["post_step_data"] = post_data
            self.info["dt_statistics"].add_batch(int(count), total, mn, mx)
            return combine(state_obj, leaves), t

        return adaptive_stepper

    def make_stepper(self, state: FieldBase, dt: float | None = None) -> Callable:
        """Return ``stepper(state, t_start, t_end) -> (state, t_reached)``:
        adaptive from `dt` (or ``dt_default``) where ``adaptive`` is set,
        else fixed-dt."""
        dt_float = float(dt) if dt is not None else self.dt_default
        self.info["dt"] = dt_float
        self.info["dt_adaptive"] = bool(self.adaptive)
        if self.adaptive:
            if self._backend_obj.fused_windows == "never":
                raise NotImplementedError(
                    "backend='numpy' (eager) supports fixed-dt stepping only"
                )
            if self._backend_obj.fused_windows == "require":
                raise RuntimeError(
                    "backend='cuda' has no adaptive-dt kernel path: each trial's accept "
                    "test is a global reduction (use backend='torch')"
                )
            return self._make_adaptive_stepper(state)
        return self._make_fixed_stepper(state, dt_float)


def _max_abs(differences):
    """The largest magnitude over a sequence of tensors, as a 0-d tensor on
    their device (no host read)."""
    error = None
    for diff in differences:
        value = diff.abs().amax()
        error = value if error is None else torch.maximum(error, value)
    return error


def registered_solvers() -> list[str]:
    """List of all registered solver names."""
    return sorted(k for k in SolverBase._subclasses if k[0].islower())
