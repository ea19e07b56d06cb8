"""Base classes for PDEs (deterministic and stochastic).

Port of :mod:`pde_tpu.models.base`. A PDE describes its evolution rate on the
field level; :meth:`PDEBase.make_pde_rhs` lowers it to a function on the raw
data tensors, which the solvers' plain step loop calls. :class:`SDEBase` adds
noise: :meth:`SDEBase.make_sde_noise_step` gives the Euler-Maruyama
increments, drawn from an explicit ``torch.Generator`` (the counterpart of the
JAX package's PRNG keys). Additive noise keeps its constants on the host;
a model whose ``make_noise_variance`` depends on the state (multiplicative
noise, which the Milstein solver corrects for) computes it with torch on the
leaves' device, where the noise steps use it.
"""

from __future__ import annotations

import copy
import logging
import math
from typing import Any, Callable

import numpy as np
import torch

from ..fields.base import FieldBase
from ..ops.cuda_cartesian import KernelUnsupportedError

NOISE_INTERPRETATIONS: dict[str, float] = {
    "ito": 0.0,
    "itô": 0.0,
    "stratonovich": 0.5,
    "anti-ito": 1.0,
    "anti-itô": 1.0,
    "hänggi-klimontovich": 1.0,
    "hanggi-klimontovich": 1.0,
}


def make_increment_draw() -> Callable:
    """Return ``draw(generator, out) -> out`` filling `out` with unit-variance
    noise increments drawn from a ``torch.Generator`` on `out`'s device.

    Selected by the config key ``sde.increment_dist``. Euler-Maruyama
    converges weakly (order 1) for any increment law matching the Gaussian's
    first three moments (Kloeden & Platen), so cheaper laws are admissible
    when only distributional statistics matter:

    - ``"normal"`` (default): exact N(0, 1), needed for pathwise convergence;
    - ``"irwin4"``: ``(sum of 4 uniforms - 2) * sqrt(3)``;
    - ``"rademacher"``: the two-point law +-1.
    """
    from ..utils.config import config

    dist = str(config["sde.increment_dist"])
    if dist == "normal":

        def draw(generator, out):
            return out.normal_(generator=generator)

    elif dist == "irwin4":

        def draw(generator, out):
            u = torch.rand((4, *out.shape), generator=generator, dtype=out.dtype, device=out.device)
            return torch.sum(u, dim=0, out=out).sub_(2.0).mul_(math.sqrt(3.0))

    elif dist == "rademacher":

        def draw(generator, out):
            return out.bernoulli_(0.5, generator=generator).mul_(2.0).sub_(1.0)

    else:
        raise ValueError(
            f"Unknown sde.increment_dist {dist!r} (expected 'normal', 'irwin4', or 'rademacher')"
        )
    return draw


def _host_factor(values):
    """A host constant as a Python float when it is uniform (a broadcast
    view, as variances and cell volumes are), else the array itself."""
    arr = np.asarray(values, dtype=float)
    return float(arr.flat[0]) if not any(arr.strides) else arr


def _on_leaf(factor, leaf: torch.Tensor):
    if isinstance(factor, float):
        return factor
    return torch.as_tensor(factor, dtype=leaf.dtype, device=leaf.device)


def state_leaves(state: FieldBase) -> list:
    """The raw data tensors of a field, one per field of a collection."""
    from ..fields.collection import FieldCollection

    if isinstance(state, FieldCollection):
        return [f.data for f in state]
    return [state.data]


def state_from_leaves(template: FieldBase, leaves) -> FieldBase:
    """A field (or collection) like `template` holding the given data tensors."""
    from ..fields.collection import FieldCollection

    if isinstance(template, FieldCollection):
        return template.with_data(leaves)
    (data,) = leaves
    return template.with_data(data)


def expr_prod(factor: float, expression: str) -> str:
    """Helper for building expression strings with prefactors."""
    if factor == 0:
        return "0"
    if factor == 1:
        return expression
    if factor == -1:
        return f"-{expression}"
    return f"{factor:g} * {expression}"


class PDEBase:
    """Abstract base class for partial differential equations."""

    explicit_time_dependence: bool | None = None
    complex_valued: bool = False
    use_noise_variance: bool = False
    use_noise_realization: bool = False

    def __init__(self, *, rng: np.random.Generator | None = None):
        self._logger = logging.getLogger(self.__class__.__name__)
        #: seeds the solvers' noise generators (one draw per solver)
        self.rng = np.random.default_rng(rng)
        self.diagnostics: dict[str, Any] = {}

    @property
    def is_sde(self) -> bool:
        noise = getattr(self, "noise", 0)
        has_noise = not np.allclose(np.asarray(noise, dtype=float), 0, atol=1e-14)
        return (self.use_noise_variance and has_noise) or self.use_noise_realization

    @property
    def _noise_drift_factor(self) -> float:
        return NOISE_INTERPRETATIONS[getattr(self, "noise_interpretation", "ito")]

    def evolution_rate(self, state: FieldBase, t: float = 0) -> FieldBase:
        """Evaluate the right hand side of the PDE."""
        raise NotImplementedError

    def make_post_step_hook(self, state: FieldBase):
        """Return ``(hook(leaves, t, data) -> (leaves, data), initial data)``;
        raises ``NotImplementedError`` (the default) when there is no hook."""
        raise NotImplementedError

    def _fused_rhs(self) -> tuple[str, Any]:
        """``(rhs expression, bc)`` of the expression-routed fused windows;
        raises ``NotImplementedError`` (the default) for a model without a
        one-field expression form."""
        raise NotImplementedError(
            f"{self.__class__.__name__} has no expression form for fused windows"
        )

    def stencil_depth(self, state: FieldBase) -> int | None:
        """The cells per side one rhs evaluation reads beyond a cell: the
        depth of the stencil lowering of the model's expression form
        (:meth:`_fused_rhs`), or None where there is none (the plain
        decomposed stepper then counts the operator calls of its rhs)."""
        try:
            rhs, bc = self._fused_rhs()
        except NotImplementedError:
            return None
        from .pde import PDE

        return PDE({"c": rhs}, bc=bc).stencil_depth(state)

    def make_fused_rk4_window(self, state: FieldBase, dt: float, mesh=None):
        """Fused fixed-dt RK4 window via the expression compiler (see
        :meth:`~pde_tpu_torch.models.pde.PDE.make_fused_rk4_window`), on every
        model with :meth:`_fused_rhs`; raises ``NotImplementedError`` where
        none applies (solvers then run the plain loop)."""
        if self.is_sde:
            raise KernelUnsupportedError("Deterministic RK4 windows do not support noise")
        rhs, bc = self._fused_rhs()
        return make_fused_window_via_expression(self, state, dt, rhs, bc, mesh=mesh, kind="rk4")

    def make_fused_ab2_window(self, state: FieldBase, dt: float, mesh=None):
        """Fused fixed-dt Adams-Bashforth window via the expression compiler
        (see :meth:`~pde_tpu_torch.models.pde.PDE.make_fused_ab2_window`)."""
        if self.is_sde:
            raise KernelUnsupportedError("Adams-Bashforth windows do not support noise")
        rhs, bc = self._fused_rhs()
        return make_fused_window_via_expression(self, state, dt, rhs, bc, mesh=mesh, kind="ab2")

    def make_pde_rhs(self, state: FieldBase, backend: str = "torch") -> Callable:
        """Return ``rhs(leaves, t) -> leaves`` operating on raw data tensors,
        one rate per leaf. There is one plain engine (torch); `backend` is
        accepted for API compatibility, as in ``pde_tpu``."""
        def rhs(leaves, t):
            return state_leaves(self.evolution_rate(state_from_leaves(state, leaves), t))

        return rhs

    def make_evolution_rate(self, state: FieldBase, backend: str = "torch") -> Callable:
        """Alias of :meth:`make_pde_rhs` (``pde_tpu``'s)."""
        return self.make_pde_rhs(state, backend)

    def check_rhs_consistency(self, state: FieldBase, t: float = 0, *, tol: float = 1e-7):
        """Check that the lowered rhs matches the field-level evolution rate."""
        rhs = self.make_pde_rhs(state)
        res_data = rhs(state_leaves(state), t)
        expected = state_leaves(self.evolution_rate(state, t))
        for a, b in zip(res_data, expected, strict=True):
            from ..fields.base import to_host

            np.testing.assert_allclose(
                to_host(torch.as_tensor(a)), to_host(torch.as_tensor(b)), rtol=tol, atol=tol,
                err_msg="make_pde_rhs inconsistent with evolution_rate",
            )

    def solve(
        self,
        state: FieldBase,
        t_range,
        dt: float | None = None,
        tracker="auto",
        *,
        backend: str = "auto",
        solver="euler",
        ret_info: bool = False,
        **kwargs,
    ):
        """Solve the PDE: construct solver + controller and run the time loop.

        `solver` is a registered name or a solver class (an instance raises
        ``TypeError``). Without `dt` the explicit Euler and Runge-Kutta
        solvers step adaptively. With ``ret_info=True`` the result
        is ``(state, diagnostics)``. ``gather_mode`` goes to the
        :class:`~pde_tpu_torch.solvers.Controller`; every other keyword goes
        to the solver (``decomposition=`` among them).
        """
        from ..solvers import Controller
        from ..solvers.base import SolverBase

        gather_mode = kwargs.pop("gather_mode", "all")
        if isinstance(solver, SolverBase):
            raise TypeError("`solver` must be a class or name, not an instance")
        if isinstance(solver, str):
            if solver in {"euler", "explicit", "explicit_mpi", "explicit_sharded",
                          "runge-kutta"}:
                kwargs.setdefault("adaptive", dt is None)
            solver_obj = SolverBase.from_name(solver, pde=self, backend=backend, **kwargs)
        elif callable(solver):
            solver_obj = solver(pde=self, backend=backend, **kwargs)
        else:
            raise TypeError(f"Solver {solver} is not supported")
        controller = Controller(
            solver_obj, t_range=t_range, tracker=tracker, gather_mode=gather_mode
        )
        try:
            final_state = controller.run(state, dt)
        finally:
            self.diagnostics.update(controller.diagnostics)
        if ret_info:
            return final_state, copy.deepcopy(self.diagnostics)
        return final_state


class SDEBase(PDEBase):
    """Base class for stochastic differential equations with Gaussian white
    noise (or a moment-matched increment law): additive by default,
    multiplicative where a subclass overrides :meth:`make_noise_variance`."""

    use_noise_variance: bool = True
    use_noise_realization: bool = False

    def __init__(self, *, noise=0, noise_interpretation: str = "ito",
                 rng: np.random.Generator | None = None):
        super().__init__(rng=rng)
        self.noise = np.asanyarray(noise)
        if noise_interpretation not in NOISE_INTERPRETATIONS:
            raise ValueError(
                f"Unknown noise interpretation `{noise_interpretation}`; "
                f"options: {sorted(set(NOISE_INTERPRETATIONS))}"
            )
        self.noise_interpretation = noise_interpretation

    def _host_noise_variance(self, state: FieldBase) -> list:
        """The additive noise's variance of each leaf: a host array broadcast
        to the leaf's shape (a view of ``self.noise``)."""
        from ..fields.collection import FieldCollection

        if isinstance(state, FieldCollection):
            noise_arr = np.broadcast_to(self.noise, (len(state),))
            return [np.broadcast_to(float(var), tuple(f.data.shape))
                    for var, f in zip(noise_arr, state, strict=True)]
        if self.noise.ndim > 0 and state.rank > 0:
            shape = self.noise.shape + (1,) * state.grid.num_axes
            return [np.broadcast_to(self.noise.reshape(shape), tuple(state.data.shape))]
        return [np.broadcast_to(self.noise, tuple(state.data.shape))]

    def make_noise_variance(self, state: FieldBase, *, ret_diff: bool = False) -> Callable:
        """Return ``noise_var(leaves, t) -> variances``, one tensor per leaf on
        the leaf's device and in its dtype (an expanded view of the additive
        noise); with ``ret_diff=True`` it returns ``(variances,
        derivatives)``, zero for additive noise.

        Multiplicative noise: a subclass returns variances (and their
        derivatives by the state) that depend on `leaves` and `t`, computed
        with torch on the leaves' device; the noise steps keep them there."""
        variances = [_expanded(view, leaf) for view, leaf in
                     zip(self._host_noise_variance(state), state_leaves(state), strict=True)]

        if ret_diff:
            zeros = [torch.zeros((), dtype=v.dtype, device=v.device).expand(v.shape)
                     for v in variances]

            def noise_var_diff(leaves, t):
                return variances, zeros

            return noise_var_diff

        def noise_var(leaves, t):
            return variances

        return noise_var

    def make_noise_realization(self, state: FieldBase, backend: str = "torch") -> Callable:
        """Return ``noise(leaves, t, generator) -> leaves`` for custom noise
        structures; only used when ``use_noise_realization`` is set (`backend`
        accepted for API compatibility)."""
        raise NotImplementedError

    def make_sde_noise_step(self, state: FieldBase) -> Callable:
        """Return ``noise_step(leaves, t, generator, dt, outs=None) -> increments``.

        The Euler-Maruyama noise term: ``sqrt(dt) * sqrt(var / cell_volume)``
        times unit increments of the configured law (``sde.increment_dist``,
        read here), plus the Stratonovich/anti-Itô drift term
        ``dt/2 * factor * d(var)/dc / cell_volume``. Draws come from
        `generator` in leaf order; given ``outs``, the increments are drawn
        into those tensors. A variance or derivative that is a tensor (a
        state-dependent one) is used on its leaf's device in the leaf's
        dtype; host constants (additive noise, the cell volumes) stay
        Python floats where they are uniform.
        """
        drift_factor = self._noise_drift_factor
        has_drift = drift_factor != 0
        inv_cell = 1.0 / _host_factor(state.grid.cell_volumes)
        if type(self).make_noise_variance is SDEBase.make_noise_variance:
            # additive noise: the host views, whose constants stay Python floats
            host = self._host_noise_variance(state)
            zeros = [np.broadcast_to(0.0, v.shape) for v in host]

            def noise_var(leaves, t):
                return (host, zeros) if has_drift else host

        else:
            noise_var = self.make_noise_variance(state, ret_diff=has_drift)
        draw = make_increment_draw()
        realization_fn = (
            self.make_noise_realization(state) if self.use_noise_realization else None
        )

        def noise_step(leaves, t, generator, dt, outs=None):
            if not self.use_noise_variance:
                result = [torch.zeros_like(leaf) for leaf in leaves]
            else:
                if has_drift:
                    variances, diffs = noise_var(leaves, t)
                else:
                    variances, diffs = noise_var(leaves, t), None
                result = []
                for i, (leaf, var) in enumerate(zip(leaves, variances, strict=True)):
                    out = torch.empty_like(leaf) if outs is None else outs[i]
                    scale = _noise_scale(var, inv_cell, leaf, dt)
                    inc = draw(generator, out).mul_(scale)
                    if has_drift:
                        inc = inc + _drift_term(diffs[i], inv_cell, leaf, dt, drift_factor)
                    result.append(inc)
            if realization_fn is not None:
                extra = realization_fn(leaves, t, generator)
                result = [a + math.sqrt(dt) * b for a, b in zip(result, extra, strict=True)]
            return result

        return noise_step


def _expanded(view: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """A host broadcast view as a tensor on the leaf's device in its dtype,
    its repeated axes expanded rather than copied."""
    small = view[tuple(slice(None) if stride else slice(0, 1) for stride in view.strides)]
    return torch.as_tensor(np.array(small, dtype=float), dtype=leaf.dtype,
                           device=leaf.device).expand(view.shape)


def _on_device(value, leaf: torch.Tensor) -> torch.Tensor:
    """A tensor variance or derivative on its leaf's device, in its dtype."""
    return value.to(device=leaf.device, dtype=leaf.dtype)


def _noise_scale(var, inv_cell, leaf: torch.Tensor, dt: float):
    """``sqrt(dt) * sqrt(var / cell_volume)``: a Python float or a host
    array for host variances (the fast route of additive noise), a tensor
    on the leaf's device for tensor ones."""
    if isinstance(var, torch.Tensor):
        return math.sqrt(dt) * torch.sqrt(_on_device(var, leaf) * _on_leaf(inv_cell, leaf))
    return _on_leaf(math.sqrt(dt) * np.sqrt(_host_factor(var) * inv_cell), leaf)


def _drift_term(diff, inv_cell, leaf: torch.Tensor, dt: float, drift_factor: float):
    """``dt/2 * factor * d(var)/dc / cell_volume``, routed as :func:`_noise_scale`."""
    if isinstance(diff, torch.Tensor):
        return (0.5 * dt * drift_factor) * _on_device(diff, leaf) * _on_leaf(inv_cell, leaf)
    return _on_leaf(0.5 * dt * drift_factor * _host_factor(diff) * inv_cell, leaf)


def require_fusable_noise(pde_obj) -> None:
    """Raise :class:`KernelUnsupportedError` unless the equation's noise is
    what the Euler-Maruyama kernels take: additive, scalar, Itô."""
    if (
        type(pde_obj).make_noise_variance is not SDEBase.make_noise_variance
        or pde_obj.use_noise_realization
        or pde_obj._noise_drift_factor != 0
        or np.ndim(pde_obj.noise) > 0
    ):
        raise KernelUnsupportedError(
            "Fused SDE windows take additive scalar noise in the Itô interpretation only"
        )


def make_fused_window_via_expression(pde_obj, state, dt: float, rhs_str: str, bc, mesh=None,
                                     kind: str = "euler"):
    """A fused window of the scheme `kind` (``"euler"``, ``"rk4"`` or
    ``"ab2"``) through the expression compiler's stencil lowering, for
    predefined scalar models (KPZ, stochastic diffusion, Swift-Hohenberg);
    with `mesh`, its decomposed variant.

    Additive scalar Itô noise fuses as an Euler-Maruyama window whose staged
    increments replicate the plain step loop's stream. Raises
    :class:`KernelUnsupportedError` for other noise, and for noise on a mesh.
    """
    from .pde import PDE

    kwargs = {}
    if pde_obj.is_sde:
        require_fusable_noise(pde_obj)
        kwargs["noise"] = float(pde_obj.noise)
    eq = PDE({"c": rhs_str}, bc=bc, **kwargs)
    hook = {"euler": eq.make_fused_euler_window, "rk4": eq.make_fused_rk4_window,
            "ab2": eq.make_fused_ab2_window}[kind]
    return hook(state, dt, mesh=mesh)


class EtdrkParts:
    """Spectral linear/nonlinear split consumed by the ETDRK4 solver.

    ``L_vals`` holds the linear operator's modal values (host numpy, float64):
    shape ``spectral_shape`` for a single field, or ``(*spectral_shape, N,
    N)`` for an N-field coupled system (per-mode coupling matrices).
    ``axis_kinds`` names the diagonalizing transform per grid axis:
    ``"periodic"`` (rfft), ``"neumann"`` (DCT-II), or ``"dirichlet"``
    (DST-II). ``nonlinear_pde`` is the PDE of the remainder (``nonlinear_rhs``
    is its plain rhs), which decomposed runs evaluate over the blocks.
    Iterating yields ``(L_vals, nonlinear_rhs)`` so the two-tuple contract
    keeps working.
    """

    def __init__(self, L_vals, nonlinear_rhs, axis_kinds=None, n_fields=1, nonlinear_pde=None):
        self.L_vals = L_vals
        self.nonlinear_rhs = nonlinear_rhs
        self.axis_kinds = axis_kinds
        self.n_fields = n_fields
        self.nonlinear_pde = nonlinear_pde

    def __iter__(self):
        return iter((self.L_vals, self.nonlinear_rhs))


def make_etdrk_parts_via_expression(pde_obj, state, rhs_str: str, bc, rhs_state=None):
    """ETDRK spectral split for predefined scalar classes, routed through the
    expression compiler (see `PDE.make_etdrk_parts`)."""
    from .pde import PDE

    if getattr(pde_obj, "is_sde", False):
        raise NotImplementedError("ETDRK4 is deterministic; disable the noise")
    eq = PDE({"c": rhs_str}, bc=bc)
    return eq.make_etdrk_parts(state, rhs_state=rhs_state)
