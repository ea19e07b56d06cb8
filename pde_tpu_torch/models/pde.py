"""PDEs defined by mathematical expressions.

Port of :mod:`pde_tpu.models.pde` for equations of scalar and vector fields,
with optional additive noise. Expressions like ``PDE({"c": "laplace(c**3 - c - laplace(c))"})`` are
parsed once by sympy; differential operators are resolved against the grid's
operator registry with per-(variable, operator) boundary-condition routing,
and each rate lowers with ``sympy.lambdify`` to plain PyTorch operators (the
plain path). On 2D and 3D Cartesian grids the fixed-dt Euler window lowers
the same sympy tree through stencil helpers into one generated CUDA kernel
(:mod:`pde_tpu_torch.ops.cuda_stencil_2d`,
:mod:`pde_tpu_torch.ops.cuda_stencil_3d`) advancing all fields by several
steps per pass over device memory; a vector field enters that kernel as
its component planes. With noise on a 2D grid (scalar fields), one of the
Euler-Maruyama kernels of :mod:`pde_tpu_torch.ops.cuda_sde_2d`.
"""

from __future__ import annotations

import keyword
import numbers
import re
from typing import Any, Callable

import numpy as np
import sympy
import torch

from ..fields.base import FieldBase
from ..fields.collection import FieldCollection
from ..fields.datafield_base import DataFieldBase
from ..fields.vectorial import vector_dot, vector_outer
from ..grids.boundaries import set_default_bc
from ..ops.cuda_cartesian import KernelUnsupportedError
from .base import SDEBase, require_fusable_noise

# Shorthand notations expanded before parsing
_EXPRESSION_REPLACEMENT: dict[str, str] = {
    r"\|\s*∇\s*(\w+)\s*\|(²|\*\*2)": r"gradient_squared(\1)",
    r"∇(²|\*\*2)\s*(\w+)": r"laplace(\2)",
    r"∇(²|\*\*2)\s*\(": r"laplace(",
    r"²": r"**2",
    r"³": r"**3",
    # normalize to the sympy spelling so it is not mistaken for an operator
    r"\bheaviside\(": r"Heaviside(",
}

_SPECIAL_OPERATORS = {"dot", "inner", "outer", "integral"}

#: the linear operators with a Fourier symbol (the keys of ``pde_tpu``'s
#: ``_OPERATOR_FOURIER_MAPPING``), which the spectral split distributes over sums
_FOURIER_LINEAR_OPERATORS = frozenset({"laplace", "gradient", "divergence"})


def _corner_weight() -> float:
    from ..utils.config import config

    return float(config["operators.cartesian.laplacian_2d_corner_weight"])


def require_default_laplace_stencil() -> None:
    """Raise :class:`KernelUnsupportedError` when the 9-point corner-weight
    Laplacian is configured: the stencil kernels lower the 5-point form only."""
    if _corner_weight() != 0:
        raise KernelUnsupportedError(
            "The multi-field kernels implement the 5-point Laplacian only; under a corner "
            "weight the plain loop runs, as pde_tpu's gate (pde_tpu/ops/pallas_cartesian.py:"
            "51-63, called at pde_tpu/models/pde.py:750-762 and "
            "pde_tpu/models/cahn_hilliard.py:57-63)"
        )


def _cell_coords(grid, like: torch.Tensor) -> list[torch.Tensor]:
    """Cell-centre coordinate arrays of a Cartesian grid, on `like`'s device."""
    coords = []
    for axis, values in enumerate(grid.axes_coords):
        shape = [1] * grid.num_axes
        shape[axis] = len(values)
        arr = torch.as_tensor(values, dtype=like.dtype, device=like.device).reshape(shape)
        coords.append(torch.broadcast_to(arr, tuple(grid.shape)))
    return coords


def side_inputs_for(grid, bc_table: dict, *, offsets=(0.0,)):
    """The :class:`~pde_tpu_torch.ops.cuda_stencil_2d.SideInputs` of a
    window (2D: serial, deterministic or Euler-Maruyama, or decomposed; 3D:
    serial or decomposed, whose blocks read the global grid's tables) whose
    ghosts read per-point (per-face) or time-dependent BC values
    (``bc_table``: the affine specs of each operator), None where every
    value is a constant scalar (``pde_tpu``'s ``collect_bc_side_inputs``, or
    ``collect_bc_side_inputs_3d`` on a 3D grid, returns None)."""
    from ..ops.cuda_cartesian import collect_bc_side_inputs, collect_bc_side_inputs_3d
    from ..ops.cuda_stencil_2d import SideInputs

    collect = collect_bc_side_inputs_3d if grid.num_axes == 3 else collect_bc_side_inputs
    if collect(bc_table) is None:
        return None
    return SideInputs(grid, offsets)


def _wrap_vector_planes(window, slots):
    """Adapt a plane-list fused window to state leaves of mixed rank.

    The multi-field kernels advance a flat list of planes; a vector leaf is
    one ``(dim, *grid.shape)`` tensor, and its slot the tuple of its plane
    indices. Vector leaves enter the window as their component planes and
    leave it restacked; the window's attributes are carried over.
    """

    def wrapped(datas, steps):
        planes = []
        for data, slot in zip(datas, slots, strict=True):
            if isinstance(slot, tuple):
                planes.extend(data[j] for j in range(len(slot)))
            else:
                planes.append(data)
        out = window(planes, steps)
        result = []
        for slot in slots:
            if isinstance(slot, tuple):
                result.append(torch.stack([out[p] for p in slot]))
            else:
                result.append(out[slot])
        return result

    for attr in ("multi_field", "n_aux", "specs", "program"):
        if hasattr(window, attr):
            setattr(wrapped, attr, getattr(window, attr))
    return wrapped


#: the operators whose cylindrical forms the multi-field kernel's radial helpers
#: model (``pde_tpu``'s gate, ``models/pde.py``)
CYLINDRICAL_FUSED_OPERATORS = frozenset(
    {"laplace", "gradient_squared", "gradient", "divergence", "dot", "inner"})


class PDE(SDEBase):
    """A partial differential equation defined by expression strings."""

    default_bc = "auto_periodic_neumann"

    #: pointwise sympy functions the stencil lowering knows how to emit
    _POINTWISE_FUNCS = {
        "sin": "sin", "cos": "cos", "tan": "tan", "exp": "exp", "log": "log",
        "sqrt": "sqrt", "tanh": "tanh", "sinh": "sinh", "cosh": "cosh", "Abs": "abs",
    }

    def __init__(
        self,
        rhs: dict[str, str],
        *,
        bc=None,
        bc_ops: dict[str, Any] | None = None,
        post_step_hook: Callable | None = None,
        user_funcs: dict[str, Callable] | None = None,
        consts: dict[str, Any] | None = None,
        noise=0,
        noise_interpretation: str = "ito",
        rng: np.random.Generator | None = None,
    ):
        from sympy.core.function import AppliedUndef

        from ..utils.expressions import ScalarExpression

        if isinstance(noise, dict):
            noise = np.array([noise.get(var, 0) for var in rhs])
        if hasattr(noise, "__iter__") and len(noise) != len(rhs):
            raise ValueError("Number of noise strengths does not match field count")
        super().__init__(noise=noise, noise_interpretation=noise_interpretation, rng=rng)

        rhs = dict(rhs)
        for name in rhs:
            self._check_identifier(name)
        self.consts = dict(consts or {})
        self.user_funcs = dict(user_funcs or {})

        self._rhs_expr: dict[str, ScalarExpression] = {}
        self._operators: dict[str, set[str]] = {}
        explicit_time_dependence = False
        complex_valued = False
        for var, rhs_item in rhs.items():
            if isinstance(rhs_item, str):
                for search, repl in _EXPRESSION_REPLACEMENT.items():
                    rhs_item = re.sub(search, repl, rhs_item)
            expr = ScalarExpression(
                rhs_item,
                signature=None,
                user_funcs=self.user_funcs,
                consts=dict.fromkeys(self.consts, 0),
                explicit_symbols=list(rhs.keys()) + ["t"],
            )
            explicit_time_dependence |= expr.depends_on_variable("t")
            complex_valued |= expr.complex
            self._operators[var] = {
                func.__class__.__name__
                for func in expr._sympy_expr.atoms(AppliedUndef)
                if func.__class__.__name__ not in self.user_funcs
            }
            self._rhs_expr[var] = expr

        self.rhs = rhs
        self.variables = tuple(rhs.keys())
        self.explicit_time_dependence = explicit_time_dependence
        self.complex_valued = complex_valued
        self.post_step_hook = post_step_hook

        # boundary condition routing table "var:op" -> bc
        bc = set_default_bc(bc, self.default_bc)
        if bc_ops is None:
            bcs = {"*:*": bc}
        elif isinstance(bc_ops, dict):
            bcs = dict(bc_ops)
            bcs["*:*"] = bc
        else:
            raise TypeError("`bc_ops` must be a dictionary")
        self.bcs: dict[str, Any] = {}
        for key_str, value in bcs.items():
            parts = re.split(r"\.|:", key_str)
            if len(parts) == 1:
                key = f"{self.variables[0]}:{key_str}" if self.variables else key_str
            elif len(parts) == 2:
                key = ":".join(parts)
            else:
                raise ValueError(f'Cannot parse boundary condition "{key_str}"')
            self.bcs[key] = value

        self.diagnostics["pde"] = {
            "variables": list(self.variables),
            "constants": sorted(self.consts),
            "explicit_time_dependence": explicit_time_dependence,
            "complex_valued_rhs": complex_valued,
            "operators": sorted(set().union(*self._operators.values())),
            "bcs_used": set(),
        }
        self._cache: dict[Any, dict[str, Any]] = {}

    @staticmethod
    def _check_identifier(name: str) -> None:
        if not name.isidentifier():
            raise ValueError(f"`{name}` is not a valid field name")
        if keyword.iskeyword(name):
            raise ValueError(f"`{name}` is a keyword and cannot be a field name")
        if name == "t":
            raise ValueError("Cannot name a field `t` since it denotes time")

    @property
    def expressions(self) -> dict[str, str]:
        """The (expanded) expressions of the PDE."""
        return {k: v.expression for k, v in self._rhs_expr.items()}

    @property
    def expression(self) -> str:
        return "; ".join(f"d{k}/dt = {v}" for k, v in self.expressions.items())

    # -- boundary condition routing ------------------------------------------------------
    def _resolve_bc(self, var: str, func: str):
        for bc_key, bc in self.bcs.items():
            bc_var, bc_func = bc_key.split(":")
            if bc_var in (var, "*") and bc_func in (func, "*"):
                self.diagnostics["pde"]["bcs_used"].add(bc_key)
                return bc
        raise RuntimeError(
            f"Could not find a boundary condition for operator `{func}` in the "
            f"equation for `{var}`"
        )

    # -- compilation of the plain path ---------------------------------------------------
    def _compile_rhs_single(self, var: str, ops: dict[str, Callable], state: FieldBase):
        """Compile the rhs function of one variable to torch operations."""
        from sympy.core.function import UndefinedFunction

        from ..utils.expressions import _get_torch_modules

        expr = self._rhs_expr[var].copy()
        grid = state.grid

        # resolve differential operators with their boundary conditions
        for func in self._operators[var]:
            if func in ops:
                continue
            op = grid.make_operator(func, bc=self._resolve_bc(var, func))
            ops[func] = (lambda _op: lambda arr, t: _op(arr, t, None))(op)

        # `f(args)` -> `f(args, t)` for differential operators, so that
        # time-dependent boundary conditions could receive the current time
        t_sym = sympy.Symbol("t")
        for func in self._operators[var] - _SPECIAL_OPERATORS:
            expr._sympy_expr = expr._sympy_expr.replace(
                lambda e, _name=func: (
                    isinstance(e.func, UndefinedFunction)
                    and e.func.__name__ == _name
                    and not (len(e.args) > 1 and e.args[-1] == t_sym)
                ),
                lambda application: application.func(*application.args, t_sym),
            )

        signature: list[str] = list(self.variables) + ["t"]
        needs_coords = any(expr.depends_on_variable(c) for c in grid.axes)
        if needs_coords:
            signature += list(grid.axes)

        # separate scalar and field-valued constants
        scalar_consts = {}
        const_args: list = []
        const_names: list[str] = []
        # a decomposed block's view takes its cells of a field constant
        mesh = getattr(grid, "mesh", None)
        for name, value in self.consts.items():
            if isinstance(value, DataFieldBase):
                if mesh is None:
                    value.grid.assert_grid_compatible(grid)
                    const_args.append(value.data)
                else:
                    value.grid.assert_grid_compatible(mesh.basegrid)
                    const_args.append(grid.restrict(value.data))
                const_names.append(name)
            elif np.isscalar(value) or isinstance(value, numbers.Number):
                scalar_consts[name] = value
            elif isinstance(value, np.ndarray):
                const_names.append(name)
                if mesh is not None and value.shape[value.ndim - grid.num_axes:] == tuple(
                        mesh.basegrid.shape):
                    value = grid.restrict(value)
                const_args.append(torch.as_tensor(value))
            else:
                raise TypeError(f"Constant `{name}` has unsupported type {type(value)}")
        signature += const_names

        sympy_expr = expr._sympy_expr
        if scalar_consts:
            sympy_expr = sympy_expr.subs({sympy.Symbol(k): v for k, v in scalar_consts.items()})
        unknown = {str(s) for s in sympy_expr.free_symbols} - set(signature)
        if unknown:
            raise RuntimeError(f"Undefined variables in expression: {sorted(unknown)}")

        modules = [dict(ops), self.user_funcs, *_get_torch_modules()]
        func_inner = sympy.lambdify(
            [sympy.Symbol(v) for v in signature], sympy_expr, modules=modules
        )
        var_index = list(self.variables).index(var)

        def rhs_func(field_data: tuple, t):
            like = field_data[var_index]
            coord_args = _cell_coords(grid, like) if needs_coords else ()
            consts = [c.to(device=like.device) for c in const_args]
            result = func_inner(*field_data, t, *coord_args, *consts)
            # constant expressions (e.g. "0") must still fill the field shape
            result = torch.as_tensor(result, dtype=like.dtype, device=like.device)
            return torch.broadcast_to(result, like.shape)

        return rhs_func

    def _prepare_cache(self, state: FieldBase) -> dict[str, Any]:
        """Compile all rhs functions for a given state (cached)."""
        n_state = len(state) if isinstance(state, FieldCollection) else 1
        key = (state.grid, type(state).__name__, n_state)
        cache = self._cache.get(key)
        if cache is not None:
            return cache

        if isinstance(state, FieldCollection):
            if len(self.variables) != len(state):
                raise ValueError(
                    f"Expected {len(self.variables)} fields in state, got {len(state)}"
                )
        elif isinstance(state, DataFieldBase):
            if len(self.variables) != 1:
                raise ValueError(f"Expected {len(self.variables)} fields in state, got one")
        else:
            raise TypeError(f"Unknown state class {state.__class__.__name__}")
        if set(self.rhs) & set(state.grid.axes):
            raise ValueError("Field names cannot coincide with grid axes")

        operators = set().union(*self._operators.values())
        ops_general: dict[str, Callable] = {}
        if "dot" in operators or "inner" in operators:
            ops_general["dot"] = ops_general["inner"] = vector_dot
        if "outer" in operators:
            ops_general["outer"] = vector_outer
        if "integral" in operators:
            grid = state.grid
            ops_general["integral"] = lambda arr: grid.integrate(arr)

        rhs_funcs = [
            self._compile_rhs_single(var, ops_general.copy(), state) for var in self.variables
        ]
        cache = {"rhs_funcs": rhs_funcs}
        self._cache[key] = cache
        return cache

    def make_pde_rhs(self, state: FieldBase, backend: str = "torch") -> Callable:
        """Plain rhs on raw data leaves: ``rhs(leaves, t) -> leaves`` (`backend`
        accepted for API compatibility, as in ``pde_tpu``)."""
        rhs_funcs = self._prepare_cache(state)["rhs_funcs"]

        def rhs(leaves, t):
            data = tuple(leaves)
            return [f(data, t) for f in rhs_funcs]

        return rhs

    def evolution_rate(self, state: FieldBase, t: float = 0.0) -> FieldBase:
        rhs_funcs = self._prepare_cache(state)["rhs_funcs"]
        if isinstance(state, DataFieldBase):
            data = rhs_funcs[0]((state.data,), t)
            return state.__class__(state.grid, data=data, label="evolution rate")
        data_tuple = tuple(f.data for f in state)
        fields = [
            field.__class__(field.grid, data=rhs_funcs[i](data_tuple, t), label=field.label)
            for i, field in enumerate(state)
        ]
        return FieldCollection(fields)

    def make_post_step_hook(self, state: FieldBase):
        """Return ``(hook(leaves, t, data) -> (leaves, data), initial data)``."""
        if self.post_step_hook is None:
            raise NotImplementedError("`post_step_hook` not set")
        hook = self.post_step_hook
        is_collection = isinstance(state, FieldCollection)

        def post_step_hook(leaves, t, data):
            if is_collection:
                return list(hook(list(leaves), t)), data
            return [hook(leaves[0], t)], data

        return post_step_hook, 0.0

    # -- the stencil lowering ------------------------------------------------------------
    def _lower_stencil_expr(self, expr, var_map, helpers, get_bc=None, vector_components=None):
        """Recursively lower a sympy rhs through stencil helpers.

        ``var_map`` maps field symbols to plane indices: an int for a scalar
        field, a tuple of plane indices for a vector field (one plane per
        component). Returns ``(fn, depth)`` where ``fn(works)`` produces the
        value on the work planes shrunk by `depth` cells per side (as the
        helpers define shrinking). Supported: field symbols, numbers,
        Add/Mul/Pow, the pointwise functions of ``_POINTWISE_FUNCS``, and
        ``laplace``, ``vector_laplace``, ``gradient_squared``, ``gradient``,
        ``divergence`` and ``dot``/``inner``, arbitrarily composed (each
        derivative consumes one halo cell per side; vector intermediates are
        component tuples).

        With ``vector_components`` set the rhs belongs to a vector variable:
        ``fn`` returns a component tuple of that length (a scalar-valued rhs
        is replicated across the components, as the plain path broadcasts
        it to the field's shape).
        """
        from sympy.core.function import AppliedUndef

        if get_bc is None:
            get_bc = lambda op_name: None  # noqa: E731
        trim = helpers.trim

        def lower(e):
            """Returns (fn, depth, is_vector)."""
            if e in var_map:
                index = var_map[e]
                if isinstance(index, tuple):  # a vector field: its component planes
                    return (lambda ws, _i=index: tuple(ws[j] for j in _i)), 0, True
                return (lambda ws, _i=index: ws[_i]), 0, False
            if e.is_Number:
                if not e.is_real:
                    raise NotImplementedError("complex coefficients unsupported")
                value = float(e)
                return (lambda ws: value), 0, False
            if isinstance(e, AppliedUndef):
                name = e.func.__name__
                if name in ("laplace", "gradient_squared") and len(e.args) == 1:
                    fn, d, vec = lower(e.args[0])
                    if vec and name == "laplace":
                        raise NotImplementedError(
                            "`laplace` takes a scalar; use `vector_laplace` for vector arguments"
                        )
                    if vec:
                        raise NotImplementedError(f"`{name}` takes a scalar")
                    bc = get_bc(name)
                    op = helpers.lap if name == "laplace" else helpers.gradient_squared
                    return (lambda ws, _fn=fn, _op=op: _op(_fn(ws), bc=bc)), d + 1, False
                if name == "vector_laplace" and len(e.args) == 1:
                    # component-wise, as on Cartesian grids (the only ones ported)
                    fn, d, vec = lower(e.args[0])
                    if not vec:
                        raise NotImplementedError("`vector_laplace` needs a vector argument")
                    bc = get_bc(name)

                    def vlap_fn(ws, _fn=fn, _bc=bc):
                        return tuple(helpers.lap(c, bc=_bc) for c in _fn(ws))

                    return vlap_fn, d + 1, True
                if name == "gradient" and len(e.args) == 1:
                    fn, d, vec = lower(e.args[0])
                    if vec:
                        raise NotImplementedError("gradient of vector unsupported")
                    bc = get_bc("gradient")

                    def grad_fn(ws, _fn=fn, _bc=bc):
                        value = _fn(ws)
                        return tuple(dv(value, bc=_bc) for dv in helpers.derivatives)

                    return grad_fn, d + 1, True
                if name == "divergence" and len(e.args) == 1:
                    fn, d, vec = lower(e.args[0])
                    if not vec:
                        raise NotImplementedError("divergence needs a vector")
                    bc = get_bc("divergence")
                    return (lambda ws, _fn=fn: helpers.divergence(_fn(ws), bc=bc)), d + 1, False
                if name in ("dot", "inner") and len(e.args) == 2:
                    fa, da, va = lower(e.args[0])
                    fb, db, vb = lower(e.args[1])
                    if not (va and vb):
                        raise NotImplementedError("dot needs two vectors")
                    depth = max(da, db)

                    def dot_fn(ws, _fa=fa, _fb=fb, _ea=depth - da, _eb=depth - db):
                        total = None
                        for av, bv in zip(trim(_fa(ws), _ea), trim(_fb(ws), _eb), strict=True):
                            term = av * bv
                            total = term if total is None else total + term
                        return total

                    return dot_fn, depth, False
                raise NotImplementedError(f"operator `{name}` has no stencil lowering")
            if isinstance(e, (sympy.Add, sympy.Mul)):
                parts = [lower(a) for a in e.args]
                depth = max(d for _, d, _v in parts)
                n_vec = sum(v for _, _d, v in parts)
                fns = [(fn, depth - d, v) for fn, d, v in parts]
                if isinstance(e, sympy.Add):
                    if n_vec not in (0, len(parts)):
                        raise NotImplementedError("cannot add scalar and vector")

                    def added(ws, _fns=fns, _vec=n_vec > 0):
                        total = None
                        for fn, extra, _v in _fns:
                            value = trim(fn(ws), extra)
                            if total is None:
                                total = value
                            elif _vec:
                                total = tuple(a + b for a, b in zip(total, value))
                            else:
                                total = total + value
                        return total

                    return added, depth, n_vec > 0
                if n_vec > 1:
                    raise NotImplementedError("product of vectors (use dot)")

                def multiplied(ws, _fns=fns):
                    total = None
                    vec_value = None
                    for fn, extra, v in _fns:
                        value = trim(fn(ws), extra)
                        if v:
                            vec_value = value
                        elif total is None:
                            total = value
                        else:
                            total = total * value
                    if vec_value is not None:
                        return vec_value if total is None else tuple(total * c for c in vec_value)
                    return total

                return multiplied, depth, n_vec > 0
            if isinstance(e, sympy.Pow):
                base_fn, d, vec = lower(e.args[0])
                if vec:
                    raise NotImplementedError("power of a vector")
                if not e.args[1].is_Number or not e.args[1].is_real:
                    raise NotImplementedError("unsupported exponent")
                exponent = float(e.args[1])
                if exponent == int(exponent) and 0 < exponent <= 4:
                    n = int(exponent)

                    def powered(ws, _fn=base_fn, _n=n):
                        value = _fn(ws)
                        result = value
                        for _ in range(_n - 1):
                            result = result * value
                        return result

                    return powered, d, False
                return (lambda ws: base_fn(ws) ** exponent), d, False
            if isinstance(e, sympy.Function) and type(e).__name__ in self._POINTWISE_FUNCS:
                fn, d, vec = lower(e.args[0])
                if vec:
                    raise NotImplementedError("pointwise function of a vector")
                fname = self._POINTWISE_FUNCS[type(e).__name__]
                return (lambda ws: helpers.pointwise(fname, fn(ws))), d, False
            raise NotImplementedError(f"no stencil lowering for `{e}`")

        fn, depth, vec = lower(expr)
        if vector_components is None:
            if vec:
                raise NotImplementedError("rhs must be a scalar expression")
            return fn, depth
        if vec:
            return fn, depth
        return (lambda ws, _fn=fn, _n=vector_components: (_fn(ws),) * _n), depth

    def _fused_stencil_lowering(self, state: FieldBase):
        """The gates of the fused window and the expression lowering.

        Returns ``(fields, grid, exprs, var_map, depth, make_get_bc,
        bc_table)``, the last the affine specs of each ``(variable,
        operator)``; raises :class:`KernelUnsupportedError` (a
        ``NotImplementedError``) where the configuration cannot fuse, before
        anything is built.
        """
        from ..grids.boundaries.axes import BoundariesList
        from ..grids.cartesian import CartesianGrid
        from ..grids.cylindrical import CylindricalSymGrid
        from ..ops.cuda_cartesian import affine_bc_specs, collect_bc_side_inputs

        if self.post_step_hook is not None or self.consts or self.user_funcs:
            raise KernelUnsupportedError(
                "Fused window unsupported for a PDE with consts, user functions or a "
                "post-step hook (they keep the plain path)"
            )
        if isinstance(state, FieldCollection):
            fields = list(state)
        elif isinstance(state, DataFieldBase):
            fields = [state]
        else:
            raise KernelUnsupportedError("Fused window unsupported for this state")
        if len(fields) != len(self.variables) or any(f.rank not in (0, 1) for f in fields):
            raise KernelUnsupportedError("Fused window requires scalar or vector fields")
        if len({f.dtype for f in fields}) != 1:
            raise KernelUnsupportedError("Fused window requires uniform dtypes")
        grid = fields[0].grid
        cylindrical = isinstance(grid, CylindricalSymGrid)
        if not (cylindrical or isinstance(grid, CartesianGrid)) or grid.num_axes not in (2, 3):
            raise KernelUnsupportedError(
                "The multi-field kernel requires a 2D or 3D CartesianGrid or a "
                "CylindricalSymGrid (polar and spherical grids run the plain loop, as in pde_tpu)"
            )
        used = set().union(*(self._operators[v] for v in self.variables))
        if cylindrical:
            # the kernel's radial helpers model the cylindrical Laplacian, the
            # gradient (no radial term in its r and z components) and the
            # divergence (its v_r / r); as in pde_tpu, nothing else fuses there
            unsafe = used - CYLINDRICAL_FUSED_OPERATORS
            if unsafe:
                raise KernelUnsupportedError(
                    "Fused windows on cylindrical grids take only "
                    f"{sorted(CYLINDRICAL_FUSED_OPERATORS)} (got {sorted(unsafe)}), as in pde_tpu")
            if any(f.rank == 1 for f in fields):
                raise KernelUnsupportedError(
                    "Fused vector windows require Cartesian grids (the cylindrical vector "
                    "components couple through r), as in pde_tpu")
        elif grid.num_axes == 2 and used & {"laplace", "vector_laplace"}:
            # the key alters the 2D Cartesian stencil only; the plain vector
            # Laplacian follows it too
            require_default_laplace_stencil()
        if any(f.rank == 1 for f in fields) and self.is_sde:
            raise KernelUnsupportedError("Fused vector windows do not support noise")

        # plane layout: a vector field occupies grid.dim consecutive planes
        var_map: dict = {}
        position = 0
        for var, field in zip(self.variables, fields, strict=True):
            if field.rank == 0:
                var_map[sympy.Symbol(var)] = position
                position += 1
            else:
                var_map[sympy.Symbol(var)] = tuple(range(position, position + grid.dim))
                position += grid.dim
        exprs = []
        bc_table: dict[tuple[str, str], object] = {}
        for var, field in zip(self.variables, fields, strict=True):
            expr = sympy.expand(self._rhs_expr[var]._sympy_expr)
            if expr.has(sympy.Symbol("t")) or any(expr.has(sympy.Symbol(ax)) for ax in grid.axes):
                raise KernelUnsupportedError("Fused window requires an autonomous rhs")
            # every stencil operator needs periodic or affine BCs, which lower into
            # the kernel as ghost values of the operand (their per-point and
            # time-dependent parts as side inputs, see side_inputs_for)
            for func in self._operators[var]:
                bcs = grid.get_boundary_conditions(self._resolve_bc(var, func))
                if not isinstance(bcs, BoundariesList):
                    raise KernelUnsupportedError("Fused window requires per-axis BCs")
                if field.rank and any(type(side).normal for pair in bcs for side in pair):
                    raise KernelUnsupportedError(
                        "Fused vector windows apply one condition to every component "
                        "plane; normal conditions keep the plain path"
                    )
                specs = bc_table[(var, func)] = affine_bc_specs(grid, bcs)
                if field.rank == 1 and collect_bc_side_inputs({0: specs}) is not None:
                    # a per-boundary-point array on a vector state is ambiguous
                    # between "per component" and "along the boundary"
                    raise KernelUnsupportedError("Fused vector windows require scalar BC values")
            exprs.append(expr)

        def make_get_bc(var):
            return lambda op_name: bc_table.get((var, op_name))

        # probe the lowering once (host side) to find the stencil depth
        class _Probe:
            lap = gradient_squared = d_row = staticmethod(lambda x, bc=None: x)
            derivatives = (d_row,) * grid.num_axes
            divergence = staticmethod(lambda comps, bc=None: comps[0])
            trim = staticmethod(lambda x, amount: x)
            pointwise = staticmethod(lambda name, x: x)

        try:
            depth = max(
                self._lower_stencil_expr(
                    e, var_map, _Probe, vector_components=grid.dim if f.rank else None
                )[1]
                for e, f in zip(exprs, fields, strict=True)
            )
        except NotImplementedError as err:
            raise KernelUnsupportedError(str(err)) from err
        if depth == 0:
            raise KernelUnsupportedError("The rhs has no stencil operator (depth 0)")
        return fields, grid, exprs, var_map, depth, make_get_bc, bc_table

    def stencil_depth(self, state: FieldBase) -> int | None:
        """The depth of the stencil lowering (``_fused_stencil_lowering``), or
        None where the rhs does not lower."""
        try:
            return self._fused_stencil_lowering(state)[4]
        except NotImplementedError:
            return None

    def _sde_kernel_noise_spec(self, grid, dt: float) -> dict | None:
        """``{"dist", "scale"}`` of in-kernel increments for the fused SDE
        window, or None when the increments are staged.

        In the kernel when config ``sde.kernel_noise`` is ``"on"``, or
        ``"auto"`` (default) with a cheap weak law (``sde.increment_dist``
        ``irwin4`` or ``rademacher``); exact Gaussian increments under
        ``"auto"`` are staged from torch's generator, the plain loop's stream.
        The scale ``sqrt(dt * var / cell_volume)`` is the plain step's.
        """
        from ..grids.cartesian import CartesianGrid
        from ..utils.config import config

        mode = str(config["sde.kernel_noise"])
        dist = str(config["sde.increment_dist"])
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"Unknown sde.kernel_noise {mode!r} (expected 'auto', 'on' or 'off')")
        if mode == "off" or np.ndim(self.noise) > 0:
            return None
        if mode == "auto" and dist == "normal":
            return None
        if not isinstance(grid, CartesianGrid) or grid.num_axes != 2:
            return None
        var = float(self.noise)
        cell_vol = float(np.prod(grid.discretization))
        return {"dist": dist, "scale": float(np.sqrt(dt * var / cell_vol))}

    def make_fused_euler_window(self, state: FieldBase, dt: float, mesh=None):
        """Fused Euler window through the generated multi-field CUDA kernel.

        Returns ``window(datas, steps) -> datas`` over one leaf per variable
        (``window.multi_field`` is True); a vector field's leaf advances as
        its ``grid.dim`` component planes. With noise, the Euler-Maruyama
        window ``window(data, window_seed, steps) -> data`` of one field
        (``window.needs_key`` is True), through kernel ``sde_stencil_2d``
        (staged increments) or ``sde_kernel_noise_2d`` (increments drawn in
        the kernel), as :meth:`_sde_kernel_noise_spec` routes. Raises
        :class:`~pde_tpu_torch.ops.KernelUnsupportedError` (a
        ``NotImplementedError``) for configurations the kernels do not take;
        solvers then use the plain step loop.

        With `mesh` (a :class:`~pde_tpu_torch.parallel.GridMesh`), the
        decomposed window ``window(blocks, steps) -> blocks`` through the
        generated ext kernel ``multi_stencil_ext_2d`` or
        ``multi_stencil_ext_3d``, for scalar fields on 2D and 3D grids without
        noise (the gates of ``pde_tpu``'s sharded windows; the ``torch``
        engine runs vector states and noise on a mesh through the plain
        sharded stepper, as ``pde_tpu`` does).
        """
        if self.is_sde:
            if len(self.variables) != 1:
                raise KernelUnsupportedError("Fused SDE windows advance one field")
            require_fusable_noise(self)
        return self._emit_fused_window(state, dt, kind="euler", mesh=mesh)

    def make_fused_rk4_window(self, state: FieldBase, dt: float, mesh=None):
        """Fused window of classic fixed-dt RK4 steps through the generated
        multi-field kernel of the grid's rank: the four rhs stages of each of
        k steps per pass. The lowering is the Euler window's; a step takes
        ``4 * depth`` halo cells per side (one rhs per stage), so the 2D
        ladder tops at k = 2 for a one-deep rhs and k = 1 for a two-deep one,
        and the 3D one at k = 1; a two-deep 3D step, whose rings fit no plan
        whole, is cut at its RK stages (the ``ops.bind_stage`` marks) into
        four passes of the rhs's depth (``StencilProgram3D.passes`` of
        :mod:`~pde_tpu_torch.ops.cuda_stencil_3d`), and a three-deep one
        likewise in fp32, fp64 raising by name as ``pde_tpu`` refuses it.
        Deterministic only. With `mesh`, the decomposed window through the
        ext kernels, as :meth:`make_fused_euler_window` gives it. Raises
        :class:`~pde_tpu_torch.ops.KernelUnsupportedError` where the kernels
        do not apply, as :meth:`make_fused_euler_window` does.
        """
        if self.is_sde:
            raise KernelUnsupportedError("Deterministic RK4 windows do not support noise")
        return self._emit_fused_window(state, dt, kind="rk4", mesh=mesh)

    def make_fused_ab2_window(self, state: FieldBase, dt: float, mesh=None):
        """Fused window of fixed-dt second-order Adams-Bashforth steps: the
        previous rates ride as extra planes of the generated kernel, which no
        stencil reads, so a step takes ``depth`` halo cells (Euler's ladder).
        ``window(planes + rates, steps) -> planes + rates`` carries
        ``n_aux`` = one rate plane per field plane; the solver bootstraps and
        keeps them. Scalar fields only (as in ``pde_tpu``); deterministic
        only. With `mesh`, the ext kernels' window of the same ``2n`` planes,
        whose rate planes the solver splits into blocks.
        """
        if self.is_sde:
            raise KernelUnsupportedError("Adams-Bashforth windows do not support noise")
        return self._emit_fused_window(state, dt, kind="ab2", mesh=mesh)

    def _emit_fused_window(self, state: FieldBase, dt: float, *, kind: str, mesh=None):
        """The fused window of the scheme `kind`: ``"euler"`` (and
        Euler-Maruyama), ``"rk4"`` or ``"ab2"``, from one stencil lowering."""
        from ..ops.cuda_sde_2d import make_chunked_sde_window_2d
        from ..ops.cuda_stencil_3d import make_chunked_multi_window

        if kind not in ("euler", "rk4", "ab2"):
            raise ValueError(f"Unknown window kind `{kind}`")
        fields, grid, exprs, var_map, depth, make_get_bc, bc_table = \
            self._fused_stencil_lowering(state)
        if self.is_sde and grid.num_axes == 3:
            raise KernelUnsupportedError(
                "Fused 3D SDE windows are not supported, as in pde_tpu")
        sides = side_inputs_for(grid, bc_table,
                                offsets=(0.0, 0.5, 1.0) if kind == "rk4" else (0.0,))
        # a scalar field's slot is its plane, a vector field's the tuple of its planes
        slots = [var_map[sympy.Symbol(v)] for v in self.variables]
        n_planes = sum(len(s) if isinstance(s, tuple) else 1 for s in slots)
        if kind == "ab2" and n_planes != len(fields):
            raise KernelUnsupportedError("Fused AB2 windows do not support vector states")

        def plane_rates(ops, rhs_fns, works):
            """Each plane's rate, broadcast to the plane trimmed by `depth`."""
            rates = []
            for (rhs_fn, d), slot in zip(rhs_fns, slots, strict=True):
                rate = ops.trim(rhs_fn(works), depth - d)
                comps = rate if isinstance(slot, tuple) else (rate,)
                planes = slot if isinstance(slot, tuple) else (slot,)
                for comp, plane in zip(comps, planes, strict=True):
                    rates.append(ops.broadcast(comp, ops.trim(works[plane], depth)))
            return rates

        def make_multi_step(ops):
            rhs_fns = [
                self._lower_stencil_expr(
                    e, var_map, ops, make_get_bc(v),
                    vector_components=len(s) if isinstance(s, tuple) else None,
                )
                for e, v, s in zip(exprs, self.variables, slots, strict=True)
            ]
            trim = ops.trim

            def euler(works):
                rates = plane_rates(ops, rhs_fns, works)
                return [trim(w, depth) + dt * r for w, r in zip(works, rates, strict=True)]

            def rk4(works):
                # the stages' ghosts read the times t, t + dt/2 (k2, k3) and
                # t + dt (k4) of the window's side inputs, as in pde_tpu
                k1 = plane_rates(ops, rhs_fns, works)
                y2 = [trim(w, depth) + (0.5 * dt) * a for w, a in zip(works, k1, strict=True)]
                ops.bind_stage(1)
                k2 = plane_rates(ops, rhs_fns, y2)
                y3 = [trim(w, 2 * depth) + (0.5 * dt) * b for w, b in zip(works, k2, strict=True)]
                k3 = plane_rates(ops, rhs_fns, y3)
                y4 = [trim(w, 3 * depth) + dt * c for w, c in zip(works, k3, strict=True)]
                ops.bind_stage(2)
                k4 = plane_rates(ops, rhs_fns, y4)
                return [
                    trim(w, 4 * depth) + (dt / 6.0) * (
                        trim(a, 3 * depth) + 2.0 * trim(b, 2 * depth) + 2.0 * trim(c, depth) + d)
                    for w, a, b, c, d in zip(works, k1, k2, k3, k4, strict=True)
                ]

            def ab2(all_works):
                # planes [0, n): the fields; [n, 2n): the previous rates, which
                # no stencil reads (trimmed in step with the fields)
                works, prevs = all_works[:n_planes], all_works[n_planes:]
                rates = plane_rates(ops, rhs_fns, works)
                new = [trim(w, depth) + dt * (1.5 * rc - 0.5 * trim(rp, depth))
                       for w, rc, rp in zip(works, rates, prevs, strict=True)]
                return new + rates

            return {"euler": euler, "rk4": rk4, "ab2": ab2}[kind]

        # RK4 stores the stage values its later stages read (k1, then k1 + 2 k2
        # and k1 + 2 k2 + 2 k3) rather than recompute them: 9-22 % faster a pass
        # on every program timed (scripts/torch_rk4_sweep.py, PERF.md); the Euler
        # windows keep the recomputing cut they were timed with. An AB2 step
        # carries the previous rates as n more planes.
        halo = 4 * depth if kind == "rk4" else depth
        planes = 2 * n_planes if kind == "ab2" else n_planes
        if mesh is not None:
            from ..parallel.fused import make_fused_multi_window_sharded

            # as in pde_tpu; the torch engine runs these on the plain sharded stepper
            if self.is_sde:
                raise KernelUnsupportedError("Sharded fused windows do not support noise")
            if n_planes != len(fields):
                raise KernelUnsupportedError("Sharded fused windows require scalar fields")
            window = make_fused_multi_window_sharded(
                mesh, make_multi_step, halo, planes, dtype=fields[0].dtype, carry=kind == "rk4",
                sides=sides, dt=dt)
        elif self.is_sde:
            return make_chunked_sde_window_2d(
                grid, make_multi_step, depth, self._make_staged_noise(fields[0], dt),
                dtype=fields[0].dtype, kernel_noise=self._sde_kernel_noise_spec(grid, dt),
                sides=sides, dt=dt,
            )
        else:
            window = make_chunked_multi_window(
                grid, make_multi_step, halo, planes, dtype=fields[0].dtype, carry=kind == "rk4",
                sides=sides, dt=dt)
        if kind == "ab2":
            window.n_aux = n_planes
        elif n_planes != len(fields):
            window = _wrap_vector_planes(window, slots)
        return window

    def _make_staged_noise(self, state: FieldBase, dt: float) -> Callable:
        """``noise_fn(window_seed, indices, like)`` of the staged SDE window:
        the plain step loop's increments of those steps (a generator on
        `like`'s device reseeded per (window seed, step)), drawn into one
        reused ``(k, n, m)`` staging buffer."""
        from ..ops.philox import step_seed

        noise_step = self.make_sde_noise_step(state)
        cache: dict = {}

        def noise_fn(window_seed, indices, like):
            indices = list(indices)
            planes = cache.get("planes")
            if planes is None or planes.shape[0] < len(indices) or planes.device != like.device:
                planes = cache["planes"] = torch.empty(
                    (len(indices), *like.shape), dtype=like.dtype, device=like.device
                )
                cache["generator"] = torch.Generator(device=like.device)
            generator = cache["generator"]
            for j, i in enumerate(indices):
                generator.manual_seed(step_seed(window_seed, i))
                noise_step([like], 0.0, generator, dt, outs=[planes[j]])
            return planes[: len(indices)]

        return noise_fn

    # -- exponential-integrator support ---------------------------------------------------
    @staticmethod
    def _axis_spectral_kind(pair) -> str:
        """Transform kind diagonalizing the FD Laplacian along one axis.

        ``"periodic"`` (rfft modes), ``"neumann"`` (DCT-II modes, homogeneous
        no-flux both sides), or ``"dirichlet"`` (DST-II modes, homogeneous
        value-0 both sides); anything else raises NotImplementedError.
        """
        from ..grids.boundaries.local import DirichletBC, NeumannBC

        if pair.periodic:
            if getattr(pair.low, "flip_sign", False):
                raise NotImplementedError(
                    "The spectral split does not support anti-periodic axes"
                )
            return "periodic"
        for kind, cls in (("neumann", NeumannBC), ("dirichlet", DirichletBC)):
            if all(
                isinstance(bc, cls)
                and not getattr(bc, "normal", False)
                and np.all(np.asarray(bc.value) == 0)
                for bc in (pair.low, pair.high)
            ):
                return kind
        raise NotImplementedError(
            "The spectral split requires periodic, homogeneous-Neumann, or "
            "homogeneous-Dirichlet boundary conditions per axis"
        )

    def make_etdrk_parts(self, state, rhs_state=None):
        """Split the rhs into a spectral linear part and a nonlinear remainder.

        Returns an :class:`~pde_tpu_torch.models.base.EtdrkParts` for
        :class:`~pde_tpu_torch.solvers.etdrk.ETDRK4Solver`. The linear
        constant-coefficient part (sums of ``c * laplace^m(u_j)`` and ``c *
        u_j`` over all fields) is evaluated on the host per mode of the
        diagonalizing basis: rfft modes on periodic axes, DCT-II modes on
        homogeneous-Neumann axes, DST-II modes on homogeneous-Dirichlet axes
        (the eigenbases of the cell-centered ghost-cell stencils, so the
        integrator advances exactly the semi-discretization of every other
        solver). For coupled FieldCollection systems ``L_vals`` holds per-mode
        ``(N, N)`` coupling matrices. ``nonlinear_rhs(leaves, t)`` computes
        everything else, the plain rhs of ``nonlinear_pde`` on `rhs_state`
        (default `state`). Linear operators are first distributed over sums
        (``laplace(a + b) -> laplace(a) + laplace(b)``), so Cahn-Hilliard's
        ``laplace(c**3 - c - laplace(c))`` splits into the stiff ``q**2 -
        q**4`` symbol plus ``laplace(c**3)``.
        """
        from ..grids.cartesian import CartesianGrid
        from .base import EtdrkParts

        if self.is_sde:
            raise NotImplementedError("The spectral split is deterministic")
        grid = state.grid
        if not isinstance(grid, CartesianGrid):
            raise NotImplementedError(
                "The spectral split requires a Cartesian grid"
            )
        variables = self.variables
        n_fields = len(variables)
        # the modal basis must diagonalize every laplace application: check
        # the (var, laplace) BCs of every field that uses the operator
        axis_kinds = None
        for var in variables:
            if "laplace" not in self._operators[var]:
                continue  # no laplace terms: no constraint from this field
            bcs_resolved = grid.get_boundary_conditions(
                self._resolve_bc(var, "laplace")
            )
            kinds = tuple(self._axis_spectral_kind(p) for p in bcs_resolved)
            if axis_kinds is None:
                axis_kinds = kinds
            elif kinds != axis_kinds:
                raise NotImplementedError(
                    "The spectral split requires all fields to share the "
                    "same laplace boundary-condition types"
                )
        if axis_kinds is None:
            # no laplace anywhere: any orthogonal basis works; pick by grid
            # periodicity so the transform stays well-defined
            axis_kinds = tuple(
                "periodic" if p else "neumann" for p in grid.periodic
            )

        # substitute scalar consts so e.g. `D*laplace(c)` with consts={'D':1}
        # keeps the stiff term in the exponential part instead of silently
        # dropping it into the explicit remainder (coeff.is_number is False
        # for an unsubstituted Symbol)
        scalar_consts = {
            sympy.Symbol(name): float(value)
            for name, value in self.consts.items()
            if isinstance(value, numbers.Number) and not isinstance(value, complex)
        }
        u_syms = [sympy.Symbol(v) for v in variables]
        q = sympy.Symbol("__wave_number")
        lin_matrix = [
            [sympy.S.Zero for _ in variables] for _ in variables
        ]
        rest_exprs = {}
        for i1, var in enumerate(variables):
            expr = self._rhs_expr[var]._sympy_expr
            if scalar_consts:
                expr = expr.subs(scalar_consts)
            expr = self._distribute_linear_ops(sympy.expand(expr))
            expr = sympy.expand(expr)
            rest_terms = []
            for term in expr.as_ordered_terms():
                matched = False
                for i2, u2 in enumerate(u_syms):
                    if not term.has(u2):
                        continue
                    sym = self._linear_term_symbol(term, u2, q)
                    if sym is not None:
                        lin_matrix[i1][i2] = lin_matrix[i1][i2] + sym
                        matched = True
                    break  # a linear term involves exactly one field symbol
                if not matched:
                    rest_terms.append(term)
            rest_exprs[var] = (
                sympy.Add(*rest_terms) if rest_terms else sympy.S.Zero
            )

        # evaluate the symbols with the DISCRETE Laplacian eigenvalues of the
        # per-axis modal bases (λ(k) = -4 sin²(·)/dx² chains); a continuum
        # -|q|² symbol would silently change the spatial scheme
        from ..ops.common import (
            dirichlet_laplace_eigenvalues_1d,
            laplace_eigenvalues_1d,
            neumann_laplace_eigenvalues_1d,
        )

        periodic_axes = [
            ax for ax, kind in enumerate(axis_kinds) if kind == "periodic"
        ]
        half_axis = periodic_axes[-1] if periodic_axes else None
        lam_axes = []
        for ax, (n, dx, kind) in enumerate(
            zip(grid.shape, grid.discretization, axis_kinds, strict=True)
        ):
            if kind == "periodic":
                lam_ax = laplace_eigenvalues_1d(
                    n, float(dx), real_half=ax == half_axis
                )
            elif kind == "neumann":
                lam_ax = neumann_laplace_eigenvalues_1d(n, float(dx))
            else:
                lam_ax = dirichlet_laplace_eigenvalues_1d(n, float(dx))
            shape = [1] * grid.num_axes
            shape[ax] = len(lam_ax)
            lam_axes.append(lam_ax.reshape(shape))

        # honor the configured 9-point corner-weight Laplacian: the stencil
        # is A⊗I + I⊗B + c·A⊗B over the per-axis second differences, so its
        # exact eigenvalues are a·λx + b·λy + c·λx·λy in the same tensor
        # basis; silently using the 5-point chain would make ETDRK4 integrate
        # a different semi-discretization than every other solver
        corner_weight = _corner_weight() if grid.num_axes == 2 else 0.0
        uses_laplace = any(sym.has(q) for row in lin_matrix for sym in row)
        if corner_weight != 0.0 and uses_laplace:
            if any(kind != "periodic" for kind in axis_kinds):
                raise NotImplementedError(
                    "The spectral split supports the corner-weight Laplacian "
                    "(laplacian_2d_corner_weight != 0) only on fully periodic "
                    "grids — the corner-ghost extrapolation on physical "
                    "boundaries is not an exact tensor-product operator"
                )
            w = corner_weight
            sx, sy = (float(d) ** -2 for d in grid.discretization)
            dm2 = sx + sy
            lam = (
                ((1 - w) + dm2 * w / (2 * sx)) * lam_axes[0]
                + ((1 - w) + dm2 * w / (2 * sy)) * lam_axes[1]
                + dm2 * w / (4 * sx * sy) * lam_axes[0] * lam_axes[1]
            )
        else:
            lam = lam_axes[0]
            for lam_ax in lam_axes[1:]:
                lam = lam + lam_ax

        def eval_symbol(sym):
            if sym == 0:
                return np.zeros(lam.shape)
            # symbols contain only even powers of q ((-q²)^m chains), so
            # substituting q = sqrt(-λ) evaluates (-q²)^m as λ^m exactly
            sym_fn = sympy.lambdify(q, sym, modules="numpy")
            vals = np.asarray(sym_fn(np.sqrt(-lam)), dtype=float)
            return np.broadcast_to(vals, lam.shape).copy()

        if n_fields == 1:
            L_vals = eval_symbol(lin_matrix[0][0])
        else:
            L_vals = np.zeros((*lam.shape, n_fields, n_fields))
            for i1 in range(n_fields):
                for i2 in range(n_fields):
                    if lin_matrix[i1][i2] != 0:
                        L_vals[..., i1, i2] = eval_symbol(lin_matrix[i1][i2])

        sub_pde = PDE(
            {var: str(rest_exprs[var]) for var in variables},
            bc=self.bcs.get("*:*"),
            bc_ops={k: v for k, v in self.bcs.items() if k != "*:*"},
            user_funcs=self.user_funcs,
            consts=self.consts,
        )
        nonlinear_rhs = sub_pde.make_pde_rhs(
            state if rhs_state is None else rhs_state
        )
        return EtdrkParts(L_vals, nonlinear_rhs, axis_kinds, n_fields, nonlinear_pde=sub_pde)

    @staticmethod
    def _distribute_linear_ops(expr):
        """Rewrite ``laplace(a + c*b) -> laplace(a) + c*laplace(b)`` (fixpoint)
        for the Fourier-mappable linear operators."""
        from sympy.core.function import AppliedUndef

        def rewrite_once(e):
            def matches(node):
                return (
                    isinstance(node, AppliedUndef)
                    and node.func.__name__ in _FOURIER_LINEAR_OPERATORS
                    and len(node.args) == 1
                )

            def apply(node):
                arg = sympy.expand(node.args[0])
                if arg.is_Add:
                    return sympy.Add(*[node.func(a) for a in arg.args])
                coeff, core = arg.as_coeff_Mul()
                if coeff != 1:
                    return coeff * node.func(core)
                return node.func(arg)

            return e.replace(matches, apply)

        for _ in range(8):  # nesting depth bound; fixpoint in practice
            new = rewrite_once(expr)
            if new == expr:
                break
            expr = new
        return expr

    @classmethod
    def _linear_term_symbol(cls, term, u, q):
        """Fourier symbol of a term linear in `u` via laplace chains, or None.

        Supported shapes: ``c * u`` and ``c * laplace(...laplace(u)...)``
        with ``c`` free of ``u`` and real. Gradient/divergence terms (odd,
        anisotropic symbols) and everything nonlinear return None and stay
        in the remainder.
        """
        from sympy.core.function import AppliedUndef

        coeff, core = term.as_independent(u, as_Add=False)
        if coeff.has(u) or not coeff.is_number or not coeff.is_real:
            return None
        symbol = sympy.S.One
        node = core
        while True:
            if node == u:
                return coeff * symbol
            if (
                isinstance(node, AppliedUndef)
                and node.func.__name__ == "laplace"
                and len(node.args) == 1
            ):
                symbol = symbol * (-(q**2))
                node = node.args[0]
                continue
            return None
