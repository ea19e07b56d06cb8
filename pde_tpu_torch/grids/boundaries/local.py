"""Local boundary conditions: one side of one axis.

Port of :mod:`pde_tpu.grids.boundaries.local`: periodic conditions, constant
affine ones (whose values may vary along the side: arrays, or a string, an
expression of the coordinates evaluated on the side once), the expression
conditions (:class:`ExpressionBC` and its value, derivative and mixed forms:
the ghost is an expression, or a function, of the adjacent cell value, the
spacing, the side's coordinates and the time) and :class:`UserBC`, whose
values come with the operator's call. Each condition computes the *virtual
point* (ghost-cell value) just outside the boundary from the field values
inside.

Virtual-point formulas (1st order):
    ghost = const + factor * data[edge]
with (const, factor):
    * Dirichlet value v:  (2v, -1)
    * Neumann deriv d:    (d*dx, +1)
    * Robin ∂c+γc=β:      (2dxβ/(2+dxγ), (2-dxγ)/(2+dxγ)); γ→∞ gives (0, -1)
2nd order (curvature v): ghost = v*dx² + 2*data[i1] - data[i2]

Ghost setters ``setter(full, t=0.0, args=None)`` write into a padded tensor
(one ghost layer per axis) in place; the operator that owns the padded tensor
created it for this purpose. `t` is the time the operator is applied at
(the expression conditions read it) and `args` the operator's extra data
(:class:`UserBC` reads it).
"""

from __future__ import annotations

import copy
import numbers
from typing import Any, Callable

import numpy as np
import torch

from ..base import GridBase, PeriodicityError


class BCDataError(ValueError):
    """Exception indicating that given boundary data could not be interpreted."""


def _hash_value(value) -> Any:
    if isinstance(value, np.ndarray):
        return (value.shape, value.tobytes())
    return value


class BCBase:
    """A single boundary condition on one side of one axis."""

    names: list[str] = []
    #: whether the condition acts on the normal component only (of a vector or
    #: tensor field; a scalar field has no components, so it acts on the field)
    normal: bool = False

    _subclasses: dict[str, type[BCBase]] = {}
    _conditions: dict[str, type[BCBase]] = {}

    def __init__(self, grid: GridBase, axis: int, upper: bool, *, rank: int = 0):
        if rank not in (0, 1, 2):
            raise NotImplementedError(f"Boundary conditions of rank {rank} are not supported")
        self.grid = grid
        self.axis = axis
        self.upper = upper
        self.rank = rank
        if rank == 0:
            self.normal = False
        self._shape_tensor = (grid.dim,) * (rank - 1 if self.normal else rank)
        self._shape_boundary = grid.shape[:axis] + grid.shape[axis + 1 :]

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        BCBase._subclasses[cls.__name__] = cls
        for name in cls.names:
            BCBase._conditions[name] = cls

    @property
    def periodic(self) -> bool:
        return isinstance(self, _PeriodicBC)

    @property
    def axis_coord(self) -> float:
        """Coordinate of the side along its axis."""
        return self.grid.axes_bounds[self.axis][1 if self.upper else 0]

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        return f"{self.__class__.__name__} @ axis {self.axis}"

    def copy(self) -> BCBase:
        return copy.copy(self)

    def __repr__(self) -> str:
        fields = [f"axis={self.axis}", f"upper={self.upper}"] + self._repr_value()
        return f"{self.__class__.__name__}({', '.join(fields)})"

    def _repr_value(self) -> list[str]:
        return []

    def __eq__(self, other) -> bool:
        if not isinstance(other, BCBase):
            return NotImplemented
        return (
            self.__class__ is other.__class__
            and self.grid == other.grid
            and self.axis == other.axis
            and self.upper == other.upper
            and self._value_key() == other._value_key()
        )

    def __hash__(self) -> int:
        return hash(
            (self.__class__.__name__, self.grid, self.axis, self.upper, self._value_key())
        )

    def _value_key(self) -> Any:
        return None

    # -- construction -------------------------------------------------------------
    @classmethod
    def get_help(cls) -> str:
        return f"Possible boundary conditions are: {sorted(BCBase._conditions)}"

    @classmethod
    def from_str(
        cls, grid: GridBase, axis: int, upper: bool, condition: str, *, rank: int = 0, **kwargs
    ) -> BCBase:
        """Create a boundary condition from a string identifier."""
        if condition in ("auto_periodic_neumann", "natural", "auto_periodic_dirichlet"):
            if grid.periodic[axis]:
                condition = "periodic"
            elif condition == "auto_periodic_dirichlet":
                condition = "value"
            else:
                condition = "derivative"
        if condition in ("periodic", "anti-periodic"):
            if not grid.periodic[axis]:
                raise PeriodicityError(
                    "Periodic boundary conditions can only be set on periodic axes"
                )
            return _PeriodicBC(grid, axis, upper, flip_sign=condition == "anti-periodic")
        if condition == "no-flux":
            condition, kwargs = "derivative", {"value": 0, **kwargs}
        # callable values become expression conditions of the matching target
        if callable(kwargs.get("value")) or callable(kwargs.get("const")):
            target = _CALLABLE_TARGETS.get(condition)
            if target is not None:
                kwargs.setdefault("target", target)
                return ExpressionBC(grid, axis, upper, rank=rank, **kwargs)
        try:
            bc_cls = BCBase._conditions[condition]
        except KeyError:
            raise BCDataError(
                f"Boundary condition `{condition}` not defined. " + cls.get_help()
            ) from None
        return bc_cls(grid, axis, upper, rank=rank, **kwargs)

    @classmethod
    def from_dict(
        cls, grid: GridBase, axis: int, upper: bool, data: dict, *, rank: int = 0
    ) -> BCBase:
        """Create a boundary condition from a dictionary specification."""
        data = dict(data)
        if "type" in data:
            b_type = data.pop("type")
            return cls.from_str(grid, axis, upper, b_type, rank=rank, **data)
        if not data:
            raise BCDataError("Boundary condition defined by empty dictionary")
        for key in list(data):
            if key in BCBase._conditions:
                value = data.pop(key)
                return cls.from_str(grid, axis, upper, key, rank=rank, value=value, **data)
        raise BCDataError(f"Could not interpret boundary data `{data}`. " + cls.get_help())

    @classmethod
    def from_data(cls, grid: GridBase, axis: int, upper: bool, data, *, rank: int = 0) -> BCBase:
        """Create a boundary condition from flexible data."""
        if isinstance(data, BCBase):
            if (data.grid, data.axis, data.upper) != (grid, axis, upper):
                raise BCDataError("Boundary condition belongs to another grid side")
            return data
        if isinstance(data, str):
            return cls.from_str(grid, axis, upper, data, rank=rank)
        if isinstance(data, dict):
            return cls.from_dict(grid, axis, upper, data, rank=rank)
        if callable(data):
            return UserBC(grid, axis, upper, rank=rank)
        if isinstance(data, (numbers.Number, np.ndarray, list, tuple)):
            return DirichletBC(grid, axis, upper, rank=rank, value=data)
        raise BCDataError(f"Unsupported boundary format: `{data}`. " + cls.get_help())

    # -- ghost cells --------------------------------------------------------------
    def _ghost_index(self, offset: int = -1) -> tuple:
        """Index of the ghost layer (``offset=-1``) or of the valid layer
        ``offset`` cells inward from this boundary, in a padded array; the
        other axes select their valid range, and leading (component) axes
        are kept whole, so one condition applies to every component, except
        that a normal condition selects the component along its axis (the
        others keep their ghost cells)."""
        idx: list[Any] = [slice(1, -1)] * self.grid.num_axes
        if self.upper:
            idx[self.axis] = -1 if offset < 0 else -2 - offset
        else:
            idx[self.axis] = 0 if offset < 0 else 1 + offset
        if self.normal:
            return (Ellipsis, self.axis, *idx)
        return (Ellipsis, *idx)

    def make_ghost_setter(self) -> Callable:
        """Return ``setter(full, t=0.0, args=None) -> full`` writing this side's
        ghost cells."""
        raise NotImplementedError

    def copy_for(self, grid: GridBase, axis: int | None = None, upper: bool | None = None, *,
                 rank: int | None = None) -> BCBase:
        """This condition on another grid, axis or side."""
        new = copy.copy(self)
        new.__init__(grid, self.axis if axis is None else axis,
                     self.upper if upper is None else upper,
                     rank=self.rank if rank is None else rank, **self._init_kwargs())
        return new

    def _init_kwargs(self) -> dict:
        return {}

    def to_subgrid(self, subgrid: GridBase) -> BCBase:
        """This condition on a subgrid."""
        return self.copy_for(subgrid, self.axis, self.upper, rank=self.rank)

    def get_sparse_matrix_data(self, idx: tuple[int, ...]):
        """``(const, {index: factor})`` of the virtual point, for implicit
        matrices."""
        raise NotImplementedError(f"{self.__class__.__name__} does not support sparse matrices")

    def get_virtual_point(self, arr, idx=None):
        """The virtual point's values for the data `arr` (numpy or a tensor),
        at the position `idx` along the side's other axes, or all of them; a
        debugging aid computed on the host, returned as numpy."""
        from ...fields.base import from_host

        data = torch.as_tensor(from_host(np.asarray(arr)) if not isinstance(arr, torch.Tensor)
                               else arr)
        full = torch.nn.functional.pad(data, [1, 1] * self.grid.num_axes)
        full = self.make_ghost_setter()(full)
        lead = self.rank
        sel: list[Any] = [slice(None)] * full.ndim
        sel[lead + self.axis] = -1 if self.upper else 0
        if idx is not None:
            others = [i for i in range(self.grid.num_axes) if i != self.axis]
            for pos, i in enumerate(others):
                sel[lead + i] = idx[pos] + 1
        from ...fields.base import to_host

        result = to_host(full[tuple(sel)])
        return result.squeeze() if result.ndim else result[()]


class _PeriodicBC(BCBase):
    """Periodic (or anti-periodic) boundary condition."""

    def __init__(self, grid, axis, upper, *, flip_sign: bool = False, rank: int = 0):
        super().__init__(grid, axis, upper, rank=rank)
        self.flip_sign = flip_sign

    def _value_key(self):
        return self.flip_sign

    def _init_kwargs(self):
        return {"flip_sign": self.flip_sign}

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        ax = self.grid.axes[self.axis]
        lo, hi = self.grid.axes_bounds[self.axis]
        sign = "-" if self.flip_sign else ""
        return f"{field_name}({ax}={lo}) = {sign}{field_name}({ax}={hi})"

    def make_ghost_setter(self):
        write = self._ghost_index()
        read = list(write)
        read[1 + self.axis] = 1 if self.upper else -2  # opposite valid edge (after ...)
        read = tuple(read)
        sign = -1.0 if self.flip_sign else 1.0

        def setter(full, t=0.0, args=None):
            full[write] = sign * full[read]
            return full

        return setter

    def get_sparse_matrix_data(self, idx):
        index = 0 if self.upper else self.grid.shape[self.axis] - 1
        return 0.0, {index: -1.0 if self.flip_sign else 1.0}


def _as_tensor_like(value, full: torch.Tensor):
    """A python float for scalars, else a tensor on `full`'s device."""
    if np.ndim(value) == 0:
        return float(value)
    return torch.as_tensor(np.asarray(value), dtype=full.dtype, device=full.device)


def _user_value(value, full: torch.Tensor):
    """A value of a :class:`UserBC`'s `args`: a python float for scalars, else
    a tensor on `full`'s device (numpy data keeps its dtype, as ``pde_tpu``'s
    ``jnp.asarray`` does)."""
    if isinstance(value, torch.Tensor):
        return value.to(full.device)
    if np.ndim(value) == 0:
        return float(value)
    return torch.as_tensor(np.asarray(value), device=full.device)


class UserBC(BCBase):
    """A condition whose ghost values come with the operator's call, in its
    `args`: ``args={"virtual_point": vp}``, ``{"value": v}`` or
    ``{"derivative": d}``; without them (``args`` None or none of these
    keys) the ghost cells are left as they are."""

    names = ["user"]

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        return f"user-controlled  @ {self.grid.axes[self.axis]}={self.axis_coord}"

    def make_ghost_setter(self):
        dx = float(self.grid.discretization[self.axis])
        write, read = self._ghost_index(), self._ghost_index(0)

        def setter(full, t=0.0, args=None):
            if args is None:
                return full
            if "virtual_point" in args:
                ghost = _user_value(args["virtual_point"], full)
            elif "value" in args:
                ghost = 2 * _user_value(args["value"], full) - full[read]
            elif "derivative" in args:
                ghost = dx * _user_value(args["derivative"], full) + full[read]
            else:
                return full
            shape = full[read].shape
            full[write] = torch.broadcast_to(torch.as_tensor(ghost, device=full.device), shape)
            return full

        return setter


class ConstBCBase(BCBase):
    """Base class for conditions with a constant (possibly space-dependent) value."""

    def __init__(self, grid, axis, upper, *, rank: int = 0, value=0):
        super().__init__(grid, axis, upper, rank=rank)
        self.value = self._parse_value(value)

    def _value_key(self):
        return _hash_value(self.value)

    def _init_kwargs(self):
        return {"value": self.value}

    def _repr_value(self):
        return [f"value={self.value!r}"]

    def _parse_value(self, value):
        """Parse a BC value: a scalar, or an array over the boundary, over the
        components (vector and tensor conditions), or over both, or a string,
        an expression of the coordinates evaluated on the side's cells; arrays
        are broadcast to ``(dim,)*rank + boundary shape``."""
        if isinstance(value, str):
            value = self._value_from_expression(value)
        if np.iscomplexobj(value):
            raise NotImplementedError("Complex boundary values are not ported yet")
        if np.ndim(value) == 0:
            return float(value)
        value = np.asarray(value, dtype=float)
        full = self._shape_tensor + self._shape_boundary
        if self.rank and value.shape == self._shape_tensor and value.shape != full:
            # one value per component, uniform along the boundary
            value = value.reshape(self._shape_tensor + (1,) * len(self._shape_boundary))
        try:
            return np.ascontiguousarray(np.broadcast_to(value, full))
        except ValueError:
            raise BCDataError(
                f"Value shape {value.shape} incompatible with tensor shape "
                f"{self._shape_tensor} and boundary shape {self._shape_boundary}"
            ) from None

    def to_subgrid(self, subgrid: GridBase) -> BCBase:
        if np.ndim(self.value) != 0:
            raise NotImplementedError(
                "Inhomogeneous boundary values are not supported on subgrids yet")
        return super().to_subgrid(subgrid)

    def _value_from_expression(self, expression: str) -> np.ndarray:
        """An expression of the grid's coordinates on the side's cells (the
        side's position along its axis), evaluated once on the host."""
        from ...utils.expressions import ScalarExpression

        expr = ScalarExpression(expression, signature=self.grid.axes, allow_indexed=True)
        coords = self.grid._boundary_coordinates(self.axis, self.upper)
        values = expr(*[coords[..., i] for i in range(self.grid.num_axes)])
        return np.broadcast_to(values, self._shape_boundary).astype(float)


class ConstBC1stOrderBase(ConstBCBase):
    """Conditions whose virtual point is affine in one adjacent cell."""

    def get_virtual_point_data(self) -> tuple[Any, Any, int]:
        """Return (const, factor, index) with ghost = const + factor*data[index]."""
        raise NotImplementedError

    def make_ghost_setter(self):
        const, factor, index = self.get_virtual_point_data()
        edge = self.grid.shape[self.axis] - 1 if self.upper else 0
        write, read = self._ghost_index(), self._ghost_index(abs(index - edge))

        def setter(full, t=0.0, args=None):
            c = _as_tensor_like(const, full)
            f = _as_tensor_like(factor, full)
            full[write] = c + f * full[read]
            return full

        return setter

    def get_sparse_matrix_data(self, idx):
        const, factor, index = self.get_virtual_point_data()
        if np.ndim(self.value) == 0 and np.ndim(getattr(self, "const", 0)) == 0:
            c, f = const, factor
        else:
            idx_c = list(idx)
            del idx_c[self.axis]
            c = np.asarray(const)[tuple(idx_c)]
            f = np.asarray(factor)[tuple(idx_c)]
        return np.asarray(c).item() if np.ndim(c) == 0 else c, {index: f}


class DirichletBC(ConstBC1stOrderBase):
    """Imposes the value of the field at the boundary."""

    names = ["value", "dirichlet"]

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        ax = self.grid.axes[self.axis]
        return f"{field_name} = {self.value}   @ {ax}={self.axis_coord}"

    def get_virtual_point_data(self):
        const = 2 * np.asarray(self.value)
        index = self.grid.shape[self.axis] - 1 if self.upper else 0
        return (const, -np.ones_like(const), index)


class NeumannBC(ConstBC1stOrderBase):
    """Imposes the derivative in the outward normal direction."""

    names = ["derivative", "neumann"]

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        sign = " " if self.upper else "-"
        ax = self.grid.axes[self.axis]
        return f"{sign}∂{field_name}/∂{ax} = {self.value}   @ {ax}={self.axis_coord}"

    def get_virtual_point_data(self):
        dx = self.grid.discretization[self.axis]
        const = dx * np.asarray(self.value)
        index = self.grid.shape[self.axis] - 1 if self.upper else 0
        return (const, np.ones_like(const), index)


class MixedBC(ConstBC1stOrderBase):
    r"""Robin condition :math:`\partial_n c + \gamma c = \beta`.

    `value` is :math:`\gamma`, `const` is :math:`\beta`.
    """

    names = ["mixed", "robin"]

    def __init__(self, grid, axis, upper, *, rank: int = 0, value=0, const=0):
        super().__init__(grid, axis, upper, rank=rank, value=value)
        self.const = self._parse_value(const)

    def _value_key(self):
        return (_hash_value(self.value), _hash_value(self.const))

    def _init_kwargs(self):
        return {"value": self.value, "const": self.const}

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        sign = "" if self.upper else "-"
        ax = self.grid.axes[self.axis]
        return (f"{sign}∂{field_name}/∂{ax} + {self.value} * {field_name} = {self.const}"
                f"   @ {ax}={self.axis_coord}")

    def to_subgrid(self, subgrid: GridBase) -> BCBase:
        if np.ndim(self.const) != 0:
            raise NotImplementedError(
                "Inhomogeneous boundary values are not supported on subgrids yet")
        return super().to_subgrid(subgrid)

    def get_virtual_point_data(self):
        dx = self.grid.discretization[self.axis]
        gamma = np.asarray(self.value, dtype=float)
        beta = np.asarray(self.const, dtype=float)
        with np.errstate(invalid="ignore", divide="ignore"):
            const = np.asarray(2 * dx * beta / (2 + dx * gamma))
            factor = np.asarray((2 - dx * gamma) / (2 + dx * gamma))
        const = np.where(np.isfinite(factor), const, 0.0)
        factor = np.where(np.isfinite(factor), factor, -1.0)
        index = self.grid.shape[self.axis] - 1 if self.upper else 0
        return (const, factor, index)


class ConstBC2ndOrderBase(ConstBCBase):
    """Conditions whose virtual point involves two adjacent cells."""

    def get_virtual_point_data(self) -> tuple[Any, Any, int, Any, int]:
        """Return (const, factor1, index1, factor2, index2)."""
        raise NotImplementedError

    def make_ghost_setter(self):
        const, f1, i1, f2, i2 = self.get_virtual_point_data()
        edge = self.grid.shape[self.axis] - 1 if self.upper else 0
        write = self._ghost_index()
        read1, read2 = self._ghost_index(abs(i1 - edge)), self._ghost_index(abs(i2 - edge))

        def setter(full, t=0.0, args=None):
            c = _as_tensor_like(const, full)
            g1 = _as_tensor_like(f1, full)
            g2 = _as_tensor_like(f2, full)
            full[write] = c + g1 * full[read1] + g2 * full[read2]
            return full

        return setter

    def get_sparse_matrix_data(self, idx):
        const, f1, i1, f2, i2 = self.get_virtual_point_data()
        if np.ndim(self.value) == 0:
            return np.asarray(const).item() if np.ndim(const) == 0 else const, {i1: f1, i2: f2}
        idx_c = list(idx)
        del idx_c[self.axis]
        sel = tuple(idx_c)
        return np.asarray(const)[sel], {i1: np.asarray(f1)[sel], i2: np.asarray(f2)[sel]}


class CurvatureBC(ConstBC2ndOrderBase):
    """Imposes the second normal derivative at the boundary."""

    names = ["curvature", "second_derivative", "extrapolate"]

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        sign = " " if self.upper else "-"
        ax = self.grid.axes[self.axis]
        return f"{sign}∂²{field_name}/∂{ax}² = {self.value}   @ {ax}={self.axis_coord}"

    def get_virtual_point_data(self):
        size = self.grid.shape[self.axis]
        dx = self.grid.discretization[self.axis]
        if size < 2:
            raise RuntimeError(
                "Need at least 2 support points to use curvature boundary conditions"
            )
        value = np.asarray(self.value) * dx**2
        f1 = np.full_like(np.asarray(value, dtype=float), 2.0)
        f2 = np.full_like(np.asarray(value, dtype=float), -1.0)
        if self.upper:
            i1, i2 = size - 1, size - 2
        else:
            i1, i2 = 0, 1
        return (value, f1, i1, f2, i2)


class ExpressionBC(BCBase):
    """A condition whose ghost value is an expression (or a function) of the
    adjacent cell's value (``value``), the spacing ``dx`` along the axis, the
    side's coordinates (the grid's axis names) and the time ``t``.

    `target` says what the expression gives: ``"virtual_point"`` the ghost
    itself, ``"value"`` the value at the side, ``"derivative"`` the outward
    derivative, ``"mixed"`` the Robin condition ``∂n c + value * c = const``.
    A callable `value` (and `const`) takes ``(value, dx, *coords, t)``.
    `value_cell` reads the cell of that index along the axis instead of the
    adjacent one. Scalar fields only.
    """

    names = ["virtual_point"]

    def __init__(self, grid, axis, upper, *, rank: int = 0, value=0, const=0,
                 target: str = "virtual_point", user_funcs=None, value_cell=None):
        super().__init__(grid, axis, upper, rank=rank)
        if self.rank != 0:
            raise NotImplementedError("Expression boundary conditions only work for scalar fields")
        self.value_cell = value_cell
        self._input = {"value_expr": value, "const_expr": const, "target": target,
                       "user_funcs": user_funcs}
        self._expr = None
        if callable(value) or callable(const):
            self._func = _callable_ghost(value, const, target)
            return
        if target == "virtual_point":
            expression = f"{value}"
        elif target == "value":
            expression = f"2 * ({value}) - value"
        elif target == "derivative":
            expression = f"dx * ({value}) + value"
        elif target == "mixed":
            numerator = f"2 * dx * ({const}) + (2 - ({value}) * dx) * value"
            expression = f"({numerator}) / (({value}) * dx + 2)"
        else:
            raise ValueError(f"Unknown target `{target}` for expression")
        from ...utils.expressions import ScalarExpression

        signature = ["value", "dx", *grid.axes, "t"]
        self._expr = ScalarExpression(expression, signature=signature, user_funcs=user_funcs)
        self._func = self._expr._get_function(backend="torch")

    def _value_key(self):
        return (str(self._input["value_expr"]), str(self._input["const_expr"]),
                self._input["target"], self.value_cell)

    def _init_kwargs(self):
        return {"value": self._input["value_expr"], "const": self._input["const_expr"],
                "target": self._input["target"], "user_funcs": self._input["user_funcs"],
                "value_cell": self.value_cell}

    def _repr_value(self):
        return [f"{self._input['target']}={self._input['value_expr']!r}"]

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        target = self._input["target"]
        ax = self.grid.axes[self.axis]
        return f"{target}({field_name}) = {self._input['value_expr']}   @ {ax}={self.axis_coord}"

    @property
    def read_offset(self) -> int:
        """Cells inward from the side of the cell the ghost reads."""
        if self.value_cell is None:
            return 0
        edge = self.grid.shape[self.axis] - 1 if self.upper else 0
        return abs(self.value_cell - edge)

    def boundary_coordinates(self) -> tuple:
        """The side's coordinate arrays (numpy float64), one per axis."""
        coords = self.grid._boundary_coordinates(self.axis, self.upper)
        return tuple(np.asarray(coords[..., i]) for i in range(self.grid.num_axes))

    def make_ghost_setter(self, coords: tuple | None = None):
        """The setter; `coords` replaces the side's coordinate arrays (a
        decomposed block's view passes its cells' part of them)."""
        from ...ops.common import host_values_on

        dx = float(self.grid.discretization[self.axis])
        write, read = self._ghost_index(), self._ghost_index(self.read_offset)
        coords_on = [host_values_on(c) for c in (self.boundary_coordinates()
                                                 if coords is None else coords)]
        func = self._func
        f64 = torch.empty(0, dtype=torch.float64)

        def setter(full, t=0.0, args=None):
            adjacent = full[read]
            like = f64.to(full.device)
            ghost = func(adjacent, dx, *[on(like) for on in coords_on], t)
            ghost = torch.as_tensor(ghost, device=full.device)
            full[write] = torch.broadcast_to(ghost, adjacent.shape)
            return full

        return setter


def _callable_ghost(value, const, target: str) -> Callable:
    """The ghost function ``(adjacent, dx, *coords, t)`` of a callable
    condition of `target`."""
    if target == "virtual_point":
        return value
    if target == "value":
        return lambda adj, dx, *rest: 2 * value(adj, dx, *rest) - adj
    if target == "derivative":
        return lambda adj, dx, *rest: dx * value(adj, dx, *rest) + adj
    if target == "mixed":
        def mixed(adj, dx, *rest):
            gamma = value(adj, dx, *rest)
            beta = const(adj, dx, *rest) if callable(const) else const
            return (2 * dx * beta + (2 - gamma * dx) * adj) / (gamma * dx + 2)

        return mixed
    raise ValueError(f"Unknown target `{target}` for expression")


#: the target a condition name gives a callable value
_CALLABLE_TARGETS = {
    "value": "value", "dirichlet": "value", "derivative": "derivative",
    "neumann": "derivative", "mixed": "mixed", "robin": "mixed",
    "virtual_point": "virtual_point",
}


class ExpressionValueBC(ExpressionBC):
    """Dirichlet condition from an expression of the coordinates and time."""

    names = ["value_expression", "value_expr"]

    def __init__(self, grid, axis, upper, *, rank=0, value=0, const=0, target="value", **kwargs):
        super().__init__(grid, axis, upper, rank=rank, value=value, const=const, target=target,
                         **kwargs)


class ExpressionDerivativeBC(ExpressionBC):
    """Neumann condition from an expression of the coordinates and time."""

    names = ["derivative_expression", "derivative_expr"]

    def __init__(self, grid, axis, upper, *, rank=0, value=0, const=0, target="derivative",
                 **kwargs):
        super().__init__(grid, axis, upper, rank=rank, value=value, const=const, target=target,
                         **kwargs)


class ExpressionMixedBC(ExpressionBC):
    """Robin condition from expressions of the coordinates and time."""

    names = ["mixed_expression", "mixed_expr", "robin_expression", "robin_expr"]

    def __init__(self, grid, axis, upper, *, rank=0, value=0, const=0, target="mixed", **kwargs):
        super().__init__(grid, axis, upper, rank=rank, value=value, const=const, target=target,
                         **kwargs)


class NormalDirichletBC(DirichletBC):
    """Dirichlet condition affecting only the normal field component."""

    names = ["normal_value", "normal_dirichlet", "dirichlet_normal"]
    normal = True


class NormalNeumannBC(NeumannBC):
    """Neumann condition affecting only the normal field component."""

    names = ["normal_derivative", "normal_neumann", "neumann_normal"]
    normal = True


class NormalMixedBC(MixedBC):
    """Robin condition affecting only the normal field component."""

    names = ["normal_mixed", "normal_robin"]
    normal = True


class NormalCurvatureBC(CurvatureBC):
    """Curvature condition affecting only the normal field component."""

    names = ["normal_curvature"]
    normal = True


def registered_boundary_condition_classes() -> dict[str, type[BCBase]]:
    """All registered boundary condition classes, by class name."""
    return dict(BCBase._subclasses)


def registered_boundary_condition_names() -> dict[str, type[BCBase]]:
    """All registered boundary condition names."""
    return dict(BCBase._conditions)
