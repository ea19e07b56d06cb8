"""Local boundary conditions: one side of one axis.

Port of :mod:`pde_tpu.grids.boundaries.local` restricted to periodic and
constant affine conditions. Each condition computes the *virtual point*
(ghost-cell value) just outside the boundary from the field values inside.

Virtual-point formulas (1st order):
    ghost = const + factor * data[edge]
with (const, factor):
    * Dirichlet value v:  (2v, -1)
    * Neumann deriv d:    (d*dx, +1)
    * Robin ∂c+γc=β:      (2dxβ/(2+dxγ), (2-dxγ)/(2+dxγ)); γ→∞ gives (0, -1)
2nd order (curvature v): ghost = v*dx² + 2*data[i1] - data[i2]

Ghost setters write into a padded tensor (one ghost layer per axis) in place;
the operator that owns the padded tensor created it for this purpose.
"""

from __future__ import annotations

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
        for name in cls.names:
            BCBase._conditions[name] = cls

    @property
    def periodic(self) -> bool:
        return isinstance(self, _PeriodicBC)

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

    #: the names of ``pde_tpu``'s expression conditions (``ExpressionBC``), not ported yet
    _EXPRESSION_NAMES = (
        "value_expression", "value_expr", "derivative_expression", "derivative_expr",
        "mixed_expression", "mixed_expr", "robin_expression", "robin_expr",
    )

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
        if condition in cls._EXPRESSION_NAMES:
            raise NotImplementedError(
                f"The `{condition}` condition (an expression of the coordinates and time) is "
                "not ported yet (ROADMAP A4)")
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
        for key in list(data):
            if key in BCBase._conditions or key in cls._EXPRESSION_NAMES:
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
        """Return ``setter(full) -> full`` writing this side's ghost cells."""
        raise NotImplementedError


class _PeriodicBC(BCBase):
    """Periodic (or anti-periodic) boundary condition."""

    def __init__(self, grid, axis, upper, *, flip_sign: bool = False, rank: int = 0):
        super().__init__(grid, axis, upper, rank=rank)
        self.flip_sign = flip_sign

    def _value_key(self):
        return self.flip_sign

    def make_ghost_setter(self):
        write = self._ghost_index()
        read = list(write)
        read[1 + self.axis] = 1 if self.upper else -2  # opposite valid edge (after ...)
        read = tuple(read)
        sign = -1.0 if self.flip_sign else 1.0

        def setter(full):
            full[write] = sign * full[read]
            return full

        return setter


def _as_tensor_like(value, full: torch.Tensor):
    """A python float for scalars, else a tensor on `full`'s device."""
    if np.ndim(value) == 0:
        return float(value)
    return torch.as_tensor(np.asarray(value), dtype=full.dtype, device=full.device)


class ConstBCBase(BCBase):
    """Base class for conditions with a constant (possibly space-dependent) value."""

    def __init__(self, grid, axis, upper, *, rank: int = 0, value=0):
        super().__init__(grid, axis, upper, rank=rank)
        self.value = self._parse_value(value)

    def _value_key(self):
        return _hash_value(self.value)

    def _repr_value(self):
        return [f"value={self.value!r}"]

    def _parse_value(self, value):
        """Parse a BC value: a scalar, or an array over the boundary, over the
        components (vector and tensor conditions), or over both; arrays are
        broadcast to ``(dim,)*rank + boundary shape``."""
        if isinstance(value, str):
            raise NotImplementedError(
                "Expression-valued boundary conditions are not ported yet "
                "(ROADMAP A4)"
            )
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


class ConstBC1stOrderBase(ConstBCBase):
    """Conditions whose virtual point is affine in one adjacent cell."""

    def get_virtual_point_data(self) -> tuple[Any, Any, int]:
        """Return (const, factor, index) with ghost = const + factor*data[index]."""
        raise NotImplementedError

    def make_ghost_setter(self):
        const, factor, index = self.get_virtual_point_data()
        edge = self.grid.shape[self.axis] - 1 if self.upper else 0
        write, read = self._ghost_index(), self._ghost_index(abs(index - edge))

        def setter(full):
            c = _as_tensor_like(const, full)
            f = _as_tensor_like(factor, full)
            full[write] = c + f * full[read]
            return full

        return setter


class DirichletBC(ConstBC1stOrderBase):
    """Imposes the value of the field at the boundary."""

    names = ["value", "dirichlet"]

    def get_virtual_point_data(self):
        const = 2 * np.asarray(self.value)
        index = self.grid.shape[self.axis] - 1 if self.upper else 0
        return (const, -np.ones_like(const), index)


class NeumannBC(ConstBC1stOrderBase):
    """Imposes the derivative in the outward normal direction."""

    names = ["derivative", "neumann"]

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

        def setter(full):
            c = _as_tensor_like(const, full)
            g1 = _as_tensor_like(f1, full)
            g2 = _as_tensor_like(f2, full)
            full[write] = c + g1 * full[read1] + g2 * full[read2]
            return full

        return setter


class CurvatureBC(ConstBC2ndOrderBase):
    """Imposes the second normal derivative at the boundary."""

    names = ["curvature", "second_derivative", "extrapolate"]

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
