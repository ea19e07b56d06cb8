"""Base class for grids: host-side geometry metadata.

Port of :class:`pde_tpu.grids.base.GridBase`. A grid holds shapes,
coordinates, spacings and cell volumes as numpy data. It builds operators
for one set of boundary conditions (:meth:`GridBase.make_operator`), which
act on ``torch.Tensor`` data on whatever device the tensor lives on.
"""

from __future__ import annotations

import functools
import json
from typing import Any, Callable

import numpy as np
import torch

from .coordinates import CoordinatesBase, DimensionError  # noqa: F401


class PeriodicityError(RuntimeError):
    """Exception indicating inconsistent grid periodicity."""


def _check_shape(shape) -> tuple[int, ...]:
    """Normalize a shape specification to a tuple of positive ints."""
    if not hasattr(shape, "__iter__"):
        shape = [shape]
    if len(shape) == 0:
        raise ValueError("Require at least one dimension")
    result = []
    for n in shape:
        if n != int(n) or n < 1:
            raise ValueError(f"{n!r} is not a valid number of support points")
        result.append(int(n))
    return tuple(result)


def discretize_interval(x_min: float, x_max: float, num: int):
    """Equidistant cell-centered discretization: (cell midpoints, dx)."""
    dx = (x_max - x_min) / num
    return (np.arange(num) + 0.5) * dx + x_min, dx


class OperatorInfo:
    """Metadata for a registered differential operator."""

    __slots__ = ("factory", "rank_in", "rank_out", "name")

    def __init__(self, factory, rank_in: int, rank_out: int, name: str = ""):
        self.factory = factory
        self.rank_in = rank_in
        self.rank_out = rank_out
        self.name = name


class GridBase:
    """Abstract base class for all grids."""

    _subclasses: dict[str, type[GridBase]] = {}
    _operators: dict[str, OperatorInfo]  # per-class operator registry

    c: CoordinatesBase
    axes: list[str]
    boundary_names: dict[str, tuple[int, bool]] = {}
    coordinate_constraints: list[int] = []

    _shape: tuple[int, ...]
    _periodic: list[bool]

    def __init__(self) -> None:
        self._axes_coords: tuple[np.ndarray, ...] = ()
        self._axes_bounds: tuple[tuple[float, float], ...] = ()
        self._discretization: np.ndarray = np.empty(0)
        self._operator_cache: dict[Any, Callable] = {}

    def __init_subclass__(cls, **kwargs) -> None:
        super().__init_subclass__(**kwargs)
        GridBase._subclasses.setdefault(cls.__name__, cls)
        cls._operators = {}

    # -- fundamental properties ------------------------------------------------
    @property
    def dim(self) -> int:
        """Dimension of the embedding space."""
        return self.c.dim

    @property
    def num_axes(self) -> int:
        return len(self._shape)

    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape

    @property
    def periodic(self) -> list[bool]:
        return self._periodic

    @property
    def discretization(self) -> np.ndarray:
        return self._discretization

    @property
    def axes_coords(self) -> tuple[np.ndarray, ...]:
        return self._axes_coords

    @property
    def axes_bounds(self) -> tuple[tuple[float, float], ...]:
        return self._axes_bounds

    @property
    def num_cells(self) -> int:
        return int(np.prod(self._shape))

    @functools.cached_property
    def cell_coords(self) -> np.ndarray:
        """Coordinates of all cell centers, shape ``shape + (num_axes,)``."""
        return np.moveaxis(np.array(np.meshgrid(*self.axes_coords, indexing="ij")), 0, -1)

    @functools.cached_property
    def cell_volumes(self) -> np.ndarray:
        """Volume of every cell, through the coordinate system's cell volume
        of the box each cell spans in grid coordinates."""
        half = self.discretization / 2
        return np.asarray(self.c.cell_volume(self.cell_coords - half, self.cell_coords + half))

    @functools.cached_property
    def volume(self) -> float:
        return float(np.broadcast_to(self.cell_volumes, self.shape).sum())

    @functools.cached_property
    def _axis_volume_factors(self) -> list[np.ndarray]:
        """Per-axis 1D arrays whose outer product is ``cell_volumes`` (the
        spacings here; curvilinear grids override it)."""
        return [np.full(self.shape[i], self.discretization[i]) for i in range(self.num_axes)]

    def get_axis_index(self, key: int | str) -> int:
        """Return the index of the axis given by name (or one of the
        coordinate system's alternative names, ``"radius"`` for ``"r"``) or
        index."""
        if isinstance(key, (int, np.integer)):
            if 0 <= key < self.num_axes:
                return int(key)
            raise IndexError(f"Axis index {key} out of bounds")
        if key in self.axes:
            return self.axes.index(key)
        for name, alternatives in getattr(self.c, "_axes_alt", {}).items():
            if key in alternatives and name in self.axes:
                return self.axes.index(name)
        raise IndexError(f"`{key}` is not an axis of {self.__class__.__name__} ({self.axes})")

    # -- points ---------------------------------------------------------------------------
    def _coords_symmetric(self, points):
        """Reduce the coordinate system's coordinates to the grid's."""
        return points

    def _coords_full(self, points):
        """Extend the grid's coordinates to all of the coordinate system's."""
        return points

    def point_to_cartesian(self, points, *, full: bool = False):
        """Convert grid coordinates (all ``dim`` of them with ``full=True``)
        to Cartesian coordinates."""
        points = np.atleast_1d(points)
        return self.c.pos_to_cart(points if full else self._coords_full(points))

    def point_from_cartesian(self, points, *, full: bool = False):
        """Convert Cartesian coordinates to grid coordinates."""
        coords = self.c.pos_from_cart(np.atleast_1d(points))
        return coords if full else self._coords_symmetric(coords)

    # -- identity ---------------------------------------------------------------
    @property
    def state(self) -> dict[str, Any]:
        raise NotImplementedError

    @property
    def state_serialized(self) -> str:
        state = dict(self.state)
        state["class"] = self.__class__.__name__
        return json.dumps(state)

    @classmethod
    def from_state(cls, state: str | dict[str, Any]) -> GridBase:
        """Recreate a grid from a (serialized) state naming its class."""
        if isinstance(state, str):
            state = json.loads(state)
        state = dict(state)
        cls_name = state.pop("class")
        if cls_name not in GridBase._subclasses:
            raise ValueError(f"Unknown grid class `{cls_name}`")
        return GridBase._subclasses[cls_name].from_state(state)

    def __eq__(self, other) -> bool:
        if not isinstance(other, GridBase):
            return NotImplemented
        return (
            self.__class__ is other.__class__
            and self.shape == other.shape
            and self.axes_bounds == other.axes_bounds
            and self.periodic == other.periodic
        )

    def __hash__(self) -> int:
        return hash(
            (self.__class__.__name__, self.shape, self.axes_bounds, tuple(self.periodic))
        )

    def compatible_with(self, other: GridBase) -> bool:
        """Whether fields from `other` can be used with this grid."""
        return (
            self.__class__ is other.__class__
            and self.shape == other.shape
            and self.periodic == other.periodic
        )

    def assert_grid_compatible(self, other: GridBase) -> None:
        if not self.compatible_with(other):
            raise ValueError(f"Grids {self} and {other} are incompatible")

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}" for k, v in self.state.items())
        return f"{self.__class__.__name__}({args})"

    # -- boundary conditions -------------------------------------------------------
    def _boundary_coordinates(self, axis: int, upper: bool, *, offset: float = 0.0):
        """Coordinates of the cell centres next to one side, with the side's
        position (moved outward by `offset`) along `axis`: an array of shape
        ``shape[:axis] + shape[axis + 1:] + (num_axes,)``."""
        coords = [np.asarray(c) for c in self.axes_coords]
        bound = self.axes_bounds[axis][1 if upper else 0]
        sign = 1 if upper else -1
        coords[axis] = np.array([bound + sign * offset])
        mesh = np.meshgrid(*coords, indexing="ij")
        return np.squeeze(np.moveaxis(np.array(mesh), 0, -1), axis=axis)

    def get_boundary_conditions(self, bc="auto_periodic_neumann", rank: int = 0):
        """Construct boundary conditions from the BC mini-language.

        On a decomposed block's view (a grid holding its ``mesh``, as
        :class:`~pde_tpu_torch.parallel.mesh.ExtendedBlockGrid` does) the
        specification parses on the global grid, so that value arrays refer to
        the global boundary, and becomes that view's
        :class:`~pde_tpu_torch.parallel.boundaries.ShardedBoundaries`, as in
        ``pde_tpu``."""
        from .boundaries.axes import BoundariesBase

        mesh = getattr(self, "mesh", None)
        if mesh is not None:
            from ..parallel.boundaries import ShardedBoundaries

            if isinstance(bc, ShardedBoundaries):
                return bc
            return ShardedBoundaries(self, BoundariesBase.from_data(
                bc, grid=mesh.basegrid, rank=rank))
        return BoundariesBase.from_data(bc, grid=self, rank=rank)

    # -- operators -------------------------------------------------------------------
    @classmethod
    def register_operator(cls, name: str, factory=None, rank_in: int = 0, rank_out: int = 0):
        """Register a differential operator factory for this grid class."""

        def register(factory):
            cls._operators[name] = OperatorInfo(factory, rank_in, rank_out, name)
            return factory

        if factory is None:
            return register
        return register(factory)

    @classmethod
    def _get_operator_info(cls, operator: str) -> OperatorInfo:
        from .. import ops  # noqa: F401  (registers the operators)

        for klass in cls.__mro__:
            registry = getattr(klass, "_operators", None)
            if registry and operator in registry:
                return registry[operator]
        raise NotImplementedError(
            f"Operator `{operator}` is not defined for grid {cls.__name__}"
        )

    def make_operator(self, operator: str, bc, **kwargs) -> Callable:
        """Return ``op(data, t=0.0, args=None)`` applying `operator` with `bc`.

        Operators are cached per (operator, boundary conditions, kwargs,
        operator configuration).
        """
        from ..utils.config import config

        info = self._get_operator_info(operator)
        bcs = self.get_boundary_conditions(bc, rank=info.rank_in)
        key = (operator, bcs, tuple(sorted(kwargs.items())),
               tuple(sorted(config["operators"].items())))
        op = self._operator_cache.get(key)
        if op is None:
            op = self._operator_cache[key] = info.factory(self, bcs=bcs, **kwargs)
        return op

    # -- integration -----------------------------------------------------------------
    def integrate(self, data: torch.Tensor, axes=None) -> torch.Tensor:
        """Integrate data over the grid, or over the axes `axes`: the data
        times each axis' volume factor, summed, as in ``pde_tpu``."""
        if axes is None:
            axes_list = list(range(self.num_axes))
        elif isinstance(axes, int):
            axes_list = [axes % self.num_axes]
        else:
            axes_list = sorted(a % self.num_axes for a in axes)
        for ax in axes_list:
            shape = [1] * self.num_axes
            shape[ax] = self.shape[ax]
            factor = torch.as_tensor(self._axis_volume_factors[ax], dtype=data.dtype,
                                     device=data.device)
            data = data * factor.reshape(shape)
        return data.sum(dim=tuple(a - self.num_axes for a in axes_list))


def radial_factor(grid: GridBase, compute: Callable, axis: int = 0) -> np.ndarray:
    """A coordinate-dependent factor of an operator, ``compute(coords)``
    evaluated in numpy on the host on the cell-centre coordinates of `axis`.

    On a decomposed block's view (a grid holding its ``mesh`` and the global
    ``indices`` of its cells, :class:`~pde_tpu_torch.parallel.mesh.ExtendedBlockGrid`)
    it is the global grid's factor sliced to the view's cells, as
    ``pde_tpu``'s ``radial_factor_traced`` slices it per shard, so that every
    cell of a view gets the number the serial grid gives that cell."""
    mesh = getattr(grid, "mesh", None)
    if mesh is None:
        return np.asarray(compute(np.asarray(grid.axes_coords[axis])))
    values = np.asarray(compute(np.asarray(mesh.basegrid.axes_coords[axis])))
    return values[grid.indices[axis]] if values.ndim else values
