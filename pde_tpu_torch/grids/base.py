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


class DomainError(ValueError):
    """Exception indicating that a point lies outside the domain."""


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
    #: ``pde_tpu``'s attribute, which holds no data there either
    cell_volume_data: Any = None

    _shape: tuple[int, ...]
    _periodic: list[bool]

    def __init__(self) -> None:
        self._axes_coords: tuple[np.ndarray, ...] = ()
        self._axes_bounds: tuple[tuple[float, float], ...] = ()
        self._discretization: np.ndarray = np.empty(0)
        self._operator_cache: dict[Any, Callable] = {}

    def __init_subclass__(cls, register: bool = True, **kwargs) -> None:
        """Register the class by name (for :meth:`from_state` and
        :func:`registered_grids`) unless ``register=False``, as for the views
        of decomposed grids."""
        super().__init_subclass__(**kwargs)
        if register:
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

    @property
    def _shape_full(self) -> tuple[int, ...]:
        """The shape with one layer of ghost cells on every axis."""
        return tuple(n + 2 for n in self._shape)

    @property
    def _idx_valid(self) -> tuple[slice, ...]:
        """Slices of the valid cells in data with ghost cells."""
        return tuple(slice(1, n + 1) for n in self._shape)

    @functools.cached_property
    def coordinate_arrays(self) -> tuple[np.ndarray, ...]:
        """Meshgrid arrays of the cell-centre coordinates, one per axis."""
        return tuple(np.meshgrid(*self.axes_coords, indexing="ij"))

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
    def uniform_cell_volumes(self) -> bool:
        vols = np.asarray(self.cell_volumes)
        return bool(np.allclose(vols, vols.flat[0]))

    @functools.cached_property
    def volume(self) -> float:
        return float(np.broadcast_to(self.cell_volumes, self.shape).sum())

    @property
    def typical_discretization(self) -> float:
        return float(np.mean(self.discretization))

    @functools.cached_property
    def _axis_volume_factors(self) -> list[np.ndarray]:
        """Per-axis 1D arrays whose outer product is ``cell_volumes`` (the
        spacings here; curvilinear grids override it)."""
        return [np.full(self.shape[i], self.discretization[i]) for i in range(self.num_axes)]

    def get_axis_index(self, key: int | str, allow_symmetric: bool = True) -> int:
        """Return the index of the axis given by name (or one of the
        coordinate system's alternative names, ``"radius"`` for ``"r"``) or
        index (`allow_symmetric` accepted as in ``pde_tpu``, which ignores it
        too)."""
        if isinstance(key, (int, np.integer)):
            if 0 <= key < self.num_axes:
                return int(key)
            raise IndexError(f"Axis index {key} out of bounds")
        if key in self.axes:
            return self.axes.index(key)
        for name, alternatives in getattr(self.c, "_axes_alt", {}).items():
            if key in alternatives and name in self.axes:
                return self.axes.index(name)
        raise ValueError(f"`{key}` is not a valid axis name; use one of {self.axes}")

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

    def transform(self, coordinates, source: str, target: str, *, full: bool = False):
        """Convert coordinates between ``"cartesian"``, ``"grid"`` and
        ``"cell"`` (fractional cell positions) representations."""
        coordinates = np.atleast_1d(coordinates)
        if source == target:
            return coordinates
        x0 = np.array([b[0] for b in self.axes_bounds])
        if source == "cartesian":
            grid_coords = self.point_from_cartesian(coordinates, full=full)
        elif source == "cell":
            grid_coords = x0 + coordinates * self.discretization
        elif source == "grid":
            grid_coords = coordinates
        else:
            raise ValueError(f"Unknown coordinate system `{source}`")
        if target == "grid":
            return grid_coords
        if target == "cartesian":
            return self.point_to_cartesian(grid_coords, full=full)
        if target == "cell":
            return (grid_coords - x0) / self.discretization
        raise ValueError(f"Unknown coordinate system `{target}`")

    def contains_point(self, points, *, coords: str = "cartesian", full: bool = False):
        """Whether the points lie within the grid's bounds."""
        points = self.transform(np.atleast_1d(points), coords, "grid", full=full)
        result = np.ones(points.shape[:-1], dtype=bool)
        for i, (lo, hi) in enumerate(self.axes_bounds):
            result &= (points[..., i] >= lo) & (points[..., i] <= hi)
        return result

    def normalize_point(self, point, *, reflect: bool = False):
        """Map points into the grid: periodic axes wrap, and with `reflect`
        the others reflect at their bounds."""
        point = np.array(np.atleast_1d(point), dtype=float)
        if point.shape[-1] != self.num_axes:
            raise DimensionError(
                f"Point with {point.shape[-1]} coordinates cannot be normalized on a "
                f"grid with {self.num_axes} axes")
        for i in range(self.num_axes):
            lo, hi = self.axes_bounds[i]
            length = hi - lo
            if self.periodic[i]:
                point[..., i] = (point[..., i] - lo) % length + lo
            elif reflect:
                arg = (point[..., i] - hi) % (2 * length)
                point[..., i] = hi - np.abs(arg - length)
        return point

    def iter_mirror_points(self, point, with_self: bool = False, only_periodic: bool = True):
        """The images of `point` one period away along each (periodic) axis."""
        point = np.asanyarray(point, dtype=float)
        if with_self:
            yield point.copy()
        for i in range(self.num_axes):
            if self.periodic[i] or not only_periodic:
                lo, hi = self.axes_bounds[i]
                for offset in (lo - hi, hi - lo):
                    p = point.copy()
                    p[..., i] += offset
                    yield p

    def difference_vector(self, p1, p2, *, coords: str = "grid"):
        """``p2 - p1``, the shortest one across periodic axes."""
        p1 = self.transform(np.atleast_1d(p1), coords, "grid")
        p2 = self.transform(np.atleast_1d(p2), coords, "grid")
        diff = np.atleast_1d(p2) - np.atleast_1d(p1)
        for i in range(self.num_axes):
            if self.periodic[i]:
                length = self.axes_bounds[i][1] - self.axes_bounds[i][0]
                diff[..., i] = (diff[..., i] + length / 2) % length - length / 2
        return diff

    def distance(self, p1, p2, *, coords: str = "grid"):
        """The distance of two points, across periodic axes."""
        return np.linalg.norm(self.difference_vector(p1, p2, coords=coords), axis=-1)

    def get_random_point(self, *, boundary_distance: float = 0, coords: str = "cartesian",
                         rng=None):
        """A random point of the grid's box, at least `boundary_distance` from
        its bounds (``pde_tpu``'s draw for the same `rng`)."""
        rng = np.random.default_rng(rng)
        bounds = np.array(self.axes_bounds)
        lo = bounds[:, 0] + boundary_distance
        hi = bounds[:, 1] - boundary_distance
        if np.any(lo > hi):
            raise RuntimeError("Random points would be too close to boundary")
        return self.transform(rng.uniform(lo, hi), "grid", coords)

    def _grid_to_fractional(self, points):
        """Fractional cell indices of points in grid coordinates: numpy for
        an array, torch (on its device) for a tensor."""
        x0 = np.array([b[0] for b in self.axes_bounds])
        dx = np.asarray(self.discretization)
        if isinstance(points, torch.Tensor):
            x0 = torch.as_tensor(x0, dtype=points.dtype, device=points.device)
            dx = torch.as_tensor(dx, dtype=points.dtype, device=points.device)
            return (points - x0) / dx - 0.5
        return (np.asarray(points) - x0) / dx - 0.5

    def _get_boundary_index(self, index) -> tuple[int, bool]:
        """``(axis, upper)`` of a side given by name (``"left"``, ``"x-"``)
        or as a pair."""
        if isinstance(index, str):
            if index in self.boundary_names:
                return self.boundary_names[index]
            if index.endswith(("-", "+")):
                return self.get_axis_index(index[:-1]), index.endswith("+")
            raise ValueError(f"Unknown boundary `{index}`")
        axis, upper = index
        if isinstance(axis, str):
            axis = self.get_axis_index(axis)
        return int(axis), bool(upper)

    # -- plotting ----------------------------------------------------------------------
    def get_image_data(self, data, **kwargs) -> dict[str, Any]:
        raise NotImplementedError

    def get_line_data(self, data, extract: str = "auto") -> dict[str, Any]:
        raise NotImplementedError

    def get_vector_data(self, data, **kwargs) -> dict[str, Any]:
        raise NotImplementedError

    def plot(self, *args, **kwargs):
        raise NotImplementedError(
            f"Grid class {self.__class__.__name__} does not support plotting"
        )

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

    def copy(self) -> GridBase:
        return self.__class__.from_state(dict(self.state))

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

        if isinstance(operator, OperatorInfo):
            return operator
        for klass in cls.__mro__:
            registry = getattr(klass, "_operators", None)
            if registry and operator in registry:
                return registry[operator]
        raise NotImplementedError(
            f"Operator `{operator}` is not defined for grid {cls.__name__}. "
            f"Defined operators: {sorted(cls.operators())}"
        )

    @classmethod
    def operators(cls) -> set[str]:
        """The names of the operators registered for this grid class."""
        from .. import ops  # noqa: F401  (registers the operators)

        result: set[str] = set()
        for klass in cls.__mro__:
            result |= set(getattr(klass, "_operators", {}) or {})
        return result

    def _resolve_axis_operator(self, operator) -> OperatorInfo | None:
        """The derivative along an axis of this grid that `operator` names
        (``d_dx``, ``d_dx_central``, ``d_dx_forward``, ``d_dx_backward``,
        ``d2_dx2``; ``pde_tpu``'s ``make_derivative`` and
        ``make_derivative2``, resolved as ``pde_tpu`` resolves them), or None."""
        from ..ops.common import make_derivative, make_derivative2

        if not isinstance(operator, str):
            return None
        if operator.startswith("d2_d") and operator.endswith("2"):
            name = operator[len("d2_d"):-1]
            if name in self.axes:
                factory = functools.partial(make_derivative2, axis=self.axes.index(name))
                return OperatorInfo(factory, rank_in=0, rank_out=0, name=operator)
        elif operator.startswith("d_d"):
            name, method = operator[len("d_d"):], "central"
            for direction in ("central", "forward", "backward"):
                if name.endswith("_" + direction):
                    name, method = name[: -len("_" + direction)], direction
                    break
            if name in self.axes:
                factory = functools.partial(make_derivative, axis=self.axes.index(name),
                                            method=method)
                return OperatorInfo(factory, rank_in=0, rank_out=0, name=operator)
        return None

    def make_operator_no_bc(self, operator: str, **kwargs) -> Callable:
        """``op(full) -> valid``: `operator` applied to data that already
        holds one layer of ghost cells."""
        info = self._resolve_axis_operator(operator) or self._get_operator_info(operator)
        return info.factory(self, bcs=None, **kwargs)

    def make_operator(self, operator: str, bc, **kwargs) -> Callable:
        """Return ``op(data, t=0.0, args=None)`` applying `operator` with `bc`.

        Operators are cached per (operator, boundary conditions, kwargs,
        operator configuration).
        """
        from ..utils.config import config

        info = self._resolve_axis_operator(operator) or self._get_operator_info(operator)
        bcs = self.get_boundary_conditions(bc, rank=info.rank_in)
        key = (operator, bcs, tuple(sorted(kwargs.items())),
               tuple(sorted(config["operators"].items())))
        op = self._operator_cache.get(key)
        if op is None:
            op = self._operator_cache[key] = info.factory(self, bcs=bcs, **kwargs)
        return op

    # -- integration -----------------------------------------------------------------
    def integrate(self, data, axes=None) -> torch.Tensor:
        """Integrate data over the grid, or over the axes `axes`: the data
        times each axis' volume factor, summed, as in ``pde_tpu``. `data` is
        a tensor (its dtype and device kept) or anything ``np.asarray``
        takes, which becomes a tensor on the config's device: a numpy array
        keeps its dtype, a Python scalar takes torch's default dtype (a
        scalar integrates to the grid's volume)."""
        from ..utils.config import default_device

        if not isinstance(data, torch.Tensor):
            dtype = torch.get_default_dtype() if isinstance(data, (int, float)) else None
            from ..fields.base import from_host

            data = torch.as_tensor(from_host(np.asarray(data)), dtype=dtype,
                                   device=default_device())
        # integer data is weighted in the default dtype, as numpy promotes it
        weights = data.dtype if data.is_floating_point() or data.is_complex() else \
            torch.get_default_dtype()
        if axes is None:
            axes_list = list(range(self.num_axes))
        elif isinstance(axes, int):
            axes_list = [axes % self.num_axes]
        else:
            axes_list = sorted(a % self.num_axes for a in axes)
        for ax in axes_list:
            shape = [1] * self.num_axes
            shape[ax] = self.shape[ax]
            factor = torch.as_tensor(self._axis_volume_factors[ax], dtype=weights,
                                     device=data.device)
            data = data * factor.reshape(shape)
        if not axes_list:  # torch sums every axis for dim=(); numpy sums none
            return data
        return data.sum(dim=tuple(a - self.num_axes for a in axes_list))


def registered_grids() -> list[str]:
    """The names of all registered grid classes."""
    return sorted(name for name in GridBase._subclasses if not name.endswith("Base"))


def registered_operators() -> dict[str, list[str]]:
    """The operators registered for each grid class, by class name."""
    return {name: sorted(cls.operators()) for name, cls in GridBase._subclasses.items()
            if any(getattr(k, "_operators", None) for k in cls.__mro__)}


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
