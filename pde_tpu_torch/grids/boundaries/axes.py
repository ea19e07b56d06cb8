"""Boundary conditions for all axes of a grid, and the BC mini-language.

Port of :mod:`pde_tpu.grids.boundaries.axes` for per-axis conditions
(:class:`BoundariesList`). Strings (``"periodic"``,
``"auto_periodic_neumann"``, ...), single-condition dicts (``{"value": 2}``)
and per-side dicts (``{"x": ..., "y-": ..., "*": ...}``) are accepted; under
the config key ``boundaries.accept_lists`` (default True) also a list of
per-axis conditions (with a ``DeprecationWarning``) and a ``{"low": ...,
"high": ...}`` dict for every axis, as in ``pde_tpu``. A callable is a user
function setting every ghost cell (:class:`BoundariesSetter`).
"""

from __future__ import annotations

import logging
import warnings
from typing import Any, Callable

from ...utils.config import config
from ..base import GridBase, PeriodicityError
from .axis import BoundaryAxisBase, get_boundary_axis
from .local import BCBase, BCDataError

_logger = logging.getLogger(__name__)

_DEFAULT_BC = "auto_periodic_neumann"


def set_default_bc(bc_data, default=_DEFAULT_BC):
    """Fill in a default boundary condition where the user did not give one."""
    if bc_data is None:
        return default
    if isinstance(bc_data, dict) and not _is_local_bc_data(bc_data):
        bc_data = dict(bc_data)
        bc_data.setdefault("*", default)
    return bc_data


def _is_local_bc_data(data: dict[str, Any]) -> bool:
    """Whether a dict describes a single local condition (not per-side)."""
    return "type" in data or bool(set(data) & set(BCBase._conditions))


class BoundariesBase:
    """Base class for boundary conditions of all axes of a grid."""

    @classmethod
    def from_data(cls, data, *, grid: GridBase, rank: int = 0) -> BoundariesBase:
        """Create boundary conditions from flexible data."""
        if data is None:
            data = _DEFAULT_BC
        if isinstance(data, BoundariesList):
            if data.grid != grid:
                raise ValueError(
                    "Boundary conditions were defined on a different grid: "
                    f"{data.grid!r} != {grid!r}"
                )
            return data
        if isinstance(data, BoundariesSetter):
            return data
        if callable(data):
            return BoundariesSetter(data)
        return BoundariesList.from_data(data, grid=grid, rank=rank)

    def make_ghost_setter(self) -> Callable:
        """Return ``setter(full, t=0.0, args=None) -> full`` setting the ghost
        cells in place (`t` and `args` reach every side's setter)."""
        raise NotImplementedError


class BoundariesList(BoundariesBase):
    """Boundary conditions specified per axis."""

    def __init__(self, boundaries: list[BoundaryAxisBase]):
        if len(boundaries) == 0:
            raise BCDataError("List of boundaries must not be empty")
        self.grid = boundaries[0].grid
        self.rank = boundaries[0].rank
        if len(boundaries) != self.grid.num_axes:
            raise BCDataError(f"Need boundary conditions for {self.grid.num_axes} axes")
        for axis, boundary in enumerate(boundaries):
            if boundary.grid != self.grid:
                raise BCDataError("Boundaries are not defined on the same grid")
            if boundary.axis != axis:
                raise BCDataError("Boundaries must be ordered like the axes")
            if boundary.periodic != self.grid.periodic[axis]:
                raise PeriodicityError(
                    "Periodicity of conditions incompatible with grid: "
                    f"{boundary.periodic} != {self.grid.periodic[axis]} (axis {axis})"
                )
        self._axes = list(boundaries)

    @classmethod
    def _parse_from_dict(cls, data: dict, *, grid: GridBase, rank: int = 0):
        if config["boundaries.accept_lists"] and ("low" in data or "high" in data):
            return [get_boundary_axis(grid, i, data, rank=rank) for i in range(grid.num_axes)]
        if _is_local_bc_data(data):
            return [get_boundary_axis(grid, i, data, rank=rank) for i in range(grid.num_axes)]
        data = dict(data)
        bc_all = data.pop("*", None)
        bc_data: list[list[Any]] = [[bc_all, bc_all] for _ in range(grid.num_axes)]
        # alternative axis names of the coordinates ("radius" for "r")
        for name, alternatives in getattr(grid.c, "_axes_alt", {}).items():
            for alt in alternatives:
                for ext in ("", "-", "+"):
                    if alt + ext in data:
                        if name + ext in data:
                            raise KeyError(f"Key `{name + ext}` specified twice")
                        data[name + ext] = data.pop(alt + ext)
        for ax, ax_name in enumerate(grid.axes):
            if (bc_axis := data.pop(ax_name, None)) is not None:
                bc_data[ax] = [bc_axis, bc_axis]
            if (bc_lower := data.pop(ax_name + "-", None)) is not None:
                bc_data[ax][0] = bc_lower
            if (bc_upper := data.pop(ax_name + "+", None)) is not None:
                bc_data[ax][1] = bc_upper
        for name, (ax, upper) in grid.boundary_names.items():
            if (bc := data.pop(name, None)) is not None:
                bc_data[ax][int(upper)] = bc
        if data:
            # pde_tpu logs these keys and drops them; an unknown condition
            # name would then silently become the default condition
            raise BCDataError(
                f"Unknown boundary condition data {list(data)}: neither an axis nor a "
                "condition name. " + BCBase.get_help()
            )
        unspecified = [
            grid.axes[ax] + "-+"[i]
            for ax, bc_ax in enumerate(bc_data)
            for i, bc in enumerate(bc_ax)
            if bc is None and not grid.periodic[ax]
        ]
        if unspecified:
            _logger.warning(
                "No boundary conditions specified for %s; using `%s`", unspecified, _DEFAULT_BC
            )
        return [
            get_boundary_axis(
                grid, i, tuple(pair) if pair[0] is not pair[1] else pair[0], rank=rank
            )
            for i, pair in enumerate(bc_data)
        ]

    @classmethod
    def from_data(cls, data, *, grid: GridBase, rank: int = 0) -> BoundariesList:
        if isinstance(data, str):
            bcs = [get_boundary_axis(grid, i, data, rank=rank) for i in range(grid.num_axes)]
        elif isinstance(data, dict):
            bcs = cls._parse_from_dict(data, grid=grid, rank=rank)
        elif config["boundaries.accept_lists"] and hasattr(data, "__len__"):
            warnings.warn(
                "List format for boundary conditions is deprecated. " + BCBase.get_help(),
                DeprecationWarning,
                stacklevel=2,
            )
            if len(data) == grid.num_axes:
                bcs = [get_boundary_axis(grid, i, b, rank=rank) for i, b in enumerate(data)]
            elif grid.num_axes == 1 and len(data) == 2:
                bcs = [get_boundary_axis(grid, 0, data, rank=rank)]
            else:
                raise BCDataError(
                    f"Got {len(data)} conditions for {grid.num_axes} axes. " + BCBase.get_help()
                )
        else:
            raise BCDataError(f"Unsupported boundary format: `{data}`. " + BCBase.get_help())
        return cls(bcs)

    # -- container protocol ---------------------------------------------------------
    def __iter__(self):
        return iter(self._axes)

    def __len__(self) -> int:
        return len(self._axes)

    def __getitem__(self, index) -> BoundaryAxisBase:
        """An axis's pair by index, or one side's condition by name (``"x-"``,
        ``"left"``)."""
        if isinstance(index, str):
            axis, upper = self.grid._get_boundary_index(index)
            return self._axes[axis][upper]
        return self._axes[index]

    def __eq__(self, other):
        if not isinstance(other, BoundariesList):
            return NotImplemented
        return self._axes == other._axes

    def __hash__(self):
        return hash(tuple(self._axes))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self._axes!r})"

    @property
    def boundaries(self):
        """Every local condition, axis by axis, low side first."""
        for pair in self._axes:
            yield from pair

    @property
    def periodic(self) -> list[bool]:
        return [b.periodic for b in self._axes]

    @classmethod
    def get_help(cls) -> str:
        return (
            "Boundary conditions can be specified as a string (e.g. 'periodic', "
            "'auto_periodic_neumann'), a single condition dict (e.g. {'value': 2}), "
            "or a dict keyed by axes/sides (e.g. {'x': 'periodic', 'y-': {'value': 2},"
            " '*': 'derivative'}). " + BCBase.get_help()
        )

    def check_value_rank(self, rank: int) -> None:
        """Check that every condition can handle fields of the given rank."""
        for bc in self.boundaries:
            if bc.rank > rank:
                raise RuntimeError(
                    f"Boundary condition {bc} requires rank {bc.rank}, but field has rank {rank}")

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        """Every side's condition, one a line (both sides of a periodic axis)."""
        lines = []
        for pair in self._axes:
            lines.extend(pair.get_mathematical_representation(field_name))
        return "\n".join(lines)

    def copy(self) -> BoundariesList:
        return BoundariesList([b.copy() for b in self._axes])

    def to_subgrid(self, subgrid: GridBase) -> BoundariesList:
        return BoundariesList([b.to_subgrid(subgrid) for b in self._axes])

    def make_ghost_setter(self) -> Callable:
        """Compose the ghost setters of all axes (non-periodic first, then
        periodic, so periodic wrapping sees physically set ghost values)."""
        setters = [b.make_ghost_setter() for b in self._axes if not b.periodic]
        setters += [b.make_ghost_setter() for b in self._axes if b.periodic]

        def setter(full, t=0.0, args=None):
            for s in setters:
                full = s(full, t, args)
            return full

        return setter


class BoundariesSetter(BoundariesBase):
    """Boundary conditions defined by a user function setting all ghost cells.

    The function's signature is ``f(data_full, args=None) -> data_full``: it
    gets the data with one ghost layer, a tensor on the state's device, and
    returns the tensor with its ghost cells set (a functional update, as in
    ``pde_tpu``; writing into the tensor it got and returning it works too).
    ``args`` holds ``t``. The plain operators take it; the kernels' gates
    refuse it, as ``pde_tpu``'s fused gates do.
    """

    def __init__(self, setter: Callable):
        self._setter = setter

    def __eq__(self, other):
        if not isinstance(other, BoundariesSetter):
            return NotImplemented
        return self._setter is other._setter

    def __hash__(self):
        return hash(self._setter)

    def make_ghost_setter(self) -> Callable:
        user_setter = self._setter

        def setter(full, t=0.0, args=None):
            args = dict(args) if args is not None else {}
            args.setdefault("t", t)
            return user_setter(full, args=args)

        return setter

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        return f"user-defined ghost-cell setter for {field_name}"
