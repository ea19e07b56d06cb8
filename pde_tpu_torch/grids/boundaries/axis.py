"""Boundary-condition pairs for a single grid axis.

Port of :mod:`pde_tpu.grids.boundaries.axis`.
"""

from __future__ import annotations

from ..base import GridBase, PeriodicityError
from .local import BCBase, BCDataError, _PeriodicBC


class BoundaryAxisBase:
    """Boundary conditions at both ends of one axis."""

    def __init__(self, low: BCBase, high: BCBase):
        if low.grid != high.grid:
            raise ValueError("Boundary conditions are not defined on the same grid")
        if low.axis != high.axis:
            raise ValueError("Boundary conditions are not defined for the same axis")
        if low.upper or not high.upper:
            raise ValueError("Order of boundary conditions is incorrect")
        self.low = low
        self.high = high

    @property
    def grid(self) -> GridBase:
        return self.low.grid

    @property
    def axis(self) -> int:
        return self.low.axis

    @property
    def rank(self) -> int:
        return self.low.rank

    @property
    def periodic(self) -> bool:
        return self.low.periodic

    def __iter__(self):
        yield self.low
        yield self.high

    def __getitem__(self, index):
        if index in (0, False):
            return self.low
        if index in (1, True):
            return self.high
        raise IndexError("Index must be 0/False (lower) or 1/True (upper)")

    def __eq__(self, other):
        if not isinstance(other, BoundaryAxisBase):
            return NotImplemented
        return self.low == other.low and self.high == other.high

    def __hash__(self):
        return hash((self.low, self.high))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.low!r}, {self.high!r})"

    def _recreate(self, low: BCBase, high: BCBase) -> BoundaryAxisBase:
        """A pair of the new local conditions (a periodic pair's periodicity
        lives in its conditions, so it recreates as a plain pair, as in
        ``pde_tpu``)."""
        return BoundaryPair(low, high)

    def copy(self) -> BoundaryAxisBase:
        return self._recreate(self.low.copy(), self.high.copy())

    def to_subgrid(self, subgrid: GridBase) -> BoundaryAxisBase:
        return self._recreate(self.low.to_subgrid(subgrid), self.high.to_subgrid(subgrid))

    def get_mathematical_representation(self, field_name: str = "C") -> tuple[str, str]:
        return (self.low.get_mathematical_representation(field_name),
                self.high.get_mathematical_representation(field_name))

    def make_ghost_setter(self):
        """Function setting the ghost layers on both sides of this axis."""
        set_low = self.low.make_ghost_setter()
        set_high = self.high.make_ghost_setter()

        def setter(full, t=0.0, args=None):
            return set_high(set_low(full, t, args), t, args)

        return setter


class BoundaryPair(BoundaryAxisBase):
    """The two boundaries of one axis."""

    @classmethod
    def from_data(cls, grid: GridBase, axis: int, data, *, rank: int = 0) -> BoundaryPair:
        if isinstance(data, dict) and ("low" in data or "high" in data):
            data = dict(data)
            low, high = data.pop("low"), data.pop("high")
            if data:
                raise BCDataError(f"Unexpected keys in BC data: {list(data)}")
        elif isinstance(data, (tuple, list)) and len(data) == 2:
            low, high = data
        else:  # one condition for both sides
            low = high = data
        return cls(
            BCBase.from_data(grid, axis, False, low, rank=rank),
            BCBase.from_data(grid, axis, True, high, rank=rank),
        )


class BoundaryPeriodic(BoundaryPair):
    """The two periodic boundaries of one axis."""

    def __init__(self, grid: GridBase, axis: int, flip_sign: bool = False, *, rank: int = 0):
        low = _PeriodicBC(grid, axis, upper=False, flip_sign=flip_sign, rank=rank)
        high = _PeriodicBC(grid, axis, upper=True, flip_sign=flip_sign, rank=rank)
        super().__init__(low, high)

    @property
    def flip_sign(self) -> bool:
        return self.low.flip_sign


def get_boundary_axis(grid: GridBase, axis: int, data, *, rank: int = 0) -> BoundaryAxisBase:
    """Return the boundary pair for one axis from flexible data."""
    if data is None:
        data = "auto_periodic_neumann"
    if isinstance(data, BoundaryAxisBase):
        if data.grid != grid or data.axis != axis:
            raise BCDataError("Boundary pair belongs to another grid axis")
        return data
    if isinstance(data, str):
        if data in ("periodic", "anti-periodic"):
            if not grid.periodic[axis]:
                raise PeriodicityError(
                    f"Axis {grid.axes[axis]} is not periodic; cannot use periodic BCs"
                )
            return BoundaryPeriodic(grid, axis, flip_sign=(data == "anti-periodic"), rank=rank)
        if data.startswith("auto_periodic_") or data == "natural":
            if grid.periodic[axis]:
                return BoundaryPeriodic(grid, axis, rank=rank)
            kind = "neumann" if data == "natural" else data[len("auto_periodic_") :]
            data = {"neumann": "derivative", "dirichlet": "value"}.get(kind, kind)
    if grid.periodic[axis]:
        # periodic axes only support periodic conditions
        if isinstance(data, (tuple, list)) and len(data) == 2 and all(
            d in ("periodic", "anti-periodic") for d in data
        ):
            if data[0] != data[1]:
                raise PeriodicityError("Both sides of a periodic axis must match")
            return BoundaryPeriodic(grid, axis, flip_sign=(data[0] == "anti-periodic"), rank=rank)
        raise PeriodicityError(
            f"Axis {grid.axes[axis]} is periodic; only 'periodic' or 'anti-periodic' "
            f"boundary conditions are allowed (got `{data}`)"
        )
    return BoundaryPair.from_data(grid, axis, data, rank=rank)
