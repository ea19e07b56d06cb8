"""Boundary conditions of a decomposed grid's blocks.

Port of :mod:`pde_tpu.parallel.boundaries`. ``pde_tpu`` runs one shard's rhs
under ``shard_map``, and every operator's ghost setter exchanges one ghost
layer by ``lax.ppermute``, overwritten by the physical condition on the shards
at the global edge. One process holds every block here and cannot read a
neighbour's intermediate values, so the plain decomposed stepper fills each
block's extended view once per rhs evaluation instead, a halo as deep as the
rhs reads (:meth:`.fused.HaloExchange.extend`), and evaluates the rhs on it.
These are the conditions of that view (an
:class:`~.mesh.ExtendedBlockGrid`): where the view stops at a global
non-periodic edge, that side's condition of the global grid, its value arrays
sliced to the view; on an uncut periodic axis, the local wrap; at a cut side
or across a cut periodic wrap, nothing: the halo holds the neighbours' cells,
and the padded ghost layer beyond it (zero) spoils only cells of the halo,
which the stepper trims. Every interior cell then reads the operands the
serial run reads, in the same order.

An anti-periodic axis that the mesh cuts: the exchange copies the cells
across the global wrap as they are, so a view holds, past the wrap, the
cells of the far side. ``pde_tpu``'s exchanger negates them for every
operator (``pde_tpu/parallel/boundaries.py:312-337``); here each operator
on the view negates them on entry and its result there on exit
(:attr:`ShardedBoundaries.flip`, applied by
:func:`~pde_tpu_torch.ops.common.wrap_with_bcs`), so that the stencil reads
the anti-periodic continuation, as the serial run's ghosts give it, while
the pointwise parts of the rhs see the far side's own values there. Every
interior cell then reads the serial run's operands: negation is exact. An expression condition evaluates on
the view's part of the global side's coordinates, at the time of the
rhs; a string value is an array over the global side, sliced like the
others. The 9-point stencil's ghost corners
need no pass of their own (``pde_tpu``'s ``_make_corner_pass``): the serial
corner rule on the view is exact wherever an interior cell reads a corner,
since a corner next to a cut side or a cut wrap lies beside the halo.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np

from ..grids.boundaries.axes import BoundariesBase, BoundariesList
from ..grids.boundaries.local import ConstBCBase, ExpressionBC, UserBC, _PeriodicBC


class ShardedBoundaries(BoundariesBase):
    """The global grid's per-axis conditions on one block's extended view."""

    def __init__(self, grid, bcs: BoundariesList):
        if not isinstance(bcs, BoundariesList):
            raise NotImplementedError("Sharded execution requires per-axis boundary conditions")
        self.grid = grid  # the view (ExtendedBlockGrid)
        self.mesh = grid.mesh
        self.rank = bcs.rank
        self._global_bcs = bcs
        #: ±1 per view cell (numpy, the view's shape): -1 where the cell lies
        #: across the global wrap of an odd number of anti-periodic axes the
        #: mesh cuts; None where no such axis is cut
        self.flip = None
        for pair in bcs:
            if pair.periodic and pair.low.flip_sign and self.mesh.decomposition[pair.axis] > 1:
                lo, hi = grid.ranges[pair.axis]
                n = self.mesh.basegrid.shape[pair.axis]
                g = np.arange(lo, hi)
                sign = np.where((g < 0) | (g >= n), -1.0, 1.0)
                shape = [1] * grid.num_axes
                shape[pair.axis] = len(sign)
                sign = sign.reshape(shape)
                self.flip = sign if self.flip is None else self.flip * sign
        if self.flip is not None:
            self.flip = self.flip * np.ones(grid.shape)

    def __eq__(self, other):
        if not isinstance(other, ShardedBoundaries):
            return NotImplemented
        return self.grid == other.grid and self._global_bcs == other._global_bcs

    def __hash__(self):
        return hash((self.grid, self._global_bcs))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(block={self.grid.block}, {self._global_bcs!r})"

    def get_mathematical_representation(self, field_name: str = "C") -> str:
        """The global conditions, one side a line (the halo exchange at the
        cut sides is no condition of the problem)."""
        grid = self.mesh.basegrid
        lines = []
        for pair in self._global_bcs:
            ax = grid.axes[pair.axis]
            lo, hi = grid.axes_bounds[pair.axis]
            if pair.periodic:
                sign = "-" if pair.low.flip_sign else ""
                lines.append(f"{field_name}({ax}={lo}) = {sign}{field_name}({ax}={hi})")
                continue
            for bc, coord in ((pair.low, lo), (pair.high, hi)):
                lines.append(f"{type(bc).__name__}({', '.join(bc._repr_value())}) @ {ax}={coord}")
        return "\n".join(lines)

    def _side_setter(self, bc) -> Callable | None:
        """The ghost setter of one global side on this view, or None where
        the halo stands in for it."""
        grid = self.grid
        if isinstance(bc, _PeriodicBC):
            if self.mesh.decomposition[bc.axis] == 1:  # the view spans the axis: wrap it
                return bc.make_ghost_setter()
            return None  # the halo, negated across an anti-periodic wrap by `flip`
        if not isinstance(bc, (ConstBCBase, ExpressionBC, UserBC)):
            raise NotImplementedError(
                f"Boundary condition {type(bc).__name__} is not supported on decomposed grids"
            )
        if not grid.at_edge(bc.axis, bc.upper):
            return None
        # the global side's setter indexes from the edge, so it serves the view;
        # a value array along the boundary is sliced to the view's cells
        other = [a for a in range(grid.num_axes) if a != bc.axis]
        if isinstance(bc, ExpressionBC):
            return bc.make_ghost_setter(
                tuple(grid.restrict(c, other) for c in bc.boundary_coordinates()))
        if isinstance(bc, UserBC):
            return bc.make_ghost_setter()
        side = copy.copy(bc)
        for attr in ("value", "const"):
            if np.ndim(getattr(bc, attr, 0.0)) > 0:
                setattr(side, attr, grid.restrict(getattr(bc, attr), other))
        return side.make_ghost_setter()

    def make_ghost_setter(self) -> Callable:
        """``setter(full, t=0.0, args=None) -> full`` on the view padded by one
        ghost layer, in the serial order (non-periodic axes, then periodic
        ones, low side first)."""
        pairs = [p for p in self._global_bcs if not p.periodic]
        pairs += [p for p in self._global_bcs if p.periodic]
        setters = [s for pair in pairs for side in (pair.low, pair.high)
                   if (s := self._side_setter(side)) is not None]

        def setter(full, t=0.0, args=None):
            for s in setters:
                full = s(full, t, args)
            return full

        return setter
