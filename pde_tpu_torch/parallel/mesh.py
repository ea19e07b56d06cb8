"""Domain decomposition of a grid over a mesh of blocks.

Port of :mod:`pde_tpu.parallel.mesh`. ``pde_tpu`` shards one global array
over a ``jax.sharding.Mesh`` and runs SPMD under ``shard_map``. The port keeps
a single controller instead: one process holds every block of the grid as a
tensor of its own, block ``i`` on ``devices[i]``, and halos move between
blocks by copies (:mod:`.fused`). A device may appear several times in the
device list; that is the port's counterpart of ``pde_tpu``'s virtual CPU
devices, and lets one card (or the CPU) hold a 2×2 or 4×2 mesh. The default
device list repeats every device of the configured type (config key
``device``: ``cuda:0 .. cuda:n-1``, or ``cpu``) ``parallel.devices_per_device``
times.

Cartesian grids split along every axis; polar and spherical grids along r,
and cylindrical grids along r and z, into annular blocks (``pde_tpu``'s
radial decompositions). The plain decomposed stepper (``ShardedBoundaries``,
:mod:`.boundaries`) evaluates the rhs on each block's extended view
(:meth:`GridMesh.view_ranges`, :class:`ExtendedBlockGrid`): the block and a
halo as deep as the rhs reads, wrapped across periodic axes and stopped at
the global edges.

Runs over several processes (``torch.distributed``) would sit behind the same
API; they are ROADMAP A9's last item.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

from ..fields.base import FieldBase
from ..fields.collection import FieldCollection
from ..grids.base import GridBase
from ..grids.cartesian import CartesianGrid
from ..grids.cylindrical import CylindricalSymGrid
from ..grids.spherical import SphericalSymGridBase


def _get_optimal_decomposition(shape: Sequence[int], num: int) -> list[int]:
    """Distribute `num` devices over the grid axes (a copy of ``pde_tpu``'s).

    Greedily assigns prime factors of `num` to the currently largest axis,
    requiring that each axis size stays divisible by its chunk count.
    """
    decomposition = [1] * len(shape)
    factors = []
    n = num
    for p in range(2, int(math.isqrt(n)) + 1):
        while n % p == 0:
            factors.append(p)
            n //= p
    if n > 1:
        factors.append(n)
    sizes = list(shape)
    for f in sorted(factors, reverse=True):
        # the axis with the largest local size that remains divisible
        order = sorted(range(len(shape)), key=lambda i: -sizes[i])
        for i in order:
            if sizes[i] % f == 0:
                decomposition[i] *= f
                sizes[i] //= f
                break
        else:
            raise ValueError(
                f"Cannot decompose grid of shape {tuple(shape)} over {num} devices"
            )
    return decomposition


def default_devices() -> list[torch.device]:
    """Every device of the configured type, each repeated
    ``parallel.devices_per_device`` times."""
    from ..utils.config import config

    kind = torch.device(config["device"]).type
    if kind == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(kind)]
    repeat = int(config["parallel.devices_per_device"])
    if repeat < 1:
        raise ValueError("parallel.devices_per_device must be at least 1")
    return [device for device in devices for _ in range(repeat)]


def _part_class(grid: GridBase) -> type:
    """The class of a part of `grid` (its blocks and their views): a
    ``CartesianGrid``, or the radial grid's own class."""
    if isinstance(grid, CartesianGrid):
        return CartesianGrid
    if isinstance(grid, (SphericalSymGridBase, CylindricalSymGrid)):
        return type(grid)
    raise NotImplementedError(
        f"Domain decomposition is not implemented for {grid.__class__.__name__}")


def _part_arguments(grid: GridBase, bounds, shape) -> tuple[tuple, dict]:
    """The constructor arguments of a part of `grid` over `bounds` and
    `shape`, with `grid`'s periodicity: a box, an annulus (shell), or a
    cylinder over an r range."""
    shape = [int(n) for n in shape]
    if isinstance(grid, CartesianGrid):
        return (bounds, shape), {"periodic": list(grid.periodic)}
    if isinstance(grid, SphericalSymGridBase):
        return (tuple(bounds[0]), shape[0]), {}
    return (tuple(bounds[0]), tuple(bounds[1]), shape), {"periodic_z": grid.periodic[1]}


class ExtendedBlockGrid:
    """The grid of one block's extended view: the global cells
    ``ranges[a][0] <= i < ranges[a][1]`` of every axis a, indices wrapped on
    periodic axes (:meth:`GridMesh.view_ranges`).

    A view is a grid of the base grid's class (:func:`view_class`: a
    Cartesian box, an annulus or shell, a cylinder of the view's r range), so
    the operators of that class act on it. Its coordinates are the global
    cells' (across a periodic wrap, those of the wrapped cell), its spacing
    and periodicity the global grid's, and a factor that depends on the
    coordinates is the global grid's, sliced
    (:func:`~pde_tpu_torch.grids.base.radial_factor`), so that every view
    cell gets the number the serial grid gives that cell. Boundary conditions
    parse on the global grid and become
    :class:`~.boundaries.ShardedBoundaries` of this view. A global reduction
    (``integrate`` over every axis, the ``integral`` operator) reads the
    :class:`GlobalReductions` of the run the view belongs to (the plain
    decomposed stepper's, :attr:`reductions`): the integral over the global
    grid, from the blocks' partial integrals of their own cells.
    """

    #: the run's global reductions (set by the plain decomposed stepper), else None
    reductions = None

    def __init__(self, mesh: GridMesh, index: int, ranges):
        base = mesh.basegrid
        self.mesh = mesh
        self.block = int(index)
        self.ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
        #: the global index of every view cell, per axis
        self.indices = tuple(np.arange(lo, hi) % n for (lo, hi), n in zip(
            self.ranges, base.shape, strict=True))
        dx = base.discretization
        bounds = [(x0 + lo * d, x0 + hi * d) for (x0, _), (lo, hi), d in zip(
            base.axes_bounds, self.ranges, dx, strict=True)]
        args, kwargs = _part_arguments(base, bounds, [hi - lo for lo, hi in self.ranges])
        super().__init__(*args, **kwargs)
        self._axes_coords = tuple(c[i] for c, i in zip(base.axes_coords, self.indices,
                                                       strict=True))
        self._discretization = np.array(dx, copy=True)

    def at_edge(self, axis: int, upper: bool) -> bool:
        """Whether the view stops at that global non-periodic edge (where the
        serial conditions apply): r = 0 of a full disc, ball or cylinder, or
        the rim of its hole, counts as an edge."""
        if self.mesh.basegrid.periodic[axis]:
            return False
        lo, hi = self.ranges[axis]
        return hi == self.mesh.basegrid.shape[axis] if upper else lo == 0

    def restrict(self, data, axes=None):
        """The view's part of an array over the global grid's trailing axes
        (a tensor or a numpy array; leading axes kept whole); `axes` picks
        the grid axes the trailing axes are (default: all)."""
        axes = range(self.num_axes) if axes is None else list(axes)
        lead = data.ndim - len(axes)
        for j, axis in enumerate(axes):
            index = self.indices[axis]
            if isinstance(data, torch.Tensor):
                data = data.index_select(lead + j, torch.as_tensor(index, device=data.device))
            else:
                data = np.take(data, index, axis=lead + j)
        return data

    def interior(self) -> tuple[slice, ...]:
        """The block's own cells in the view, per axis."""
        mesh = self.mesh
        return tuple(slice(i * n - lo, (i + 1) * n - lo) for i, n, (lo, _) in zip(
            mesh.block_index(self.block), mesh.local_shape, self.ranges, strict=True))

    def integrate(self, data, axes=None):
        """The integral of `data` (over the view's cells) over the GLOBAL grid,
        as the serial grid's ``integrate`` gives it: from the run's
        :attr:`reductions`, which sum the blocks' partial integrals of their
        own cells. A reduction over some axes only would need the cut axes'
        other blocks as well and raises, as it has no serial meaning here."""
        if axes is not None:
            given = [axes] if isinstance(axes, int) else list(axes)
            if sorted(a % self.num_axes for a in given) != list(range(self.num_axes)):
                raise NotImplementedError(
                    "A decomposed block's view integrates over every axis (the global "
                    "reduction), not over some of them")
        if self.reductions is None:
            raise NotImplementedError(
                "A global reduction on a decomposed block's view needs the run's blocks: "
                "it is evaluated by the plain decomposed stepper (BlockedRun)")
        return self.reductions.integral(self, data)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ExtendedBlockGrid):
            return NotImplemented
        return self.mesh is other.mesh and self.ranges == other.ranges

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.ranges))


class GlobalReductions:
    """The global reductions of one rhs evaluation over a mesh's blocks, as
    ``pde_tpu``'s ``integrate`` sums its shards' partial integrals by
    ``lax.psum`` (``pde_tpu/grids/base.py:424-452``).

    The plain decomposed stepper evaluates the rhs twice where it reduces
    (:meth:`.stepper.BlockedRun.rhs`): first every block in turn with
    :meth:`record` on, each ``integrate`` of its view returning the partial
    integral of the block's own cells (the operand times the global grid's
    cell volumes there, summed), kept in call order; then :meth:`total` adds
    the blocks' partials of each call in block order, and the second pass
    returns those totals, so that every block's rhs reads the same global
    integrals. The sums run in another order than the serial grid's one
    ``sum``, so a decomposed run with a reduction agrees with the serial run
    to rounding, not bit for bit.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.partials: list[list] | None = None  # per block, per call (recording)
        self.totals: list | None = None  # per call (replaying)
        self._next: dict = {}  # per block, its next call's index (replaying)
        self._factors: dict = {}

    def record(self) -> None:
        self.partials, self.totals = [[] for _ in range(len(self.mesh))], None

    def total(self) -> bool:
        """Sum the recorded partials, per call in block order, for the second
        pass; False where the first pass made no reduction."""
        calls = {len(p) for p in self.partials}
        if calls == {0}:
            self.partials = None
            return False
        if len(calls) != 1:
            raise RuntimeError("The blocks' rhs evaluations made different reductions")
        self.totals = []
        for i in range(calls.pop()):
            value = self.partials[0][i]
            for block in self.partials[1:]:
                value = value + block[i].to(value.device)
            self.totals.append(value)
        self.partials = None
        self._next = {}
        return True

    def done(self) -> None:
        self.partials = self.totals = None

    def _volumes(self, view, dtype, device) -> list:
        """The global grid's cell-volume factors of the block's cells, per axis."""
        key = (view.block, dtype, device)
        if key not in self._factors:
            base = self.mesh.basegrid
            shape = [1] * base.num_axes
            factors = []
            for axis, sl in enumerate(self.mesh._block_slices(view.block)):
                f = torch.as_tensor(np.asarray(base._axis_volume_factors[axis])[sl], dtype=dtype,
                                    device=device)
                factors.append(f.reshape(shape[:axis] + [-1] + shape[axis + 1:]))
            self._factors[key] = factors
        return self._factors[key]

    def integral(self, view, data):
        """In the first pass the block's partial integral of `data` over its
        own cells, recorded; in the second the call's total."""
        if self.totals is not None:
            call = self._next.get(view.block, 0)
            self._next[view.block] = call + 1
            return self.totals[call].to(data.device)
        if self.partials is None:
            raise RuntimeError("A global reduction outside the plain decomposed stepper's rhs")
        own = data[(Ellipsis, *view.interior())]
        for factor in self._volumes(view, own.dtype, own.device):
            own = own * factor
        partial = own.sum(dim=tuple(range(-view.num_axes, 0)))
        self.partials[view.block].append(partial)
        return partial


@functools.cache
def view_class(grid_class: type) -> type:
    """The class of the extended views of grids of `grid_class`: an
    :class:`ExtendedBlockGrid` that is a `grid_class`."""
    return type(f"Extended{grid_class.__name__}", (ExtendedBlockGrid, grid_class), {},
                register=False)


class GridMesh:
    """Splits a grid into equal blocks, one per entry of a device list."""

    def __init__(self, basegrid: GridBase, decomposition: Sequence[int], devices=None):
        _part_class(basegrid)  # raises for a grid class no mesh splits
        self.basegrid = basegrid
        self.decomposition = [int(n) for n in decomposition]
        if len(self.decomposition) != basegrid.num_axes:
            raise ValueError("Decomposition length must match the number of grid axes")
        for n, size in zip(self.decomposition, basegrid.shape, strict=True):
            if size % n != 0:
                raise ValueError(
                    f"Axis of size {size} cannot be split into {n} equal chunks"
                )
        if devices is None:
            devices = default_devices()
        num = len(self)
        if num > len(devices):
            raise ValueError(
                f"Decomposition {self.decomposition} needs {num} devices, "
                f"got {len(devices)}"
            )
        #: the device of each block, in row-major block order
        self.devices = [torch.device(d) for d in devices[:num]]

    @classmethod
    def from_grid(cls, grid: GridBase, decomposition="auto", devices=None) -> GridMesh:
        """Create a mesh from a grid; ``"auto"``, ``None``, -1 or a device
        count choose the decomposition with :func:`_get_optimal_decomposition`
        (-1 and ``"auto"``: over every device). One -1 in a list takes the
        devices the other axes leave, as in py-pde (``pde_tpu`` raises on
        both -1 forms)."""
        if devices is None:
            devices = default_devices()
        if decomposition == "auto" or decomposition is None or decomposition == -1:
            decomposition = _get_optimal_decomposition(grid.shape, len(devices))
        elif isinstance(decomposition, int):
            decomposition = _get_optimal_decomposition(grid.shape, decomposition)
        elif -1 in list(decomposition):
            decomposition = list(decomposition)
            rest = int(np.prod([n for n in decomposition if n != -1]))
            decomposition[decomposition.index(-1)] = max(1, len(devices) // rest)
        return cls(grid, decomposition, devices=devices)

    # -- basic properties ---------------------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.decomposition)

    def __len__(self) -> int:
        """Total number of blocks."""
        return int(np.prod(self.decomposition))

    @property
    def local_shape(self) -> tuple[int, ...]:
        """Shape of every block."""
        return tuple(s // n for s, n in zip(self.basegrid.shape, self.decomposition, strict=True))

    def block_index(self, index) -> tuple[int, ...]:
        """Per-axis index of a block given by its flat index or by that tuple."""
        if isinstance(index, (int, np.integer)):
            return tuple(int(i) for i in np.unravel_index(int(index), self.decomposition))
        return tuple(int(i) for i in index)

    def edge_flags(self, index) -> list[int]:
        """``[row_lo, row_hi, col_lo, col_hi, ...]`` of a block: 1 where the
        axis is not periodic and the block lies on that side's global edge."""
        flags = []
        for i, n, periodic in zip(
            self.block_index(index), self.decomposition, self.basegrid.periodic, strict=True
        ):
            flags += [int(not periodic and i == 0), int(not periodic and i == n - 1)]
        return flags

    def block_origin(self, index) -> tuple[int, ...]:
        """The global index of block `index`'s first cell on every axis (on a
        radial grid, its first row is where its factors start: ``pde_tpu``'s
        row offset, ``flags[4]``)."""
        return tuple(i * n for i, n in zip(self.block_index(index), self.local_shape,
                                           strict=True))

    @property
    def current_grid(self) -> GridBase:
        return self.subgrid

    # -- subgrids -----------------------------------------------------------------------
    @property
    def subgrid(self) -> GridBase:
        """The grid of block 0 (every block has its shape)."""
        if not hasattr(self, "_subgrid"):
            self._subgrid = self.subgrid_for(0)
        return self._subgrid

    def subgrid_for(self, index) -> GridBase:
        """Subgrid covering block `index` (flat index or per-axis tuple), of
        the base grid's class: a radial split gives annuli (shells, hollow
        cylinders), as ``pde_tpu``'s does."""
        grid = self.basegrid
        index = self.block_index(index)
        bounds = []
        for (lo, hi), n, i in zip(grid.axes_bounds, self.decomposition, index, strict=True):
            length = (hi - lo) / n
            bounds.append((lo + i * length, lo + (i + 1) * length))
        args, kwargs = _part_arguments(grid, bounds, self.local_shape)
        return _part_class(grid)(*args, **kwargs)

    def view_ranges(self, index, halo: int) -> tuple[tuple[int, int], ...]:
        """The global cell ranges ``(start, stop)`` per axis of block `index`'s
        extended view for a rhs reading `halo` cells deep: `halo` cells past
        the block on a cut periodic axis (wrapped), as far as the global edge
        allows on a non-periodic one, the whole axis on an uncut periodic one
        (whose conditions wrap it locally, as the serial run's do)."""
        ranges = []
        for i, n, d, periodic in zip(self.block_index(index), self.local_shape,
                                     self.decomposition, self.basegrid.periodic, strict=True):
            if periodic and d == 1:
                ranges.append((0, n))
            elif periodic:
                ranges.append((i * n - halo, (i + 1) * n + halo))
            else:
                ranges.append((max(0, i * n - halo), min(n * d, (i + 1) * n + halo)))
        return tuple(ranges)

    def extended_grid(self, index: int, halo: int) -> ExtendedBlockGrid:
        """The grid of block `index`'s extended view (:meth:`view_ranges`), of
        the base grid's class (:func:`view_class`)."""
        view = view_class(_part_class(self.basegrid))
        return view(self, index, self.view_ranges(index, halo))

    def extract_boundary_conditions(self, bcs, index: int = 0, halo: int = 0):
        """The conditions `bcs` of the global grid on block `index`'s extended
        view: physical sides where the view stops at a global edge, the
        exchanged halo elsewhere (:class:`~.boundaries.ShardedBoundaries`)."""
        from .boundaries import ShardedBoundaries

        return ShardedBoundaries(self.extended_grid(index, halo), bcs)

    def _block_slices(self, index) -> tuple[slice, ...]:
        return tuple(
            slice(i * n, (i + 1) * n)
            for i, n in zip(self.block_index(index), self.local_shape, strict=True)
        )

    # -- data ---------------------------------------------------------------------------
    def split_field_data(self, field_data: torch.Tensor, rank: int = 0) -> list[torch.Tensor]:
        """The blocks of `field_data` (leading `rank` component axes kept
        whole), each a contiguous tensor on its block's device."""
        if tuple(field_data.shape[field_data.ndim - self.basegrid.num_axes:]) != tuple(
            self.basegrid.shape
        ):
            raise ValueError(
                f"Data of shape {tuple(field_data.shape)} does not cover the grid "
                f"{tuple(self.basegrid.shape)}"
            )
        blocks = []
        for i, device in enumerate(self.devices):
            block = field_data[(Ellipsis, *self._block_slices(i))]
            blocks.append(block.to(device=device, copy=True).contiguous())
        return blocks

    def combine_field_data(self, blocks, device=None) -> torch.Tensor:
        """One tensor on `device` (default: block 0's) from the blocks of
        :meth:`split_field_data`."""
        blocks = list(blocks)
        if len(blocks) != len(self):
            raise ValueError(f"Expected {len(self)} blocks, got {len(blocks)}")
        device = blocks[0].device if device is None else torch.device(device)
        blocks = [block.to(device) for block in blocks]
        lead = blocks[0].ndim - self.basegrid.num_axes
        for axis in reversed(range(self.basegrid.num_axes)):
            n = self.decomposition[axis]
            blocks = [torch.cat(blocks[j : j + n], dim=lead + axis)
                      for j in range(0, len(blocks), n)]
        (data,) = blocks
        return data

    def split_field(self, field: FieldBase) -> list[FieldBase]:
        """One field per block, on the block's subgrid and device.

        ``pde_tpu`` returns one field whose array is sharded; here the blocks
        are separate tensors, so the result is a list."""
        if isinstance(field, FieldCollection):
            parts = [self.split_field(f) for f in field]
            return [
                FieldCollection([p[i] for p in parts], label=field.label)
                for i in range(len(self))
            ]
        blocks = self.split_field_data(field.data, field.rank)
        return [
            field.__class__(self.subgrid_for(i), data=block, label=field.label)
            for i, block in enumerate(blocks)
        ]

    def place_field(self, field: FieldBase) -> FieldBase:
        """A copy of `field` on the mesh's first device that holds this mesh
        as ``mesh`` (each field of a collection too): the port's form of
        ``pde_tpu``'s ``split_field``, whose copy is one array sharded over
        the mesh. The blocks of a run are made from it when it runs
        (:meth:`split_field_data`)."""
        field.grid.assert_grid_compatible(self.basegrid)
        result = field.copy(device=self.devices[0])
        for part in [result, *(result if isinstance(result, FieldCollection) else [])]:
            part.mesh = self
        return result

    def combine_field(self, fields) -> FieldBase:
        """The field on the whole grid from the per-block fields of
        :meth:`split_field`, or a copy of one field placed on this mesh
        (:meth:`place_field`, ``FieldBase.split_mpi``) without its mesh, as
        ``pde_tpu``'s gathers a sharded field."""
        if isinstance(fields, FieldBase):
            if getattr(fields, "mesh", None) is not self:
                raise ValueError("The field is not placed on this mesh")
            result = fields.copy()
            for part in [result, *(result if isinstance(result, FieldCollection) else [])]:
                del part.mesh
            return result
        fields = list(fields)
        first = fields[0]
        if isinstance(first, FieldCollection):
            return FieldCollection(
                [self.combine_field([f[j] for f in fields]) for j in range(len(first))],
                label=first.label,
            )
        data = self.combine_field_data([f.data for f in fields])
        return first.__class__(self.basegrid, data=data, label=first.label)

    def extract_subfield(self, field: FieldBase) -> FieldBase:
        """A zero field like `field` on the template subgrid (block 0's)."""
        sub = self.subgrid
        if isinstance(field, FieldCollection):
            return FieldCollection([self.extract_subfield(f) for f in field], label=field.label)
        shape = (field.grid.dim,) * field.rank + tuple(sub.shape)
        data = torch.zeros(shape, dtype=field.dtype, device=field.device)
        return field.__class__(sub, data=data, label=field.label)

    # -- communication primitives -------------------------------------------------------
    def broadcast(self, data):
        """Broadcast host data to all blocks: the single controller already
        holds the value, so this is the identity."""
        return data

    def gather(self, data):
        """Gather blocks into one tensor (the identity on a whole tensor)."""
        if isinstance(data, (list, tuple)):
            return self.combine_field_data(data)
        return data

    def allgather(self, data):
        """All-gather: with one controller, the same as :meth:`gather`."""
        return self.gather(data)

    def scatter(self, data, rank: int = 0) -> list[torch.Tensor]:
        """Scatter data over the blocks (:meth:`split_field_data`)."""
        return self.split_field_data(torch.as_tensor(data), rank)
