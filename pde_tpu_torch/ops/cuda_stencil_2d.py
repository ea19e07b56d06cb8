"""Temporally blocked multi-field stencil windows: generated CUDA kernel, plain
version, replay of the kernel's row march, ladder.

Port of the 2D expression-compiler path of :mod:`pde_tpu.ops.pallas_cartesian`:
the in-kernel stencil helpers (``_make_stencil_helpers``), the kernel
``make_fused_multi_stencil_window_2d`` and its ladder window
``make_chunked_multi_window_2d``. A window advances n coupled scalar planes by
k explicit steps of an arbitrary rhs per pass over device memory: Euler, RK4
(four rhs stages a step), or Adams-Bashforth (the previous rates as planes).

One lowering, three executions. The PDE supplies ``make_step(helpers)``,
returning ``step(works) -> works``; it is run against one of three helper
objects with the same interface (``lap``, ``gradient_squared``, ``d_row``,
``d_col``, ``d_depth`` in 3D, ``divergence``, ``derivatives``, ``trim``,
``pointwise``, ``broadcast``). The helpers and the tracer take 2D and 3D
grids; :mod:`.cuda_stencil_3d` emits the 3D kernel from the same graph.

- :class:`PlainHelpers` work on whole planes (volumes in 3D): each operator
  pads its operand with ghost cells (a periodic wrap or the affine formula of
  its BC) and applies the stencil. This is the plain version of the kernel;
  the wrapper runs it for tensors on the CPU.
- :class:`TileHelpers` emulate the square window of the SDE kernels
  (:mod:`.cuda_sde_2d`) on the CPU: arrays carry halos on every side, every
  operator consumes one cell per side on every axis, ghost values are
  substituted only where a cell lies on a global edge, and cells outside the
  domain are held at zero.
- the tracing helpers of :class:`StencilProgram` record a small expression
  graph (fields, constants, ``+ - * / pow``, pointwise functions, stencil
  nodes with their BC triplets). :func:`.cuda_march.march_layout` cuts it
  into the stages of the row march, whose per-cell functions are emitted as a
  ``Program`` struct around the hand-written template ``csrc/march_2d.cuh``
  (kernels #7 and #8); :func:`multi_stencil_2d_marched` replays that march in
  pure torch. :class:`WindowProgram` emits the same graph as the ``level``
  struct of the SDE kernels' square window (``csrc/multi_stencil_2d.cuh``).

The generated source instantiates every k of the ladder for float and double
at the plan :func:`row_plan` picks and is built with ``nvcc`` for ``sm_90a``
at first use into ``pde_tpu_torch/_build/`` (the ``.cu`` is written beside
the ``.so``), keyed by a hash of the source, the template and the flags, and
bound with ctypes.

Supported: a 2D ``CartesianGrid``, float32 or float64 planes, periodic axes or
constant affine BCs per operator, the 5-point Laplacian. A 2D window (and,
through :mod:`.cuda_stencil_3d` and the ext kernels, a 3D or decomposed one)
also takes ``pde_tpu``'s side inputs (B2(b), :class:`SideInputs`): consts and
ghost factors that vary along a side, consts and factors that vary in time
(a table of the pass's steps, and of RK4's stages), and consts varying in
both (a table per step of the side's values); their values reach the kernel
as arguments, never as literals, so a library serves every solve of the same
form. On a
``CylindricalSymGrid`` (rows r, columns z) the row march also takes the
radial helpers of ``pde_tpu``'s kernel: ``lap`` gains the ``(1/r) d/dr``
term through the factor ``fac = (1 / (2 dr)) / r`` of the row (the
Laplacian is ``(sx - fac) up + (sx + fac) down + sy (left + right) -
2 (sx + sy) centre``), and ``divergence`` the ``v_r / r`` term (the graph
node ``radial``, the row's ``1 / r``); the gradient and its square gain no
radial term. ``r = (row + 0.5) dr + r_lo`` is computed from the row's grid
index in the planes' dtype, in every version: the kernel reads a row's two
values once a row from a table of them (:func:`row_table`). The square
window of the SDE kernels and the ext kernel take Cartesian grids only.
Everything else raises :class:`KernelUnsupportedError` before anything is
built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from ..grids.cartesian import CartesianGrid
from ..grids.cylindrical import CylindricalSymGrid
from .cuda_cartesian import (
    _BUILD_DIR,
    _DTYPES,
    _NVCC_FLAGS,
    _PACKAGE,
    KernelUnsupportedError,
    _ghost,
    _neighbours,
    _nvcc,
    bf16_refusal,
    compute_dtype,
    rounded_table,
)

if TYPE_CHECKING:
    from .cuda_march import MarchLayout, MarchWindow

_CSRC = _PACKAGE / "csrc"
#: the square-window template of the Euler-Maruyama kernels (:mod:`.cuda_sde_2d`)
_TEMPLATE = _CSRC / "multi_stencil_2d.cuh"
#: the row-marching template of the multi-field kernels #7 and #8
_MARCH_TEMPLATE = _CSRC / "march_2d.cuh"
#: shared memory one block may take, so that two blocks fit on one SM
SMEM_BUDGET = 112 * 1024
#: output tile sides the square window of the SDE kernels may choose, largest first
TILES = (64, 32, 16, 8)
#: steps per pass at the top of the SDE kernels' ladder, before the budget cuts
#: it (the TPU kernel's default, one 8-cell halo granule per side)
DEFAULT_HALO = 8
#: halo cells per side of the row march's top pass (k * depth), before the
#: shared-memory budget cuts it (``scripts/torch_multi2d_sweep.py``, PERF.md)
TOP_HALO = 8
#: the row march's strip widths, widest first
ROW_TX = (256, 128, 64)
#: most threads of a march block (each holds window columns dealt linearly)
ROW_THREADS = 512
#: longest period (least common multiple of the rings' lengths) a row march
#: keeps as its rings need; past it the rings are lengthened (:func:`.cuda_march.pad_rings`),
#: since the march unrolls its row loop by the period
PERIOD_CAP = 12
#: steps of a window whose time-dependent side inputs are evaluated at once
#: (:meth:`SideInputs.block`)
SIDE_BLOCK = 512
#: blocks a launch should hold at least (two per SM of the H100's 132), and the
#: chunk lengths that may give them, longest first (:func:`chunk_rows`)
FILL_BLOCKS = 264
CHUNK_ROWS = (512, 256, 128, 64, 32, 16)

#: pointwise functions of the expression compiler: torch op, CUDA math function
POINTWISE = {
    "sin": (torch.sin, "sin"), "cos": (torch.cos, "cos"), "tan": (torch.tan, "tan"),
    "exp": (torch.exp, "exp"), "log": (torch.log, "log"), "sqrt": (torch.sqrt, "sqrt"),
    "tanh": (torch.tanh, "tanh"), "sinh": (torch.sinh, "sinh"),
    "cosh": (torch.cosh, "cosh"), "abs": (torch.abs, "fabs"),
}


# -- boundary conditions ----------------------------------------------------------------------
def is_side_ref(term) -> bool:
    """Whether a term of a ghost formula is a side input
    (``("side", index, base)``: the input's value, plus `base` unless None)."""
    return isinstance(term, tuple)


def _side_triplet(side, axis: int, sides=None, stage: int = 0) -> tuple:
    """A side's ghost formula ``(c, f1, f2)``: numbers, or, where the side has
    per-point or time-dependent parts, terms referring to the program's
    side inputs `sides` (:meth:`SideInputs.terms`)."""
    if hasattr(side, "scalar_triplet"):
        if side.is_scalar:
            return side.scalar_triplet()
        if sides is None:
            raise KernelUnsupportedError(
                "Per-point and time-dependent BC values reach a generated window as its side "
                "inputs; this program was built without them (models/pde.py's side_inputs_for "
                "gives them)")
        return sides.terms(side, axis, stage)
    return tuple(t if is_side_ref(t) else float(t) for t in side)


def bc_key(bc, rank: int = 2, sides=None, stage: int = 0):
    """Normalise an operator's BC argument to ``None`` (periodic) or a per-axis
    tuple of ``None`` (periodic axis) or ``((c, f1, f2), (c, f1, f2))``
    (low and high side, ``ghost = c + f1*edge + f2*next_inward``), whose
    terms are numbers or refer to the side inputs `sides` at RK4 stage
    `stage` (see :func:`_side_triplet`)."""
    if bc is None:
        return None
    axes = tuple(
        None if pair is None else tuple(_side_triplet(side, axis, sides, stage) for side in pair)
        for axis, pair in enumerate(bc)
    )
    if len(axes) != rank:
        raise KernelUnsupportedError(f"The multi-field kernel takes {rank}D boundary conditions")
    return None if all(axis is None for axis in axes) else axes


#: the side inputs' kinds (``P::side_axis`` of the generated program): a value
#: per step (and stage), a row side's values along the columns (read at the
#: cell's column), a column side's along the rows (read at the cell's row);
#: on a 3D grid a face of x, y or z, its values over the other two axes (read
#: at the cell's place on the face)
SIDE_KINDS = ("t", "row", "col", "x", "y", "z")
#: entries a 3D face table holds past the grid's end along x, y and z beyond
#: the pad: a march block's window columns pass the last cell by up to its
#: column tile (the largest, ``MARCH_TY[0]`` and ``MARCH_TZ`` of
#: :mod:`.cuda_cartesian_3d`), its planes never do
FACE_TAIL = (0, 32, 64)


class SideInputs:
    """The side inputs of a program's ghosts (B2(b)), ``pde_tpu``'s staged
    ``bc_inputs``: per-point consts and factors of a side, time-dependent
    consts and factors (``const_t``, ``f1_t``; one value per step and RK4
    stage, the stage times ``t + offsets[j] * dt``), and consts varying in
    space and time (``const_xt``; the side's values per step and stage).

    The tracer asks for an input where a stencil's ghost reads such a part
    (:meth:`terms`); each distinct (side, part, stage) is one input, whose
    kind (:data:`SIDE_KINDS`) is all the generated source knows of it. The
    kernel reads an input from a device table of the data's compute dtype
    (for bf16 planes, bf16-rounded values in float32): a
    row side's along the columns and a column side's along the rows, both
    padded by :attr:`pad` cells before the grid and ``pad + ROW_TX[0]``
    after it (wrapped on a periodic axis, the edge value repeated
    otherwise), a step's row ``step`` elements after the last's (0 where it
    does not depend on time). On a 3D grid a face's row covers its two
    axes (an x face's y and z, a y face's x and z, a z face's x and y),
    row-major, each padded by :attr:`pad` before the grid and ``pad +
    FACE_TAIL[axis]`` after it, the same way (:meth:`face_shape`). The
    windows evaluate the time-dependent tables on the device with torch, a
    block of steps at a time (:meth:`block`); :meth:`for_pass` gives each
    pass its views.
    """

    def __init__(self, grid, offsets=(0.0,)):
        self.shape = tuple(grid.shape)
        self.rank = len(self.shape)
        self.periodic = tuple(bool(p) for p in grid.periodic)
        #: the stages' times as fractions of dt (RK4: 0, 1/2, 1)
        self.offsets = tuple(float(o) for o in offsets)
        #: (spec, part, kind, stage or None) of each input
        self.entries: list[tuple] = []
        self._index: dict = {}
        #: cells of a table before the grid: the deepest halo of the program's passes
        self.pad = 0
        self._static: dict = {}

    @property
    def needs_t(self) -> bool:
        return any(stage is not None for *_, stage in self.entries)

    def ref(self, spec, part: str, axis: int, stage: int) -> int:
        """The index of the input of `part` of a side of `axis` at `stage`."""
        timed = part in ("const_t", "f1_t", "const_xt")
        if part in ("const_t", "f1_t"):
            kind = "t"
        elif self.rank == 3:
            kind = "xyz"[axis]
        else:
            kind = "row" if axis == 0 else "col"
        key = (id(spec), part, stage if timed else None)
        if key not in self._index:
            self._index[key] = len(self.entries)
            self.entries.append((spec, part, kind, stage if timed else None))
        return self._index[key]

    def terms(self, spec, axis: int, stage: int) -> tuple:
        """A side's ghost formula ``(c, f1, f2)`` whose parts are numbers or
        input references ``("side", index, base)``."""
        if spec.const_xt is not None:
            const = ("side", self.ref(spec, "const_xt", axis, stage), None)
        elif np.ndim(spec.const_static):
            const = ("side", self.ref(spec, "const_static", axis, stage), None)
        elif spec.const_t is not None:
            const = ("side", self.ref(spec, "const_t", axis, stage), spec.const_static)
        else:
            const = spec.const_static
        if spec.f1_t is not None:
            f1 = ("side", self.ref(spec, "f1_t", axis, stage), None)
        elif np.ndim(spec.f1):
            f1 = ("side", self.ref(spec, "f1", axis, stage), None)
        else:
            f1 = spec.f1
        f2 = ("side", self.ref(spec, "f2", axis, stage), None) if np.ndim(spec.f2) else spec.f2
        return const, f1, f2

    def kind(self, index: int) -> str:
        return self.entries[index][2]

    def step(self, index: int) -> int:
        """Elements from one step's row of input `index` to the next's in the
        tables of :meth:`for_pass`: 0 (constant), the number of stages (a
        value per step and stage), or -1 where it is the table's row length
        times that (a side's values varying in time), which the kernel takes
        from the host."""
        _, part, kind, stage = self.entries[index]
        if stage is None:
            return 0
        return len(self.offsets) if kind == "t" else -1

    @staticmethod
    def face_axes(kind: str) -> tuple[int, ...]:
        """The grid axes a table of `kind` runs along (a side's or a face's)."""
        if kind in ("row", "col"):
            return (1,) if kind == "row" else (0,)
        return tuple(a for a in range(3) if a != "xyz".index(kind))

    def face_shape(self, kind: str) -> tuple[int, ...]:
        """Entries of a table row of `kind` along each of its axes: the
        grid's cells, :attr:`pad` before them and ``pad + ROW_TX[0]`` (2D) or
        ``pad + FACE_TAIL[axis]`` (3D) after them."""
        tails = (ROW_TX[0],) * 2 if self.rank == 2 else FACE_TAIL
        return tuple(self.shape[a] + 2 * self.pad + tails[a] for a in self.face_axes(kind))

    def length(self, kind: str) -> int:
        """Entries of a table row of an input of `kind`."""
        return 1 if kind == "t" else int(np.prod(self.face_shape(kind)))

    def row_stride(self, index: int) -> int:
        """Entries from one line of input `index`'s 3D face table to the
        next (its second axis' length), 0 for the other kinds."""
        kind = self.kind(index)
        return self.face_shape(kind)[1] if kind in ("x", "y", "z") else 0

    def _padded(self, values, kind: str):
        """Values along a side or over a face (last axis, row-major) as a
        padded table row (see above)."""
        axes = self.face_axes(kind)
        values = values.reshape(*values.shape[:-1], *(self.shape[a] for a in axes))
        for dim, (axis, size) in enumerate(zip(axes, self.face_shape(kind), strict=True)):
            n = self.shape[axis]
            g = torch.arange(-self.pad, size - self.pad, device=values.device)
            index = g % n if self.periodic[axis] else g.clamp(0, n - 1)
            values = values.index_select(values.dim() - len(axes) + dim, index)
        return values.reshape(*values.shape[:values.dim() - len(axes)], -1)

    def gather(self, row, kind: str, cells):
        """A table row's entries at grid cells: `cells` holds, per axis of
        the table, broadcastable indices of the grid (unwrapped, within the
        padding)."""
        table = row.reshape(self.face_shape(kind))
        return table[tuple(c + self.pad for c in cells)]

    def _static_table(self, i: int, dtype, device):
        key = (i, dtype, torch.device(device))
        if key not in self._static:
            spec, part, kind, _ = self.entries[i]
            values = torch.as_tensor(np.asarray(getattr(spec, part), dtype=float).reshape(-1),
                                     dtype=torch.float64, device=device)
            self._static[key] = rounded_table(self._padded(values, kind), dtype).reshape(
                1, -1).contiguous()
        return self._static[key]

    def block(self, t0: float, first: int, steps: int, dt: float, dtype, device) -> dict:
        """The time-dependent tables of `steps` steps from inner step `first`
        of a window starting at `t0`: per time-dependent (side, part) a
        ``(steps * stages, length)`` tensor of `dtype` on `device`, step s's
        stage j in row ``s * stages + j``, at ``t0 + (first + s)*dt +
        offsets[j]*dt``, evaluated in float64 with torch on `device`."""
        f64 = torch.float64
        base = t0 + (first + torch.arange(steps, dtype=f64, device=device)) * dt
        frac = torch.tensor(self.offsets, dtype=f64, device=device)
        times = (base[:, None] + frac[None, :] * dt).reshape(-1)
        tables = {}
        for spec, part, kind, stage in self.entries:
            key = (id(spec), part)
            if stage is None or key in tables:
                continue
            if part == "const_xt":
                values = self._padded(spec.const_xt(times, device), kind)
            else:
                values = getattr(spec, part)(times).reshape(-1, 1)
            tables[key] = rounded_table(values, dtype).contiguous()
        return tables

    def for_pass(self, dtype, device, k: int, block: dict | None = None, offset: int = 0) -> list:
        """One pass's inputs, a ``(k, length)`` view per input (row s: step
        s of the pass; `offset`: the pass's first step in `block`, the
        tables of :meth:`block`; a static input's view repeats its row)."""
        views = []
        n_stages = len(self.offsets)
        for i, (spec, part, kind, stage) in enumerate(self.entries):
            if stage is None:
                views.append(self._static_table(i, dtype, device).expand(k, -1))
                continue
            table = block[(id(spec), part)]
            start = offset * n_stages + stage
            views.append(table[start:start + (k - 1) * n_stages + 1:n_stages])
        return views

    def passes(self, t0: float, total: int, dt: float | None, dtype, device) -> Callable:
        """``views(index, k)``: the views (:meth:`for_pass`) of a pass of `k`
        steps from inner step `index` of a window of `total` steps from
        `t0`, the time-dependent tables evaluated :data:`SIDE_BLOCK` steps at
        a time (:meth:`block`) as the passes reach them."""
        held = {"first": 0, "end": 0, "block": None}

        def views(index: int, k: int) -> list:
            if self.needs_t and index + k > held["end"]:
                end = index + min(max(SIDE_BLOCK, k), total - index)
                held.update(first=index, end=end,
                            block=self.block(t0, index, end - index, dt, dtype, device))
            return self.for_pass(dtype, device, k, held["block"], index - held["first"])

        return views

    def values(self, views, i: int, s: int):
        """Input i's values at step s of a pass (`views` of :meth:`for_pass`):
        a 0-d tensor, or the grid side's (face's) values, from the table's
        first grid cell."""
        row = views[i][s]
        kind = self.kind(i)
        if kind == "t":
            return row[0]
        axes = self.face_axes(kind)
        table = row.reshape(self.face_shape(kind))
        return table[tuple(slice(self.pad, self.pad + self.shape[a]) for a in axes)]


#: stencil operators of the traced graph and the axes each reads (None: every axis)
_STENCIL_AXES = {"lap": None, "gsq": None, "drow": (0,), "dcol": (1,), "ddep": (2,)}


def stencil_axes(op: str, rank: int) -> tuple[int, ...]:
    """The axes whose neighbours the stencil operator `op` reads."""
    axes = _STENCIL_AXES[op]
    return tuple(range(rank)) if axes is None else axes


class _Geometry:
    """Grid facts shared by the three helper kinds, on 2D and 3D grids."""

    def __init__(self, grid):
        cylindrical = isinstance(grid, CylindricalSymGrid)
        if not (cylindrical or isinstance(grid, CartesianGrid)) or grid.num_axes not in (2, 3):
            raise KernelUnsupportedError(
                "The multi-field kernel requires a 2D or 3D CartesianGrid or a "
                "CylindricalSymGrid"
            )
        #: (r of the inner edge, dr) on a cylindrical grid (the radial helpers), else None
        self.radial = None
        if cylindrical:
            self.radial = (float(grid.axes_bounds[0][0]), float(grid.discretization[0]))
        self.rank = grid.num_axes
        self.shape = tuple(grid.shape)
        self.periodic = tuple(bool(p) for p in grid.periodic)
        #: 1/dx² and 1/(2 dx) per axis
        self.scales = tuple((1.0 / grid.discretization**2).tolist())
        self.halves = tuple((0.5 / grid.discretization).tolist())
        self.sx, self.sy = self.scales[:2]
        self.gx, self.gy = self.halves[:2]
        #: the program's side inputs (:class:`SideInputs`; None: scalar BCs only),
        #: one pass's views of them, and the step and RK4 stage being computed
        self.sides = None
        self.side_views = None
        self.step = 0
        self.stage = 0

    def bind_stage(self, stage: int) -> None:
        """The RK4 stage whose times the next stencils' ghosts read (0: the
        step's start; ``pde_tpu``'s ``helpers.bind_stage``)."""
        self.stage = stage

    def axis_sides(self, bc, axis: int):
        """The (low, high) ghost formulas of one axis, their side inputs
        resolved (:meth:`_resolve`); None on a periodic axis."""
        key = bc_key(bc, self.rank, self.sides, self.stage)
        sides = None if key is None else key[axis]
        if sides is None and not self.periodic[axis]:
            raise KernelUnsupportedError(
                f"A stencil along the non-periodic axis {axis} needs its boundary conditions"
            )
        if sides is not None and self.side_views is not None:
            sides = tuple(tuple(self._resolve(term, axis) for term in side) for side in sides)
        return sides

    def _resolve(self, term, axis: int):
        """A ghost formula's term as a value: a number, or a side input at
        the step being computed, shaped along the side (whole planes)."""
        if not is_side_ref(term):
            return term
        _, index, base = term
        value = self.sides.values(self.side_views, index, self.step)
        if value.dim():
            value = value.unsqueeze(axis)
        return value if base is None else base + value


#: the radial helpers, in the order of a cylindrical program's values of a row
#: (``O.rv`` of its stage functions, a row of :func:`row_table`)
ROW_VALUES = ("fac", "inv")


def radial_values(geo: _Geometry, kind: str, rows, dtype):
    """The radial helpers' per-row value at the grid rows `rows` (an int or
    an index tensor, on its device), in `dtype`: ``"fac"``, ``(1 / (2 dr)) /
    r``, or ``"inv"``, ``1 / r``, with ``r = (row + 0.5) * dr + r_lo``, in
    the order of ``pde_tpu``'s ``radial_fac`` and ``radial_inv_r``."""
    r_lo, dr = geo.radial
    r = (torch.as_tensor(rows).to(dtype) + 0.5) * dr + r_lo
    return (1.0 / (2.0 * dr)) / r if kind == "fac" else 1.0 / r


def row_table(program, dtype, device) -> torch.Tensor:
    """A cylindrical program's table of the :data:`ROW_VALUES` of every grid
    row, which its kernel reads once a row: an ``(n_rows + 2*pad, 2)``
    tensor of `dtype` on `device`, grid row i at index ``i + pad`` with pad
    the deepest halo of the program's passes (:func:`row_pad`; those rows
    repeat the edge rows, whose values they never stand for), the numbers of
    :func:`radial_values`. Made once per program, dtype and device."""
    tables = program.__dict__.setdefault("_row_tables", {})
    key = (dtype, torch.device(device))
    if key not in tables:
        n_rows, pad = program.geometry.shape[0], row_pad(program)
        rows = torch.arange(-pad, n_rows + pad, device=device).clamp(0, n_rows - 1)
        tables[key] = torch.stack([radial_values(program.geometry, kind, rows, dtype)
                                   for kind in ROW_VALUES], dim=1).contiguous()
    return tables[key]


def row_pad(program) -> int:
    """The rows a pass of the program reaches past an edge at most: the
    halo of its ladder's deepest pass."""
    return max(program.ladder) * program.depth


def _laplace(geo: _Geometry, center, *pairs, fac=None):
    """The 5-point (2D) or 7-point (3D) Laplacian from the (low, high)
    neighbours of each axis, in the TPU helpers' order of operations; on a
    cylindrical grid with the rows' radial factor `fac`."""
    if geo.radial is not None:
        (up, down), (left, right) = pairs
        return ((geo.sx - fac) * up + (geo.sx + fac) * down + geo.sy * (left + right)
                - (2.0 * (geo.sx + geo.sy)) * center)
    if len(set(geo.scales)) == 1:
        total = pairs[0][0] + pairs[0][1]
        for low, high in pairs[1:]:
            total = total + low + high
        return (total - (2.0 * geo.rank) * center) * geo.scales[0]
    result = None
    for (low, high), scale in zip(pairs, geo.scales, strict=True):
        term = (low + high - 2.0 * center) * scale
        result = term if result is None else result + term
    return result


def along(values, axis: int, rank: int):
    """A 1D tensor shaped to broadcast along `axis` of a rank-`rank` array."""
    shape = [1] * rank
    shape[axis] = -1
    return values.reshape(shape)


def _sum_of_squares(values):
    total = None
    for v in values:
        total = v * v if total is None else total + v * v
    return total


# -- (a) the plain version: whole planes ------------------------------------------------------
class PlainHelpers(_Geometry):
    """Stencil primitives on whole planes or volumes; ``trim`` is a no-op."""

    def __init__(self, grid):
        super().__init__(grid)
        self.derivatives = (self.d_row, self.d_col, self.d_depth)[: self.rank]

    def _neighbours(self, f, axis: int, bc):
        sides = self.axis_sides(bc, axis)
        if sides is None:
            return torch.roll(f, 1, axis), torch.roll(f, -1, axis)
        return _neighbours(f, axis, False, *sides)

    def _rows(self, kind: str, work):
        """The radial helper `kind` over the rows, a column on `work`'s device."""
        rows = torch.arange(self.shape[0], device=work.device)
        return radial_values(self, kind, rows, work.dtype)[:, None]

    def lap(self, work, bc=None):
        pairs = [self._neighbours(work, axis, bc) for axis in range(self.rank)]
        fac = None if self.radial is None else self._rows("fac", work)
        return _laplace(self, work, *pairs, fac=fac)

    def gradient_squared(self, work, bc=None):
        return _sum_of_squares(d(work, bc) for d in self.derivatives)

    def _diff(self, work, axis: int, bc):
        low, high = self._neighbours(work, axis, bc)
        return (high - low) * self.halves[axis]

    def d_row(self, work, bc=None):
        return self._diff(work, 0, bc)

    def d_col(self, work, bc=None):
        return self._diff(work, 1, bc)

    def d_depth(self, work, bc=None):
        return self._diff(work, 2, bc)

    def divergence(self, comps, bc=None):
        total = None
        for d, comp in zip(self.derivatives, comps, strict=True):
            term = d(comp, bc)
            total = term if total is None else total + term
        if self.radial is not None:  # the cylindrical divergence's v_r / r
            total = total + comps[0] * self._rows("inv", total)
        return total

    def trim(self, value, amount):
        return value

    @staticmethod
    def pointwise(name: str, value):
        return POINTWISE[name][0](value)

    @staticmethod
    def broadcast(value, like):
        if isinstance(value, torch.Tensor):
            return value.expand_as(like)
        return torch.full_like(like, float(value))


# -- (b) emulation of the SDE kernels' square window ------------------------------------------
class TileHelpers(PlainHelpers):
    """Stencil primitives on one tile's arrays, as a square-window kernel
    computes them (the SDE kernels; the ext plain version on a whole block).

    An array is centred on the output tile (``tile`` cells per axis from
    ``origin``) with equal halos on every side; each operator consumes one
    cell per side on every axis. On a non-periodic axis the neighbour beyond
    a global edge cell is replaced by the operand's ghost value at that
    level, and results outside the domain are zero.
    """

    def __init__(self, grid, tile, *origin: int):
        super().__init__(grid)
        if self.radial is not None:
            raise KernelUnsupportedError("The square-window and ext kernels take Cartesian grids")
        self.tile = (tile,) * self.rank if isinstance(tile, int) else tuple(tile)
        self.origin = origin

    def _edges(self, axis: int) -> tuple[bool, bool]:
        """Whether the low and the high side of `axis` are global edges."""
        edge = not self.periodic[axis]
        return edge, edge

    def _coords(self, size: int, axis: int):
        """Global indices and in-domain mask of the inner cells of an array side."""
        halo = (size - self.tile[axis]) // 2
        g = torch.arange(1, size - 1) + self.origin[axis] - halo
        n = self.shape[axis]
        lo_edge, hi_edge = self._edges(axis)
        inside = torch.ones_like(g, dtype=torch.bool)
        if lo_edge:
            inside &= g >= 0
        if hi_edge:
            inside &= g < n
        return g, inside

    def _stencil(self, w, bc, axes):
        """Centre, {axis: (low, high)} neighbours with ghost substitution, and
        the in-domain mask of the inner cells of `w`."""
        inner = (slice(1, -1),) * self.rank
        center = w[inner]
        coords = [self._coords(w.shape[axis], axis) for axis in range(self.rank)]
        pairs = {}
        for axis in axes:
            low_sl, high_sl = list(inner), list(inner)
            low_sl[axis], high_sl[axis] = slice(None, -2), slice(2, None)
            low, high = w[tuple(low_sl)], w[tuple(high_sl)]
            sides = self.axis_sides(bc, axis)
            if sides is not None:
                lo, hi = sides
                if self.side_views is not None:  # the side inputs at the tile's cells
                    key = bc_key(bc, self.rank, self.sides, self.stage)[axis]
                    lo, hi = (tuple(self._tile_term(t, axis, coords) for t in side)
                              for side in key)
                g = coords[axis][0]
                lo_edge, hi_edge = self._edges(axis)
                at_lo = along((g == 0) & lo_edge, axis, self.rank)
                at_hi = along((g == self.shape[axis] - 1) & hi_edge, axis, self.rank)
                low, high = (
                    torch.where(at_lo, _ghost(lo, center, high), low),
                    torch.where(at_hi, _ghost(hi, center, low), high),
                )
            pairs[axis] = (low, high)
        inside = functools.reduce(
            torch.logical_and, (along(m, axis, self.rank) for axis, (_, m) in enumerate(coords))
        )
        return center, pairs, inside

    def _tile_term(self, term, axis: int, coords):
        """A ghost term at the tile's inner cells: a side input's values at
        their global positions along the side (wrapped on a periodic axis)."""
        if not is_side_ref(term):
            return term
        _, index, base = term
        row = self.side_views[index][self.step]
        kind = self.sides.kind(index)
        if kind == "t":
            value = row[0]
        else:
            cells = []
            for other in self.sides.face_axes(kind):
                g, n = self._side_cells(coords[other][0], other)
                g = g % n if self.periodic[other] else g.clamp(0, n - 1)
                cells.append(along(g, other, self.rank))
            value = self.sides.gather(row, kind, cells)
        return value if base is None else base + value

    def _side_cells(self, g, axis: int):
        """The grid's cells along `axis` of the tile's cells `g`, and their count."""
        return g, self.shape[axis]

    @staticmethod
    def _mask(value, inside):
        return torch.where(inside, value, torch.zeros((), dtype=value.dtype))

    def lap(self, work, bc=None):
        center, pairs, inside = self._stencil(work, bc, range(self.rank))
        return self._mask(_laplace(self, center, *pairs.values()), inside)

    def gradient_squared(self, work, bc=None):
        _, pairs, inside = self._stencil(work, bc, range(self.rank))
        diffs = ((high - low) * self.halves[axis] for axis, (low, high) in pairs.items())
        return self._mask(_sum_of_squares(diffs), inside)

    def _diff(self, work, axis: int, bc):
        _, pairs, inside = self._stencil(work, bc, (axis,))
        low, high = pairs[axis]
        return self._mask((high - low) * self.halves[axis], inside)

    def trim(self, value, amount):
        if isinstance(value, tuple):
            return tuple(self.trim(v, amount) for v in value)
        if amount == 0 or not isinstance(value, torch.Tensor):
            return value
        return value[(slice(amount, -amount),) * self.rank]


# -- (c) tracing: the expression graph the kernel is emitted from ------------------------------
class _Node:
    """One value of the traced step: an operation on earlier nodes."""

    __slots__ = ("tracer", "op", "args", "depth", "index")

    def __init__(self, tracer, op, args, depth, index):
        self.tracer, self.op, self.args, self.depth, self.index = tracer, op, args, depth, index

    def __add__(self, other):
        return self.tracer.binary("+", self, other)

    def __radd__(self, other):
        return self.tracer.binary("+", other, self)

    def __sub__(self, other):
        return self.tracer.binary("-", self, other)

    def __rsub__(self, other):
        return self.tracer.binary("-", other, self)

    def __mul__(self, other):
        return self.tracer.binary("*", self, other)

    def __rmul__(self, other):
        return self.tracer.binary("*", other, self)

    def __truediv__(self, other):
        return self.tracer.binary("/", self, other)

    def __rtruediv__(self, other):
        return self.tracer.binary("/", other, self)

    def __neg__(self):
        return self.tracer.make("neg", self)

    def __pow__(self, exponent):
        if isinstance(exponent, _Node):
            raise KernelUnsupportedError("The kernel takes numeric exponents only")
        return self.tracer.make("pow", self, float(exponent))


class _Tracer(_Geometry):
    """Helpers that record the step as a graph of :class:`_Node` (hash-consed,
    so equal subexpressions are one node)."""

    def __init__(self, grid):
        super().__init__(grid)
        self.nodes: list[_Node] = []
        self._index: dict = {}
        self.derivatives = (self.d_row, self.d_col, self.d_depth)[: self.rank]
        #: (stage, nodes traced before it) at each :meth:`bind_stage` of the
        #: step: an RK4 step's marks, which cut it into passes in 3D
        self.marks: list[tuple[int, int]] = []

    def bind_stage(self, stage: int) -> None:
        super().bind_stage(stage)
        self.marks.append((stage, len(self.nodes)))

    def make(self, op, *args):
        key = (op,) + tuple(
            ("n", a.index) if isinstance(a, _Node) else ("v", repr(a)) for a in args
        )
        node = self._index.get(key)
        if node is None:
            if op in _STENCIL_AXES:
                depth = args[0].depth + 1
            else:
                depth = max((a.depth for a in args if isinstance(a, _Node)), default=0)
            node = _Node(self, op, args, depth, len(self.nodes))
            self.nodes.append(node)
            self._index[key] = node
        return node

    def lift(self, value) -> _Node:
        if isinstance(value, _Node):
            return value
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise KernelUnsupportedError(f"Cannot lower {type(value).__name__} into the kernel")
        return self.make("const", float(value))

    def binary(self, op, a, b):
        return self.make(op, self.lift(a), self.lift(b))

    def _stencil(self, kind, work, bc):
        if not isinstance(work, _Node) or work.op == "const":
            raise KernelUnsupportedError("A stencil of a constant has no kernel lowering")
        key = bc_key(bc, self.rank, self.sides, self.stage)
        for axis in stencil_axes(kind, self.rank):
            self.axis_sides(key, axis)
        return self.make(kind, work, key)

    def lap(self, work, bc=None):
        return self._stencil("lap", work, bc)

    def gradient_squared(self, work, bc=None):
        return self._stencil("gsq", work, bc)

    def d_row(self, work, bc=None):
        return self._stencil("drow", work, bc)

    def d_col(self, work, bc=None):
        return self._stencil("dcol", work, bc)

    def d_depth(self, work, bc=None):
        return self._stencil("ddep", work, bc)

    def divergence(self, comps, bc=None):
        total = None
        for d, comp in zip(self.derivatives, comps, strict=True):
            total = d(comp, bc) if total is None else total + d(comp, bc)
        if self.radial is not None:  # the cylindrical divergence's v_r / r
            total = total + comps[0] * self.make("radial", "inv")
        return total

    def trim(self, value, amount):
        return value

    def pointwise(self, name: str, value):
        if name not in POINTWISE:
            raise KernelUnsupportedError(f"No kernel lowering for the function `{name}`")
        return self.make("func", self.lift(value), name)

    def broadcast(self, value, like):
        return self.lift(value)


def _tile_for(n_planes: int, halo: int, itemsize: int) -> int | None:
    """Largest output tile of the SDE kernels' square window whose planes fit
    the shared-memory budget."""
    for tile in TILES:
        if n_planes * (tile + 2 * halo) ** 2 * itemsize <= SMEM_BUDGET:
            return tile
    return None


def _plan_ladder(top_k: int, tile_for: Callable) -> list[int]:
    """The ladder of steps per pass (top_k, top_k/2, ..., 1), its top cut
    until ``tile_for(k, 8)`` (fp64 planes) finds a tile."""
    k = top_k
    while k > 1 and tile_for(k, 8) is None:
        k //= 2
    if tile_for(k, 8) is None:
        raise KernelUnsupportedError("The planes at k = 1 do not fit the kernel's shared memory")
    ladder = []
    while k >= 1:
        ladder.append(k)
        k //= 2
    return ladder


def row_threads(width: int) -> int:
    """Threads of a march block over window rows of `width` cells: one column
    each, in whole warps, at most :data:`ROW_THREADS`."""
    return min(ROW_THREADS, -(-width // 32) * 32)


def row_plan(levels: int, slots: int, halo: int, itemsize: int) -> tuple[int, int] | None:
    """The plan ``(tx, threads)`` of a row march that keeps `slots`
    shared-memory rows for each of `levels` levels, with `halo` cells of halo
    per side: the widest strip of :data:`ROW_TX` whose rows fit the budget of
    :data:`SMEM_BUDGET`, and :func:`row_threads` of its window row; None when
    none fits. ``RowShape::kSmem`` of the template (level 0 through
    registers)."""
    for tx in ROW_TX:
        if levels * slots * (tx + 2 * halo) * itemsize <= SMEM_BUDGET:
            return tx, row_threads(tx + 2 * halo)
    return None


def chunk_rows(n_rows: int, strips: int, n_blocks: int = 1) -> int:
    """The rows each block of a launch over `n_rows` rows in `strips` strips
    and `n_blocks` blocks marches, which the wrappers pass to the kernel: the
    longest of :data:`CHUNK_ROWS` that still gives :data:`FILL_BLOCKS`
    blocks, else the shortest."""
    for chunk in CHUNK_ROWS[:-1]:
        if -(-n_rows // chunk) * strips * n_blocks >= FILL_BLOCKS:
            return chunk
    return CHUNK_ROWS[-1]


class StencilProgram:
    """A step traced once into an expression graph, with its kernel geometry.

    ``make_step(helpers)`` returns ``step(works) -> works`` over ``n_fields``
    planes consuming ``depth`` halo cells per side per step. The program holds
    the grid's ``rank``, the ladder of steps per pass (``ladder``, largest
    first), the plan of each (dtype, k) (``tiles``), and the generated CUDA
    source. This class emits the 2D row-marching kernel (the march's stages
    and slots: :attr:`march`); :class:`WindowProgram` the SDE kernels'
    square window, :class:`.cuda_stencil_3d.StencilProgram3D` the 3D march.
    """

    #: rank of the grids this program's kernel takes
    rank = 2
    #: stem of the built library's file name
    library = "multi_stencil_2d"
    template = _MARCH_TEMPLATE
    #: the headers the template includes, beside those every build has
    headers: tuple[Path, ...] = ()
    #: halo cells per side of the ladder's top pass, before the budget cuts it
    top_halo = TOP_HALO

    def __init__(self, grid, make_step: Callable, depth: int, n_fields: int, *,
                 carry: bool = False, sides: SideInputs | None = None):
        #: whether the stage cut stores the values a later stage needs from an
        #: earlier one (:func:`.cuda_march.march_layout`) instead of recomputing them
        self.carry = carry
        tracer = _Tracer(grid)
        tracer.sides = sides
        if tracer.rank != self.rank:
            raise KernelUnsupportedError(
                f"{type(self).__name__} emits the {self.rank}D kernel, not a {tracer.rank}D one"
            )
        outputs = make_step(tracer)([tracer.make("field", f) for f in range(n_fields)])
        if len(outputs) != n_fields:
            raise ValueError(f"The step returned {len(outputs)} planes for {n_fields} fields")
        self.outputs = [tracer.lift(out) for out in outputs]
        if max(out.depth for out in self.outputs) > depth:
            raise ValueError(f"The step consumes more than its halo of {depth} cells per step")
        if depth < 1:
            raise KernelUnsupportedError("The rhs has no stencil operator (depth 0)")
        for axis, n in enumerate(tracer.shape):
            if not tracer.periodic[axis] and n < 2:
                raise KernelUnsupportedError(
                    "A non-periodic axis needs at least 2 cells for the kernel"
                )
        self.grid, self.make_step, self.depth, self.n_fields = grid, make_step, depth, n_fields
        self.geometry = tracer
        self.nodes = tracer.nodes
        #: the side inputs its ghosts read (:class:`SideInputs`), None where none
        self.sides = sides if sides is not None and sides.entries else None
        # each stencil operand that is not a bare field lives in a shared-memory buffer
        operands = {n.args[0].index: n.args[0] for n in self.nodes if n.op in _STENCIL_AXES}
        self.buffers = [n for i, n in sorted(operands.items()) if n.op != "field"]
        self.ladder = self.plan_ladder()
        self.tiles = {
            dtype: {kk: self.tile_for(kk, size) for kk in self.ladder}
            for dtype, (_, _, size) in _DTYPES.items()
        }
        if self.sides is not None:
            self.sides.pad = row_pad(self)
        self.source = self.emit()
        text = (self.source + self.template.read_text()
                + "".join(header.read_text() for header in self.headers) + " ".join(_NVCC_FLAGS))
        self.digest = hashlib.sha256(text.encode()).hexdigest()[:16]

    @functools.cached_property
    def march(self) -> MarchLayout:
        from .cuda_march import march_layout, pad_rings  # they build on this module's tracer

        return pad_rings(march_layout(self, _ROW_AXES), PERIOD_CAP)

    def plan_ladder(self) -> list[int]:
        """The ladder (top, top // 2, ..., 1), its top lowered one step at a time
        until an fp64 plan fits (a top of 3 that does not fit falls to 2, not 1)."""
        top = max(1, self.top_halo // self.depth)
        while top > 1 and self.tile_for(top, 8) is None:
            top -= 1
        return _plan_ladder(top, self.tile_for)

    def tile_for(self, k: int, itemsize: int):
        """The kernel's plan of a k-step pass, or None when none fits."""
        return row_plan(k, self.march.step_slots, k * self.depth, itemsize)

    def emit(self) -> str:
        return emit_source(self)

    @functools.cached_property
    def plain_helpers(self) -> PlainHelpers:
        helpers = PlainHelpers(self.grid)
        helpers.sides = self.sides
        return helpers

    @functools.cached_property
    def plain_step(self) -> Callable:
        return self.make_step(self.plain_helpers)

    def launch_args(self, spec) -> tuple[int, ...]:
        """The int arguments of the entry point for one pass: the plane shape,
        k and the rows each block marches (:func:`chunk_rows`)."""
        n_rows, n_cols = spec.shape
        return n_rows, n_cols, spec.k, chunk_rows(n_rows, -(-n_cols // spec.tile[0]))

    def load(self, path: str) -> ctypes.CDLL:
        return _load(path, self.library, self.sides is not None)


class WindowProgram(StencilProgram):
    """A traced one-field step for the Euler-Maruyama kernels of
    :mod:`.cuda_sde_2d`, whose square window (``sde_window_2d_kernel`` of
    ``csrc/multi_stencil_2d.cuh``) takes a ``(tile + 2*k*depth)²`` window per
    plane: the ladder halves from :data:`DEFAULT_HALO` until an fp64 tile fits
    the budget, and :attr:`source` is the ``Level`` program struct that the
    SDE sources include."""

    template = _TEMPLATE
    top_halo = DEFAULT_HALO

    def __init__(self, grid, make_step: Callable, depth: int, n_fields: int, **kwargs):
        if isinstance(grid, CylindricalSymGrid):
            raise KernelUnsupportedError(
                "The Euler-Maruyama windows take 2D Cartesian grids only, as in pde_tpu")
        super().__init__(grid, make_step, depth, n_fields, **kwargs)

    @property
    def n_planes(self) -> int:
        """Shared-memory planes of the window: the fields' two levels and the buffers."""
        return 2 * self.n_fields + len(self.buffers)

    def plan_ladder(self) -> list[int]:
        return _plan_ladder(max(1, self.top_halo // self.depth), self.tile_for)

    def tile_for(self, k: int, itemsize: int):
        return _tile_for(self.n_planes, k * self.depth, itemsize)

    def emit(self) -> str:
        return "\n".join(emit_program(self))


# -- the emitters ----------------------------------------------------------------------------
def _literal(value: float) -> str:
    return f"T({value!r})"


class _CellBody:
    """C++ statements computing graph nodes at one cell (index ``idx``) of the
    square window's level struct ``L``."""

    def __init__(self, program: StencilProgram, stored: dict[int, int]):
        self.program, self.stored = program, stored
        self.lines: list[str] = []
        self.names: dict[int, str] = {}

    def _let(self, node, expr: str) -> str:
        name = f"v{node.index}"
        self.lines.append(f"const T {name} = {expr};")
        self.names[node.index] = name
        return name

    def storage(self, node) -> str:
        if node.op == "field":
            return f"L.cur[{node.args[0]}]"
        return f"L.buf[{self.program.buffers.index(node)}]"

    def value(self, node) -> str:
        if node.index in self.names:
            return self.names[node.index]
        if node.index in self.stored:
            return self._let(node, f"L.buf[{self.stored[node.index]}][idx]")
        op, args = node.op, node.args
        if op == "const":
            return _literal(args[0])
        if op == "field":
            return self._let(node, f"L.cur[{args[0]}][idx]")
        if op in ("+", "-", "*", "/"):
            return self._let(node, f"{self.value(args[0])} {op} {self.value(args[1])}")
        if op == "neg":
            return self._let(node, f"-{self.value(args[0])}")
        if op == "pow":
            return self._let(node, f"pow({self.value(args[0])}, {_literal(args[1])})")
        if op == "func":
            return self._let(node, f"{POINTWISE[args[1]][1]}({self.value(args[0])})")
        if op == "radial":
            raise KernelUnsupportedError("The square window has no radial helpers")
        return self._stencil(node)

    def _term(self, term) -> str:
        """A ghost formula's term in C: a literal, or a side input of the
        program (:meth:`_side_read`), plus its base where it has one."""
        if not is_side_ref(term):
            return _literal(term)
        _, index, base = term
        read = self._side_read(index)
        return read if base is None else f"({_literal(base)} + {read})"

    def _side_read(self, index: int) -> str:
        """Side input `index` at the step's row ``L.sp[i]``: a row side's at
        the cell's global column gc, a column side's at its global row gr, a
        value per step at 0."""
        at = {"t": "0", "row": "gc", "col": "gr"}[self.program.sides.kind(index)]
        return f"L.sp[{index}][{at}]"

    def _stencil(self, node) -> str:
        geo = self.program.geometry
        operand, key = node.args
        rows, cols = (axis in stencil_axes(node.op, 2) for axis in (0, 1))
        s = f"v{node.index}"
        p = self.storage(operand)
        c = f"{p}[idx]"
        lines = self.lines
        if rows:
            lines.append(f"T {s}_u = {p}[idx - W];")
            lines.append(f"T {s}_d = {p}[idx + W];")
        if cols:
            lines.append(f"T {s}_l = {p}[idx - 1];")
            lines.append(f"T {s}_r = {p}[idx + 1];")
        if node.op == "lap":
            lines.append(f"const T {s}_c = {c};")
            c = f"{s}_c"
        for axis, needed, g, n, (lo_n, hi_n) in (
            (0, rows, "gr", "n_rows", ("u", "d")),
            (1, cols, "gc", "n_cols", ("l", "r")),
        ):
            if not needed or key is None or key[axis] is None:
                continue
            lo, hi = key[axis]
            lines.append(
                f"if ({g} == 0) {s}_{lo_n} = {_ghost_expr(lo, c, f'{s}_{hi_n}', self._term)}; "
                f"else if ({g} == {n} - 1) "
                f"{s}_{hi_n} = {_ghost_expr(hi, c, f'{s}_{lo_n}', self._term)};"
            )
        if node.op == "lap":
            if geo.sx == geo.sy:
                expr = (f"({s}_u + {s}_d + {s}_l + {s}_r - T(4) * {c}) * {_literal(geo.sx)}")
            else:
                expr = (f"({s}_u + {s}_d - T(2) * {c}) * {_literal(geo.sx)} + "
                        f"({s}_l + {s}_r - T(2) * {c}) * {_literal(geo.sy)}")
        elif node.op == "gsq":
            lines.append(f"const T {s}_x = ({s}_d - {s}_u) * {_literal(geo.gx)};")
            lines.append(f"const T {s}_y = ({s}_r - {s}_l) * {_literal(geo.gy)};")
            expr = f"{s}_x * {s}_x + {s}_y * {s}_y"
        elif node.op == "drow":
            expr = f"({s}_d - {s}_u) * {_literal(geo.gx)}"
        else:
            expr = f"({s}_r - {s}_l) * {_literal(geo.gy)}"
        return self._let(node, expr)


def _ghost_expr(side, edge: str, inward: str, render: Callable = _literal) -> str:
    """``c + f1*edge (+ f2*inward)`` in C, each term through `render` (a
    side input's term reads the program's inputs)."""
    const, f1, f2 = side
    expr = f"{render(const)} + {render(f1)} * {edge}"
    if f2:
        expr += f" + {render(f2)} * {inward}"
    return expr


# the row march's neighbour reads (:class:`.cuda_march.MarchCellBody`): rows
# from the operand rows before and after (row flags ``rf``), columns from the
# neighbouring cells of the centre row (column flags ``cf``)
_ROW_AXES = (
    ("u", "d", "O.lo[{v}][q]", "O.hi[{v}][q]", "rf & pde_tpu_torch::kLowEdge",
     "rf & pde_tpu_torch::kHighEdge"),
    ("l", "r", "O.c[{v}][q - 1]", "O.c[{v}][q + 1]", "cf & pde_tpu_torch::kLowEdge",
     "cf & pde_tpu_torch::kHighEdge"),
)


def _sweep(program, halo: str, targets, stored) -> list[str]:
    """One region sweep of the square window: every cell computes `targets`
    ((destination, node))."""
    body = _CellBody(program, stored)
    values = [(dst, body.value(node)) for dst, node in targets]
    lines = [
        "pde_tpu_torch::for_each_cell<kRowsPeriodic, kColsPeriodic>(L, " + halo + ", "
        "[&](int idx, int gr, int gc, bool inside) {",
        "  (void)gr;",
        "  (void)gc;",
        "  if (!inside) {",
        *[f"    {dst}[idx] = T(0);" for dst, _ in targets],
        "    return;",
        "  }",
        *["  " + line for line in body.lines],
        *[f"  {dst}[idx] = {value};" for dst, value in values],
        "});",
    ]
    return lines


def emit_program(program: StencilProgram) -> list[str]:
    """The ``Program`` struct of one traced step for the square window of the
    SDE kernels (``level``: one step over the window's level struct)."""
    geo = program.geometry
    level = "T, kFields, kBuffers" + (", kSideInputs" if program.sides is not None else "")
    lines = [
        "namespace {",
        "",
        "struct Program {",
        f"  static constexpr int kFields = {program.n_fields};",
        f"  static constexpr int kBuffers = {len(program.buffers)};",
        f"  static constexpr int kDepth = {program.depth};",
        f"  static constexpr bool kRowsPeriodic = {str(geo.periodic[0]).lower()};",
        f"  static constexpr bool kColsPeriodic = {str(geo.periodic[1]).lower()};",
        *_side_constants(program.sides),
        "",
        "  template <typename T>",
        f"  __device__ static void level(const pde_tpu_torch::Level<{level}>& L, int h) {{",
        "    const int W = L.w;",
        "    const int n_rows = L.n_rows;",
        "    const int n_cols = L.n_cols;",
        "    (void)W;",
        "    (void)n_rows;",
        "    (void)n_cols;",
    ]
    stored: dict[int, int] = {}
    for depth in sorted({node.depth for node in program.buffers}):
        group = [(f"L.buf[{program.buffers.index(n)}]", n)
                 for n in program.buffers if n.depth == depth]
        lines += ["    // operand buffers of depth %d" % depth]
        lines += ["    " + line for line in _sweep(program, f"h - {depth}", group, stored)]
        lines += ["    __syncthreads();"]
        stored.update({n.index: program.buffers.index(n) for _, n in group})
    targets = [(f"L.nxt[{f}]", out) for f, out in enumerate(program.outputs)]
    lines += ["    // the next level of every field"]
    lines += ["    " + line for line in _sweep(program, f"h - {program.depth}", targets, stored)]
    lines += ["  }", "};", "", "}  // namespace", ""]
    return lines


def select_expr(var: str, values) -> str:
    """A C expression giving ``values[var]``."""
    expr = str(values[-1])
    for i in range(len(values) - 2, -1, -1):
        expr = f"{var} == {i} ? {values[i]} : {expr}"
    return expr


def _side_constants(sides: SideInputs | None) -> list[str]:
    """A program struct's description of its side inputs (none without):
    their count, the tables' padding, and each one's kind
    (:data:`SIDE_KINDS`) and step stride (:meth:`SideInputs.step`)."""
    if sides is None:
        return []
    kinds = [SIDE_KINDS.index(kind) for _, _, kind, _ in sides.entries]
    return [
        f"  static constexpr int kSideInputs = {len(kinds)};",
        f"  static constexpr int kSidePad = {sides.pad};",
        "  __host__ __device__ static constexpr int side_axis(int i) { return "
        f"{select_expr('i', kinds)}; }}",
        "  __host__ __device__ static constexpr long long side_step(int i) { return "
        f"{select_expr('i', [sides.step(i) for i in range(len(kinds))])}; }}",
    ]


def emit_march_program(program: StencilProgram, round_bf16: bool = False) -> list[str]:
    """The ``Program`` struct of one traced step, for the row march of
    ``csrc/march_2d.cuh`` (both kernels call its stage functions); with
    `round_bf16` its last stage rounds the fields' next level to bf16 (the
    bf16 storage of the ext kernel #8)."""
    geo = program.geometry
    layout = program.march
    stages = layout.stages
    n_volumes = len(layout.slots)
    bases = [sum(layout.slots[:v]) for v in range(n_volumes)]
    lines = [
        "namespace {",
        "",
        "struct Program {",
        f"  static constexpr int kFields = {program.n_fields};",
        f"  static constexpr int kVolumes = {n_volumes};",
        f"  static constexpr int kDepth = {program.depth};",
        f"  static constexpr int kStages = {len(stages)};",
        f"  static constexpr int kStepSlots = {layout.step_slots};",
        f"  static constexpr bool kRowsPeriodic = {str(geo.periodic[0]).lower()};",
        f"  static constexpr bool kColsPeriodic = {str(geo.periodic[1]).lower()};",
        "",
        "  __host__ __device__ static constexpr int stage_lag(int j) { return "
        f"{select_expr('j', [st.lag for st in stages])}; }}",
        "  __host__ __device__ static constexpr int stage_out(int j) { return "
        f"{select_expr('j', [st.first for st in stages])}; }}",
        "  __host__ __device__ static constexpr int stage_width(int j) { return "
        f"{select_expr('j', [len(st.nodes) for st in stages])}; }}",
        "  __host__ __device__ static constexpr int volume_slots(int v) { return "
        f"{select_expr('v', layout.slots)}; }}",
        "  __host__ __device__ static constexpr int volume_base(int v) { return "
        f"{select_expr('v', bases)}; }}",
    ]
    operands = "kVolumes"
    if geo.radial is not None:  # the radial helpers, from the row table (row_table)
        operands = "kVolumes, kRowValues"
        lines.append(f"  static constexpr int kRowValues = {len(ROW_VALUES)};  // "
                     f"{', '.join(ROW_VALUES)} of a row")
    sides = program.sides
    if sides is not None:  # the ghosts' side inputs, by kind (SIDE_KINDS)
        operands = ("kVolumes, kRowValues" if geo.radial is not None else "kVolumes, 0") + \
            ", kSideInputs"
        lines += _side_constants(sides)
    signature = (f"(const pde_tpu_torch::RowOperands<T, {operands}>& O, int q, unsigned cf, "
                 "unsigned rf, T* out)")
    for j, st in enumerate(stages):
        last = j + 1 == len(stages)
        what = "the next level of every field" if last else f"operand buffers of depth {st.lag}"
        if last and round_bf16:
            what += ", rounded to bf16"
        values = [f"__bfloat162float(__float2bfloat16_rn({value}))" if last and round_bf16
                  else value for value in st.values]
        lines += [
            "",
            f"  // stage {j}: {what}",
            "  template <typename T>",
            f"  __device__ static __forceinline__ void stage{j}{signature} {{",
            "    (void)O;",
            "    (void)q;",
            "    (void)cf;",
            "    (void)rf;",
            *["    " + line for line in st.lines],
            *[f"    out[{i}] = {value};" for i, value in enumerate(values)],
            "  }",
        ]
    lines += [
        "",
        "  template <int J, typename T>",
        f"  __device__ static __forceinline__ void stage{signature} {{",
        *[f"    {'if' if j == 0 else 'else if'} constexpr (J == {j}) stage{j}(O, q, cf, rf, out);"
          for j in range(len(stages))],
        "  }",
        "};",
        "",
        "}  // namespace",
        "",
    ]
    return lines


def emit_source(program: StencilProgram) -> str:
    """The CUDA C++ source of one traced step: a program struct for the row
    march's serial kernel, and the plain C entry points."""
    lines = [
        "// Generated by pde_tpu_torch/ops/cuda_stencil_2d.py from a traced step;",
        "// the kernel is the row march of pde_tpu_torch/csrc/march_2d.cuh.",
        '#include "march_2d.cuh"',
        "",
        *emit_march_program(program),
    ]
    sides = program.sides is not None
    for dtype, (ctype, suffix, _) in _DTYPES.items():
        lines += [
            f"extern \"C\" int multi_stencil_2d_{suffix}(const void* const* ins, void* const* outs,",
            "                                 int n_rows, int n_cols, int k, int chunk,",
            *(["                                 const void* const* sides, "
               "const long long* steps,"] if sides else []),
            "                                 void* stream) {",
            "  switch (k) {",
        ]
        for k in program.ladder:
            tx, threads = program.tiles[dtype][k]
            launcher, extra = ("launch_sides_2d", "sides, steps, ") if sides else ("launch_2d", "")
            lines.append(
                f"    case {k}: return pde_tpu_torch::{launcher}<Program, {ctype}, {k}, {tx}, "
                f"{threads}>(ins, outs, n_rows, n_cols, chunk, {extra}stream);"
            )
        lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


# -- the gate ---------------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class MultiStencilSpec:
    """One kernel pass: a program at k steps on planes of one shape and dtype."""

    program: StencilProgram
    shape: tuple[int, int]
    k: int
    dtype: torch.dtype
    tile: object  # the kernel's plan at this k and dtype: (tx, threads) of the march


def multi_stencil_spec(program: StencilProgram, k: int, dtype) -> MultiStencilSpec:
    """Describe one pass; raises :class:`KernelUnsupportedError` exactly where
    the kernel does not take it (nothing is built here). bf16 planes are
    refused, as ``pde_tpu``'s #7, #9, #10 and 3D gates refuse them."""
    if dtype == torch.bfloat16:
        if program.rank == 3:
            raise bf16_refusal("the 3D expression kernels #5 and #4",
                               "ops/pallas_cartesian.py:3044, 3487")
        if isinstance(program, WindowProgram):
            raise bf16_refusal("the SDE kernels #9 and #10",
                               "ops/pallas_cartesian.py:4690, 4878")
        raise bf16_refusal("the serial expression kernel #7", "ops/pallas_cartesian.py:3815")
    if dtype not in _DTYPES:
        raise KernelUnsupportedError(
            f"The kernel takes float32 or float64 planes, not {dtype}"
        )
    if k not in program.ladder:
        raise KernelUnsupportedError(f"k = {k} is not on the program's ladder {program.ladder}")
    if program.tiles[dtype][k] is None:  # a 3D program with an fp32 plan only
        raise KernelUnsupportedError(program.unplanned(k, dtype))
    return MultiStencilSpec(program, program.geometry.shape, k, dtype, program.tiles[dtype][k])


# -- plain version and the square window's emulation -----------------------------------------
def multi_stencil_2d_plain(datas, spec: MultiStencilSpec, sides=None) -> list:
    """k plain PyTorch steps on whole planes; `sides`: the pass's views of
    the program's side inputs (:meth:`SideInputs.for_pass`), where it has
    them."""
    program = spec.program
    step = program.plain_step
    helpers = program.plain_helpers
    helpers.side_views = sides
    works = list(datas)
    try:
        for s in range(spec.k):
            helpers.step = s
            helpers.bind_stage(0)
            works = list(step(works))
    finally:
        helpers.side_views = None
    return works


def tiled_pass(datas, spec: MultiStencilSpec, tile, noise=None, sides=None) -> list:
    """Pure-torch emulation of the SDE kernels' square window, tile by tile:
    each tile loads its window of every plane (periodic halos wrapped, zeros
    outside the domain), runs k steps through :class:`TileHelpers`, holds
    cells outside the domain at zero after each step, and writes its centre.
    `tile` is an int (the same on every axis) or one size per axis.

    With ``noise(s, rows, cols)`` (the increments of pass step s at the global
    cells ``rows x cols``, 1D index tensors wrapped on periodic axes), the
    first plane gets them after step s on the cells of the step's valid region
    that lie in the domain, as the kernel's noise policies add them. `sides`:
    the pass's views of the program's side inputs (:meth:`SideInputs.for_pass`),
    read at each tile's cells."""
    program = spec.program
    geo = program.geometry
    rank, k, depth = geo.rank, spec.k, program.depth
    tiles = (tile,) * rank if isinstance(tile, int) else tuple(tile)
    h0 = k * depth
    outs = [torch.empty_like(d) for d in datas]
    zero = torch.zeros((), dtype=datas[0].dtype)

    def window_index(start: int, axis: int):
        n, w = geo.shape[axis], tiles[axis] + 2 * h0
        g = torch.arange(start - h0, start - h0 + w)
        if geo.periodic[axis]:
            return g % n, torch.ones(w, dtype=torch.bool)
        return g.clamp(0, n - 1), (g >= 0) & (g < n)

    for origin in itertools.product(*(range(0, n, t) for n, t in zip(geo.shape, tiles))):
        index, masks = zip(*(window_index(o, axis) for axis, o in enumerate(origin)))
        inside = functools.reduce(
            torch.logical_and, (along(m, a, rank) for a, m in enumerate(masks))
        )
        gather = tuple(along(i, a, rank) for a, i in enumerate(index))
        works = [torch.where(inside, d[gather], zero) for d in datas]
        helpers = TileHelpers(program.grid, tiles, *origin)
        helpers.sides, helpers.side_views = program.sides, sides
        step = program.make_step(helpers)
        for s in range(1, k + 1):
            helpers.step = s - 1
            helpers.bind_stage(0)
            cut = tuple(slice(s * depth, t + 2 * h0 - s * depth) for t in tiles)
            works = [torch.where(inside[cut], x, zero) for x in step(works)]
            if noise is not None:
                cells = [i[c] for i, c in zip(index, cut)]
                works[0] = torch.where(inside[cut], works[0] + noise(s - 1, *cells), zero)
        sizes = [min(t, n - o) for t, n, o in zip(tiles, geo.shape, origin)]
        centre = tuple(slice(o, o + n) for o, n in zip(origin, sizes))
        for out, x in zip(outs, works, strict=True):
            out[centre] = x[tuple(slice(0, n) for n in sizes)]
    return outs


# -- replay of the row march --------------------------------------------------------------------
def grid_row_window(datas, shape, periodic, origin, tx: int, halo: int) -> MarchWindow:
    """The serial row march's window (``GridRows``) of the block whose first
    output cell is `origin` (row, column), over a strip of `tx` columns with
    `halo` cells of halo: periodic axes wrap, cells outside a non-periodic
    axis are outside the domain; ``read`` gives one row of each of `datas`."""
    from .cuda_march import MarchWindow

    n_rows, n_cols = shape
    g = torch.arange(origin[1] - halo, origin[1] + tx + halo)
    if periodic[1]:
        index, inside = g % n_cols, torch.ones_like(g, dtype=torch.bool)
        low = high = torch.zeros_like(inside)
    else:
        index, inside = g.clamp(0, n_cols - 1), (g >= 0) & (g < n_cols)
        low, high = g == 0, g == n_cols - 1
    out = inside & (g >= origin[1]) & (g < origin[1] + tx) & (g < n_cols)

    def plane(w):
        gr = origin[0] - halo + w
        row_in = periodic[0] or 0 <= gr < n_rows
        return row_in, row_in, not periodic[0] and gr == 0, not periodic[0] and gr == n_rows - 1

    def read(w):
        return [d[(origin[0] - halo + w) % n_rows][index] for d in datas]

    def row(w):
        return origin[0] - halo + w

    return MarchWindow(inside, inside, (inside & low, inside & high), out, plane, read, row,
                       cols=index)


def row_blocks(shape, halo: int, plan, window: Callable, march: Callable, n_out: int, dtype,
               n_blocks: int = 1) -> list:
    """Every block's march over a 2D `shape` in the row kernels' grid of strips
    and chunks at the plan ``(tx, chunk)`` (``chunk`` None: :func:`chunk_rows`
    of the shape over `n_blocks` blocks, as the launch picks it), with `halo`
    cells of halo: ``window(origin, halo)`` gives the
    :class:`.cuda_march.MarchWindow` of the block whose first output cell is
    `origin`, and ``march(window, rows, store)`` replays its march over `rows`
    window rows, handing each output row of its `n_out` planes to
    ``store(w, values, mask)``. Returns the planes; cells no block writes stay
    NaN."""
    tx, chunk = plan
    n_rows, n_cols = shape
    if chunk is None:
        chunk = chunk_rows(n_rows, -(-n_cols // tx), n_blocks)
    outs = [torch.full(tuple(shape), float("nan"), dtype=dtype) for _ in range(n_out)]
    for r0, c0 in itertools.product(range(0, n_rows, chunk), range(0, n_cols, tx)):
        width = min(tx, n_cols - c0)
        region, target = slice(halo, halo + width), slice(c0, c0 + width)

        def store(w, values, mask, r=r0 - halo, region=region, target=target):
            for out, value in zip(outs, values, strict=True):
                out[r + w, target] = torch.where(mask[region], value[region], out[r + w, target])

        march(window((r0, c0), halo), min(chunk, n_rows - r0) + 2 * halo, store)
    return outs


def march_program_rows(program, k: int, shape, plan, window: Callable, dtype,
                       n_blocks: int = 1, sides=None) -> list:
    """Every block's :func:`.cuda_march.march_program_block` of a 2D program
    over `shape` (see :func:`row_blocks`, with k * depth cells of halo).
    Returns the planes; cells no block writes stay NaN."""
    from .cuda_march import march_program_block

    return row_blocks(
        shape, k * program.depth, plan, window,
        lambda win, rows, store: march_program_block(win, program, k, rows, store, sides),
        program.n_fields, dtype, n_blocks)


def multi_stencil_2d_marched(datas, spec: MultiStencilSpec, plan=None, sides=None) -> list:
    """Pure-torch replay of the kernel's row march, block by block: see
    :func:`.cuda_march.march_program_block`. `plan` is ``(tx, chunk)``: the strip width
    and the chunk length; by default the kernel's strip and the chunk its
    launch picks; `sides` the pass's views of the program's side inputs.
    Cells no block writes stay NaN."""
    program = spec.program
    tx, chunk = (spec.tile[0], None) if plan is None else plan
    geo = program.geometry
    return march_program_rows(
        program, spec.k, spec.shape, (tx, chunk),
        lambda origin, halo: grid_row_window(list(datas), spec.shape, geo.periodic, origin, tx,
                                             halo),
        datas[0].dtype, sides=sides)


# -- the CUDA build ----------------------------------------------------------------------------
def _paths(program) -> tuple[Path, Path, Path]:
    stem = _BUILD_DIR / f"{program.library}_{program.digest}"
    return stem.with_suffix(".cu"), stem.with_suffix(".so"), stem.with_suffix(".log")


def build_programs(programs) -> list[dict]:
    """Build the kernel library of each program that is not built yet, one
    ``nvcc`` per distinct source, all started together. A program has a
    ``library`` stem, a ``digest`` and a ``source`` (a :class:`StencilProgram`,
    or a noise window's program from :mod:`.cuda_sde_2d`).

    Returns one ``{"path", "source", "seconds", "cpu_seconds", "compiled",
    "log"}`` per program: ``seconds`` until its build was collected,
    ``cpu_seconds`` the CPU time of its ``nvcc`` and the compilers it ran (0
    where nothing was built), ``log`` ptxas' resource report. Raises when any
    build fails.
    """
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, dict] = {}
    running = []
    started = set()
    for program in programs:
        source, lib, log = _paths(program)
        if program.digest in results or program.digest in started:
            continue
        started.add(program.digest)
        if lib.exists():
            results[program.digest] = {
                "path": str(lib), "source": str(source), "seconds": 0.0, "compiled": False,
                "cpu_seconds": 0.0, "log": log.read_text() if log.exists() else "",
            }
            continue
        source.write_text(program.source)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((program, cmd, proc, tmp, time.perf_counter()))
    failures = []
    for program, cmd, proc, tmp, start in running:
        output = proc.stdout.read()
        proc.stdout.close()
        _, status, usage = os.wait4(proc.pid, 0)  # with the CPU time of nvcc's compilers
        proc.returncode = os.waitstatus_to_exitcode(status)
        seconds = time.perf_counter() - start
        source, lib, log = _paths(program)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{output}")
            continue
        log.write_text(output)
        os.replace(tmp, lib)
        results[program.digest] = {
            "path": str(lib), "source": str(source), "seconds": seconds, "compiled": True,
            "cpu_seconds": usage.ru_utime + usage.ru_stime, "log": output,
        }
    if failures:
        raise RuntimeError("\n".join(failures))
    return [results[program.digest] for program in programs]


@functools.cache
def _load(path: str, library: str, sides: bool = False) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"{library}_{suffix}")
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # host arrays of input and output pointers
            *[ctypes.c_int] * 4,  # the program's launch_args (four at either rank)
            # the side inputs: a host array of device pointers and one of step strides
            *[ctypes.c_void_p] * (2 if sides else 0),
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def _library(program) -> ctypes.CDLL:
    """The program's kernel library, built and loaded at first use."""
    lib = program.__dict__.get("_lib")
    if lib is None:
        lib = program._lib = program.load(build_programs([program])[0]["path"])
    return lib


# -- the wrapper ------------------------------------------------------------------------------
def multi_stencil_2d(datas, spec: MultiStencilSpec, outs=None, sides=None) -> list:
    """k steps of the spec's program over the planes `datas`, with the pass's
    views of its side inputs `sides` (:meth:`SideInputs.for_pass`; required
    where the program has them).

    CPU tensors get the plain version. CUDA tensors go through the generated
    kernel, which writes `outs` (allocated when not given; they must not alias
    the inputs, since tiles read their neighbours' cells); any failure raises.
    ``multi_stencil_2d.launches`` counts kernel launches, ``.sides_launches``
    those with side inputs.
    """
    return run_pass(multi_stencil_2d, datas, spec, outs, sides)


multi_stencil_2d.launches = 0
multi_stencil_2d.sides_launches = 0


def check_sides(program, sides, spec, device) -> None:
    """Raise unless `sides` are the views of the program's side inputs that
    a pass of `spec` on `device` reads (None where it has none)."""
    n_sides = 0 if program.sides is None else len(program.sides.entries)
    if (sides is None) != (n_sides == 0) or (sides is not None and len(sides) != n_sides):
        raise ValueError(f"The program reads {n_sides} side inputs; got "
                         f"{'none' if sides is None else len(sides)}")
    work = compute_dtype(spec.dtype)
    if sides is not None and any(v.dtype != work or v.device != device or v.shape[0] < spec.k
                                 for v in sides):
        raise ValueError("The side inputs must be tables of the planes' compute dtype and "
                         "device")


def side_args(program, sides) -> list:
    """The ctypes arrays of a pass's side inputs for the kernel: each view's
    first row and its step stride, then, for a 3D program, each table's line
    stride (:meth:`SideInputs.row_stride`); none without side inputs. The
    caller passes their addresses and keeps them alive through the call."""
    if sides is None:
        return []
    n_sides = len(sides)
    pointers = (ctypes.c_void_p * n_sides)(*[v.data_ptr() for v in sides])
    strides = [step if step >= 0 else v.stride(0)
               for step, v in ((program.sides.step(i), v) for i, v in enumerate(sides))]
    if program.rank == 3:
        strides += [program.sides.row_stride(i) for i in range(n_sides)]
    steps = (ctypes.c_longlong * len(strides))(*strides)
    return [pointers, steps]


def run_pass(wrapper, datas, spec: MultiStencilSpec, outs=None, sides=None, unit=None) -> list:
    """One pass of a program's kernel for the `wrapper` of its rank, whose
    ``launches`` it counts: the plain version on the CPU, the generated
    library's ``<library>_f32``/``_f64`` entry point on a CUDA device. With
    `unit`, pass ``unit.index`` of the cut 3D step ``spec.program``, whose
    inputs and outputs differ: its plain version ``unit.plain``, its entry
    point ``<library>_p<index>_f32``/``_f64``, its launches also counted in
    ``wrapper.pass_launches``."""
    program = spec.program
    unit = program if unit is None else unit
    n_fields = unit.n_fields
    n_outs = n_fields if unit is program else len(unit.outputs)
    datas = list(datas)
    if len(datas) != n_fields:
        raise ValueError(f"Expected {n_fields} planes, got {len(datas)}")
    for data in datas:
        if tuple(data.shape) != spec.shape or data.dtype != spec.dtype:
            raise ValueError(
                f"Expected {spec.shape} {spec.dtype} planes, got {tuple(data.shape)} {data.dtype}"
            )
    device = datas[0].device
    if any(data.device != device for data in datas):
        raise ValueError("All planes must lie on one device")
    check_sides(program, sides, spec, device)
    if device.type == "cpu":
        result = (multi_stencil_2d_plain(datas, spec, sides) if unit is program
                  else unit.plain(datas, sides))
        if outs is None:
            return result
        return [out.copy_(r) for out, r in zip(outs, result, strict=True)]
    if device.type != "cuda":
        raise RuntimeError(f"No multi-stencil kernel for device {device}")
    if not all(data.is_contiguous() for data in datas):
        raise ValueError("The kernel needs contiguous planes")
    if outs is None:
        outs = [torch.empty_like(datas[0]) for _ in range(n_outs)]
    else:
        outs = list(outs)
        ins = {data.data_ptr() for data in datas}
        if len(outs) != n_outs or any(
            out.shape != datas[0].shape or out.dtype != spec.dtype or out.device != device
            or not out.is_contiguous() or out.data_ptr() in ins
            for out in outs
        ):
            raise ValueError("`outs` must be distinct contiguous planes like `datas`")
    lib = _library(program)
    suffix = "f32" if spec.dtype == torch.float32 else "f64"
    entry = program.library if unit is program else f"{program.library}_p{unit.index}"
    launch = getattr(lib, f"{entry}_{suffix}")
    tables = []  # a cylindrical program's row table (at grid row 0's), after the planes
    if program.geometry.radial is not None:
        tables.append(row_table(program, spec.dtype, device)[row_pad(program)].data_ptr())
    in_ptrs = (ctypes.c_void_p * (n_fields + len(tables)))(
        *[data.data_ptr() for data in datas], *tables)
    out_ptrs = (ctypes.c_void_p * n_outs)(*[out.data_ptr() for out in outs])
    side_arrays = side_args(program, sides)
    args = (ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs), *program.launch_args(spec),
            *map(ctypes.addressof, side_arrays), torch.cuda.current_stream(device).cuda_stream)
    if device.index == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(device):
            err = launch(*args)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err}")
    wrapper.launches += 1
    if unit is not program:
        wrapper.pass_launches[unit.index] = wrapper.pass_launches.get(unit.index, 0) + 1
    if sides is not None:
        wrapper.sides_launches += 1
    return outs


# -- the ladder window ------------------------------------------------------------------------
def ladder_window(specs, run: Callable, sides: SideInputs | None = None,
                  dt: float | None = None) -> Callable:
    """``window(datas, steps) -> list`` splitting `steps` over the passes of
    `specs` (largest k first), so a remainder costs O(log k) passes; each
    pass is ``run(datas, spec, outs=...)``. Passes alternate between two
    buffer sets; the inputs are never written. With side inputs `sides`
    each pass also gets ``sides=`` its views; where they depend on time the
    window is ``window(datas, t0, steps)`` (``needs_t``), inner step i at
    ``t0 + i*dt``, its tables evaluated on the planes' device
    :data:`SIDE_BLOCK` steps at a time. The window carries ``multi_field =
    True``, ``n_aux = 0``, ``needs_t`` and its ``specs``."""
    needs_t = sides is not None and sides.needs_t
    if needs_t and dt is None:
        raise ValueError("A window whose side inputs depend on time needs its dt")

    def window(datas, *args):
        t0, steps = args if needs_t else (0.0, *args)
        datas = list(datas)
        buffers = None
        passes = index = 0
        remaining = int(steps)
        views = None if sides is None else sides.passes(t0, remaining, dt, datas[0].dtype,
                                                        datas[0].device)
        for spec in specs:
            chunks, remaining = divmod(remaining, spec.k)
            for _ in range(chunks):
                if buffers is None:
                    buffers = tuple([torch.empty_like(d) for d in datas] for _ in range(2))
                kwargs = {} if views is None else {"sides": views(index, spec.k)}
                datas = run(datas, spec, outs=buffers[passes % 2], **kwargs)
                passes += 1
                index += spec.k
        return datas

    window.multi_field = True
    window.n_aux = 0
    window.needs_t = needs_t
    window.specs = specs
    return window


def make_chunked_multi_window_2d(
    grid, make_step: Callable, halo_per_step: int, n_fields: int, *, dtype=torch.float32,
    carry: bool = False, sides: SideInputs | None = None, dt: float | None = None,
) -> Callable:
    """Return ``window(datas, steps) -> list`` advancing `steps` steps of
    ``make_step`` through :func:`multi_stencil_2d` passes over the program's
    ladder (see :func:`ladder_window`); the window also carries its
    ``program`` (`carry`: see :class:`StencilProgram`). With the side inputs
    `sides` the ghosts' per-point and time-dependent parts become the
    kernel's arguments; where they depend on time the window is
    ``window(datas, t0, steps)`` of step `dt` (``window.needs_t``)."""
    program = StencilProgram(grid, make_step, halo_per_step, n_fields, carry=carry, sides=sides)
    window = ladder_window(
        [multi_stencil_spec(program, kk, dtype) for kk in program.ladder], multi_stencil_2d,
        program.sides, dt,
    )
    window.program = program
    return window
