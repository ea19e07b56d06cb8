"""Halo-extended kernels of decomposed 2D runs: CUDA kernels, plain versions,
tile emulation and march replay.

Port of the two 2D ext kernels of :mod:`pde_tpu.ops.pallas_cartesian`:
``make_affine_laplace_ext_2d`` (TPU kernel #12; the decomposed counterpart of
kernel #1) and ``make_fused_multi_ext_window_2d`` (#8; of kernel #7). Each
advances a local block of shape ``(n, m)`` by k steps from an extended buffer
of shape ``(n + 2h, m + 2h)`` whose halo ring was filled from the neighbouring
blocks (:mod:`pde_tpu_torch.parallel.fused`), and writes the block into the
interior of a second buffer of that shape.

Edge flags ``[row_lo, row_hi, col_lo, col_hi]`` (host ints per block) mark the
sides of a block that lie on a non-periodic global edge: there the cells
beyond the edge are held at zero and the ghost values of the boundary
conditions are rewritten at every step, as the serial kernels do at the
global edge. Elsewhere the halo is trusted.

On the blocks of a decomposed ``CylindricalSymGrid`` the affine ext kernel
takes kernel #1's radial mode (``pde_tpu``'s ``radial=``): a block's flags
then carry a fifth int, its first row in the grid (``pde_tpu``'s row offset,
``flags[4]``), and each row's factors are those of its global row, from the
serial radial kernel's table of the global grid (``radial_rows``). With side
inputs (below) the radial mode takes six ints, the first row serving both
the radial table and the side tables.

Both kernels also take the side inputs of their serial counterparts (A9.3;
``pde_tpu``'s ``bc_specs`` of #12 and ``bc_inputs`` of #8): per-point and
time-dependent BC values, and in #8 values varying in space and time and
per-point or time-dependent ghost factors. Every block reads the tables of
the GLOBAL grid that the serial window builds, at its own origin, where
``pde_tpu`` slices a copy of them per shard (``pde_tpu/parallel/fused.py:
197-215, 476-516``); a block's flags then carry six ints, its four edge flags
and its first row and column in the grid.

The halo width. ``pde_tpu`` fixes it at 8 rows on the TPU (one sublane tile)
and uses ``h = k * halo_per_step`` in interpret mode (:func:`ext_halo_width`
there); the port takes the interpret-mode rule: a k-step pass of a depth-d rhs
needs ``h >= k*d``. A block needs at least h cells on every axis, since the
halo comes from the next block alone. The port always extends both axes:
``pde_tpu`` keeps an uncut periodic column axis locally periodic by lane
rolls (``ext_cols=False``), a TPU layout matter; here such an axis wraps
locally in the exchange (the block's own opposite columns), which gives the
same values.

Three implementations of each function, as for the serial kernels: the CUDA
kernel (the ext kernel of the serial kernel's row march: for the affine
Laplacian, of ``csrc/affine_march_2d.cuh`` with entry points generated per
periodicity by :mod:`.cuda_cartesian`; for the multi-field window, of
``csrc/march_2d.cuh`` with a program generated per rhs, whose stage
functions are the serial kernel's), the plain version (k plain PyTorch steps
on the block's whole window, the oracle and what the wrappers run for CPU
tensors) and a CPU replay of the kernel's schedule (window offsets, load
clipping and flag logic; the affine kernel also has an emulation of the
values its blocks compute).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
from dataclasses import dataclass, fields
from pathlib import Path

import torch

from .cuda_cartesian import (
    BF16,
    CORNER_EXT_LIBRARY,
    EXT_MAX_STEPS,
    RADIAL_EXT_LIBRARY,
    RADIAL_SIDES_EXT_LIBRARY,
    REGISTER_SIDE_PAD,
    SIDE_PAD,
    SIDES_EXT_LIBRARY,
    AffineLaplaceSpec,
    AffineSides,
    KernelUnsupportedError,
    affine_laplace_spec,
    bf16_refusal,
    block_plan,
    compute_dtype,
    deep_library,
    dtype_suffix,
    kernel_source,
    march_block,
    radial_rows,
    round_level,
    side_pointers,
    step_doubles,
    window_steps_2d,
)
from .cuda_march import MarchWindow
from .cuda_stencil_2d import (
    _DTYPES,
    StencilProgram,
    TileHelpers,
    _library,
    along,
    check_sides,
    chunk_rows,
    emit_march_program,
    march_program_rows,
    row_blocks,
    side_args,
)

#: blocks one launch covers (``kMaxBlocks``/``kMaxExtBlocks`` in the sources)
MAX_BLOCKS = 8
#: the template of the bf16 ext kernel #8 (edge-free interior blocks)
BF16_EXT_TEMPLATE = Path(__file__).resolve().parents[1] / "csrc" / "march_bf16_ext_2d.cuh"
#: the rows a block of the bf16 kernel marches where a block of the launch has
#: a flagged side (where the default plan gives more, as on 2048² blocks): its
#: edge blocks march longer than its interior ones, and shorter chunks spread
#: them over more blocks an SM (timed on 2048² blocks alone,
#: ``scripts/torch_bf16_ext_sweep.py --diagnose``, PERF.md)
BF16_EDGE_CHUNK = 32


def ext_halo_width(cells: int) -> int:
    """Halo width of the extended buffers for a pass consuming `cells` cells
    per side (k steps of a depth-d rhs: ``k*d``)."""
    return int(cells)


def check_block(local_shape, halo: int) -> None:
    """Raise :class:`KernelUnsupportedError` unless every axis of a block
    holds at least `halo` cells (its halo comes from one neighbour)."""
    if min(local_shape) < halo:
        raise KernelUnsupportedError(
            f"Shard too small for the halo exchange: blocks of {tuple(local_shape)} cells "
            f"cannot supply a halo of {halo}"
        )


def _domain(index: torch.Tensor, n: int, lo_edge: bool, hi_edge: bool) -> torch.Tensor:
    """Whether local indices lie in the domain: only a flagged side has an outside."""
    inside = torch.ones_like(index, dtype=torch.bool)
    if lo_edge:
        inside &= index >= 0
    if hi_edge:
        inside &= index < n
    return inside


def _block_flags(flags, periodic) -> tuple[bool, ...]:
    """One block's edge flags (two per axis) as booleans; a periodic axis has
    no global edge, and the generated kernels drop its test at compile time,
    so a flag there is refused."""
    flags = tuple(bool(f) for f in flags)
    if len(flags) != 2 * len(periodic):
        raise ValueError(f"Expected {2 * len(periodic)} edge flags per block")
    for axis, per in enumerate(periodic):
        if per and (flags[2 * axis] or flags[2 * axis + 1]):
            raise ValueError(f"Edge flags set on the periodic axis {axis}")
    return flags


def _check_flags(flags, n_blocks: int, periodic) -> list[tuple[int, ...]]:
    flags = [tuple(map(int, _block_flags(f, periodic))) for f in flags]
    if len(flags) != n_blocks:
        raise ValueError("Expected the edge flags of every block")
    return flags


# -- row 12: the affine Laplacian ---------------------------------------------------------------
@dataclass(frozen=True)
class AffineExtSpec(AffineLaplaceSpec):
    """One ext pass of the affine Laplacian: ``shape`` is the block's,
    ``halo`` the extended buffers' halo width (``k <= halo``) and
    ``grid_rows``, ``grid_cols`` the global grid's shape (whose radial table
    the radial mode reads, whose side tables the side inputs' mode reads)."""

    halo: int = 0
    grid_rows: int = 0
    grid_cols: int = 0

    def table_rows(self) -> int:
        return self.grid_rows

    def table_cols(self) -> int:
        return self.grid_cols


def affine_laplace_ext_spec(
    grid, local_shape, *, a: float, b: float, k: int, halo: int, dtype, bcs=None
) -> AffineExtSpec:
    """Check that the ext kernel takes a configuration and describe it: the
    gates of kernel #1 on the global `grid` (:func:`affine_laplace_spec`; on
    a ``CylindricalSymGrid`` the radial mode; per-point and time-dependent
    consts take the side inputs' mode, on a cylinder the radial one's), with
    ``1 <= k <=`` :data:`.cuda_cartesian.EXT_MAX_STEPS` in every 5-point
    mode (at least ``pde_tpu``'s hardware cap of 8; the passes past the
    register march's top in the mode take the deep march), plus ``k <= halo
    <= min(local_shape)``; a pass with side inputs takes a halo of at most
    ``REGISTER_SIDE_PAD``, as the register march's ext kernels do. bf16 data
    goes where the blocks cut the columns, as ``pde_tpu``'s ext kernel takes
    it (``ext_cols``)."""
    if k > EXT_MAX_STEPS:
        raise KernelUnsupportedError(
            f"The ext kernel takes 1 <= k <= {EXT_MAX_STEPS} steps, not {k} (pde_tpu's hardware "
            "path takes k <= 8: supports_affine_laplace_ext, pde_tpu/ops/pallas_cartesian.py:"
            "5746-5770)")
    ext_cols = len(local_shape) == grid.num_axes == 2 and int(local_shape[1]) < grid.shape[1]
    base = affine_laplace_spec(grid, a=a, b=b, k=k, dtype=dtype, bcs=bcs, ext_cols=ext_cols)
    if not 1 <= k <= halo:
        raise KernelUnsupportedError(f"A k = {k} pass needs a halo of at least k, not {halo}")
    if base.has_sides and halo > REGISTER_SIDE_PAD:
        raise KernelUnsupportedError(
            f"A pass with side inputs takes a halo of at most {REGISTER_SIDE_PAD}, not {halo}")
    check_block(local_shape, halo)
    values = {f.name: getattr(base, f.name) for f in fields(AffineLaplaceSpec)}
    values["shape"] = tuple(int(n) for n in local_shape)
    return AffineExtSpec(**values, halo=int(halo), grid_rows=int(grid.shape[0]),
                         grid_cols=int(grid.shape[1]))


def _affine_flags(flags, spec: AffineExtSpec) -> tuple[tuple[bool, ...], int, int]:
    """One block's edge flags as booleans and its first row and column in
    the grid: the radial mode takes five ints (the fifth its first row,
    ``pde_tpu``'s ``flags[4]``), the side inputs' mode six (then its first
    column; in the radial mode too, the first row serving the radial table
    and the side tables), the Cartesian kernel four (origin 0)."""
    flags = tuple(int(f) for f in flags)
    if spec.radial is None and not spec.has_sides:
        return _block_flags(flags, spec.periodic), 0, 0
    count, what = (5, "the radial mode takes 5 ints per block: 4 edge flags and its first "
                      "row") if not spec.has_sides else (
        6, "passes with side inputs take 6 ints per block: 4 edge flags, its first row and "
           "its first column")
    if len(flags) != count:
        raise ValueError(f"The {what} in the grid")
    row0, col0 = flags[4], flags[5] if count == 6 else 0
    if not 0 <= row0 <= spec.grid_rows - spec.shape[0]:
        raise ValueError(f"A block's first row {row0} does not lie in the grid")
    if not 0 <= col0 <= spec.grid_cols - spec.shape[1]:
        raise ValueError(f"A block's first column {col0} does not lie in the grid")
    return _block_flags(flags[:4], spec.periodic), row0, col0


def affine_laplace_ext_2d_plain(ext: torch.Tensor, spec: AffineExtSpec, flags,
                                sides: AffineSides | None = None) -> torch.Tensor:
    """k plain PyTorch steps on one block's extended buffer: the ``(n + 2k,
    m + 2k)`` window around the block, flag-gated ghost rewrites, cells beyond
    a flagged edge at zero (in the radial mode, each row's factors at its
    global row; with side inputs `sides`, the ghosts' per-point consts at the
    cells' places in the grid); returns the ``(n, m)`` block."""
    n_rows, n_cols = spec.shape
    h, k = spec.halo, spec.k
    window = ext[h - k : h + k + n_rows, h - k : h + k + n_cols]
    edges, row0, col0 = _affine_flags(flags, spec)
    return window_steps_2d(window, spec, edges, -k, -k, row0, sides, col0)


def affine_laplace_ext_2d_tiled(
    ext: torch.Tensor, spec: AffineExtSpec, flags, tile=None, sides: AffineSides | None = None
) -> torch.Tensor:
    """Pure-torch emulation of the values the ext kernel's blocks compute on
    one block (`tile`: strip and chunk, see :func:`.cuda_cartesian.block_plan`):
    each block of the grid of strips and chunks loads its window with k-deep
    halos from the buffer at offset ``h - k`` (cells past the buffer or beyond
    a flagged edge as zero), runs the k steps and keeps its centre."""
    n_rows, n_cols = spec.shape
    h, k = spec.halo, spec.k
    tx, chunk = block_plan(spec, tile)
    edges, row0, col0 = _affine_flags(flags, spec)
    out = torch.empty(spec.shape, dtype=ext.dtype, device=ext.device)
    zero = torch.zeros((), dtype=ext.dtype)
    for r0 in range(0, n_rows, chunk):
        for c0 in range(0, n_cols, tx):
            gr = torch.arange(r0 - k, r0 + chunk + k, device=ext.device)
            gc = torch.arange(c0 - k, c0 + tx + k, device=ext.device)
            in_buffer = (gr < n_rows + h)[:, None] & (gc < n_cols + h)[None, :]
            window = ext[(gr + h).clamp(max=n_rows + 2 * h - 1)][
                :, (gc + h).clamp(max=n_cols + 2 * h - 1)]
            window = torch.where(in_buffer, window, zero)
            centre = window_steps_2d(window, spec, edges, r0 - k, c0 - k, row0, sides, col0)
            n_r, n_c = min(chunk, n_rows - r0), min(tx, n_cols - c0)
            out[r0 : r0 + n_r, c0 : c0 + n_c] = centre[:n_r, :n_c]
    return out


def affine_laplace_ext_2d_marched(ext: torch.Tensor, spec: AffineExtSpec, flags,
                                  plan=None, sides: AffineSides | None = None) -> torch.Tensor:
    """Pure-torch replay of the ext kernel's row march on one block (`plan`,
    ``(tx, chunk)``, defaults to the kernel's strip and the chunk its launch
    picks for one block): the serial kernel's
    :func:`.cuda_cartesian.march_block` on the ext kernel's windows, with
    side inputs `sides` read where the kernel reads them (a row side's entry
    of a window column at its offset in a buffer row plus the block's shift,
    ``col0 - halo + SIDE_PAD``; a column side's at the row's grid row).
    Returns the ``(n, m)`` block; cells no block writes stay NaN."""
    tx, chunk = block_plan(spec, plan)
    block_flags, row0, col0 = _affine_flags(flags, spec)
    h = spec.halo

    def window(origin, halo):
        win = _ext_row_window([ext], spec.shape, h, block_flags, origin, tx, halo, row0)
        if sides is None:
            return win
        offset = torch.where(win.load, torch.arange(origin[1] - halo, origin[1] + tx + halo) + h,
                             0)
        return dataclasses.replace(win, cols=offset + col0 - h + SIDE_PAD)

    (out,) = row_blocks(
        spec.shape, spec.k, (tx, chunk), window,
        lambda win, rows, store: march_block(win, spec, rows, store, sides), 1, ext.dtype)
    return out


def affine_ext_source(periodic, radial: bool = False, corner: bool = False,
                      sides: bool = False, bf16: bool = False, deep: bool = False) -> object:
    """The affine ext kernel's build unit for axes of this periodicity, the
    radial mode's with `radial`, the 9-point corner-weight mode's with
    `corner`, the side inputs' with `sides` (the radial side-input mode's
    with both `radial` and `sides`), its bf16 storage entry points with
    `bf16`, the deep march's of that mode with `deep` (``build_programs(
    [affine_ext_source(spec.periodic, spec.radial is not None,
    bool(spec.corner), spec.has_sides, spec.dtype == torch.bfloat16,
    spec.deep)])`` builds it)."""
    library = (RADIAL_SIDES_EXT_LIBRARY if radial and sides else RADIAL_EXT_LIBRARY if radial
               else CORNER_EXT_LIBRARY if corner else SIDES_EXT_LIBRARY if sides
               else "affine_laplace_ext_2d")
    return kernel_source(tuple(periodic), deep_library(library) if deep else library, bf16)


def _check_buffers(ins, outs, shape, dtype) -> tuple[torch.device, int]:
    """The one device of the buffers and their common row stride; raises
    unless they are distinct `shape` tensors of `dtype` there whose rows are
    contiguous (rows may be padded, for aligned row starts)."""
    device = ins[0].device
    ld = ins[0].stride(0)
    seen = set()
    for buf in list(ins) + list(outs):
        if tuple(buf.shape) != shape or buf.dtype != dtype or buf.device != device:
            raise ValueError(
                f"Expected {shape} {dtype} buffers on {device}, got "
                f"{tuple(buf.shape)} {buf.dtype} on {buf.device}"
            )
        if device.type == "cuda" and (buf.stride() != (ld, 1) or buf.data_ptr() in seen):
            raise ValueError("The kernel needs distinct buffers with one row stride")
        seen.add(buf.data_ptr())
    return device, ld


def _launch(device, launch, args) -> int:
    if device.index == torch.cuda.current_device():
        return launch(*args)
    with torch.cuda.device(device):
        return launch(*args)


def affine_laplace_ext_2d(ins, outs, flags, spec: AffineExtSpec,
                          sides: AffineSides | None = None) -> list:
    """One k-step pass over blocks of one device: ``ins[b]`` and ``outs[b]``
    are block b's extended buffers, ``flags[b]`` its edge flags (in the
    radial mode, and its first row in the grid; with side inputs, and its
    first row and column); the block is written into the interior of
    ``outs[b]`` (its halo is left as it was). `sides`: the pass's side inputs
    (:class:`.cuda_cartesian.AffineSides` with ``row_pad=SIDE_PAD``, the
    global grid's tables), required where the spec has them.

    CPU buffers get the plain version. CUDA buffers go through the CUDA
    kernel (the radial mode's on a cylindrical grid, the 9-point mode's
    under a corner weight, the side inputs' where the spec has them, the
    radial side-input mode's where both hold), up to
    ``MAX_BLOCKS`` blocks per launch; any failure raises.
    ``affine_laplace_ext_2d.launches`` counts kernel launches of every mode,
    ``.corner_launches`` those of the 9-point mode, ``.sides_launches``
    those with side inputs, ``.radial_sides_launches`` those of the register
    march's radial mode with side inputs, ``.bf16_launches`` those on bf16
    buffers, ``.deep_launches`` those of the deep march (``spec.deep``).
    """
    n_rows, n_cols = spec.shape
    h = spec.halo
    shape = (n_rows + 2 * h, n_cols + 2 * h)
    ins, outs = list(ins), list(outs)
    if len(flags) != len(ins):
        raise ValueError("Expected the edge flags of every block")
    flags = [(*map(int, edges), *([row0, col0] if spec.has_sides else
                                  [row0] if spec.radial else []))
             for edges, row0, col0 in (_affine_flags(f, spec) for f in flags)]
    if len(outs) != len(ins):
        raise ValueError("Expected one output buffer per input buffer")
    device, ld = _check_buffers(ins, outs, shape, spec.dtype)
    _check_affine_sides(spec, sides, device)
    interior = (slice(h, h + n_rows), slice(h, h + n_cols))
    if device.type == "cpu":
        for ext, out, block_flags in zip(ins, outs, flags):
            out[interior] = affine_laplace_ext_2d_plain(ext, spec, block_flags, sides)
        return outs
    if device.type != "cuda":
        raise RuntimeError(f"No affine ext kernel for device {device}")
    unit = affine_ext_source(spec.periodic, spec.radial is not None, bool(spec.corner),
                             spec.has_sides, spec.dtype == torch.bfloat16, spec.deep)
    launch = getattr(_library(unit), f"{unit.library}_{dtype_suffix(spec.dtype)}")
    tx, threads, prefetch, _ = spec.tile
    strips = -(-n_cols // tx)
    doubles = step_doubles(spec, sides)
    # after n_blocks: the radial mode's row table of the global grid, then the
    # side inputs' tables
    extra = [] if spec.radial is None else [radial_rows(spec, device).data_ptr()]
    if spec.has_sides:
        arrays = side_pointers(spec, sides)
        extra.append(ctypes.addressof(arrays))
    stream = torch.cuda.current_stream(device).cuda_stream
    per_block = len(flags[0])
    for start in range(0, len(ins), MAX_BLOCKS):
        group = range(start, min(start + MAX_BLOCKS, len(ins)))
        in_ptrs = (ctypes.c_void_p * len(group))(*[ins[b].data_ptr() for b in group])
        out_ptrs = (ctypes.c_void_p * len(group))(*[outs[b].data_ptr() for b in group])
        edges = (ctypes.c_int * (per_block * len(group)))(*[f for b in group for f in flags[b]])
        ints = (ctypes.c_int * 11)(n_rows, n_cols, h, ld, chunk_rows(n_rows, strips, len(group)),
                                   spec.k, tx, threads, prefetch, *map(int, spec.periodic))
        err = _launch(device, launch, (
            ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs), ctypes.addressof(edges),
            len(group), *extra, ctypes.addressof(ints), ctypes.addressof(doubles), stream,
        ))
        if err != 0:
            raise RuntimeError(f"affine_laplace_ext_2d kernel launch failed with CUDA error {err}")
        affine_laplace_ext_2d.launches += 1
        if spec.corner:
            affine_laplace_ext_2d.corner_launches += 1
        if spec.has_sides:
            affine_laplace_ext_2d.sides_launches += 1
        if unit.library == RADIAL_SIDES_EXT_LIBRARY:
            affine_laplace_ext_2d.radial_sides_launches += 1
        if spec.dtype == torch.bfloat16:
            affine_laplace_ext_2d.bf16_launches += 1
        if spec.deep:
            affine_laplace_ext_2d.deep_launches += 1
    return outs


affine_laplace_ext_2d.launches = 0
affine_laplace_ext_2d.corner_launches = 0
affine_laplace_ext_2d.sides_launches = 0
affine_laplace_ext_2d.radial_sides_launches = 0
affine_laplace_ext_2d.bf16_launches = 0
affine_laplace_ext_2d.deep_launches = 0


def _check_affine_sides(spec: AffineExtSpec, sides: AffineSides | None, device) -> None:
    """Raise unless `sides` are the ext pass's side inputs (None where it has
    none): the global grid's tables on `device`, row sides padded by
    ``SIDE_PAD``, and a t-table of k steps where a const depends on time."""
    if not spec.has_sides:
        if sides is not None:
            raise ValueError("The pass takes no side inputs")
        return
    if sides is None:
        raise ValueError("The pass has side inputs: give them (AffineSides)")
    if sides.row_pad != SIDE_PAD:
        raise ValueError(f"The ext kernel reads row sides padded by {SIDE_PAD} columns")
    if any(spec.side_t) and (sides.t is None or len(sides.t) != spec.k):
        raise ValueError(f"The pass needs a t-table of {spec.k} steps")
    lengths = (spec.grid_cols + 2 * SIDE_PAD,) * 2 + (spec.grid_rows + 2 * SIDE_PAD,) * 2
    for i, arr in enumerate(sides.arrays):
        if (arr is not None) != spec.side_arrays[i] or (arr is not None and (
                arr.dtype != spec.compute_dtype or arr.device != device
                or arr.numel() != lengths[i])):
            raise ValueError("The side inputs do not match the pass")


# -- row 8: the multi-field window --------------------------------------------------------------
class ExtTileHelpers(TileHelpers):
    """:class:`TileHelpers` on one tile of a block: indices are the block's
    local ones, and a side is a global edge only where its flag is set; the
    side inputs are read at the cells' places in the global grid (the
    block's first cell there is `block_origin`)."""

    def __init__(self, grid, tile, origin, local_shape, flags, device=None,
                 block_origin=(0, 0)):
        super().__init__(grid, tile, *origin)
        self.grid_shape = self.shape
        self.shape = tuple(local_shape)
        self.flags = tuple(bool(f) for f in flags)
        self.device = device
        self.block_origin = tuple(block_origin)

    def _side_cells(self, g, axis: int):
        return g + self.block_origin[axis], self.grid_shape[axis]

    def _edges(self, axis: int) -> tuple[bool, bool]:
        return self.flags[2 * axis], self.flags[2 * axis + 1]

    def _coords(self, size: int, axis: int):
        g, inside = super()._coords(size, axis)
        return g.to(self.device), inside.to(self.device)


class ExtStencilProgram(StencilProgram):
    """A traced step emitted for the ext kernel of decomposed 2D grids: the
    serial emitter writes the program struct (the same stage functions: the
    ghosts follow the march's flags, which the ext kernel's geometry sets
    from the block's edge flags), and the entry points take a table of
    blocks. A program whose ghosts read side inputs (`sides`, the global
    grid's :class:`.cuda_stencil_2d.SideInputs`) launches the side-input ext
    kernel, whose blocks read the tables at their origins. With `bf16` its
    library holds the bf16 storage entry points alone
    (``multi_stencil_ext_2d_bf16``: the float32 march at its plan, loading
    and storing ``__nv_bfloat16`` and rounding each field's every level to
    it), so that the float32 and float64 libraries build as before; they
    launch the kernel of ``csrc/march_bf16_ext_2d.cuh``, whose blocks march
    edge-free where their windows meet no flagged side."""

    library = "multi_stencil_ext_2d"

    def __init__(self, *args, bf16: bool = False, **kwargs):
        self.bf16 = bool(bf16)
        if self.bf16:
            self.headers = (BF16_EXT_TEMPLATE,)
        super().__init__(*args, **kwargs)

    @property
    def suffixes(self) -> tuple[str, ...]:
        """The entry points' dtype suffixes."""
        return (BF16[1],) if self.bf16 else tuple(v[1] for v in _DTYPES.values())

    def emit(self) -> str:
        if self.bf16:
            template = "march_bf16_ext_2d.cuh"
            head = ["// Generated by pde_tpu_torch/ops/cuda_ext_2d.py from a traced step; the",
                    f"// kernel is the bf16 ext kernel of pde_tpu_torch/csrc/{template}.",
                    "#include <cuda_bf16.h>", ""]
        else:
            template = "march_2d.cuh"
            head = ["// Generated by pde_tpu_torch/ops/cuda_ext_2d.py from a traced step; the",
                    "// kernel is the ext kernel of pde_tpu_torch/csrc/march_2d.cuh."]
        lines = [
            *head,
            f'#include "{template}"',
            "",
            *emit_march_program(self, round_bf16=self.bf16),
        ]
        sides = self.sides is not None
        launcher, extra = ("launch_ext_sides_2d", "sides, steps, ") if sides else (
            "launch_ext_2d", "")
        if self.bf16:
            launcher = launcher.replace("launch_", "launch_bf16_")
        # (the plan's dtype, C type, entry-point suffix, storage type's template argument)
        kinds = [(torch.float32, "float", BF16[1], f", {BF16[0]}")] if self.bf16 else [
            (dtype, ctype, suffix, "") for dtype, (ctype, suffix, _) in _DTYPES.items()]
        for dtype, ctype, suffix, storage in kinds:
            lines += [
                f"extern \"C\" int multi_stencil_ext_2d_{suffix}(const void* const* ins, "
                "void* const* outs, const int* edges,",
                "    int n_blocks, int n_rows, int n_cols, int halo, int ld, int k, int chunk,",
                *(["    const void* const* sides, const long long* steps,"] if sides else []),
                "    void* stream) {",
                "  switch (k) {",
            ]
            for k in self.ladder:
                tx, threads = self.tiles[dtype][k]
                lines.append(
                    f"    case {k}: return pde_tpu_torch::{launcher}<Program, {ctype}, {k}, "
                    f"{tx}, {threads}{storage}>(ins, outs, edges, n_blocks, n_rows, n_cols, "
                    f"halo, ld, chunk, {extra}stream);"
                )
            lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
        return "\n".join(lines)

    def load(self, path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        for suffix in self.suffixes:
            fn = getattr(lib, f"{self.library}_{suffix}")
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,  # host arrays of input and output pointers
                ctypes.c_void_p,  # edges: 4 host ints per block (6 with side inputs)
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_blocks, n_rows, n_cols
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # halo, ld, k
                ctypes.c_int,  # the rows each block marches
                # the side inputs' tables and their step strides
                *([ctypes.c_void_p] * (2 if self.sides is not None else 0)),
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
        return lib


@dataclass(frozen=True, eq=False)
class MultiExtSpec:
    """One ext pass: a program at k steps on blocks of one shape and dtype,
    in buffers with halo ``halo >= k * program.depth``."""

    program: ExtStencilProgram  # or a 3D one (:mod:`.cuda_ext_3d`)
    shape: tuple[int, ...]
    k: int
    dtype: torch.dtype
    tile: int | tuple[int, int, int]  # the kernel's output tile at this k and dtype
    halo: int


def multi_stencil_ext_spec(
    program: ExtStencilProgram, k: int, dtype, local_shape, halo: int
) -> MultiExtSpec:
    """Describe one ext pass; raises :class:`KernelUnsupportedError` exactly
    where the kernel does not take it (nothing is built here). bf16 planes
    go where ``pde_tpu``'s #8 takes them: on 2D blocks that cut the columns
    (``ext_cols``), through a program built with ``bf16=True``, at its
    float32 plan."""
    plan_dtype = dtype
    if dtype == torch.bfloat16:
        check_bf16_ext(program.geometry.shape, local_shape)
        if not getattr(program, "bf16", False):
            raise KernelUnsupportedError(
                "bf16 planes need the program's bf16 entry points (ExtStencilProgram(..., "
                "bf16=True))")
        plan_dtype = torch.float32
    elif dtype not in _DTYPES:
        raise KernelUnsupportedError(f"The kernel takes float32 or float64 planes, not {dtype}")
    if k not in program.ladder:
        raise KernelUnsupportedError(f"k = {k} is not on the program's ladder {program.ladder}")
    if halo < k * program.depth:
        raise KernelUnsupportedError(
            f"A k = {k} pass of depth {program.depth} needs a halo of {k * program.depth}"
        )
    check_block(local_shape, halo)
    if program.tiles[plan_dtype][k] is None:  # a 3D program with an fp32 plan only
        raise KernelUnsupportedError(program.unplanned(k, dtype))
    return MultiExtSpec(
        program, tuple(int(n) for n in local_shape), k, dtype, program.tiles[plan_dtype][k],
        int(halo)
    )


def check_bf16_ext(grid_shape, local_shape) -> None:
    """Raise :class:`KernelUnsupportedError` unless the generated ext kernel
    #8 takes bf16 planes on blocks of `local_shape` cut from a grid of
    `grid_shape`, as ``pde_tpu``'s gate: 2D blocks that cut the columns."""
    if len(grid_shape) != 2:
        raise bf16_refusal("the 3D kernels", "ops/pallas_cartesian.py:1495, 3044, 3487, 5510")
    if int(local_shape[1]) >= int(grid_shape[1]):
        raise bf16_refusal("kernel #8 where the mesh does not cut the columns",
                           "ops/pallas_cartesian.py:4121-4127, parallel/fused.py:443")


def _multi_ext_pass(ext_datas, spec: MultiExtSpec, flags, tiles, sides=None,
                    origin=None) -> list:
    """One ext pass on one block's buffers (2D or 3D), tile by tile (tiles of
    `tiles` cells per axis): each tile loads its window at offset ``halo - k*depth``
    (zeros past the buffer and beyond flagged edges), runs k steps through
    :class:`ExtTileHelpers`, holds cells beyond flagged edges at zero after
    each step, and keeps its centre. `sides`: the pass's views of the
    program's side inputs, read at the cells' places in the grid (the
    block's first cell there is `origin`)."""
    program = spec.program
    depth, k, h = program.depth, spec.k, spec.halo
    h0 = k * depth
    flags = _block_flags(flags, program.geometry.periodic)
    block_origin = (0,) * len(spec.shape) if origin is None else tuple(origin)
    device = ext_datas[0].device
    storage = ext_datas[0].dtype
    work = compute_dtype(storage)  # bf16 planes step in float32, each level rounded to bf16
    zero = torch.zeros((), dtype=work)
    outs = [torch.empty(spec.shape, dtype=d.dtype, device=device) for d in ext_datas]

    rank = len(spec.shape)

    def window_index(start: int, axis: int):
        n, w = spec.shape[axis], tiles[axis] + 2 * h0
        g = torch.arange(start - h0, start - h0 + w, device=device)
        domain = _domain(g, n, flags[2 * axis], flags[2 * axis + 1])
        return (g + h).clamp(max=n + 2 * h - 1), domain & (g < n + h), domain

    def outer(masks):
        return functools.reduce(
            torch.logical_and, (along(m, axis, rank) for axis, m in enumerate(masks)))

    for origin in itertools.product(*(range(0, n, t) for n, t in zip(spec.shape, tiles))):
        index, loaded, domain = zip(*(window_index(o, axis) for axis, o in enumerate(origin)))
        load, inside = outer(loaded), outer(domain)
        gather = tuple(along(i, axis, rank) for axis, i in enumerate(index))
        works = [torch.where(load, d[gather].to(work), zero) for d in ext_datas]
        helpers = ExtTileHelpers(program.grid, tiles, origin, spec.shape, flags, device,
                                 block_origin)
        helpers.sides, helpers.side_views = program.sides, sides
        step = program.make_step(helpers)
        for s in range(1, k + 1):
            helpers.step = s - 1
            helpers.bind_stage(0)
            cut = tuple(slice(s * depth, t + 2 * h0 - s * depth) for t in tiles)
            works = [torch.where(inside[cut], round_level(x, storage), zero) for x in step(works)]
        sizes = [min(t, n - o) for t, n, o in zip(tiles, spec.shape, origin)]
        centre = tuple(slice(o, o + n) for o, n in zip(origin, sizes))
        for out, x in zip(outs, works, strict=True):
            out[centre] = x[tuple(slice(0, n) for n in sizes)]
    return outs


def _multi_flags(flags, spec: MultiExtSpec) -> tuple[tuple[bool, ...], tuple[int, ...]]:
    """One block's edge flags as booleans and its first cell in the grid: a
    program with side inputs takes its edge flags (two per axis, 2D or 3D),
    then its origin (one int per axis), one without the edge flags alone
    (origin 0)."""
    rank = len(spec.shape)
    flags = tuple(int(f) for f in flags)
    count = 3 * rank if spec.program.sides is not None else 2 * rank
    if len(flags) != count:
        raise ValueError(f"Expected {count} ints per block: {2 * rank} edge flags"
                         + (" and its first cell in the grid" if count > 2 * rank else ""))
    origin = flags[2 * rank:] if count > 2 * rank else (0,) * rank
    grid_shape = spec.program.geometry.shape
    if any(not 0 <= o <= n - m for o, n, m in zip(origin, grid_shape, spec.shape)):
        raise ValueError(f"A block's origin {origin} does not lie in the grid")
    return _block_flags(flags[:2 * rank], spec.program.geometry.periodic), origin


def multi_stencil_ext_2d_plain(ext_datas, spec: MultiExtSpec, flags, sides=None) -> list:
    """k plain PyTorch steps on one block's extended buffers, the block's
    whole window at once (flag-gated ghosts, cells beyond flagged edges at
    zero; with side inputs `sides`, the pass's views of the program's
    :class:`.cuda_stencil_2d.SideInputs`, read at the cells' places in the
    grid, `flags` then carrying the block's origin); returns the ``(n, m)``
    planes."""
    edges, origin = _multi_flags(flags, spec)
    return _multi_ext_pass(list(ext_datas), spec, edges, spec.shape, sides, origin)


def _ext_row_window(exts, shape, buffer_halo: int, flags, origin, tx: int,
                    halo: int, row0: int = 0, col0: int = 0) -> MarchWindow:
    """The ext kernel's window (``ExtRows``) of the block whose first output
    cell is `origin` (row, column), over a strip of `tx` columns with `halo`
    cells of halo, on blocks of `shape` held in buffers with `buffer_halo`:
    read from the buffers at that offset, cells past them zero, cells beyond
    a flagged side outside the domain; ``read`` gives one row of each of
    `exts`, ``row`` a window row's row in the grid and ``cols`` the window
    columns' columns there, unwrapped (the block's first row and column in
    the grid are `row0` and `col0`; ``ExtSideRows`` reads the side inputs'
    tables there)."""
    h = buffer_halo
    n_rows, n_cols = shape
    r_lo, r_hi, c_lo, c_hi = flags
    g = torch.arange(origin[1] - halo, origin[1] + tx + halo)
    inside = _domain(g, n_cols, c_lo, c_hi)
    index = (g + h).clamp(max=n_cols + 2 * h - 1)
    out = inside & (g >= origin[1]) & (g < origin[1] + tx) & (g < n_cols)

    def plane(w):
        gr = origin[0] - halo + w
        row_in = bool(_domain(torch.tensor(gr), n_rows, r_lo, r_hi))
        return row_in and gr < n_rows + h, row_in, r_lo and gr == 0, r_hi and gr == n_rows - 1

    def read(w):
        gr = min(origin[0] - halo + w + h, n_rows + 2 * h - 1)
        return [ext[gr][index] for ext in exts]

    def row(w):
        return row0 + origin[0] - halo + w

    return MarchWindow(inside & (g < n_cols + h), inside,
                       (inside & (g == 0) & c_lo, inside & (g == n_cols - 1) & c_hi), out,
                       plane, read, row, cols=g + col0)


def ext_window_interior(shape, buffer_halo: int, flags, origin, tx: int, halo: int,
                        chunk: int, periodic) -> bool:
    """Whether the ext kernel's block whose first output cell is `origin`
    (row, column), over a strip of `tx` columns and a chunk of `chunk` rows
    with `halo` cells of halo, marches edge-free in the bf16 kernel
    (``ext_window_interior`` of ``csrc/march_bf16_ext_2d.cuh``): its window
    lies wholly in the buffers (`buffer_halo` cells around blocks of `shape`)
    and meets no flagged side (no cell beyond one, nor on the row or column
    next to it), so that every window cell is loaded, in the domain and
    without an edge flag. As in the kernel, the flags of an axis that
    `periodic` (rows, columns) marks are ignored."""
    n_rows, n_cols = shape
    r_lo, c_lo = origin[0] - halo, origin[1] - halo
    r_hi = origin[0] + min(chunk, n_rows - origin[0]) + halo - 1
    c_hi = origin[1] + tx + halo - 1
    h = buffer_halo
    lo_r, hi_r, lo_c, hi_c = (bool(f) and not periodic[i // 2] for i, f in enumerate(flags[:4]))
    return (r_lo >= -h and r_hi < n_rows + h and c_lo >= -h and c_hi < n_cols + h
            and (not lo_r or r_lo >= 1) and (not hi_r or r_hi <= n_rows - 2)
            and (not lo_c or c_lo >= 1) and (not hi_c or c_hi <= n_cols - 2))


def launch_chunk(program, n_rows: int, strips: int, flags) -> int:
    """The rows each block of a launch over the blocks of `flags` marches:
    :func:`.cuda_stencil_2d.chunk_rows`, at most :data:`BF16_EDGE_CHUNK`
    for the bf16 kernel where a block has a flagged side (a plan moves no
    value)."""
    chunk = chunk_rows(n_rows, strips, len(flags))
    if getattr(program, "bf16", False) and any(any(f[:4]) for f in flags):
        return min(chunk, BF16_EDGE_CHUNK)
    return chunk


def multi_stencil_ext_2d_marched(ext_datas, spec: MultiExtSpec, flags, plan=None,
                                 sides=None) -> list:
    """Pure-torch replay of the ext kernel's row march on one block (`plan`,
    ``(tx, chunk)``, defaults to the kernel's strip and the chunk its launch
    picks for one block, :func:`launch_chunk`): the serial kernel's
    :func:`.cuda_march.march_program_block` on the ext kernel's windows, with
    the pass's side inputs `sides` read at the block's places in the grid.
    The bf16 kernel's blocks that :func:`ext_window_interior` classifies
    interior march with no edge flag, every cell loaded and in the domain.
    Returns the ``(n, m)`` planes; cells no block writes stay NaN."""
    program = spec.program
    tx, chunk = (spec.tile[0], None) if plan is None else plan
    block_flags, (row0, col0) = _multi_flags(flags, spec)
    if chunk is None:
        chunk = launch_chunk(program, spec.shape[0], -(-spec.shape[1] // tx), [block_flags])
    exts = list(ext_datas)
    interior = getattr(program, "bf16", False)

    def window(origin, halo):
        edges = block_flags
        if interior and ext_window_interior(spec.shape, spec.halo, block_flags, origin, tx, halo,
                                            chunk, program.geometry.periodic):
            edges = (False,) * 4
        return _ext_row_window(exts, spec.shape, spec.halo, edges, origin, tx, halo, row0, col0)

    return march_program_rows(program, spec.k, spec.shape, (tx, chunk), window, exts[0].dtype,
                              sides=sides)


def multi_stencil_ext_2d(ins, outs, flags, spec: MultiExtSpec, sides=None,
                         chunk: int | None = None) -> list:
    """One k-step pass of the spec's program over blocks of one device:
    ``ins[b]`` and ``outs[b]`` are the extended buffers of block b's planes,
    ``flags[b]`` its edge flags (and, in a program with side inputs, its
    first row and column in the grid); the planes are written into the
    interiors of ``outs[b]``. `sides`: the pass's views of the program's
    side inputs (:meth:`.cuda_stencil_2d.SideInputs.for_pass`, the global
    grid's tables), required where it has them. `chunk`: the rows a block
    of the kernel marches (:func:`launch_chunk` by default), which moves the
    bf16 kernel's blocks between its interior and edge marches and no value.

    CPU buffers get the plain version. CUDA buffers go through the generated
    ext kernel (the side-input ext kernel where the program has side
    inputs), up to ``MAX_BLOCKS`` blocks per launch; any failure raises.
    ``multi_stencil_ext_2d.launches`` counts kernel launches,
    ``.sides_launches`` those with side inputs, ``.bf16_launches`` those on
    bf16 planes.
    """
    program = spec.program
    n_fields = program.n_fields
    n_rows, n_cols = spec.shape
    h = spec.halo
    shape = (n_rows + 2 * h, n_cols + 2 * h)
    ins, outs = [list(planes) for planes in ins], [list(planes) for planes in outs]
    if len(flags) != len(ins):
        raise ValueError("Expected the edge flags of every block")
    flags = [(*map(int, edges), *(origin if program.sides is not None else ()))
             for edges, origin in (_multi_flags(f, spec) for f in flags)]
    if len(outs) != len(ins) or any(len(p) != n_fields for p in ins + outs):
        raise ValueError(f"Expected {n_fields} input and output planes per block")
    device, ld = _check_buffers(
        [b for planes in ins for b in planes], [b for planes in outs for b in planes],
        shape, spec.dtype,
    )
    check_sides(program, sides, spec, device)
    interior = (slice(h, h + n_rows), slice(h, h + n_cols))
    if device.type == "cpu":
        for ext, out, block_flags in zip(ins, outs, flags):
            results = multi_stencil_ext_2d_plain(ext, spec, block_flags, sides)
            for plane, result in zip(out, results):
                plane[interior] = result
        return outs
    if device.type != "cuda":
        raise RuntimeError(f"No multi-stencil ext kernel for device {device}")
    lib = _library(program)
    launch = getattr(lib, f"{program.library}_{dtype_suffix(spec.dtype)}")
    stream = torch.cuda.current_stream(device).cuda_stream
    strips = -(-n_cols // spec.tile[0])
    side_arrays = side_args(program, sides)
    per_block = len(flags[0])
    for start in range(0, len(ins), MAX_BLOCKS):
        group = range(start, min(start + MAX_BLOCKS, len(ins)))
        in_ptrs = (ctypes.c_void_p * (len(group) * n_fields))(
            *[p.data_ptr() for b in group for p in ins[b]])
        out_ptrs = (ctypes.c_void_p * (len(group) * n_fields))(
            *[p.data_ptr() for b in group for p in outs[b]])
        edges = (ctypes.c_int * (per_block * len(group)))(*[f for b in group for f in flags[b]])
        err = _launch(device, launch, (
            ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs), ctypes.addressof(edges),
            len(group), n_rows, n_cols, h, ld, spec.k,
            launch_chunk(program, n_rows, strips, [flags[b] for b in group]) if chunk is None
            else int(chunk),
            *map(ctypes.addressof, side_arrays), stream,
        ))
        if err != 0:
            raise RuntimeError(f"{program.library} kernel launch failed with CUDA error {err}")
        multi_stencil_ext_2d.launches += 1
        if side_arrays:
            multi_stencil_ext_2d.sides_launches += 1
        if spec.dtype == torch.bfloat16:
            multi_stencil_ext_2d.bf16_launches += 1
    return outs


multi_stencil_ext_2d.launches = 0
multi_stencil_ext_2d.sides_launches = 0
multi_stencil_ext_2d.bf16_launches = 0
