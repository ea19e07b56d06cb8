"""Halo-extended kernels of decomposed 3D runs: CUDA kernels, plain versions,
replays of the kernels' march.

Port of the two 3D ext kernels of :mod:`pde_tpu.ops.pallas_cartesian`:
``make_affine_laplace_ext_3d`` (TPU kernel #11; the decomposed counterpart of
kernel #3) and ``make_fused_multi_ext_window_3d`` (#6; of kernel #5). The
``ext_x`` mode of ``_make_ychunk_multi_window_3d`` (#4), ``pde_tpu``'s route
for x-cut meshes with large planes, computes the same function on x-cut
blocks; here the ext kernel of #6 takes those meshes too. Each advances a
local block of shape ``(nx, ny, nz)`` by k steps from an extended buffer of
shape ``(nx + 2h, ny + 2h, nz + 2h)`` whose halo shell was filled from the
neighbouring blocks (:mod:`pde_tpu_torch.parallel.fused`), and writes the
block into the interior of a second buffer of that shape.

Edge flags ``[x_lo, x_hi, y_lo, y_hi, z_lo, z_hi]`` (host ints per block, the
order of ``pde_tpu``'s int32 ``(6,)`` array and of
:meth:`~pde_tpu_torch.parallel.GridMesh.edge_flags`) mark the faces of a block
that lie on a non-periodic global face: there the cells beyond the face are
held at zero and the ghost values of the boundary conditions are rewritten at
every step, as the serial kernels do at the global faces. Elsewhere the halo
is trusted. A periodic axis has no global face: a flag there is refused.

The port extends every axis: ``pde_tpu`` keeps an undecomposed y or z axis
locally periodic by rolls (``ext_axes``), a TPU layout matter; here such an
axis wraps onto its own block in the exchange, which gives the same values
through one code path. The halo is ``h = k * depth``, as in ``pde_tpu``'s
interpret mode; a block needs at least h cells on every axis.

The generated ext kernel also takes the side inputs of its serial
counterpart (A9.3's 3D half, ``pde_tpu``'s ``bc_inputs`` of #6): values and
ghost factors that vary over a face, in time, or (values) in both. Every
block reads the serial window's face tables of the global grid at its
origin (its first cell in the grid, three ints after its six face flags),
through the template's ``multi_stencil_sides_ext_3d_kernel``, so a
decomposed run equals the serial side-input window bit for bit. The affine
ext kernel takes scalar faces only, as ``pde_tpu``'s does.

Several implementations of each function, as for the serial kernels: the
CUDA kernel (the template ``csrc/affine_laplace_ext_3d.cuh`` with entry
points generated here per periodicity; the ext kernel of
``csrc/multi_stencil_3d.cuh`` with a program generated per rhs by
:class:`ExtStencilProgram3D`), both on the window geometry ``ExtGeo`` of
``csrc/march_3d.cuh``; the plain version (k plain PyTorch steps on the
block's whole window, the oracle and what the wrappers run for CPU tensors);
a replay of the kernel's march (``*_marched``: the serial kernels' schedule
on the ext window, on the CPU) and, for the affine kernel, a tile emulation
(its tiles, window offsets, load clipping and flag logic).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
from dataclasses import dataclass, fields

import torch

from .cuda_cartesian import _NVCC_FLAGS, KernelUnsupportedError
from .cuda_cartesian_3d import (
    _CSRC,
    _MARCH,
    MAX_STEPS,
    AffineLaplace3DSpec,
    _MAX_BLOCKS,
    affine_laplace_3d_spec,
    check_block_counts,
    march_block,
    march_blocks,
    march_plan_3d,
    window_steps,
)
from .cuda_ext_2d import (
    MAX_BLOCKS,
    ExtTileHelpers,
    MultiExtSpec,
    _block_flags,
    _check_flags,
    _domain,
    _launch,
    _multi_ext_pass,
    _multi_flags,
    check_block,
    multi_stencil_ext_spec,
)
from .cuda_march import MarchWindow
from .cuda_stencil_2d import _DTYPES, _library, along, check_sides, side_args
from .cuda_stencil_3d import (
    PassProgram3D,
    StencilProgram3D,
    emit_units,
    evaluate,
    march_program_blocks,
    pass_entry_points,
    run_cut,
)

_TEMPLATE = _CSRC / "affine_laplace_ext_3d.cuh"


def _check_tile_counts(local_shape, tile) -> None:
    """The serial kernel's limit on tile counts, with blockIdx.z running over
    (block, x chunk) for up to :data:`MAX_BLOCKS` blocks."""
    check_block_counts(local_shape, tile)
    if -(-local_shape[0] // tile[0]) * MAX_BLOCKS > _MAX_BLOCKS:
        raise KernelUnsupportedError(
            f"{local_shape[0]} cells along x need more than {_MAX_BLOCKS // MAX_BLOCKS} tiles"
        )


# -- row 11: the affine Laplacian ---------------------------------------------------------------
@dataclass(frozen=True)
class AffineExt3DSpec(AffineLaplace3DSpec):
    """One ext pass of the 3D affine Laplacian: ``shape`` is the block's and
    ``halo`` the extended buffers' halo width (``k <= halo``)."""

    halo: int


def affine_laplace_ext_3d_spec(
    grid, local_shape, *, a: float, b: float, k: int, halo: int, dtype, bcs=None
) -> AffineExt3DSpec:
    """Check that the ext kernel takes a configuration and describe it: the
    gates of kernel #3 on the global `grid` (:func:`.affine_laplace_3d_spec`),
    plus ``k <= halo <= min(local_shape)``."""
    base = affine_laplace_3d_spec(grid, a=a, b=b, k=k, dtype=dtype, bcs=bcs)
    if not 1 <= k <= halo:
        raise KernelUnsupportedError(f"A k = {k} pass needs a halo of at least k, not {halo}")
    local = tuple(int(n) for n in local_shape)
    if len(local) != 3:
        raise KernelUnsupportedError("The 3D ext kernel takes 3D blocks")
    check_block(local, halo)
    _check_tile_counts(local, base.tile)
    values = {f.name: getattr(base, f.name) for f in fields(AffineLaplace3DSpec)}
    values["shape"] = local
    return AffineExt3DSpec(**values, halo=int(halo))


def _affine_ext_pass(ext: torch.Tensor, spec: AffineExt3DSpec, flags, tile) -> torch.Tensor:
    """One block's pass, tile by tile: each tile loads its window (the tile
    and k cells per side) from the buffer at offset ``h - k``, cells past the
    buffer or beyond a flagged face as zero, runs the k steps of
    :func:`.window_steps` and keeps its centre."""
    k, h = spec.k, spec.halo
    flags = _block_flags(flags, spec.periodic)
    edges = [(flags[2 * ax], flags[2 * ax + 1]) for ax in range(3)]
    zero = torch.zeros((), dtype=ext.dtype)
    out = torch.empty(spec.shape, dtype=ext.dtype, device=ext.device)
    for origin in itertools.product(*(range(0, n, t) for n, t in zip(spec.shape, tile))):
        g0 = [o - k for o in origin]
        index, in_dom, loaded = [], [], []
        for ax, (n, t) in enumerate(zip(spec.shape, tile)):
            g = torch.arange(g0[ax], g0[ax] + t + 2 * k, device=ext.device)
            domain = _domain(g, n, *edges[ax])
            index.append((g + h).clamp(max=n + 2 * h - 1))
            in_dom.append(domain)
            loaded.append(domain & (g < n + h))
        load = along(loaded[0], 0, 3) & along(loaded[1], 1, 3) & along(loaded[2], 2, 3)
        cur = torch.where(load, ext[tuple(along(i, ax, 3) for ax, i in enumerate(index))], zero)
        cur = window_steps(cur, spec, g0, in_dom, edges)
        sizes = [min(t, n - o) for t, n, o in zip(tile, spec.shape, origin)]
        out[tuple(slice(o, o + n) for o, n in zip(origin, sizes))] = cur[
            tuple(slice(k, k + n) for n in sizes)
        ]
    return out


def affine_laplace_ext_3d_plain(ext: torch.Tensor, spec: AffineExt3DSpec, flags) -> torch.Tensor:
    """k plain PyTorch steps on one block's extended buffer: the block and k
    cells per side, flag-gated ghost rewrites, cells beyond a flagged face at
    zero; returns the ``(nx, ny, nz)`` block."""
    return _affine_ext_pass(ext, spec, flags, spec.shape)


def affine_laplace_ext_3d_tiled(
    ext: torch.Tensor, spec: AffineExt3DSpec, flags, tile=None
) -> torch.Tensor:
    """Pure-torch emulation of the ext kernel on one block, tile by tile
    (`tile` defaults to the kernel's)."""
    return _affine_ext_pass(ext, spec, flags, spec.tile if tile is None else tuple(tile))


def _ext_window(exts, shape, buffer_halo: int, edges, origin, tile, halo: int,
                block_origin=(0, 0, 0), extent=None) -> MarchWindow:
    """The ext kernels' window (``ExtGeo``) of the chunk whose first output
    cell is `origin`, with `halo` cells of halo, over blocks of `shape` held
    in buffers with `buffer_halo`: read from the buffers at that offset,
    cells past them zero, cells beyond a flagged face outside the domain;
    ``read`` gives one plane of each of `exts`, ``row`` a window plane's x
    and ``cols`` the window columns' (y, z) in the grid, unwrapped (the
    block's first cell there is `block_origin`; the side-input kernel reads
    the faces' tables there). With `extent` (a pass of a cut step,
    ``RegionGeo``) the output columns run to ``extent`` cells past the
    block, in the domain or not."""
    h = buffer_halo
    columns, coords = [], []
    for ax in (1, 2):
        g = torch.arange(origin[ax] - halo, origin[ax] + tile[ax] + halo)
        coords.append(g + block_origin[ax])
        n = shape[ax]
        inside = _domain(g, n, *edges[ax])
        columns.append((
            (g + h).clamp(max=n + 2 * h - 1), inside, inside & (g < n + h),
            inside & (g == 0) & edges[ax][0], inside & (g == n - 1) & edges[ax][1],
            (g >= origin[ax]) & (g < origin[ax] + tile[ax]) & (
                (g < n) & inside if extent is None else g < n + extent),
        ))
    (iy, dy, ly_load, ly, hy, oy), (iz, dz, lz_load, lz, hz, oz) = columns
    nx, (x_lo, x_hi) = shape[0], edges[0]

    def plane(w):
        gx = origin[0] - halo + w
        x_in = bool(_domain(torch.tensor(gx), nx, x_lo, x_hi))
        return x_in and gx < nx + h, x_in, x_lo and gx == 0, x_hi and gx == nx - 1

    def read(w):
        gx = min(origin[0] - halo + w + h, nx + 2 * h - 1)
        return [ext[gx][iy[:, None], iz[None, :]] for ext in exts]

    def row(w):
        return block_origin[0] + origin[0] - halo + w

    return MarchWindow(
        ly_load[:, None] & lz_load[None, :], dy[:, None] & dz[None, :],
        (ly[:, None] & dz[None, :], hy[:, None] & dz[None, :],
         dy[:, None] & lz[None, :], dy[:, None] & hz[None, :]),
        oy[:, None] & oz[None, :], plane, read, row, cols=tuple(coords))


def _edges(flags, periodic) -> list[tuple[bool, bool]]:
    flags = _block_flags(flags, periodic)
    return [(flags[2 * ax], flags[2 * ax + 1]) for ax in range(3)]


def affine_laplace_ext_3d_marched(
    ext: torch.Tensor, spec: AffineExt3DSpec, flags, tile=None,
) -> torch.Tensor:
    """Pure-torch replay of the ext kernel's march on one block (`tile`, the
    plan ``(cx, ty, tz)``, defaults to the kernel's): the serial kernel's
    :func:`.march_block` on the ext kernel's windows. Returns the
    ``(nx, ny, nz)`` block; cells no chunk writes stay NaN."""
    tile = spec.tile if tile is None else tuple(tile)
    edges, k = _edges(flags, spec.periodic), spec.k
    (out,) = march_blocks(
        spec.shape, k, tile,
        lambda origin: _ext_window([ext], spec.shape, spec.halo, edges, origin, tile, k),
        lambda win, planes, store: march_block(win, spec, k, planes, store), 1, ext.dtype)
    return out


def emit_affine_source(periodic: tuple[bool, bool, bool]) -> str:
    """The generated entry points: the template instantiated for every k and
    dtype at the serial kernel's plan, for one periodicity."""
    flags = ", ".join(str(bool(p)).lower() for p in periodic)
    lines = [
        "// Generated by pde_tpu_torch/ops/cuda_ext_3d.py: one instantiation per (k, dtype)",
        f"// at its plan, for periodic axes ({flags}); the kernel is the template in",
        "// pde_tpu_torch/csrc/affine_laplace_ext_3d.cuh.",
        '#include "affine_laplace_ext_3d.cuh"',
        "",
    ]
    for ctype, suffix, itemsize in _DTYPES.values():
        lines += [
            f'extern "C" int affine_laplace_ext_3d_{suffix}(const void* const* ins, '
            "void* const* outs, const int* edges,",
            "    const int* ints, const double* doubles, void* stream) {",
            "  switch (ints[8]) {",
        ]
        for k in range(1, MAX_STEPS + 1):
            cx, ty, tz = march_plan_3d(k, itemsize)
            lines.append(
                f"    case {k}: return pde_tpu_torch::launch_affine_ext_3d<{ctype}, {k}, {cx}, "
                f"{ty}, {tz}, {flags}>(ins, outs, edges, ints, doubles, stream);"
            )
        lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


class _AffineExtSource:
    """The affine ext kernel's generated source for one periodicity, as a
    build unit of :func:`.cuda_stencil_2d.build_programs`."""

    library = "affine_laplace_ext_3d"

    def __init__(self, periodic: tuple[bool, bool, bool]):
        self.periodic = periodic
        self.source = emit_affine_source(periodic)
        text = (self.source + _TEMPLATE.read_text() + (_CSRC / "affine_laplace_3d.cuh").read_text()
                + _MARCH.read_text() + " ".join(_NVCC_FLAGS))
        self.digest = hashlib.sha256(text.encode()).hexdigest()[:16]

    @staticmethod
    def load(path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"affine_laplace_ext_3d_{suffix}")
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,  # host arrays of input and output pointers
                ctypes.c_void_p,  # edges: 6 host ints per block
                ctypes.c_void_p,  # ints: 12 host ints
                ctypes.c_void_p,  # doubles: 23 host doubles
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
        return lib


@functools.cache
def affine_ext_source(periodic: tuple[bool, bool, bool]) -> _AffineExtSource:
    """The affine ext kernel's build unit for axes of this periodicity
    (``build_programs([affine_ext_source(spec.periodic)])`` builds it)."""
    return _AffineExtSource(tuple(bool(p) for p in periodic))


def _check_buffers(ins, outs, shape, dtype) -> torch.device:
    """The one device of the buffers; raises unless they are distinct
    contiguous `shape` tensors of `dtype` there."""
    device = ins[0].device
    seen = set()
    for buf in list(ins) + list(outs):
        if tuple(buf.shape) != shape or buf.dtype != dtype or buf.device != device:
            raise ValueError(
                f"Expected {shape} {dtype} buffers on {device}, got "
                f"{tuple(buf.shape)} {buf.dtype} on {buf.device}"
            )
        if device.type == "cuda" and (not buf.is_contiguous() or buf.data_ptr() in seen):
            raise ValueError("The kernel needs distinct contiguous buffers")
        seen.add(buf.data_ptr())
    return device


def _interior(shape, halo: int) -> tuple[slice, ...]:
    return tuple(slice(halo, halo + n) for n in shape)


def affine_laplace_ext_3d(ins, outs, flags, spec: AffineExt3DSpec) -> list:
    """One k-step pass over blocks of one device: ``ins[b]`` and ``outs[b]``
    are block b's extended buffers, ``flags[b]`` its six edge flags; the block
    is written into the interior of ``outs[b]`` (its halo is left as it was).

    CPU buffers get the plain version. CUDA buffers go through the CUDA
    kernel, up to ``MAX_BLOCKS`` blocks per launch; any failure raises.
    ``affine_laplace_ext_3d.launches`` counts kernel launches.
    """
    h = spec.halo
    shape = tuple(n + 2 * h for n in spec.shape)
    ins, outs = list(ins), list(outs)
    flags = _check_flags(flags, len(ins), spec.periodic)
    if len(outs) != len(ins):
        raise ValueError("Expected one output buffer per input buffer")
    device = _check_buffers(ins, outs, shape, spec.dtype)
    interior = _interior(spec.shape, h)
    if device.type == "cpu":
        for ext, out, block_flags in zip(ins, outs, flags):
            out[interior] = affine_laplace_ext_3d_plain(ext, spec, block_flags)
        return outs
    if device.type != "cuda":
        raise RuntimeError(f"No 3D affine ext kernel for device {device}")
    lib = _library(affine_ext_source(spec.periodic))
    launch = getattr(lib, f"affine_laplace_ext_3d_{_DTYPES[spec.dtype][1]}")
    doubles = (ctypes.c_double * 23)(
        spec.a, spec.b, *spec.scales, *[v for side in spec.sides for v in side])
    stream = torch.cuda.current_stream(device).cuda_stream
    for start in range(0, len(ins), MAX_BLOCKS):
        chunk = range(start, min(start + MAX_BLOCKS, len(ins)))
        in_ptrs = (ctypes.c_void_p * len(chunk))(*[ins[b].data_ptr() for b in chunk])
        out_ptrs = (ctypes.c_void_p * len(chunk))(*[outs[b].data_ptr() for b in chunk])
        edges = (ctypes.c_int * (6 * len(chunk)))(*[f for b in chunk for f in flags[b]])
        ints = (ctypes.c_int * 12)(len(chunk), *spec.shape, h, *spec.tile, spec.k,
                                   *map(int, spec.periodic))
        err = _launch(device, launch, (
            ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs), ctypes.addressof(edges),
            ctypes.addressof(ints), ctypes.addressof(doubles), stream,
        ))
        if err != 0:
            raise RuntimeError(f"affine_laplace_ext_3d kernel launch failed with CUDA error {err}")
        affine_laplace_ext_3d.launches += 1
    return outs


affine_laplace_ext_3d.launches = 0


# -- row 6 (and row 4's ext_x): the multi-field window ------------------------------------------
class ExtStencilProgram3D(StencilProgram3D):
    """A traced step emitted for the ext kernel of decomposed 3D grids: the
    serial emitter of :mod:`.cuda_stencil_3d` writes the program struct (the
    same stage functions: the ghosts follow the march's flags, which the ext
    kernel's geometry sets from the block's face flags), and the entry
    points take a table of blocks. A program whose ghosts read side inputs
    (`sides`, the global grid's :class:`.cuda_stencil_2d.SideInputs`)
    launches the side-input ext kernel, whose blocks read the face tables at
    their origins. A cut step's passes compute their blocks and the cells
    around them that the later passes read (``PassProgram3D.extent``), so
    the step keeps one exchange of its whole halo; they take two RK stages
    each where that is the faster (:attr:`pass_stages`)."""

    library = "multi_stencil_ext_3d"
    ext = True

    @property
    def pass_stages(self) -> tuple[int, ...]:
        """Two RK stages a pass in each dtype where its passes have plans in
        it, else one (Kuramoto-Sivashinsky in fp64); one with side inputs.
        The fastest a step over blocks of the layouts
        ``scripts/torch_rk4_3d_sweep.py`` times (PERF.md): two passes
        compute fewer cells past their blocks than four, but with side
        inputs the second takes 80-96 registers (one block an SM)."""
        return (1,) if self.sides is not None else (2, 1)

    def emit(self) -> str:
        units = emit_units(self)
        lines = [
            "// Generated by pde_tpu_torch/ops/cuda_ext_3d.py from a traced step; the",
            "// kernel is the ext kernel of pde_tpu_torch/csrc/multi_stencil_3d.cuh.",
            '#include "multi_stencil_3d.cuh"',
            "",
            *[line for unit in units for line in unit[0]],
        ]
        sides = self.sides is not None
        launcher, extra = ("launch_ext_sides_3d", "sides, steps, ") if sides else (
            "launch_ext_3d", "")
        for _, struct, stem, tiles, ladder in units:
            for dtype in tiles:
                ctype, suffix, _ = _DTYPES[dtype]
                lines += [
                    f"extern \"C\" int {stem}_{suffix}(const void* const* ins, "
                    "void* const* outs, const int* edges,",
                    "    int n_blocks, int nx, int ny, int nz, int halo, int k, "
                    + ("const void* const* sides,\n    const long long* steps, " if sides else "")
                    + "void* stream) {",
                    "  switch (k) {",
                ]
                for k in ladder:
                    if tiles[dtype][k] is None:  # no plan in this dtype (unplanned)
                        continue
                    cx, ty, tz = tiles[dtype][k]
                    lines.append(
                        f"    case {k}: return pde_tpu_torch::{launcher}<{struct}, {ctype}, {k}, "
                        f"{cx}, {ty}, {tz}>(ins, outs, edges, n_blocks, nx, ny, nz, halo, "
                        f"{extra}stream);"
                    )
                lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
        return "\n".join(lines)

    def load(self, path: str) -> ctypes.CDLL:
        lib = ctypes.CDLL(path)
        names = (pass_entry_points(self) if self.cuts is not None else
                 [f"{self.library}_{suffix}" for _, suffix, _ in _DTYPES.values()])
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,  # host arrays of input and output pointers
                ctypes.c_void_p,  # edges: 6 host ints per block (9 with side inputs)
                ctypes.c_int,  # n_blocks
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # block shape
                ctypes.c_int, ctypes.c_int,  # halo, k
                # the side inputs' tables and their strides
                *([ctypes.c_void_p] * (2 if self.sides is not None else 0)),
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
        return lib

    def ext_temporaries(self, shape, dtype, device, n_blocks: int) -> list[dict]:
        """Per block, the extended buffers of the values the passes of a cut
        step hand on (by node index), beside the exchange's: made once per
        shape, dtype, device and block count, zeroed, reused by every step."""
        cache = self.__dict__.setdefault("_ext_temporaries", {})
        key = (tuple(shape), dtype, torch.device(device), n_blocks)
        if key not in cache:
            cache[key] = [{i: torch.zeros(tuple(shape), dtype=dtype, device=device)
                           for p in self.cut(dtype)[:-1] for i in p.writes}
                          for _ in range(n_blocks)]
        return cache[key]


def multi_stencil_ext_3d_spec(
    program: ExtStencilProgram3D, k: int, dtype, local_shape, halo: int
) -> MultiExtSpec:
    """Describe one 3D ext pass; raises :class:`KernelUnsupportedError`
    exactly where the kernel does not take it (nothing is built here)."""
    if not isinstance(program, ExtStencilProgram3D):
        raise KernelUnsupportedError("The 3D ext kernel takes an ExtStencilProgram3D")
    spec = multi_stencil_ext_spec(program, k, dtype, local_shape, halo)
    if program.cuts is None:
        _check_tile_counts(spec.shape, spec.tile)
    for p, tile in zip(program.cut(dtype) if program.cuts else (), spec.tile):
        _check_tile_counts(tuple(n + 2 * p.extent for n in spec.shape), tile)
    return spec


def multi_stencil_ext_3d_plain(ext_datas, spec: MultiExtSpec, flags, sides=None) -> list:
    """k plain PyTorch steps on one block's extended buffers, the block's
    whole window at once (flag-gated ghosts, cells beyond flagged faces at
    zero; with side inputs `sides`, the pass's views of the program's
    :class:`.cuda_stencil_2d.SideInputs`, read at the cells' places in the
    grid, `flags` then carrying the block's first cell there); returns the
    ``(nx, ny, nz)`` volumes (a cut step's too: the traced step's plain
    version, independent of the cut)."""
    edges, origin = _multi_flags(flags, spec)
    return _multi_ext_pass(list(ext_datas), spec, edges, spec.shape, sides, origin)


def _region(spec: MultiExtSpec, extent: int) -> tuple[slice, ...]:
    """A pass's cells in a block's extended buffer: the block and `extent`
    cells past it on every side."""
    return tuple(slice(spec.halo - extent, spec.halo + n + extent) for n in spec.shape)


def _ext_cut_block(exts, spec: MultiExtSpec, run) -> list:
    """A cut step on one block's extended buffers `exts`: ``run(p, ins)``
    gives pass p's values on its region (:func:`_region`) from its inputs'
    extended buffers; the values a later pass reads go into extended
    buffers of NaN (a read past what a pass wrote shows), the last pass's
    are the block's volumes."""
    passes = spec.program.cut(spec.dtype)

    def region_run(p, ins):
        outs = run(p, ins)
        if p is passes[-1]:
            return outs
        held = [torch.full_like(exts[0], float("nan")) for _ in outs]
        for buf, out in zip(held, outs, strict=True):
            buf[_region(spec, p.extent)] = out
        return held

    return run_cut(passes, exts, region_run)


def ext_pass_plain(program: PassProgram3D, exts, spec: MultiExtSpec, edges, origin,
                   sides=None) -> list:
    """One pass of a cut step on one block's extended buffers (its inputs'),
    its whole window at once: the block and ``extent + depth`` cells per
    side, loaded as the kernel loads them, the pass's graph evaluated with
    the ext tile helpers (flag-gated ghosts, the side inputs at the cells'
    places in the grid from the block's `origin`), cells beyond flagged faces
    at zero; returns the values on the block and ``extent`` cells per side."""
    e, reach, h = program.extent, program.extent + program.depth, spec.halo
    device = exts[0].device
    zero = torch.zeros((), dtype=exts[0].dtype)
    index, domain = [], []
    for axis, n in enumerate(spec.shape):
        g = torch.arange(-reach, n + reach, device=device)
        index.append(along(g + h, axis, 3))
        domain.append(along(_domain(g, n, *edges[2 * axis:2 * axis + 2]), axis, 3))
    inside = domain[0] & domain[1] & domain[2]
    works = [torch.where(inside, ext[tuple(index)], zero) for ext in exts]
    tile = tuple(n + 2 * e for n in spec.shape)
    helpers = ExtTileHelpers(program.grid, tile, (-e,) * 3, spec.shape, edges, device, origin)
    helpers.sides, helpers.side_views = program.sides, sides
    cut = (slice(program.depth, -program.depth),) * 3
    outs = []
    for value in evaluate(program, helpers, works):
        trim = [(m - t) // 2 for m, t in zip(value.shape, tile)]
        value = value[tuple(slice(c, c + t) for c, t in zip(trim, tile))]
        outs.append(torch.where(inside[cut], value, zero))
    return outs


def multi_stencil_ext_3d_marched(ext_datas, spec: MultiExtSpec, flags, tile=None,
                                 sides=None) -> list:
    """Pure-torch replay of the ext kernel's march on one block (`tile`, the
    plan ``(cx, ty, tz)``, defaults to the kernel's): the serial kernel's
    :func:`.cuda_march.march_program_block` on the ext kernel's windows, with
    the pass's side inputs `sides` read at the block's places in the grid.
    Returns the ``(nx, ny, nz)`` volumes; cells no chunk writes stay NaN."""
    program = spec.program
    block_flags, origin = _multi_flags(flags, spec)
    edges = _edges(block_flags, program.geometry.periodic)
    exts = list(ext_datas)
    if program.cuts is not None:
        tiles = spec.tile if tile is None else (tuple(tile),) * len(program.cut(spec.dtype))
        return _ext_cut_block(exts, spec, lambda p, ins: ext_pass_marched(
            p, ins, spec, block_flags, origin, tiles[p.index], sides))
    tile = spec.tile if tile is None else tuple(tile)
    return march_program_blocks(
        program, spec.k, spec.shape, tile,
        lambda at, halo: _ext_window(exts, spec.shape, spec.halo, edges, at, tile, halo, origin),
        exts[0].dtype, sides)


def ext_pass_marched(program: PassProgram3D, exts, spec: MultiExtSpec, edges, origin, tile,
                     sides=None) -> list:
    """Pure-torch replay of one pass's ext march on one block at the plan
    `tile`: its chunks and column tiles over the block and ``extent`` cells
    past it on every side (``RegionGeo``), as :func:`ext_pass_plain` returns
    them; `edges` the block's six face flags; cells no chunk writes stay
    NaN."""
    e = program.extent
    region = tuple(n + 2 * e for n in spec.shape)
    pairs = _edges(edges, program.geometry.periodic)
    return march_program_blocks(
        program, 1, region, tile,
        lambda at, halo: _ext_window(exts, spec.shape, spec.halo, pairs,
                                     tuple(a - e for a in at), tile, halo, origin, e),
        exts[0].dtype, sides)


def multi_stencil_ext_3d(ins, outs, flags, spec: MultiExtSpec, sides=None) -> list:
    """One k-step pass of the spec's program over blocks of one device:
    ``ins[b]`` and ``outs[b]`` are the extended buffers of block b's volumes,
    ``flags[b]`` its six edge flags (and, in a program with side inputs, its
    first cell in the grid); the volumes are written into the interiors of
    ``outs[b]``. `sides`: the pass's views of the program's side inputs
    (:meth:`.cuda_stencil_2d.SideInputs.for_pass`, the global grid's face
    tables), required where it has them.

    CPU buffers get the plain version. CUDA buffers go through the generated
    ext kernel (the side-input ext kernel where the program has side
    inputs), up to ``MAX_BLOCKS`` blocks per launch; any failure raises.
    ``multi_stencil_ext_3d.launches`` counts kernel launches (a cut step's
    passes each, also by pass in ``.pass_launches``), ``.sides_launches``
    those with side inputs.
    """
    program = spec.program
    n_fields = program.n_fields
    h = spec.halo
    shape = tuple(n + 2 * h for n in spec.shape)
    ins, outs = [list(planes) for planes in ins], [list(planes) for planes in outs]
    if program.sides is None:
        flags = _check_flags(flags, len(ins), program.geometry.periodic)
    else:
        if len(flags) != len(ins):
            raise ValueError("Expected the edge flags of every block")
        flags = [(*map(int, edges), *origin)
                 for edges, origin in (_multi_flags(f, spec) for f in flags)]
    if len(outs) != len(ins) or any(len(p) != n_fields for p in ins + outs):
        raise ValueError(f"Expected {n_fields} input and output volumes per block")
    device = _check_buffers(
        [b for planes in ins for b in planes], [b for planes in outs for b in planes],
        shape, spec.dtype,
    )
    check_sides(program, sides, spec, device)
    interior = _interior(spec.shape, h)
    if device.type == "cpu":
        for ext, out, block_flags in zip(ins, outs, flags):
            results = multi_stencil_ext_3d_plain(ext, spec, block_flags, sides)
            for plane, result in zip(out, results):
                plane[interior] = result
        return outs
    if program.cuts is not None and device.type == "cuda":
        temps = program.ext_temporaries(shape, spec.dtype, device, len(ins))
        passes = program.cut(spec.dtype)
        for p in passes:
            multi_stencil_ext_3d_pass(
                p, [planes + [held[i] for i in p.reads] for planes, held in zip(ins, temps)],
                outs if p is passes[-1] else [[held[i] for i in p.writes] for held in temps],
                flags, spec, sides)
        return outs
    if device.type != "cuda":
        raise RuntimeError(f"No 3D multi-stencil ext kernel for device {device}")
    launches = _launch_blocks(program.library, ins, outs, flags, spec, sides, spec.k)
    multi_stencil_ext_3d.launches += launches
    if sides is not None:
        multi_stencil_ext_3d.sides_launches += launches
    return outs


def _launch_blocks(entry: str, ins, outs, flags, spec: MultiExtSpec, sides, k: int) -> int:
    """Launch the entry point `entry` (less its dtype suffix) of the spec's
    library over the blocks of one device, up to ``MAX_BLOCKS`` a launch
    (``ins[b]``, ``outs[b]``: block b's buffers; `flags` as
    :func:`multi_stencil_ext_3d` normalises them); returns the launches.
    Raises on a failed launch."""
    program = spec.program
    device = ins[0][0].device
    launch = getattr(_library(program), f"{entry}_{_DTYPES[spec.dtype][1]}")
    stream = torch.cuda.current_stream(device).cuda_stream
    side_arrays = side_args(program, sides)
    per_block = len(flags[0])
    launches = 0
    for start in range(0, len(ins), MAX_BLOCKS):
        chunk = range(start, min(start + MAX_BLOCKS, len(ins)))
        in_ptrs = (ctypes.c_void_p * sum(len(ins[b]) for b in chunk))(
            *[p.data_ptr() for b in chunk for p in ins[b]])
        out_ptrs = (ctypes.c_void_p * sum(len(outs[b]) for b in chunk))(
            *[p.data_ptr() for b in chunk for p in outs[b]])
        edges = (ctypes.c_int * (per_block * len(chunk)))(*[f for b in chunk for f in flags[b]])
        err = _launch(device, launch, (
            ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs), ctypes.addressof(edges),
            len(chunk), *spec.shape, spec.halo, k, *map(ctypes.addressof, side_arrays), stream,
        ))
        if err != 0:
            raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err}")
        launches += 1
    return launches


multi_stencil_ext_3d.launches = 0
multi_stencil_ext_3d.sides_launches = 0
#: launches of a cut step's passes, by pass index
multi_stencil_ext_3d.pass_launches = {}


def multi_stencil_ext_3d_pass(program: PassProgram3D, ins, outs, flags, spec: MultiExtSpec,
                              sides=None) -> list:
    """One pass of the cut step `spec.program` over blocks of one device:
    ``ins[b]`` the extended buffers of block b's inputs (the step's fields,
    then the values the pass reads), ``outs[b]`` of its outputs, into which
    the pass writes the block and ``program.extent`` cells past it on every
    side; `flags` as :func:`multi_stencil_ext_3d` normalises them. CPU
    buffers get :func:`ext_pass_plain`; CUDA buffers the pass's entry point
    in the step's library, up to ``MAX_BLOCKS`` blocks a launch, counted in
    ``multi_stencil_ext_3d.launches``; any failure raises."""
    step = spec.program
    device = ins[0][0].device
    if device.type == "cpu":
        region = _region(spec, program.extent)
        for block_ins, block_outs, block_flags in zip(ins, outs, flags, strict=True):
            edges, origin = _multi_flags(block_flags, spec)
            results = ext_pass_plain(program, block_ins, spec, edges, origin, sides)
            for plane, result in zip(block_outs, results, strict=True):
                plane[region] = result
        return outs
    if device.type != "cuda":
        raise RuntimeError(f"No 3D multi-stencil ext kernel for device {device}")
    n_in, n_out = program.n_fields, len(program.outputs)
    if any(len(b) != n_in for b in ins) or any(len(b) != n_out for b in outs):
        raise ValueError(f"Pass {program.index} takes {n_in} input and {n_out} output buffers "
                         "a block")
    launches = _launch_blocks(f"{step.library}_p{program.index}", ins, outs, flags, spec, sides, 1)
    multi_stencil_ext_3d.launches += launches
    counts = multi_stencil_ext_3d.pass_launches
    counts[program.index] = counts.get(program.index, 0) + launches
    if sides is not None:
        multi_stencil_ext_3d.sides_launches += launches
    return outs
