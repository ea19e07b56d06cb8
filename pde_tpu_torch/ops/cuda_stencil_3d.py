"""Temporally blocked multi-field stencil windows on 3D grids: generated CUDA
kernel, plain version, tile emulation, ladder.

Port of the 3D expression-compiler path of :mod:`pde_tpu.ops.pallas_cartesian`:
the in-kernel helpers ``_make_stencil_helpers_3d``, the kernels
``make_fused_multi_stencil_window_3d`` and ``_make_ychunk_multi_window_3d``
(the same function cut two ways for VMEM; one Hopper kernel serves both) and
the ladder window ``make_chunked_multi_window_3d``. A window advances n
coupled scalar volumes by k explicit Euler steps of an arbitrary rhs per pass
over device memory.

The rhs is lowered once by ``make_step(helpers)`` against the n-D helpers of
:mod:`.cuda_stencil_2d`: :class:`~.cuda_stencil_2d.PlainHelpers` on whole
volumes (the plain version, which the wrapper runs for CPU tensors),
:class:`~.cuda_stencil_2d.TileHelpers` in the emulation of the kernel's
tiling, and the tracer, whose expression graph this module emits as a
``Program`` struct around the hand-written template
``csrc/multi_stencil_3d.cuh``. Each generated source instantiates every k of
the ladder for float and double and is built with ``nvcc`` for ``sm_90a`` at
first use into ``pde_tpu_torch/_build/``, through
:func:`~.cuda_stencil_2d.build_programs`.

Supported: a 3D ``CartesianGrid``, float32 or float64 volumes, periodic axes
or scalar constant affine BCs per operator. Everything else raises
:class:`KernelUnsupportedError` before anything is built.
"""

from __future__ import annotations

from typing import Callable

import torch

from .cuda_cartesian_3d import check_block_counts, tile_3d
from .cuda_stencil_2d import (
    _CSRC,
    _DTYPES,
    MultiStencilSpec,
    StencilProgram,
    _CellBody,
    _ghost_expr,
    _literal,
    ladder_window,
    make_chunked_multi_window_2d,
    multi_stencil_2d_plain,
    multi_stencil_spec,
    run_pass,
    stencil_axes,
    tiled_pass,
)

#: halo cells per face of the ladder's top pass (k * depth), before the
#: budget cuts it: the recomputed halo shell grows fast with k in 3D
TOP_HALO = 2

# per axis: low and high neighbour names, stride, global index, extent
_AXES = (("u", "d", "SX", "gx", "nx"), ("n", "s", "SY", "gy", "ny"), ("w", "e", "1", "gz", "nz"))


class StencilProgram3D(StencilProgram):
    """A traced step on a 3D grid with its kernel geometry: tiles ``(tx, ty,
    tz)`` from :func:`.cuda_cartesian_3d.tile_3d`, and the generated source
    of the template ``csrc/multi_stencil_3d.cuh``."""

    rank = 3
    library = "multi_stencil_3d"
    template = _CSRC / "multi_stencil_3d.cuh"
    top_halo = TOP_HALO

    def __init__(self, grid, make_step: Callable, depth: int, n_fields: int):
        super().__init__(grid, make_step, depth, n_fields)
        for tiles in self.tiles.values():
            for tile in tiles.values():
                check_block_counts(self.geometry.shape, tile)

    def tile_for(self, k: int, itemsize: int):
        return tile_3d(self.n_planes, k * self.depth, itemsize)

    def emit(self) -> str:
        return emit_source_3d(self)


# -- the emitter -----------------------------------------------------------------------------
class _CellBody3D(_CellBody):
    """C++ statements computing graph nodes at one cell of a 3D window."""

    def _stencil(self, node) -> str:
        geo = self.program.geometry
        operand, key = node.args
        axes = stencil_axes(node.op, 3)
        s = f"v{node.index}"
        p = self.storage(operand)
        c = f"{p}[idx]"
        lines = self.lines
        for axis in axes:
            low, high, stride = _AXES[axis][:3]
            lines.append(f"T {s}_{low} = {p}[idx - {stride}];")
            lines.append(f"T {s}_{high} = {p}[idx + {stride}];")
        if node.op == "lap":
            lines.append(f"const T {s}_c = {c};")
            c = f"{s}_c"
        for axis in axes:
            if key is None or key[axis] is None:
                continue
            low, high, _, g, n = _AXES[axis]
            lo, hi = key[axis]
            at_lo, at_hi = f"{g} == 0", f"{g} == {n} - 1"
            if self.program.ext:
                # a block's face is a global face only where its flag says so
                at_lo = f"L.edge[{2 * axis}] && {at_lo}"
                at_hi = f"L.edge[{2 * axis + 1}] && {at_hi}"
            lines.append(
                f"if ({at_lo}) {s}_{low} = {_ghost_expr(lo, c, f'{s}_{high}')}; "
                f"else if ({at_hi}) {s}_{high} = {_ghost_expr(hi, c, f'{s}_{low}')};"
            )
        diffs = [
            f"({s}_{_AXES[axis][1]} - {s}_{_AXES[axis][0]}) * {_literal(geo.halves[axis])}"
            for axis in axes
        ]
        if node.op == "lap":
            if len(set(geo.scales)) == 1:
                expr = f"({s}_u + {s}_d + {s}_n + {s}_s + {s}_w + {s}_e - T(6) * {c}) * " \
                       f"{_literal(geo.scales[0])}"
            else:
                expr = " + ".join(
                    f"({s}_{_AXES[axis][0]} + {s}_{_AXES[axis][1]} - T(2) * {c}) * "
                    f"{_literal(geo.scales[axis])}"
                    for axis in axes
                )
        elif node.op == "gsq":
            for axis, diff in zip(axes, diffs):
                lines.append(f"const T {s}_g{axis} = {diff};")
            expr = " + ".join(f"{s}_g{axis} * {s}_g{axis}" for axis in axes)
        else:
            (expr,) = diffs
        return self._let(node, expr)


def _sweep_3d(program, halo: str, targets, stored) -> list[str]:
    """One region sweep: every cell computes `targets` ((destination, node))."""
    body = _CellBody3D(program, stored)
    values = [(dst, body.value(node)) for dst, node in targets]
    sweep = "for_each_cell_ext_3d" if program.ext else "for_each_cell_3d"
    return [
        f"pde_tpu_torch::{sweep}<kXPeriodic, kYPeriodic, kZPeriodic>(L, " + halo + ", "
        "[&](int idx, int gx, int gy, int gz, bool inside) {",
        "  (void)gx;",
        "  (void)gy;",
        "  (void)gz;",
        "  if (!inside) {",
        *[f"    {dst}[idx] = T(0);" for dst, _ in targets],
        "    return;",
        "  }",
        *["  " + line for line in body.lines],
        *[f"  {dst}[idx] = {value};" for dst, value in values],
        "});",
    ]


def emit_program_3d(program: StencilProgram3D) -> list[str]:
    """The ``Program`` struct of one traced step, for the 3D template's kernel."""
    px, py, pz = (str(p).lower() for p in program.geometry.periodic)
    lines = [
        "namespace {",
        "",
        "struct Program {",
        f"  static constexpr int kFields = {program.n_fields};",
        f"  static constexpr int kBuffers = {len(program.buffers)};",
        f"  static constexpr int kDepth = {program.depth};",
        f"  static constexpr bool kXPeriodic = {px};",
        f"  static constexpr bool kYPeriodic = {py};",
        f"  static constexpr bool kZPeriodic = {pz};",
        "",
        "  template <typename T>",
        "  __device__ static void level(const pde_tpu_torch::Level3D<T, kFields, kBuffers>& L, "
        "int h) {",
        "    const int SX = L.wy * L.wz;",
        "    const int SY = L.wz;",
        "    const int nx = L.n[0];",
        "    const int ny = L.n[1];",
        "    const int nz = L.n[2];",
        "    (void)SX;",
        "    (void)SY;",
        "    (void)nx;",
        "    (void)ny;",
        "    (void)nz;",
    ]
    stored: dict[int, int] = {}
    for depth in sorted({node.depth for node in program.buffers}):
        group = [(f"L.buf[{program.buffers.index(n)}]", n)
                 for n in program.buffers if n.depth == depth]
        lines += [f"    // operand buffers of depth {depth}"]
        lines += ["    " + line for line in _sweep_3d(program, f"h - {depth}", group, stored)]
        lines += ["    __syncthreads();"]
        stored.update({n.index: program.buffers.index(n) for _, n in group})
    targets = [(f"L.nxt[{f}]", out) for f, out in enumerate(program.outputs)]
    lines += ["    // the next level of every field"]
    lines += ["    " + line for line in _sweep_3d(program, f"h - {program.depth}", targets, stored)]
    lines += ["  }", "};", "", "}  // namespace", ""]
    return lines


def emit_source_3d(program: StencilProgram3D) -> str:
    """The CUDA C++ source of one traced 3D step: a program struct for the
    template's kernel, and the plain C entry points."""
    lines = [
        "// Generated by pde_tpu_torch/ops/cuda_stencil_3d.py from a traced step;",
        "// the kernel is the template in pde_tpu_torch/csrc/multi_stencil_3d.cuh.",
        '#include "multi_stencil_3d.cuh"',
        "",
        *emit_program_3d(program),
    ]
    for dtype, (ctype, suffix, _) in _DTYPES.items():
        lines += [
            f"extern \"C\" int multi_stencil_3d_{suffix}(const void* const* ins, void* const* outs,",
            "                                 int nx, int ny, int nz, int k, void* stream) {",
            "  switch (k) {",
        ]
        for k in program.ladder:
            tx, ty, tz = program.tiles[dtype][k]
            lines.append(
                f"    case {k}: return pde_tpu_torch::launch_3d<Program, {ctype}, {k}, "
                f"{tx}, {ty}, {tz}>(ins, outs, nx, ny, nz, stream);"
            )
        lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


# -- plain version, tile emulation, wrapper --------------------------------------------------
def multi_stencil_3d_plain(datas, spec: MultiStencilSpec) -> list:
    """k plain PyTorch steps on whole volumes."""
    return multi_stencil_2d_plain(datas, spec)


def multi_stencil_3d_tiled(datas, spec: MultiStencilSpec, tile=None) -> list:
    """Pure-torch emulation of the kernel, tile by tile (`tile`, one size per
    axis or one for all, defaults to the kernel's): each tile loads its window
    of every volume (periodic halos wrapped, zeros outside the domain), runs k
    steps through :class:`~.cuda_stencil_2d.TileHelpers`, holds cells outside
    the domain at zero after each step, and writes its centre."""
    return tiled_pass(datas, spec, spec.tile if tile is None else tile)


def multi_stencil_3d(datas, spec: MultiStencilSpec, outs=None) -> list:
    """k Euler steps of the spec's 3D program over the volumes `datas`.

    CPU tensors get the plain version. CUDA tensors go through the generated
    kernel, which writes `outs` (allocated when not given; they must not alias
    the inputs); any failure raises. ``multi_stencil_3d.launches`` counts
    kernel launches.
    """
    return run_pass(multi_stencil_3d, datas, spec, outs)


multi_stencil_3d.launches = 0


# -- the ladder window ------------------------------------------------------------------------
def make_chunked_multi_window_3d(
    grid, make_step: Callable, halo_per_step: int, n_fields: int, *, dtype=torch.float32,
) -> Callable:
    """Return ``window(datas, steps) -> list`` advancing `steps` Euler steps
    through :func:`multi_stencil_3d` passes over the program's ladder (see
    :func:`~.cuda_stencil_2d.ladder_window`); the window also carries its
    ``program``."""
    program = StencilProgram3D(grid, make_step, halo_per_step, n_fields)
    window = ladder_window(
        [multi_stencil_spec(program, kk, dtype) for kk in program.ladder], multi_stencil_3d
    )
    window.program = program
    return window


def make_chunked_multi_window(
    grid, make_step: Callable, halo_per_step: int, n_fields: int, *, dtype=torch.float32,
) -> Callable:
    """The ladder window of the generated kernel of the grid's rank."""
    factory = make_chunked_multi_window_3d if grid.num_axes == 3 else make_chunked_multi_window_2d
    return factory(grid, make_step, halo_per_step, n_fields, dtype=dtype)
