"""Temporally blocked multi-field stencil windows on 3D grids: generated CUDA
kernel, plain version, replay of the kernel's march, ladder.

Port of the 3D expression-compiler path of :mod:`pde_tpu.ops.pallas_cartesian`:
the in-kernel helpers ``_make_stencil_helpers_3d``, the kernels
``make_fused_multi_stencil_window_3d`` and ``_make_ychunk_multi_window_3d``
(the same function cut two ways for VMEM; one Hopper kernel serves both) and
the ladder window ``make_chunked_multi_window_3d``. A window advances n
coupled scalar volumes by k explicit steps (Euler, RK4 or Adams-Bashforth) of
an arbitrary rhs per pass over device memory.

The rhs is lowered once by ``make_step(helpers)`` against the n-D helpers of
:mod:`.cuda_stencil_2d`: :class:`~.cuda_stencil_2d.PlainHelpers` on whole
volumes (the plain version, which the wrapper runs for CPU tensors) and the
tracer, whose expression graph :func:`.cuda_march.march_layout` cuts into the
stages of the kernel's march (shared with the 2D row march) and this module
emits as a ``Program`` struct around the hand-written template
``csrc/multi_stencil_3d.cuh``, an
x-marching wavefront on the window geometry of ``csrc/march_3d.cuh``. Each
generated source instantiates every k of the ladder for float and double at
the plan :func:`.cuda_cartesian_3d.march_plan` picks for the program's
shared-memory slots, and is built with ``nvcc`` for ``sm_90a`` at first use
into ``pde_tpu_torch/_build/``, through
:func:`~.cuda_stencil_2d.build_programs`. :func:`multi_stencil_3d_marched`
replays the march's schedule in pure torch on the CPU
(:func:`.cuda_march.march_program_block`, which replays the 2D march
too).

Supported: a 3D ``CartesianGrid``, float32 or float64 volumes, periodic axes
or constant affine BCs per operator. Their values and ghost factors may vary
over a face, in time, or (values) in both: ``pde_tpu``'s 3D side inputs
(``collect_bc_side_inputs_3d``), as :class:`~.cuda_stencil_2d.SideInputs`
with a face's table over its two axes; a program that reads them takes the
template's side-input kernel (``multi_stencil_sides_3d_kernel``), which
loads each input's values at a plane's columns with the plane, and a window
whose values depend on time is ``window(datas, t0, steps)``. Everything else
raises :class:`KernelUnsupportedError` before anything is built.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from .cuda_cartesian_3d import (
    _MARCH,
    check_block_counts,
    grid_window,
    march_blocks,
    march_plan,
)
from .cuda_march import MarchLayout, march_layout, march_program_block
from .cuda_stencil_2d import (
    _CSRC,
    _DTYPES,
    KernelUnsupportedError,
    MultiStencilSpec,
    SideInputs,
    StencilProgram,
    _side_constants,
    ladder_window,
    make_chunked_multi_window_2d,
    multi_stencil_2d_plain,
    multi_stencil_spec,
    run_pass,
    select_expr,
)

#: halo cells per face of the ladder's top pass (k * depth), before the
#: shared-memory budget cuts it: the k of the least time per step of
#: Allen-Cahn 256³ on the H100 (``scripts/torch_multi3d_sweep.py``, PERF.md)
TOP_HALO = 3
#: shared memory a k = 1 plan may take when none fits two blocks per SM (one
#: block per SM; the H100 lets a block opt in to 227 KiB): the RK4 programs,
#: whose four stages a step need four planes of halo and more volumes
SMEM_ONE_BLOCK = 216 * 1024

# the x march's neighbour reads (:class:`.cuda_march.MarchCellBody`), per axis:
# the low and high neighbour's names; the C expressions reading them from
# volume {v}'s operand planes at cell q (x from the planes before and after,
# y and z from the centre plane); the flags saying the cell is next to the low
# or high face with ghosts (plane flags ``pf``, column flags ``cf``)
_AXES = (
    ("u", "d", "O.lo[{v}][q]", "O.hi[{v}][q]", "pf & pde_tpu_torch::kLowEdge",
     "pf & pde_tpu_torch::kHighEdge"),
    ("n", "s", "O.c[{v}][q - WZ]", "O.c[{v}][q + WZ]", "cf & pde_tpu_torch::kLowEdge",
     "cf & pde_tpu_torch::kHighEdge"),
    ("w", "e", "O.c[{v}][q - 1]", "O.c[{v}][q + 1]", "cf & pde_tpu_torch::kLowEdgeZ",
     "cf & pde_tpu_torch::kHighEdgeZ"),
)


class StencilProgram3D(StencilProgram):
    """A traced step on a 3D grid with its kernel geometry: the march's
    stages and slots (:attr:`march`), its plans ``(cx, ty, tz)`` from
    :func:`.cuda_cartesian_3d.march_plan`, and the generated source of the
    template ``csrc/multi_stencil_3d.cuh``."""

    rank = 3
    library = "multi_stencil_3d"
    template = _CSRC / "multi_stencil_3d.cuh"
    headers = (_MARCH,)
    top_halo = TOP_HALO

    def __init__(self, grid, make_step: Callable, depth: int, n_fields: int, *,
                 carry: bool = False, sides: SideInputs | None = None):
        super().__init__(grid, make_step, depth, n_fields, carry=carry, sides=sides)
        for tiles in self.tiles.values():
            for tile in tiles.values():
                check_block_counts(self.geometry.shape, tile)

    @functools.cached_property
    def march(self) -> MarchLayout:
        return march_layout(self, _AXES)

    def plan_ladder(self) -> list[int]:
        try:
            return super().plan_ladder()
        except KernelUnsupportedError as err:
            raise KernelUnsupportedError(
                f"{err} (a 3D RK4 step of a two-deep rhs is ROADMAP §B.1 item 6)") from err

    def tile_for(self, k: int, itemsize: int):
        """The plan of a k-step pass: two blocks per SM, or at k = 1 one
        block per SM (:data:`SMEM_ONE_BLOCK`) where two do not fit."""
        slots = self.march.step_slots
        plan = march_plan(k, slots, k * self.depth, itemsize)
        if plan is None and k == 1:
            plan = march_plan(1, slots, self.depth, itemsize, budget=SMEM_ONE_BLOCK)
        return plan

    def emit(self) -> str:
        return emit_source_3d(self)

    def launch_args(self, spec) -> tuple[int, ...]:
        """The int arguments of the entry point for one pass: the volume's
        shape and k."""
        return (*spec.shape, spec.k)


# -- the emitter -----------------------------------------------------------------------------
def emit_program_3d(program: StencilProgram3D) -> list[str]:
    """The ``Program`` struct of one traced step, for the 3D template's march
    (both kernels call its stage functions)."""
    px, py, pz = (str(p).lower() for p in program.geometry.periodic)
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
        f"  static constexpr bool kXPeriodic = {px};",
        f"  static constexpr bool kYPeriodic = {py};",
        f"  static constexpr bool kZPeriodic = {pz};",
        *_side_constants(program.sides),
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
    operands = "kVolumes" if program.sides is None else "kVolumes, kSideInputs"
    signature = (f"(const pde_tpu_torch::MarchOperands<T, {operands}>& O, int q, unsigned cf, "
                 "unsigned pf, T* out)")
    for j, st in enumerate(stages):
        what = ("the next level of every field" if j + 1 == len(stages)
                else f"operand buffers of depth {st.lag}")
        lines += [
            "",
            f"  // stage {j}: {what}",
            "  template <int WZ, typename T>",
            f"  __device__ static __forceinline__ void stage{j}{signature} {{",
            "    (void)O;",
            "    (void)q;",
            "    (void)cf;",
            "    (void)pf;",
            *["    " + line for line in st.lines],
            *[f"    out[{i}] = {value};" for i, value in enumerate(st.values)],
            "  }",
        ]
    lines += [
        "",
        "  template <int J, int WZ, typename T>",
        f"  __device__ static __forceinline__ void stage{signature} {{",
        *[f"    {'if' if j == 0 else 'else if'} constexpr (J == {j}) stage{j}<WZ>(O, q, cf, pf, "
          "out);" for j in range(len(stages))],
        "  }",
        "};",
        "",
        "}  // namespace",
        "",
    ]
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
    sides = program.sides is not None
    launcher, extra = ("launch_sides_3d", "sides, steps, ") if sides else ("launch_3d", "")
    params = ("int nx, int ny, int nz, int k, const void* const* sides, const long long* steps, "
              "void* stream) {" if sides else "int nx, int ny, int nz, int k, void* stream) {")
    for dtype, (ctype, suffix, _) in _DTYPES.items():
        lines += [
            f"extern \"C\" int multi_stencil_3d_{suffix}(const void* const* ins, void* const* outs,",
            f"                                 {params}",
            "  switch (k) {",
        ]
        for k in program.ladder:
            cx, ty, tz = program.tiles[dtype][k]
            lines.append(
                f"    case {k}: return pde_tpu_torch::{launcher}<Program, {ctype}, {k}, "
                f"{cx}, {ty}, {tz}>(ins, outs, nx, ny, nz, {extra}stream);"
            )
        lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


# -- replay of the kernel's march --------------------------------------------------------------
def march_program_blocks(program, k: int, shape, tile, window: Callable, dtype,
                         sides=None) -> list:
    """Every block's :func:`.cuda_march.march_program_block` at the
    plan `tile`, reading the pass's side inputs `sides` where the program
    has them; ``window(origin, halo)`` gives a block's
    :class:`.cuda_march.MarchWindow`."""
    halo = k * program.depth
    return march_blocks(
        shape, halo, tile, lambda origin: window(origin, halo),
        lambda win, planes, store: march_program_block(win, program, k, planes, store, sides),
        program.n_fields, dtype)


def multi_stencil_3d_marched(datas, spec: MultiStencilSpec, tile=None, sides=None) -> list:
    """Pure-torch replay of the kernel's march, block by block (`tile`, the
    plan ``(cx, ty, tz)``, defaults to the kernel's; `sides` the pass's
    views of the program's side inputs): see
    :func:`.cuda_march.march_program_block`. Cells no block writes
    stay NaN."""
    program = spec.program
    tile = spec.tile if tile is None else tuple(tile)
    geo = program.geometry
    return march_program_blocks(
        program, spec.k, spec.shape, tile,
        lambda origin, halo: grid_window(list(datas), spec.shape, geo.periodic, origin, tile,
                                         halo),
        datas[0].dtype, sides)


# -- plain version, wrapper -----------------------------------------------------------------------
def multi_stencil_3d_plain(datas, spec: MultiStencilSpec, sides=None) -> list:
    """k plain PyTorch steps on whole volumes; `sides`: the pass's views of
    the program's side inputs, where it has them."""
    return multi_stencil_2d_plain(datas, spec, sides)


def multi_stencil_3d(datas, spec: MultiStencilSpec, outs=None, sides=None) -> list:
    """k steps of the spec's 3D program over the volumes `datas`, with the
    pass's views of its side inputs `sides`
    (:meth:`~.cuda_stencil_2d.SideInputs.for_pass`; required where the
    program has them).

    CPU tensors get the plain version. CUDA tensors go through the generated
    kernel (the side-input kernel where the program has side inputs), which
    writes `outs` (allocated when not given; they must not alias the
    inputs); any failure raises. ``multi_stencil_3d.launches`` counts kernel
    launches, ``.sides_launches`` those with side inputs.
    """
    return run_pass(multi_stencil_3d, datas, spec, outs, sides)


multi_stencil_3d.launches = 0
multi_stencil_3d.sides_launches = 0


# -- the ladder window ------------------------------------------------------------------------
def make_chunked_multi_window_3d(
    grid, make_step: Callable, halo_per_step: int, n_fields: int, *, dtype=torch.float32,
    carry: bool = False, sides: SideInputs | None = None, dt: float | None = None,
) -> Callable:
    """Return ``window(datas, steps) -> list`` advancing `steps` steps of
    ``make_step`` through :func:`multi_stencil_3d` passes over the program's
    ladder (see :func:`~.cuda_stencil_2d.ladder_window`); the window also
    carries its ``program``. With the side inputs `sides` the ghosts'
    per-face and time-dependent parts become the kernel's arguments; where
    they depend on time the window is ``window(datas, t0, steps)`` of step
    `dt` (``window.needs_t``; RK4's stages read theirs at ``t + dt/2`` and
    ``t + dt``), as ``pde_tpu``'s ``make_chunked_multi_window_3d``."""
    program = StencilProgram3D(grid, make_step, halo_per_step, n_fields, carry=carry,
                               sides=sides)
    window = ladder_window(
        [multi_stencil_spec(program, kk, dtype) for kk in program.ladder], multi_stencil_3d,
        program.sides, dt,
    )
    window.program = program
    return window


def make_chunked_multi_window(
    grid, make_step: Callable, halo_per_step: int, n_fields: int, *, dtype=torch.float32,
    carry: bool = False, sides=None, dt: float | None = None,
) -> Callable:
    """The ladder window of the generated kernel of the grid's rank."""
    factory = make_chunked_multi_window_3d if grid.num_axes == 3 else \
        make_chunked_multi_window_2d
    return factory(grid, make_step, halo_per_step, n_fields, dtype=dtype, carry=carry,
                   sides=sides, dt=dt)
