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
whose values depend on time is ``window(datas, t0, steps)``. A program
whose rings fit no plan (RK4 of a two-deep rhs: eight halo planes, 11-15
volumes) takes the template's layout that reads the fields from the pass's
input and keeps each volume in a compact plane (``Program::kInputPoints``;
:attr:`StencilProgram3D.input_points`), one step a pass. Everything else
raises :class:`KernelUnsupportedError` before anything is built.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from .cuda_cartesian_3d import (
    _MARCH,
    MARCH_CX,
    MARCH_TY,
    MARCH_TZ,
    MARCH_TZ_NARROW,
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
#: block per SM): the RK4 programs, whose four stages a step need four planes
#: of halo and more volumes
SMEM_ONE_BLOCK = 216 * 1024
#: shared memory a block may opt in to on the H100 (227 KiB): the compact
#: planes of the programs that read their fields from the pass's input (a
#: two-deep rhs's RK4 step: eight planes of halo, 11-15 volumes) take up to it
SMEM_MAX = 227 * 1024

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
# the same reads in a layout of compact planes: the march hands each stage its
# volumes' planes at the cell itself, and volume {v}'s rows are WZ - {d} wide
_COMPACT_AXES = (
    ("u", "d", "O.lo[{v}][0]", "O.hi[{v}][0]", *_AXES[0][4:]),
    ("n", "s", "O.c[{v}][-(WZ - {d})]", "O.c[{v}][WZ - {d}]", *_AXES[1][4:]),
    ("w", "e", "O.c[{v}][-1]", "O.c[{v}][1]", *_AXES[2][4:]),
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
    #: whether the stages read the fields at their cells from the pass's
    #: input, each volume in a compact plane (:func:`.cuda_march.march_layout`'s
    #: ``input_points``; the template's ``Program::kInputPoints``): set for a
    #: program whose rings fit no plan otherwise (RK4 of a two-deep rhs), whose
    #: one-step passes then also try the narrower z tiles of
    #: :data:`.cuda_cartesian_3d.MARCH_TZ_NARROW`
    input_points = False

    def __init__(self, grid, make_step: Callable, depth: int, n_fields: int, *,
                 carry: bool = False, sides: SideInputs | None = None):
        super().__init__(grid, make_step, depth, n_fields, carry=carry, sides=sides)
        for tiles in self.tiles.values():
            for tile in filter(None, tiles.values()):
                check_block_counts(self.geometry.shape, tile)

    @functools.cached_property
    def march(self) -> MarchLayout:
        if self.input_points:
            return march_layout(self, _COMPACT_AXES, True, centre="O.c[{v}][0]")
        return march_layout(self, _AXES)

    def plan_ladder(self) -> list[int]:
        """The ladder of :meth:`.StencilProgram.plan_ladder`; where no fp64
        plan fits even k = 1, the layout that reads the fields from the
        pass's input (:attr:`input_points`) at k = 1, whose fp64 plan may
        still be missing (:meth:`unplanned`). Raises where no fp32 plan fits
        either."""
        try:
            return super().plan_ladder()
        except KernelUnsupportedError:
            self.input_points = True
            self.__dict__.pop("march", None)  # reckon the rings again
        if self.tile_for(1, 4) is None:
            raise KernelUnsupportedError(self.unplanned(1, torch.float32))
        return [1]

    def tile_for(self, k: int, itemsize: int):
        """The plan of a k-step pass: two blocks per SM, or at k = 1 one
        block per SM (:data:`SMEM_ONE_BLOCK`) where two do not fit; with
        :attr:`input_points`, of the column tiles of :data:`MARCH_TY` by
        :data:`MARCH_TZ` and :data:`MARCH_TZ_NARROW` whose compact planes fit
        one block (:data:`SMEM_MAX`), the one that loads the fewest window
        cells a cell it writes (of two that load as many, the larger, then
        the wider along z)."""
        if self.input_points:
            fits = [(MARCH_CX, ty, tz) for ty in MARCH_TY for tz in (MARCH_TZ, *MARCH_TZ_NARROW)
                    if self.smem_bytes(1, (MARCH_CX, ty, tz), itemsize) <= SMEM_MAX]
            halo = 2 * self.depth
            return min(fits, default=None, key=lambda t: (
                (t[1] + halo) * (t[2] + halo) / (t[1] * t[2]), -t[1] * t[2], -t[2]))
        slots = self.march.step_slots
        plan = march_plan(k, slots, k * self.depth, itemsize)
        if plan is None and k == 1:
            plan = march_plan(1, slots, self.depth, itemsize, budget=SMEM_ONE_BLOCK)
        return plan

    def smem_bytes(self, k: int, tile, itemsize: int) -> int:
        """Shared memory of a k-step pass at the plan `tile`
        (``ProgramShape::kSmem``): each volume's ring of window planes, a
        compact volume's planes cut by its margin on every side."""
        layout = self.march
        wy, wz = (t + 2 * k * self.depth for t in tile[1:])
        margins = layout.margins or (0,) * len(layout.slots)
        return k * itemsize * sum(n * (wy - 2 * m) * (wz - 2 * m)
                                  for n, m in zip(layout.slots, margins))

    def unplanned(self, k: int, dtype) -> str:
        """Why no plan takes a k-step pass in `dtype`: the bytes its planes
        need at the narrowest plan, against the budget of one block per SM."""
        narrow = (MARCH_CX, MARCH_TY[-1], MARCH_TZ_NARROW[-1])
        need = self.smem_bytes(k, narrow, _DTYPES[dtype][2])
        return (f"The planes at k = {k} do not fit the kernel's shared memory in {dtype}: "
                f"{self.march.step_slots} planes a step need {need} bytes at the narrowest plan "
                f"{narrow}, past the {SMEM_MAX} bytes one block may take")

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
    if layout.input_points:
        points = [sum(1 << f for f in st.points) for st in stages]
        lines += [
            "  // the stages read the fields at their cells from the pass's input (one",
            "  // step a pass): a field's ring keeps only its readers' planes at lag 1;",
            "  // each volume's planes are compact, its margin off every side",
            "  static constexpr bool kInputPoints = true;",
            "  __host__ __device__ static constexpr unsigned stage_points(int j) { return "
            f"{select_expr('j', [f'{m}u' for m in points])}; }}",
            "  __host__ __device__ static constexpr int volume_margin(int v) { return "
            f"{select_expr('v', layout.margins)}; }}",
        ]
    operands = "kVolumes" if program.sides is None else "kVolumes, kSideInputs"
    if layout.input_points:
        operands = f"kVolumes, {'0' if program.sides is None else 'kSideInputs'}, kFields"
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
            if program.tiles[dtype][k] is None:  # no plan in this dtype (unplanned)
                continue
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
