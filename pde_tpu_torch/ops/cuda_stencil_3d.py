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
whose values depend on time is ``window(datas, t0, steps)``. A step whose
rings fit no plan (RK4 of a two-deep rhs: eight halo planes, 11-15 volumes)
is cut at its RK stages into passes (:func:`cut_step`,
:class:`PassProgram3D`): each a one-step march of the rhs's depth whose
inputs (the fields and the values of earlier passes it reads) differ from
its outputs, four launches a step, the values between them in device
memory. Everything else raises :class:`KernelUnsupportedError` before
anything is built.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from .cuda_cartesian_3d import (
    _MARCH,
    MARCH_CX,
    MARCH_TY,
    MARCH_TZ,
    check_block_counts,
    grid_window,
    march_blocks,
    march_plan,
)
from .cuda_march import MarchLayout, march_layout, march_program_block
from .cuda_stencil_2d import (
    _CSRC,
    _DTYPES,
    _STENCIL_AXES,
    POINTWISE,
    SMEM_BUDGET,
    KernelUnsupportedError,
    MultiStencilSpec,
    PlainHelpers,
    SideInputs,
    StencilProgram,
    _Node,
    _side_constants,
    _Tracer,
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
#: the deepest rhs (stencils an RK stage) whose cut step takes float64
MAX_STAGE_DEPTH_F64 = 2
#: blocks a pass's kernel asks to keep resident on an SM (``__launch_bounds__``),
#: which caps its registers at 64 a thread
PASS_MIN_BLOCKS = 2

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
    template ``csrc/multi_stencil_3d.cuh``. A step whose rings fit no plan
    is cut at its RK stages into :attr:`passes`, whose tiles a plan of the
    step lists."""

    rank = 3
    library = "multi_stencil_3d"
    template = _CSRC / "multi_stencil_3d.cuh"
    headers = (_MARCH,)
    top_halo = TOP_HALO
    #: whether the passes compute cells past their blocks (the ext kernel's)
    ext = False
    #: the RK stages a pass of a cut step takes (its depth in the stage's),
    #: in order of preference: each dtype takes the first whose passes all
    #: have plans in it. One, four passes a step of RK4, each a march of the
    #: rhs's depth whose rings fit two blocks an SM, the fastest a step
    #: serially of the layouts ``scripts/torch_rk4_3d_sweep.py`` times
    #: (PERF.md)
    pass_stages = (1,)
    #: the passes of a cut step (:class:`PassProgram3D`) by itemsize, None
    #: for a step marched whole
    cuts = None

    def __init__(self, grid, make_step: Callable, depth: int, n_fields: int, *,
                 carry: bool = False, sides: SideInputs | None = None):
        super().__init__(grid, make_step, depth, n_fields, carry=carry, sides=sides)
        for tiles in self.tiles.values():
            for plan in filter(None, tiles.values()):
                for tile in (plan if self.cuts else (plan,)):
                    check_block_counts(self.geometry.shape, tile)

    @functools.cached_property
    def march(self) -> MarchLayout:
        return march_layout(self, _AXES)

    @property
    def passes(self) -> list | None:
        """The passes of the cut step in float32, None for a step marched
        whole."""
        return None if self.cuts is None else self.cuts[4]

    def cut(self, dtype) -> list:
        """The passes of the cut step in `dtype`."""
        return self.cuts[_DTYPES[dtype][2]]

    def plan_ladder(self) -> list[int]:
        """The ladder of :meth:`.StencilProgram.plan_ladder`; where no fp64
        plan fits even k = 1 and the step has RK stages, the step cut into
        passes (:func:`cut_step`) at k = 1, in each dtype of the first of
        :attr:`pass_stages` whose passes all have plans in it, the fp64
        plans maybe still missing (:meth:`unplanned`). Raises where no fp32
        plan fits either."""
        try:
            return super().plan_ladder()
        except KernelUnsupportedError:
            if not self.geometry.marks:
                raise
        sizes = (4,) if self.stage_depth > MAX_STAGE_DEPTH_F64 else (4, 8)
        cuts = {}
        for stages in self.pass_stages:
            passes = cut_step(self, stages * self.stage_depth)
            for size in sizes:
                if size not in cuts and all(p.tile_for(1, size) for p in passes):
                    cuts[size] = passes
        self.cuts = {4: cuts.get(4, passes)}
        self.cuts[8] = cuts.get(8, self.cuts[4])
        if 4 not in cuts:
            raise KernelUnsupportedError(self.unplanned(1, torch.float32))
        return [1]

    @property
    def fp32_only(self) -> bool:
        """Whether the cut step is refused in float64: a rhs deeper than
        :data:`MAX_STAGE_DEPTH_F64`, as ``pde_tpu``'s fused 3D RK4 window
        refuses it in both dtypes."""
        return self.cuts is not None and self.stage_depth > MAX_STAGE_DEPTH_F64

    @property
    def stage_depth(self) -> int:
        """The depth of the step's first RK stage (k1 and y + dt/2 k1: the
        nodes traced before the first :meth:`bind_stage` mark)."""
        first = self.geometry.marks[0][1]
        return max(n.depth for n in self.nodes[:first])

    def tile_for(self, k: int, itemsize: int):
        """The plan of a k-step pass: two blocks per SM, or at k = 1 one
        block per SM (:data:`SMEM_ONE_BLOCK`) where two do not fit; of a cut
        step, its passes' plans, or None where one has none."""
        if self.cuts is not None:
            plans = tuple(p.tile_for(1, itemsize) for p in self.cuts[itemsize])
            return None if None in plans or (itemsize == 8 and self.fp32_only) else plans
        slots = self.march.step_slots
        plan = march_plan(k, slots, k * self.depth, itemsize)
        if plan is None and k == 1:
            plan = march_plan(1, slots, self.depth, itemsize, budget=SMEM_ONE_BLOCK)
        return plan

    def smem_bytes(self, k: int, tile, itemsize: int) -> int:
        """Shared memory of a k-step pass at the plan `tile`
        (``ProgramShape::kSmem``): each volume's ring of window planes."""
        wy, wz = (t + 2 * k * self.depth for t in tile[1:])
        return k * itemsize * self.march.step_slots * wy * wz

    def unplanned(self, k: int, dtype) -> str:
        """Why no plan takes a k-step pass in `dtype`: the bytes its planes
        (a cut step's widest pass's) need at the narrowest plan, against the
        budget of one block per SM."""
        itemsize = _DTYPES[dtype][2]
        narrow = (MARCH_CX, MARCH_TY[-1], MARCH_TZ)
        if itemsize == 8 and self.fp32_only:
            return (f"A 3D RK4 step of a rhs {self.stage_depth} stencils deep takes the kernel in "
                    f"float32 only: pde_tpu's fused 3D RK4 window refuses it (its band check), "
                    f"and the port's float64 passes are not built")
        if self.cuts is not None:
            program = max(self.cuts[itemsize], key=lambda p: p.smem_bytes(1, narrow, itemsize))
            what = f"pass {program.index} of the cut step keeps {program.march.step_slots} planes"
        else:
            program, what = self, f"{self.march.step_slots} planes a step"
        need = program.smem_bytes(k, narrow, itemsize)
        return (f"The planes at k = {k} do not fit the kernel's shared memory in {dtype}: "
                f"{what}, {need} bytes at the narrowest plan {narrow}, past the "
                f"{SMEM_ONE_BLOCK} bytes one block may take")

    def emit(self) -> str:
        return emit_source_3d(self)

    def launch_args(self, spec) -> tuple[int, ...]:
        """The int arguments of the entry point for one pass: the volume's
        shape and k."""
        return (*spec.shape, spec.k)

    def load(self, path: str) -> ctypes.CDLL:
        if self.cuts is None:
            return super().load(path)
        lib = ctypes.CDLL(path)
        for name in pass_entry_points(self):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 4,
                           *[ctypes.c_void_p] * (2 if self.sides is not None else 0),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        return lib

    def temporaries(self, shape, dtype, device) -> dict:
        """The volumes the passes of a cut step hand on (by node index), on
        `device`: made once per shape, dtype and device, zeroed, and reused
        by every step (a step's passes run in order on one stream)."""
        cache = self.__dict__.setdefault("_temporaries", {})
        key = (tuple(shape), dtype, torch.device(device))
        if key not in cache:
            cache[key] = {i: torch.zeros(tuple(shape), dtype=dtype, device=device)
                          for p in self.cut(dtype)[:-1] for i in p.writes}
        return cache[key]


# -- the cut of a step into passes ---------------------------------------------------------------
def _free(node) -> bool:
    """Whether a node is recomputed in any pass from the fields (a field, a
    constant, a pointwise value of the fields)."""
    return node.op in ("field", "const") or node.depth == 0


def cut_step(program: StencilProgram3D, pass_depth: int) -> list:
    """Cut a traced step at the boundaries of depth ``pass_depth * q`` into
    passes of `pass_depth` (the RK stages: :attr:`StencilProgram3D.stage_depth`
    a stage), each a :class:`PassProgram3D`.

    At each boundary the values that cross it are the nodes of that depth
    that a deeper node reads (directly or through nodes of that depth), less
    the pointwise ones that are functions of the others and of the fields:
    those the next pass recomputes (``y + dt/2 k1`` from ``y`` and ``k1``).
    RK4 of a two-deep rhs crosses ``k1``; ``k2`` and ``k1 + 2 k2``; ``k3``
    and ``k1 + 2 k2 + 2 k3``. Pass i reads the step's fields and the values
    of earlier passes it needs, and writes those a later pass reads (the
    last pass: the step's outputs), in the step's order of operations, so
    the passes composed equal the step bit for bit."""
    nodes = program.nodes
    n_passes = -(-program.depth // pass_depth)
    readers: dict[int, list] = {n.index: [] for n in nodes}
    for n in nodes:
        for a in n.args:
            if isinstance(a, _Node):
                readers[a.index].append(n)
    kept: dict[int, int] = {}  # a crossing value's node index -> the pass that writes it
    for q in range(1, n_passes):
        level = q * pass_depth
        at = [n for n in nodes if n.depth == level and not _free(n)]
        crossing: set[int] = set()
        for n in reversed(at):  # a node's readers come after it
            if any(r.depth > level or r.index in crossing for r in readers[n.index]):
                crossing.add(n.index)
        for n in reversed(at):
            if n.index in crossing and n.op not in _STENCIL_AXES and all(
                    not isinstance(a, _Node) or _free(a) or a.index in crossing for a in n.args):
                crossing.discard(n.index)
        kept.update(dict.fromkeys(crossing, q))
    cut = {}
    needed: set[int] = set()  # values the passes after the current one read
    for p in range(n_passes, 0, -1):
        writes = list(program.outputs) if p == n_passes else [
            nodes[i] for i in sorted(needed) if kept[i] == p]
        if not writes:
            raise KernelUnsupportedError(f"Pass {p - 1} of the cut step would write nothing")
        reads, seen, stack = set(), set(), list(writes)
        while stack:
            for a in stack.pop().args:
                if not isinstance(a, _Node) or a.index in seen:
                    continue
                seen.add(a.index)
                if a.index in kept and kept[a.index] < p:
                    reads.add(a.index)
                elif a.op != "field":
                    stack.append(a)
        needed |= reads
        cut[p] = (sorted(reads), writes)
    extents = [pass_depth * (n_passes - p) if program.ext else 0 for p in range(1, n_passes + 1)]
    return [PassProgram3D(program, p - 1, [nodes[i] for i in cut[p][0]], cut[p][1], pass_depth,
                          extent) for p, extent in zip(range(1, n_passes + 1), extents)]


class PassProgram3D(StencilProgram3D):
    """Pass `index` of a cut step: the step's nodes that the pass computes,
    traced again over its inputs (the step's fields, then the values of
    earlier passes it reads: `reads`, step node indices) into its outputs
    (`writes`; the last pass's are the step's fields' next level), a program
    of depth `depth` (its halo) for the x march at k = 1. The template takes
    it through ``Program::kInputs``, ``kOutputs`` and ``kExtent`` (the cells
    it computes past its block in the ext kernel, `extent`). Its plain
    version (:func:`pass_plain`) evaluates the same graph on whole volumes."""

    def __init__(self, step: StencilProgram3D, index: int, reads: list, writes: list,
                 depth: int, extent: int):
        tracer = _Tracer(step.grid)
        tracer.sides = step.sides
        self.step, self.index, self.extent = step, index, extent
        self.reads = tuple(n.index for n in reads)
        self.writes = tuple(n.index for n in writes)
        mapping = {n.index: tracer.make("field", n.args[0])
                   for n in step.nodes if n.op == "field"}
        mapping.update({n.index: tracer.make("field", step.n_fields + i)
                        for i, n in enumerate(reads)})

        def replay(node):
            if node.index not in mapping:
                args = [replay(a) if isinstance(a, _Node) else a for a in node.args]
                mapping[node.index] = tracer.make(node.op, *args)
            return mapping[node.index]

        self.outputs = [replay(n) for n in writes]
        if max(out.depth for out in self.outputs) > depth:
            raise KernelUnsupportedError(
                f"Pass {index} of the cut step reaches past its halo of {depth} cells")
        self.grid, self.make_step, self.depth = step.grid, None, depth
        self.n_fields = step.n_fields + len(reads)
        self.carry, self.geometry, self.nodes = step.carry, tracer, tracer.nodes
        self.sides = step.sides
        operands = {n.args[0].index: n.args[0] for n in self.nodes if n.op in _STENCIL_AXES}
        self.buffers = [n for i, n in sorted(operands.items()) if n.op != "field"]
        self.ladder = [1]
        self.tiles = {dtype: {1: self.tile_for(1, size)} for dtype, (_, _, size) in _DTYPES.items()}

    @property
    def min_blocks(self) -> int:
        """``Program::kMinBlocks``: :data:`PASS_MIN_BLOCKS` where every
        dtype's plan fits two blocks' shared memory an SM, else one."""
        fits = all(plan is not None and self.smem_bytes(1, plan, _DTYPES[dtype][2])
                   <= SMEM_BUDGET for dtype, plan in ((d, t[1]) for d, t in self.tiles.items()))
        return PASS_MIN_BLOCKS if fits else 1

    def plain(self, ins, sides=None) -> list:
        """The pass's plain version (:func:`pass_plain`)."""
        return pass_plain(self, ins, sides)


# -- the emitter -----------------------------------------------------------------------------
def emit_program_3d(program: StencilProgram3D) -> list[str]:
    """The ``Program`` struct of one traced step (or a pass of a cut step),
    for the 3D template's march (both kernels call its stage functions)."""
    px, py, pz = (str(p).lower() for p in program.geometry.periodic)
    layout = program.march
    stages = layout.stages
    n_volumes = len(layout.slots)
    bases = [sum(layout.slots[:v]) for v in range(n_volumes)]
    counts = [f"  static constexpr int kFields = {program.n_fields};"]
    if isinstance(program, PassProgram3D):
        counts = [
            "  // a pass of a cut step: its inputs (the step's fields, then the values",
            "  // of earlier passes it reads), its outputs, the cells it computes past",
            "  // its block (the ext kernel's) and the blocks it keeps on an SM",
            f"  static constexpr int kInputs = {program.n_fields};",
            f"  static constexpr int kOutputs = {len(program.outputs)};",
            f"  static constexpr int kExtent = {program.extent};",
            f"  static constexpr int kMinBlocks = {program.min_blocks};",
        ]
    lines = [
        "namespace {",
        "",
        "struct Program {",
        *counts,
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


def pass_entry_points(program: StencilProgram3D) -> list[str]:
    """The C entry points of a cut step's library: per dtype, one a pass of
    that dtype's cut."""
    return [f"{program.library}_p{p.index}_{suffix}" for _, suffix, size in _DTYPES.values()
            for p in program.cuts[size]]


def emit_units(program: StencilProgram3D) -> list:
    """The program structs of a source and their entry points: ``(lines,
    the struct's C name, its entry points' stem, its tiles by dtype and k,
    its ladder)``, one for a step marched whole; for a cut step, one a pass
    of each dtype's cut (in a namespace ``pass<i>``, ``pass<i>_f64`` for a
    float64 cut other than the float32 one), its tiles those of the dtypes
    whose cut it is."""
    if program.cuts is None:
        return [(emit_program_3d(program), "Program", program.library, program.tiles,
                 program.ladder)]
    groups: dict[int, tuple] = {}
    for dtype, (_, _, size) in _DTYPES.items():
        groups.setdefault(id(program.cuts[size]), (program.cuts[size], []))[1].append(dtype)
    units = []
    for passes, dtypes in groups.values():
        tag = "" if passes is program.passes else "".join(f"_{_DTYPES[d][1]}" for d in dtypes)
        for p in passes:
            name = f"pass{p.index}{tag}"
            units.append(([f"namespace {name} {{", *emit_program_3d(p),
                           f"}}  // namespace {name}", ""], f"{name}::Program",
                          f"{program.library}_p{p.index}",
                          {d: {1: program.tiles[d][1] and p.tiles[d][1]} for d in dtypes}, [1]))
    return units


def emit_source_3d(program: StencilProgram3D) -> str:
    """The CUDA C++ source of one traced 3D step: a program struct for the
    template's kernel (one a pass of a cut step), and the plain C entry
    points."""
    units = emit_units(program)
    lines = [
        "// Generated by pde_tpu_torch/ops/cuda_stencil_3d.py from a traced step;",
        "// the kernel is the template in pde_tpu_torch/csrc/multi_stencil_3d.cuh.",
        '#include "multi_stencil_3d.cuh"',
        "",
        *[line for unit in units for line in unit[0]],
    ]
    sides = program.sides is not None
    launcher, extra = ("launch_sides_3d", "sides, steps, ") if sides else ("launch_3d", "")
    params = ("int nx, int ny, int nz, int k, const void* const* sides, const long long* steps, "
              "void* stream) {" if sides else "int nx, int ny, int nz, int k, void* stream) {")
    for _, struct, stem, tiles, ladder in units:
        for dtype in tiles:
            ctype, suffix, _ = _DTYPES[dtype]
            lines += [
                f"extern \"C\" int {stem}_{suffix}(const void* const* ins, void* const* outs,",
                f"                                 {params}",
                "  switch (k) {",
            ]
            for k in ladder:
                if tiles[dtype][k] is None:  # no plan in this dtype (unplanned)
                    continue
                cx, ty, tz = tiles[dtype][k]
                lines.append(
                    f"    case {k}: return pde_tpu_torch::{launcher}<{struct}, {ctype}, {k}, "
                    f"{cx}, {ty}, {tz}>(ins, outs, nx, ny, nz, {extra}stream);"
                )
            lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


# -- the plain version of a pass -----------------------------------------------------------------
def _align(a, b):
    """Two operands of a pointwise operation, the larger cropped about its
    centre to the smaller (a tile's arrays shrink a cell a side a stencil,
    which the lowering's trims align)."""
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)) or a.shape == b.shape:
        return a, b
    crop = [(x - y) // 2 for x, y in zip(a.shape, b.shape)]
    if crop[0] > 0:
        return a[tuple(slice(c, c + n) for c, n in zip(crop, b.shape))], b
    return a, b[tuple(slice(-c, -c + n) for c, n in zip(crop, a.shape))]


_BINARY = {"+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
           "/": lambda a, b: a / b}


def evaluate(program, helpers, inputs) -> list:
    """The program's outputs from its inputs (one tensor per field volume),
    its graph evaluated node by node with `helpers`' stencils: whole volumes
    (:class:`.cuda_stencil_2d.PlainHelpers`), or a tile's shrinking arrays
    (:class:`.cuda_stencil_2d.TileHelpers`), in the lowering's order of
    operations; a constant output fills a volume like the first input."""
    values: dict[int, object] = {}
    stencils = {"lap": helpers.lap, "gsq": helpers.gradient_squared, "drow": helpers.d_row,
                "dcol": helpers.d_col, "ddep": helpers.d_depth}

    def value(node):
        if not isinstance(node, _Node):
            return node
        if node.index not in values:
            op, args = node.op, node.args
            if op == "field":
                result = inputs[args[0]]
            elif op == "const":
                result = args[0]
            elif op in _BINARY:
                result = _BINARY[op](*_align(value(args[0]), value(args[1])))
            elif op == "neg":
                result = -value(args[0])
            elif op == "pow":
                result = torch.pow(value(args[0]), args[1])
            elif op == "func":
                result = POINTWISE[args[1]][0](value(args[0]))
            elif op in stencils:
                result = stencils[op](value(args[0]), args[1])
            else:
                raise KernelUnsupportedError(f"No plain evaluation of `{op}` in a pass")
            values[node.index] = result
        return values[node.index]

    outs = [value(out) for out in program.outputs]
    return [out if isinstance(out, torch.Tensor) else torch.full_like(inputs[0], float(out))
            for out in outs]


def pass_plain(program: PassProgram3D, ins, sides=None) -> list:
    """One pass of a cut step on whole volumes: `ins` the pass's inputs,
    `sides` the pass's views of the step's side inputs."""
    helpers = PlainHelpers(program.grid)
    helpers.sides, helpers.side_views = program.sides, sides
    return evaluate(program, helpers, list(ins))


def run_cut(passes: list, datas, run: Callable) -> list:
    """A cut step's `passes` in order from the fields `datas`: ``run(p,
    ins)`` runs pass p on its inputs and returns its outputs, which this
    hands on to the passes that read them; returns the last pass's
    outputs."""
    held = {}
    for p in passes:
        ins = list(datas) + [held[i] for i in p.reads]
        outs = run(p, ins)
        held.update(zip(p.writes, outs))
    return outs


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
        len(program.outputs), dtype)


def pass_marched(program: PassProgram3D, ins, tile, sides=None) -> list:
    """Pure-torch replay of one pass's march over whole volumes (the serial
    kernel) at the plan `tile`; cells no block writes stay NaN."""
    geo = program.geometry
    shape = tuple(ins[0].shape)
    return march_program_blocks(
        program, 1, shape, tile,
        lambda origin, halo: grid_window(list(ins), shape, geo.periodic, origin, tile, halo),
        ins[0].dtype, sides)


def multi_stencil_3d_marched(datas, spec: MultiStencilSpec, tile=None, sides=None) -> list:
    """Pure-torch replay of the kernel's march, block by block (`tile`, the
    plan ``(cx, ty, tz)``, defaults to the kernel's; of a cut step, every
    pass at `tile`, or each at its own plan; `sides` the pass's views of the
    program's side inputs): see :func:`.cuda_march.march_program_block`.
    Cells no block writes stay NaN."""
    program = spec.program
    if program.cuts is not None:
        passes = program.cut(spec.dtype)
        tiles = spec.tile if tile is None else (tuple(tile),) * len(passes)
        return run_cut(passes, datas, lambda p, ins: pass_marched(p, ins, tiles[p.index], sides))
    tile = spec.tile if tile is None else tuple(tile)
    geo = program.geometry
    return march_program_blocks(
        program, spec.k, spec.shape, tile,
        lambda origin, halo: grid_window(list(datas), spec.shape, geo.periodic, origin, tile,
                                         halo),
        datas[0].dtype, sides)


# -- plain version, wrapper -----------------------------------------------------------------------
def multi_stencil_3d_plain(datas, spec: MultiStencilSpec, sides=None) -> list:
    """k plain PyTorch steps on whole volumes (a cut step's too: the traced
    step's plain version, independent of the cut); `sides`: the pass's
    views of the program's side inputs, where it has them."""
    return multi_stencil_2d_plain(datas, spec, sides)


def multi_stencil_3d(datas, spec: MultiStencilSpec, outs=None, sides=None) -> list:
    """k steps of the spec's program over the volumes `datas`, with the
    pass's views of its side inputs `sides` (required where it has them).

    CPU tensors get the plain version. CUDA tensors go through the generated
    kernel (the side-input kernel where the program has side inputs), which
    writes `outs` (allocated when not given; they must not alias the
    inputs); a cut step launches its passes in turn (:func:`multi_stencil_3d_pass`),
    the values between them in :meth:`StencilProgram3D.temporaries`; any
    failure raises. ``multi_stencil_3d.launches`` counts kernel launches
    (a cut step's: one a pass, also counted by pass in ``.pass_launches``),
    ``.sides_launches`` those with side inputs.
    """
    program = spec.program
    datas = list(datas)
    if program.cuts is None or not datas or datas[0].device.type != "cuda":
        return run_pass(multi_stencil_3d, datas, spec, outs, sides)
    temps = program.temporaries(spec.shape, spec.dtype, datas[0].device)
    passes = program.cut(spec.dtype)

    def launch(p, ins):
        targets = outs if p is passes[-1] else [temps[i] for i in p.writes]
        return multi_stencil_3d_pass(p, ins, spec, targets, sides)

    return run_cut(passes, datas, launch)


multi_stencil_3d.launches = 0
multi_stencil_3d.sides_launches = 0
#: launches of a cut step's passes, by pass index
multi_stencil_3d.pass_launches = {}


def multi_stencil_3d_pass(program: PassProgram3D, ins, spec: MultiStencilSpec, outs=None,
                          sides=None) -> list:
    """One pass of the cut step `spec.program` over whole volumes: `ins` its
    inputs (the step's fields, then the values it reads), `outs` its
    outputs (allocated when not given; not aliasing `ins`). CPU tensors get
    :func:`pass_plain`; CUDA tensors the pass's entry point in the step's
    library, counted in ``multi_stencil_3d.launches`` and ``.pass_launches``;
    any failure raises."""
    return run_pass(multi_stencil_3d, ins, spec, outs, sides, unit=program)


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
