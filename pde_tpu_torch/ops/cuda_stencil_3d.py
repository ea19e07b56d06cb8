"""Temporally blocked multi-field stencil windows on 3D grids: generated CUDA
kernel, plain version, replay of the kernel's march, ladder.

Port of the 3D expression-compiler path of :mod:`pde_tpu.ops.pallas_cartesian`:
the in-kernel helpers ``_make_stencil_helpers_3d``, the kernels
``make_fused_multi_stencil_window_3d`` and ``_make_ychunk_multi_window_3d``
(the same function cut two ways for VMEM; one Hopper kernel serves both) and
the ladder window ``make_chunked_multi_window_3d``. A window advances n
coupled scalar volumes by k explicit Euler steps of an arbitrary rhs per pass
over device memory.

The rhs is lowered once by ``make_step(helpers)`` against the n-D helpers of
:mod:`.cuda_stencil_2d`: :class:`~.cuda_stencil_2d.PlainHelpers` on whole
volumes (the plain version, which the wrapper runs for CPU tensors) and the
tracer, whose expression graph this module cuts into the stages of the
kernel's march (:func:`march_layout`) and emits as a ``Program`` struct
around the hand-written template ``csrc/multi_stencil_3d.cuh``, an
x-marching wavefront on the window geometry of ``csrc/march_3d.cuh``. Each
generated source instantiates every k of the ladder for float and double at
the plan :func:`.cuda_cartesian_3d.march_plan` picks for the program's
shared-memory slots, and is built with ``nvcc`` for ``sm_90a`` at first use
into ``pde_tpu_torch/_build/``, through
:func:`~.cuda_stencil_2d.build_programs`. :func:`multi_stencil_3d_marched`
replays the march's schedule in pure torch on the CPU.

Supported: a 3D ``CartesianGrid``, float32 or float64 volumes, periodic axes
or scalar constant affine BCs per operator. Everything else raises
:class:`KernelUnsupportedError` before anything is built.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch

from .cuda_cartesian import _ghost
from .cuda_cartesian_3d import (
    _MARCH,
    MarchWindow,
    check_block_counts,
    grid_window,
    march_blocks,
    march_plan,
)
from .cuda_stencil_2d import (
    _CSRC,
    _DTYPES,
    POINTWISE,
    MultiStencilSpec,
    StencilProgram,
    _CellBody,
    _ghost_expr,
    _laplace,
    _literal,
    _plan_ladder,
    ladder_window,
    make_chunked_multi_window_2d,
    multi_stencil_2d_plain,
    multi_stencil_spec,
    run_pass,
    stencil_axes,
)

#: halo cells per face of the ladder's top pass (k * depth), before the
#: shared-memory budget cuts it: the k of the least time per step of
#: Allen-Cahn 256³ on the H100 (``scripts/torch_multi3d_sweep.py``, PERF.md)
TOP_HALO = 3

# per axis: the low and high neighbour's names; the C expressions reading them
# from volume {v}'s operand planes at cell q; the flags saying the cell is next
# to the low or high face with ghosts
_AXES = (
    ("u", "d", "O.lo[{v}][q]", "O.hi[{v}][q]", "pf & pde_tpu_torch::kLowEdge",
     "pf & pde_tpu_torch::kHighEdge"),
    ("n", "s", "O.c[{v}][q - WZ]", "O.c[{v}][q + WZ]", "cf & pde_tpu_torch::kLowEdge",
     "cf & pde_tpu_torch::kHighEdge"),
    ("w", "e", "O.c[{v}][q - 1]", "O.c[{v}][q + 1]", "cf & pde_tpu_torch::kLowEdgeZ",
     "cf & pde_tpu_torch::kHighEdgeZ"),
)


# -- the march's stages ------------------------------------------------------------------------
@dataclass(frozen=True)
class MarchStage:
    """One stage of a step: it computes `nodes` into the volumes from `first`
    on (the last stage: the next step's fields), lagging the step's fields by
    `lag` planes, from the nodes held in volumes (`stored`: the fields and
    the earlier stages' nodes); `reads` maps each volume it reads to whether
    it reads that volume's x neighbours; `lines` and `values` are its C
    statements and the C names of its nodes."""

    lag: int
    first: int
    nodes: tuple
    stored: frozenset
    reads: dict
    lines: tuple
    values: tuple


@dataclass(frozen=True)
class MarchLayout:
    """A traced step cut into the march's stages: `volumes` maps a graph node
    (its index) to the volume that holds it (fields first, then the operand
    buffers in stage order), `lags` gives each volume's writer's lag and
    `slots` the shared-memory planes each volume keeps (from the newest plane
    down to the oldest one a reader still needs)."""

    stages: tuple
    volumes: dict
    lags: tuple
    slots: tuple

    @property
    def step_slots(self) -> int:
        return sum(self.slots)


def march_layout(program) -> MarchLayout:
    """Cut a traced 3D step into stages: the operand buffers grouped by depth
    (the stencil hops they take from the fields; each group lags the fields
    by its depth), then the next level of every field (lag ``depth``). A
    stencil operand is read on the plane before and after its reader's, so a
    stage's operands lag it by a plane at least."""
    nf = program.n_fields
    volumes = {n.index: n.args[0] for n in program.nodes if n.op == "field"}
    depths = sorted({n.depth for n in program.buffers})
    order = [n for d in depths for n in program.buffers if n.depth == d]
    volumes.update({n.index: nf + i for i, n in enumerate(order)})
    lags = (0,) * nf + tuple(n.depth for n in order)
    stages = []
    stored = frozenset(n.index for n in program.nodes if n.op == "field")
    groups = [([n for n in order if n.depth == d], d, False) for d in depths]
    for nodes, lag, output in groups + [(list(program.outputs), program.depth, True)]:
        body = _CellBody3D(program, volumes, stored)
        values = tuple(body.value(node) for node in nodes)
        first = 0 if output else volumes[nodes[0].index]
        stages.append(MarchStage(lag, first, tuple(nodes), stored, body.reads, tuple(body.lines),
                                 values))
        stored = stored | {n.index for n in nodes}
    slots = []
    for v, own in enumerate(lags):
        oldest = [st.lag - own + int(x) for st in stages for u, x in st.reads.items() if u == v]
        slots.append(1 + max(oldest, default=0))
    return MarchLayout(tuple(stages), volumes, lags, tuple(slots))


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

    def __init__(self, grid, make_step: Callable, depth: int, n_fields: int):
        super().__init__(grid, make_step, depth, n_fields)
        for tiles in self.tiles.values():
            for tile in tiles.values():
                check_block_counts(self.geometry.shape, tile)

    @functools.cached_property
    def march(self) -> MarchLayout:
        return march_layout(self)

    def plan_ladder(self) -> list[int]:
        """The ladder (top, top // 2, ..., 1), its top lowered one step at a time
        until an fp64 plan fits (a top of 3 that does not fit falls to 2, not 1)."""
        top = max(1, self.top_halo // self.depth)
        while top > 1 and self.tile_for(top, 8) is None:
            top -= 1
        return _plan_ladder(top, self.tile_for)

    def tile_for(self, k: int, itemsize: int):
        return march_plan(k, self.march.step_slots, k * self.depth, itemsize)

    def emit(self) -> str:
        return emit_source_3d(self)


# -- the emitter -----------------------------------------------------------------------------
class _CellBody3D(_CellBody):
    """C++ statements computing graph nodes at one cell q of a window plane,
    from the operand planes ``O`` of the march's volumes; records which
    volumes it reads (``reads``: volume -> whether its x neighbours)."""

    def __init__(self, program, volumes: dict, stored: set):
        super().__init__(program, {})
        self.volumes, self.stored_nodes = volumes, stored
        self.reads: dict[int, bool] = {}

    def _read(self, node, x: bool = False) -> int:
        v = self.volumes[node.index]
        self.reads[v] = self.reads.get(v, False) or x
        return v

    def value(self, node) -> str:
        if node.index not in self.names and node.index in self.stored_nodes:
            return self._let(node, f"O.c[{self._read(node)}][q]")
        return super().value(node)

    def _stencil(self, node) -> str:
        geo = self.program.geometry
        operand, key = node.args
        axes = stencil_axes(node.op, 3)
        s = f"v{node.index}"
        v = self._read(operand, 0 in axes)
        c = f"O.c[{v}][q]"
        lines = self.lines
        for axis in axes:
            low, high, read_low, read_high = _AXES[axis][:4]
            lines.append(f"T {s}_{low} = {read_low.format(v=v)};")
            lines.append(f"T {s}_{high} = {read_high.format(v=v)};")
        if node.op == "lap":
            lines.append(f"const T {s}_c = {c};")
            c = f"{s}_c"
        for axis in axes:
            if key is None or key[axis] is None:
                continue
            low, high, _, _, at_lo, at_hi = _AXES[axis]
            lo, hi = key[axis]
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


def _select(var: str, values) -> str:
    """A C expression giving ``values[var]``."""
    expr = str(values[-1])
    for i in range(len(values) - 2, -1, -1):
        expr = f"{var} == {i} ? {values[i]} : {expr}"
    return expr


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
        "",
        "  __host__ __device__ static constexpr int stage_lag(int j) { return "
        f"{_select('j', [st.lag for st in stages])}; }}",
        "  __host__ __device__ static constexpr int stage_out(int j) { return "
        f"{_select('j', [st.first for st in stages])}; }}",
        "  __host__ __device__ static constexpr int stage_width(int j) { return "
        f"{_select('j', [len(st.nodes) for st in stages])}; }}",
        "  __host__ __device__ static constexpr int volume_slots(int v) { return "
        f"{_select('v', layout.slots)}; }}",
        "  __host__ __device__ static constexpr int volume_base(int v) { return "
        f"{_select('v', bases)}; }}",
    ]
    signature = ("(const pde_tpu_torch::MarchOperands<T, kVolumes>& O, int q, unsigned cf, "
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
    for dtype, (ctype, suffix, _) in _DTYPES.items():
        lines += [
            f"extern \"C\" int multi_stencil_3d_{suffix}(const void* const* ins, void* const* outs,",
            "                                 int nx, int ny, int nz, int k, void* stream) {",
            "  switch (k) {",
        ]
        for k in program.ladder:
            cx, ty, tz = program.tiles[dtype][k]
            lines.append(
                f"    case {k}: return pde_tpu_torch::launch_3d<Program, {ctype}, {k}, "
                f"{cx}, {ty}, {tz}>(ins, outs, nx, ny, nz, stream);"
            )
        lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


# -- replay of the kernel's march --------------------------------------------------------------
class _PlaneBody:
    """The emitted C of one stage, evaluated on a whole window plane in
    torch: ``own(v, dx)`` is volume v's plane at x offset dx as the thread
    of each column reads it, ``shared(v)`` its centre plane as the other
    threads see it (y and z neighbours); ``plane_edges`` the plane's x
    flags, ``edges`` the columns' y and z flags."""

    def __init__(self, program, layout: MarchLayout, stage: MarchStage, own, shared,
                 plane_edges, edges):
        self.program, self.layout, self.stored = program, layout, stage.stored
        self.own, self.shared = own, shared
        self.plane_edges, self.edges = plane_edges, edges
        self.values: dict[int, object] = {}

    def value(self, node):
        if node.index in self.values:
            return self.values[node.index]
        op, args = node.op, node.args
        if node.index in self.stored:
            result = self.own(self.layout.volumes[node.index], 0)
        elif op == "const":
            return args[0]
        elif op in ("+", "-", "*", "/"):
            a, b = self.value(args[0]), self.value(args[1])
            result = {"+": a + b, "-": a - b, "*": a * b, "/": a / b}[op]
        elif op == "neg":
            result = -self.value(args[0])
        elif op == "pow":
            result = torch.pow(self.value(args[0]), args[1])
        elif op == "func":
            result = POINTWISE[args[1]][0](self.value(args[0]))
        else:
            result = self._stencil(node)
        self.values[node.index] = result
        return result

    def _stencil(self, node):
        geo = self.program.geometry
        operand, key = node.args
        axes = stencil_axes(node.op, 3)
        v = self.layout.volumes[operand.index]
        center = self.own(v, 0)
        shared = self.shared(v)
        pairs = {}
        for axis in axes:
            if axis == 0:
                low, high = self.own(v, -1), self.own(v, 1)
            else:
                low, high = shared.roll(1, axis - 1), shared.roll(-1, axis - 1)
            if key is not None and key[axis] is not None:
                lo, hi = key[axis]
                at_lo, at_hi = self.plane_edges if axis == 0 else self.edges[axis - 1]
                low = torch.where(torch.as_tensor(at_lo), _ghost(lo, center, high), low)
                high = torch.where(torch.as_tensor(at_hi) & ~torch.as_tensor(at_lo),
                                   _ghost(hi, center, low), high)
            pairs[axis] = (low, high)
        if node.op == "lap":
            return _laplace(geo, center, *pairs.values())
        diffs = [(high - low) * geo.halves[axis] for axis, (low, high) in pairs.items()]
        if node.op == "gsq":
            total = None
            for d in diffs:
                total = d * d if total is None else total + d * d
            return total
        (diff,) = diffs
        return diff


def march_program_block(win: MarchWindow, program, k: int, planes: int, store) -> None:
    """One block's march of a program as the kernel schedules it
    (``march_program_3d`` of ``csrc/multi_stencil_3d.cuh``): iteration t
    stores level 0 of window plane t into its slot, then, for each step s
    and stage j, computes plane t - L (L = s * depth + the stage's lag, when
    t >= 2L) on the columns of ring depth L and more, each volume's planes
    going into a ring of its slots. Slots start as NaN, so a read of a cell
    the schedule has not written yet (or has overwritten) poisons the
    result; between two barriers the threads race, so a read of another
    thread's cell (a y or z neighbour) from a slot that any thread stores to
    in the same iteration reads NaN too. Ghosts are formed where they are
    read, from the flags, as the emitted C does. ``store(w, values, mask)``
    takes the last level of window plane w, one plane per field."""
    layout = program.march
    depth, nf = program.depth, program.n_fields
    wy, wz = win.load.shape
    dtype = win.read(0)[0].dtype
    nan = torch.full((wy, wz), float("nan"), dtype=dtype)
    zero = torch.zeros((), dtype=dtype)
    y = torch.arange(wy)[:, None]
    z = torch.arange(wz)[None, :]
    ring = torch.minimum(torch.minimum(y, wy - 1 - y), torch.minimum(z, wz - 1 - z))
    smem = {(s, v, r): nan.clone() for s in range(k) for v, n in enumerate(layout.slots)
            for r in range(n)}

    def slot(s, v, w):
        return (s, v, w % layout.slots[v])

    edges = ((win.edges[0], win.edges[1]), (win.edges[2], win.edges[3]))
    runs = [(s, st, s * depth + st.lag) for s in range(k) for st in layout.stages]
    for t in range(planes):
        # the stages that run in iteration t, with the slots each stores to
        # (None: the last level, which goes to device memory)
        running = []
        for s, st, lag in runs:
            if t >= 2 * lag:
                last = st is layout.stages[-1]
                keys = None if last and s + 1 == k else [
                    slot(s + 1 if last else s, st.first + i, t - lag) for i in range(len(st.nodes))]
                running.append((s, st, lag, keys))
        written = {slot(0, f, t) for f in range(nf)}.union(
            *(keys for *_, keys in running if keys is not None))
        load, _, _, _ = win.plane(t)
        for f, plane in enumerate(win.read(t)):
            smem[slot(0, f, t)] = torch.where(win.load & load, plane, zero)
        for s, st, lag, keys in running:
            w = t - lag
            _, x_domain, x_lo, x_hi = win.plane(w)

            def own(v, dx, s=s, w=w):
                return smem[slot(s, v, w + dx)]

            def shared(v, s=s, w=w):
                return nan if slot(s, v, w) in written else smem[slot(s, v, w)]

            body = _PlaneBody(program, layout, st, own, shared, (x_lo, x_hi), edges)
            active = ring >= lag
            inside = win.domain & x_domain
            values = [torch.where(active & inside, torch.as_tensor(body.value(n), dtype=dtype),
                                  zero) for n in st.nodes]
            if keys is None:
                store(w, values, active & win.out)
                continue
            for key, value in zip(keys, values):
                smem[key] = torch.where(active, value, smem[key])


def march_program_blocks(program, k: int, shape, tile, window: Callable, dtype) -> list:
    """Every block's :func:`march_program_block` at the plan `tile`;
    ``window(origin, halo)`` gives a block's :class:`MarchWindow`."""
    halo = k * program.depth
    return march_blocks(
        shape, halo, tile, lambda origin: window(origin, halo),
        lambda win, planes, store: march_program_block(win, program, k, planes, store),
        program.n_fields, dtype)


def multi_stencil_3d_marched(datas, spec: MultiStencilSpec, tile=None) -> list:
    """Pure-torch replay of the kernel's march, block by block (`tile`, the
    plan ``(cx, ty, tz)``, defaults to the kernel's): see
    :func:`march_program_block`. Cells no block writes stay NaN."""
    program = spec.program
    tile = spec.tile if tile is None else tuple(tile)
    geo = program.geometry
    return march_program_blocks(
        program, spec.k, spec.shape, tile,
        lambda origin, halo: grid_window(list(datas), spec.shape, geo.periodic, origin, tile,
                                         halo),
        datas[0].dtype)


# -- plain version, wrapper -----------------------------------------------------------------------
def multi_stencil_3d_plain(datas, spec: MultiStencilSpec) -> list:
    """k plain PyTorch steps on whole volumes."""
    return multi_stencil_2d_plain(datas, spec)


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
