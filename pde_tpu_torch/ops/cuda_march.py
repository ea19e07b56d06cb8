"""The rank-free parts of the marching wavefront kernels.

The generated multi-field kernels march along their first axis: the 3D ones
along x plane by plane (``csrc/multi_stencil_3d.cuh``), the 2D ones down the
rows (``csrc/march_2d.cuh``). Both cut one traced Euler step into stages and
keep each stored volume in a ring of shared-memory planes (rows in 2D):
:func:`march_layout` reckons both from the expression graph of a
:class:`.cuda_stencil_2d.StencilProgram`, emitting each stage through
:class:`MarchCellBody` with the rank's table of neighbour reads, and
:func:`march_program_block` replays one block's march in pure torch on the
:class:`MarchWindow` the rank's geometry gives.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Callable

import torch

from .cuda_cartesian import _ghost, compute_dtype, round_level
from .cuda_stencil_2d import (
    POINTWISE,
    ROW_VALUES,
    _CellBody,
    _STENCIL_AXES,
    _Node,
    _ghost_expr,
    _laplace,
    _literal,
    _sum_of_squares,
    along,
    is_side_ref,
    radial_values,
    stencil_axes,
)


@dataclass(frozen=True)
class MarchStage:
    """One stage of a step: it computes `nodes` into the volumes from `first`
    on (the last stage: the next step's fields), lagging the step's fields by
    `lag` planes, from the nodes held in volumes (`stored`: the fields and
    the earlier stages' nodes); `reads` maps each volume it reads from its
    ring to whether it reads that volume's neighbours along the march axis;
    `lines` and `values` are its C statements and the C names of its nodes.
    A stage of lag 0 (in a pass of a cut step, whose stencils read pointwise
    values of its inputs such as ``y + dt/2 k1``) computes the plane just
    brought in."""

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


def march_layout(program, axes: tuple) -> MarchLayout:
    """Cut a traced step into stages: the operand buffers grouped by depth
    (the stencil hops they take from the fields; each group lags the fields
    by its depth), then the next level of every field (lag ``depth``). A
    stencil operand is read on the plane before and after its reader's, so a
    stage's operands lag it by a plane at least.

    A value a stage needs that an earlier stage could compute (a node of
    depth 1 or more below the stage's lag, such as RK4's ``k1 + 2 k2`` in its
    output stage) is recomputed from its operands, unless ``program.carry``
    is set: then each such value goes into a volume of its own, computed by
    the first stage whose lag reaches its depth and read back pointwise
    (:func:`carried_nodes`).

    Each stage is emitted through a :class:`MarchCellBody` with the rank's
    neighbour reads `axes`. A buffer of depth 0 (in a pass of a cut step: a
    pointwise value of the pass's inputs that a stencil reads) is a stage of
    lag 0."""
    nf = program.n_fields
    depths = sorted({n.depth for n in program.buffers})
    groups = [[n for n in program.buffers if n.depth == d] for d in depths]
    if program.carry:
        for group, extra in zip(groups, carried_nodes(program, depths, groups)):
            group.extend(extra)
    volumes = {n.index: n.args[0] for n in program.nodes if n.op == "field"}
    order = [n for group in groups for n in group]
    volumes.update({n.index: nf + i for i, n in enumerate(order)})
    lags = (0,) * nf + tuple(d for d, group in zip(depths, groups) for _ in group)
    stages = []
    stored = frozenset(n.index for n in program.nodes if n.op == "field")
    for nodes, lag, output in [(g, d, False) for g, d in zip(groups, depths)] + [
            (list(program.outputs), program.depth, True)]:
        body = MarchCellBody(program, volumes, stored, axes)
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


def carried_nodes(program, depths: list, groups: list) -> list[list]:
    """The values each buffer stage also stores for a later stage, by stage:
    walking each stage's expressions from the last stage back, a node that is
    not stored, whose depth d is at least 1 and below the stage's lag, whose
    value takes a stencil to recompute (not a pointwise function of stored
    volumes), and that an earlier stage can compute (one whose lag is d or
    more), goes to the first such stage; the walk does not descend into it
    (its own operands are that stage's business)."""
    lags = list(depths) + [program.depth]
    extra: list[list] = [[] for _ in depths]
    stored = {n.index for n in program.nodes if n.op == "field"}
    stored |= {n.index for group in groups for n in group}

    @functools.cache
    def stencil_below(node) -> bool:
        """Whether recomputing `node` from the stored volumes takes a stencil."""
        if node.index in stored:
            return False
        return node.op in _STENCIL_AXES or any(
            stencil_below(a) for a in node.args if isinstance(a, _Node))

    for j in reversed(range(len(lags))):
        roots = list(program.outputs) if j == len(depths) else groups[j] + extra[j]
        seen = set()
        stencil_below.cache_clear()

        def walk(node, root=False, j=j):
            if not isinstance(node, _Node):
                return
            if not root:
                if node.index in stored or node.index in seen:
                    return
                target = next((i for i, lag in enumerate(lags[:j]) if lag >= node.depth), None)
                if 1 <= node.depth < lags[j] and target is not None and stencil_below(node):
                    extra[target].append(node)
                    stored.add(node.index)
                    return
            seen.add(node.index)
            for arg in node.args:
                walk(arg)

        for root in roots:
            walk(root, root=True)
    return extra


def pad_rings(layout: MarchLayout, cap: int) -> MarchLayout:
    """`layout` with its rings lengthened, where the least common multiple of
    their lengths (the period a march unrolls its row loop by) passes `cap`:
    each ring takes the least divisor of a period P that holds it, P the
    length from the longest ring up to twice it that needs the fewest rows
    (then the least P). A longer ring holds every row a shorter one does."""
    if math.lcm(*layout.slots) <= cap:
        return layout
    longest = max(layout.slots)

    def padded(period):
        divisors = [d for d in range(1, period + 1) if period % d == 0]
        return tuple(min(d for d in divisors if d >= n) for n in layout.slots)

    period = min(range(longest, 2 * longest + 1), key=lambda p: (sum(padded(p)), p))
    return replace(layout, slots=padded(period))


class MarchCellBody(_CellBody):
    """C++ statements computing graph nodes at one cell q of a marching
    kernel's window plane (row in 2D), from the operand planes ``O`` of the
    march's volumes; records which volumes it reads (``reads``: volume ->
    whether its neighbours along the march axis). ``axes`` gives, per axis,
    the low and high neighbour's names, the C expressions reading them from
    volume {v}'s operand planes at q, and the flags saying the cell is next to
    the low or high side with ghosts."""

    centre = "O.c[{v}][q]"

    def __init__(self, program, volumes: dict, stored: set, axes: tuple):
        super().__init__(program, {})
        self.volumes, self.stored_nodes, self.axes = volumes, stored, axes
        self.reads: dict[int, bool] = {}

    def _read(self, node, march: bool = False) -> int:
        v = self.volumes[node.index]
        self.reads[v] = self.reads.get(v, False) or march
        return v

    def value(self, node) -> str:
        if node.index not in self.names and node.index in self.stored_nodes:
            return self._let(node, self._format(self.centre, self._read(node)))
        if node.op == "radial" and node.index not in self.names:
            return self._let(node, self._radial(node.args[0]))
        return super().value(node)

    @staticmethod
    def _format(read: str, v: int) -> str:
        """The C read `read` of volume v."""
        return read.format(v=v)

    def _radial(self, kind: str) -> str:
        """The radial helper `kind` of the row being computed, one of the
        program's values of the row (read once a row from its table)."""
        return f"O.rv[{ROW_VALUES.index(kind)}]"

    def _side_read(self, index: int) -> str:
        """Side input `index` of the stage's row ``O.sp[i]``: a row side's at
        the cell's column q, a column side's and a time-dependent value at
        the row's entry. In 3D the march loads each input's value at a
        plane's columns with the plane: the cell's is ``O.sv[i]``."""
        if self.program.geometry.rank == 3:
            return f"O.sv[{index}]"
        return f"O.sp[{index}][{'q' if self.program.sides.kind(index) == 'row' else '0'}]"

    def _stencil(self, node) -> str:
        geo = self.program.geometry
        operand, key = node.args
        axes = stencil_axes(node.op, geo.rank)
        s = f"v{node.index}"
        v = self._read(operand, 0 in axes)
        c = self._format(self.centre, v)
        lines = self.lines
        for axis in axes:
            low, high, read_low, read_high = self.axes[axis][:4]
            lines.append(f"T {s}_{low} = {self._format(read_low, v)};")
            lines.append(f"T {s}_{high} = {self._format(read_high, v)};")
        if node.op == "lap":
            lines.append(f"const T {s}_c = {c};")
            c = f"{s}_c"
        for axis in axes:
            if key is None or key[axis] is None:
                continue
            low, high, _, _, at_lo, at_hi = self.axes[axis]
            lo, hi = key[axis]
            lines.append(
                f"if ({at_lo}) {s}_{low} = {_ghost_expr(lo, c, f'{s}_{high}', self._term)}; "
                f"else if ({at_hi}) {s}_{high} = {_ghost_expr(hi, c, f'{s}_{low}', self._term)};"
            )
        diffs = [
            f"({s}_{self.axes[axis][1]} - {s}_{self.axes[axis][0]}) * "
            f"{_literal(geo.halves[axis])}"
            for axis in axes
        ]
        if node.op == "lap" and geo.radial is not None:
            fac = self._radial("fac")
            (u, d), (lf, rt) = (self.axes[axis][:2] for axis in axes)
            expr = (f"({_literal(geo.sx)} - {fac}) * {s}_{u} + ({_literal(geo.sx)} + {fac}) * "
                    f"{s}_{d} + {_literal(geo.sy)} * ({s}_{lf} + {s}_{rt}) - "
                    f"{_literal(2.0 * (geo.sx + geo.sy))} * {c}")
        elif node.op == "lap":
            if len(set(geo.scales)) == 1:
                names = " + ".join(f"{s}_{name}" for axis in axes for name in self.axes[axis][:2])
                expr = f"({names} - T({2 * geo.rank}) * {c}) * {_literal(geo.scales[0])}"
            else:
                expr = " + ".join(
                    f"({s}_{self.axes[axis][0]} + {s}_{self.axes[axis][1]} - T(2) * {c}) * "
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


# -- replay of the marching kernels --------------------------------------------------------------
@dataclass
class MarchWindow:
    """One block's window as a marching kernel's threads see it (a window
    plane of (y, z) columns in 3D, a window row of columns in 2D): per window
    column whether it is read from the buffer, lies in the domain, sits next
    to a side with ghosts (``edges``: low and high per axis across the march,
    in axis order) and belongs to the output tile; ``plane(w)`` gives the same
    of window plane (row) w as ``(load, domain, low edge, high edge)``,
    ``read(w)`` the buffers' cells under it, one plane per buffer, and
    ``row(w)``, where given, its row of the grid (the radial modes' factors
    are the grid row's); ``cols``, where given, each window column's column
    of the grid (wrapped on a periodic axis, clamped otherwise: the side
    inputs of a row side are read there); in 3D the (y, z) pair of the
    window columns' grid coordinates, unwrapped, and ``row(w)`` window
    plane w's x (the faces' tables are read there)."""

    load: torch.Tensor
    domain: torch.Tensor
    edges: tuple
    out: torch.Tensor
    plane: Callable
    read: Callable
    row: Callable | None = None
    cols: torch.Tensor | tuple | None = None


class MarchBody:
    """The emitted C of one stage, evaluated on a whole window plane (row) in
    torch: ``own(v, dx)`` is volume v's plane at offset dx along the march as
    the thread of each column reads it, ``shared(v)`` its centre plane as the
    other threads see it (the neighbours across the march); ``plane_edges``
    the plane's flags, ``edges`` the columns' flags per axis across the
    march."""

    def __init__(self, program, layout: MarchLayout, stage: MarchStage, own, shared,
                 plane_edges, edges, row=None, dtype=None, resolve=None):
        self.program, self.layout, self.stored = program, layout, stage.stored
        self.own, self.shared = own, shared
        self.plane_edges, self.edges = plane_edges, edges
        #: the plane's grid row and the planes' dtype (the radial helpers)
        self.row, self.dtype = row, dtype
        #: a ghost term's value on the plane (the side inputs), where given
        self.resolve = resolve
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
        elif op == "radial":
            result = radial_values(self.program.geometry, args[0], self.row, self.dtype)
        else:
            result = self._stencil(node)
        self.values[node.index] = result
        return result

    def _stencil(self, node):
        geo = self.program.geometry
        operand, key = node.args
        axes = stencil_axes(node.op, geo.rank)
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
                if self.resolve is not None:
                    lo, hi = (tuple(self.resolve(t) for t in side) for side in (lo, hi))
                at_lo, at_hi = self.plane_edges if axis == 0 else self.edges[axis - 1]
                low = torch.where(torch.as_tensor(at_lo), _ghost(lo, center, high), low)
                high = torch.where(torch.as_tensor(at_hi) & ~torch.as_tensor(at_lo),
                                   _ghost(hi, center, low), high)
            pairs[axis] = (low, high)
        if node.op == "lap":
            fac = None
            if geo.radial is not None:
                fac = radial_values(geo, "fac", self.row, self.dtype)
            return _laplace(geo, center, *pairs.values(), fac=fac)
        diffs = [(high - low) * geo.halves[axis] for axis, (low, high) in pairs.items()]
        if node.op == "gsq":
            return _sum_of_squares(diffs)
        (diff,) = diffs
        return diff


def march_program_block(win: MarchWindow, program, k: int, planes: int, store,
                        sides=None) -> None:
    """One block's march of a program as the kernel schedules it
    (``march_program_3d`` of ``csrc/multi_stencil_3d.cuh``, ``march_program_2d``
    of ``csrc/march_2d.cuh``): iteration t stores level 0 of window plane
    (row) t into its slot, then, for each step s and stage j, computes plane
    t - L (L = s * depth + the stage's lag, when t >= 2L) on the columns of
    depth L and more, each volume's planes going into a ring of its slots.
    Slots start as NaN, so a read of a cell the schedule has not written yet
    (or has overwritten) poisons the result; between two barriers the threads
    race, so a read of another thread's cell (a neighbour across the march)
    from a slot that any thread stores to in the same iteration reads NaN too.
    Ghosts are formed where they are read, from the flags, as the emitted C
    does, reading the program's side inputs from the pass's views `sides`
    where it has them (a row side's at the window's grid columns
    ``win.cols``, a column side's at grid row ``win.row(w)``, a 3D face's at
    the plane's x and the columns' (y, z), all padded as the kernel's
    tables are). A pass of a cut step reads its inputs (``win.read``) and
    stores its outputs, which differ from them. ``store(w, values, mask)``
    takes the last level of window plane w, one plane per output. bf16
    planes march in float32, the last stage rounding every field's next
    level to bf16, as the kernel's storage type does."""
    layout = program.march
    depth, nf = program.depth, program.n_fields
    shape = win.load.shape
    storage = win.read(0)[0].dtype
    dtype = compute_dtype(storage)
    nan = torch.full(shape, float("nan"), dtype=dtype)
    zero = torch.zeros((), dtype=dtype)
    ring = None
    for axis, n in enumerate(shape):
        i = along(torch.arange(n), axis, len(shape))
        depth_along = torch.minimum(i, n - 1 - i)
        ring = depth_along if ring is None else torch.minimum(ring, depth_along)
    smem = {(s, v, r): nan.clone() for s in range(k) for v, n in enumerate(layout.slots)
            for r in range(n)}

    def slot(s, v, w):
        return (s, v, w % layout.slots[v])

    edges = tuple(zip(win.edges[::2], win.edges[1::2]))
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
            smem[slot(0, f, t)] = torch.where(win.load & load, plane.to(dtype), zero)
        for s, st, lag, keys in running:
            w = t - lag
            _, domain, lo, hi = win.plane(w)

            def own(v, dx, s=s, w=w):
                return smem[slot(s, v, w + dx)]

            def shared(v, s=s, w=w):
                return nan if slot(s, v, w) in written else own(v, 0)

            resolve = None
            if sides is not None:
                def resolve(term, s=s, w=w):
                    if not is_side_ref(term):
                        return term
                    _, index, base = term
                    row, kind = sides[index][s], program.sides.kind(index)
                    pad = program.sides.pad
                    if kind in ("x", "y", "z"):  # a 3D face, at the cells' (x, y, z)
                        gy, gz = win.cols
                        cells = (torch.tensor(win.row(w)), gy[:, None], gz[None, :])
                        value = program.sides.gather(
                            row, kind, [cells[a] for a in program.sides.face_axes(kind)])
                    else:
                        value = (row[0] if kind == "t" else row[win.cols + pad] if kind == "row"
                                 else row[win.row(w) + pad])
                    return value if base is None else base + value

            body = MarchBody(program, layout, st, own, shared, (lo, hi), edges,
                             None if win.row is None else win.row(w), dtype, resolve)
            active = ring >= lag
            inside = win.domain & domain
            values = [torch.where(active & inside, torch.as_tensor(body.value(n), dtype=dtype),
                                  zero) for n in st.nodes]
            if st is layout.stages[-1]:  # the fields' next level, in the storage's values
                values = [round_level(value, storage) for value in values]
            if keys is None:
                store(w, values, active & win.out)
                continue
            for key, value in zip(keys, values):
                smem[key] = torch.where(active, value, smem[key])
