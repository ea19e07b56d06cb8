"""Fused kernel windows on decomposed 2D and 3D grids: the halo exchange and
the window drivers.

Port of :mod:`pde_tpu.parallel.fused`. ``pde_tpu`` runs its temporal-blocking
kernels under ``shard_map`` and exchanges a halo of width h by paired
``lax.ppermute`` before every k-step kernel call, re-concatenating each
shard's whole block. The port holds every block in one process
(:class:`~.mesh.GridMesh`), so the exchange is a set of plain tensor copies,
and it copies only the halo slabs: each block keeps two persistent extended
buffers of shape ``(n + 2h, m + 2h)`` (``(n + 2h, m + 2h, l + 2h)`` in 3D). A
pass copies the halo slabs from the neighbours' interiors into the current
buffers (:class:`HaloExchange`), then one kernel launch per device writes every
block's interior into the other buffers (:mod:`..ops.cuda_ext_2d`,
:mod:`..ops.cuda_ext_3d`).

Exchange order: axis by axis, x (rows) first, each axis's slabs spanning the
extended buffer along the axes exchanged before it, so edge and corner cells
arrive from the diagonal neighbours in two or three hops (the order of
``make_halo_pad``); a k-step pass of a face-neighbour stencil needs them, since
its light cone reaches diagonal cells after two steps. Every axis is extended:
periodic axes wrap, an axis with one block onto itself; the halo beyond a
non-periodic global face is left as it is, and the kernels, told by the
block's edge flags, hold those cells at zero and rewrite the ghosts. Copies
between blocks on different devices are non-blocking device-to-device copies;
on one device they are strided copy kernels, two per block and axis (16 per
pass on a 2x2 mesh, 48 on a 2x2x2 one). The slabs cost about ``2h`` cells per
block cell of surface, against the block's volume for the kernel.

On a decomposed ``CylindricalSymGrid`` (rows r, columns z) the diffusion
window runs the affine ext kernel's radial mode (``pde_tpu``'s
``radial=``), each block's rows taking the factors of their global rows,
with the side inputs below where its consts vary along a side or in time
(``radial=`` with ``bc_specs=``).
Polar and spherical grids, and the expression windows on cylindrical grids,
have no decomposed window, as in ``pde_tpu``: their runs take the plain
sharded stepper.

BC side inputs (A9.3): per-point and time-dependent BC values reach both
2D windows as they reach the serial ones, and values varying in space and
time and per-point or time-dependent ghost factors the expression window,
in 2D and in 3D (per-face values and factors there). Every block reads the
global grid's tables, made once per window (or, where they depend on time,
evaluated on each device a block of steps at a time), at its own origin:
its flags carry its first cell in the grid after the edge flags (its first
row and column in 2D, its first x, y and z in 3D). A window whose values
depend on time is ``window(blocks, t0, steps)`` (``needs_t``), as
``pde_tpu``'s ``window_td`` (``pde_tpu/parallel/fused.py:561-588``, its 3D
window ``:597-700``).
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from ..grids.cartesian import CartesianGrid
from ..grids.cylindrical import CylindricalSymGrid
from ..ops import cuda_cartesian_3d, cuda_ext_3d
from ..ops.cuda_cartesian import (
    CORNER_TOP_STEPS,
    EXT_MAX_STEPS,
    RADIAL_SIDES_TOP_STEPS,
    RADIAL_TOP_STEPS,
    SIDE_PAD,
    SIDES_TOP_STEPS,
    TOP_STEPS,
    AffineSideInputs,
    KernelUnsupportedError,
    _corner_weight,
    _has_side_inputs,
)
from ..ops.cuda_ext_2d import (
    ExtStencilProgram,
    affine_laplace_ext_2d,
    affine_laplace_ext_spec,
    check_bf16_ext,
    check_block,
    ext_halo_width,
    multi_stencil_ext_2d,
    multi_stencil_ext_spec,
)


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    dst.copy_(src, non_blocking=dst.device != src.device)


class HaloExchange:
    """The halo slabs of width `halo` between the blocks of a mesh.

    Two passes: the ext kernels' (:meth:`strips` and :meth:`copy`, on
    persistent buffers, each axis's halo from the next block alone; 2D and
    3D meshes), and the plain decomposed stepper's (:meth:`extend`, built
    with ``spans=True``: each block's extended view of
    :meth:`~.mesh.GridMesh.view_ranges`, from as many blocks as the halo
    spans; meshes of any rank, the 1D meshes of polar and spherical grids
    too). ``HaloExchange.copies`` counts copies over all exchanges.
    """

    copies = 0

    def __init__(self, mesh, halo: int, *, spans: bool = False):
        if not spans:
            check_block(mesh.local_shape, halo)
        self.mesh = mesh
        self.halo = halo
        self.periodic = tuple(bool(p) for p in mesh.basegrid.periodic)
        self._pieces: list | None = None

    def allocate(self, n_planes: int, dtype) -> list[list[torch.Tensor]]:
        """Zeroed extended buffers: ``n_planes`` per block, on its device."""
        shape = tuple(n + 2 * self.halo for n in self.mesh.local_shape)
        return [
            [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_planes)]
            for device in self.mesh.devices
        ]

    def _interior(self) -> tuple[slice, ...]:
        h = self.halo
        return tuple(slice(h, h + n) for n in self.mesh.local_shape)

    def load(self, buffers, blocks) -> None:
        """Copy each block's planes into the interiors of its buffers."""
        interior = self._interior()
        for bufs, planes in zip(buffers, blocks, strict=True):
            for buf, plane in zip(bufs, planes, strict=True):
                _copy(buf[interior], plane)

    def interiors(self, buffers) -> list[list[torch.Tensor]]:
        """The blocks' planes, copied out of the buffers' interiors."""
        interior = self._interior()
        return [[buf[interior].clone() for buf in bufs] for bufs in buffers]

    def _neighbour(self, index: tuple[int, ...], axis: int, step: int) -> int | None:
        """Flat index of the block `step` blocks along `axis`, wrapped on a
        periodic axis; None past a non-periodic edge."""
        decomposition = self.mesh.decomposition
        other = list(index)
        other[axis] += step
        if not 0 <= other[axis] < decomposition[axis]:
            if not self.periodic[axis]:
                return None
            other[axis] %= decomposition[axis]
        return int(np.ravel_multi_index(other, decomposition))

    def strips(self, buffers) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The (destination, source) views of one exchange over `buffers` (per
        block, a list of planes), in copy order: axis by axis, the two slabs
        of every block from its neighbours' interiors along that axis. A slab
        spans the extended buffer along the axes exchanged before it and the
        interior along those after it, so edge and corner cells arrive from
        the diagonal neighbours in two or three hops. The views stay valid as
        long as the buffers."""
        local = self.mesh.local_shape
        h = self.halo
        blocks = [self.mesh.block_index(b) for b in range(len(buffers))]
        pairs = []
        for axis, n in enumerate(local):
            sides = (  # (destination, source in the neighbour, step) along `axis`
                (slice(0, h), slice(n, n + h), -1),
                (slice(h + n, n + 2 * h), slice(h, 2 * h), 1),
            )

            def slab(along_axis, _axis=axis):
                return tuple(
                    along_axis if a == _axis else slice(None) if a < _axis else slice(h, h + m)
                    for a, m in enumerate(local)
                )

            for b, index in enumerate(blocks):
                for dst_sl, src_sl, step in sides:
                    other = self._neighbour(index, axis, step)
                    if other is None:
                        continue
                    for dst, src in zip(buffers[b], buffers[other], strict=True):
                        pairs.append((dst[slab(dst_sl)], src[slab(src_sl)]))
        return pairs

    def view_pieces(self, index) -> list[tuple[tuple[slice, ...], int, tuple[slice, ...]]]:
        """How block `index`'s extended view is filled: ``(destination in the
        view, source block, source in that block)`` boxes, one per block
        whose cells the view holds (a halo deeper than a block spans several;
        a periodic axis wraps)."""
        mesh = self.mesh
        segments = []  # per axis: (destination slice, source block index, source slice)
        for (start, stop), n, d in zip(mesh.view_ranges(index, self.halo), mesh.local_shape,
                                       mesh.decomposition, strict=True):
            axis_segments, g = [], start
            while g < stop:
                wrapped = g % (n * d)
                block, offset = divmod(wrapped, n)
                length = min(n - offset, stop - g)
                axis_segments.append((slice(g - start, g - start + length), block,
                                      slice(offset, offset + length)))
                g += length
            segments.append(axis_segments)
        pieces = []
        for combo in itertools.product(*segments):
            dst, blocks, src = zip(*combo)
            pieces.append((dst, int(np.ravel_multi_index(blocks, mesh.decomposition)), src))
        return pieces

    def extend(self, blocks) -> list[torch.Tensor]:
        """Each block's extended view (:meth:`~.mesh.GridMesh.view_ranges`)
        of one leaf given by its blocks (``blocks[b]``, on block b's device;
        leading component axes are copied whole), as new tensors."""
        if self._pieces is None:  # (the view's shape, its boxes) of every block
            self._pieces = [
                (tuple(hi - lo for lo, hi in self.mesh.view_ranges(b, self.halo)),
                 self.view_pieces(b))
                for b in range(len(self.mesh))
            ]
        views = []
        for b, (shape, pieces) in enumerate(self._pieces):
            lead = blocks[b].shape[: blocks[b].ndim - len(shape)]
            view = torch.empty(lead + shape, dtype=blocks[b].dtype, device=blocks[b].device)
            for dst, src_block, src in pieces:
                _copy(view[(Ellipsis, *dst)], blocks[src_block][(Ellipsis, *src)])
            HaloExchange.copies += len(pieces)
            views.append(view)
        return views

    @staticmethod
    def copy(strips) -> None:
        """Fill the halo rings: run the copies of :meth:`strips`, in order."""
        for dst, src in strips:
            _copy(dst, src)
        HaloExchange.copies += len(strips)


def sharded_window(mesh, specs, halo: int, n_planes: int, run: Callable,
                   flags=None, sides: Callable | None = None,
                   needs_t: bool = False) -> Callable:
    """``window(blocks, steps) -> blocks`` over the blocks of `mesh`:
    ``blocks[b]`` is the list of block b's ``n_planes`` planes.

    `steps` is split over the passes of `specs` (largest k first); a pass
    exchanges the halos of the current buffers, then calls
    ``run(ins, outs, flags, spec)`` once per device with that device's
    blocks and their `flags` (default: the mesh's edge flags). With
    ``sides(t0, steps, device) -> views``, each call also gets
    ``sides=views(index, k)``, the side inputs of a pass of k steps from
    inner step `index` of the window; where they depend on time
    (`needs_t`) the window is ``window(blocks, t0, steps)``, its inner step
    i at ``t0 + i*dt``. Two sets of extended buffers persist between calls;
    the returned planes are copies. The window carries ``sharded = True``,
    ``needs_t``, its ``specs`` and its ``exchange``."""
    exchange = HaloExchange(mesh, halo)
    if flags is None:
        flags = [mesh.edge_flags(b) for b in range(len(mesh))]
    groups: dict[torch.device, list[int]] = {}
    for b, device in enumerate(mesh.devices):
        groups.setdefault(device, []).append(b)
    dtype = specs[0].dtype
    state: dict = {}

    def window(blocks, *args):
        t0, steps = args if needs_t else (0.0, *args)
        if "sets" not in state:  # (buffers, their exchange's strips), twice
            buffers = [exchange.allocate(n_planes, dtype) for _ in range(2)]
            state["sets"] = [(b, exchange.strips(b)) for b in buffers]
        (cur, strips), (nxt, other) = state["sets"]
        exchange.load(cur, blocks)
        remaining = int(steps)
        views = None if sides is None else {
            device: sides(t0, remaining, device) for device in groups}
        first = 0  # the pass's first inner step
        for spec in specs:
            chunks, remaining = divmod(remaining, spec.k)
            for _ in range(chunks):
                exchange.copy(strips)
                for device, index in groups.items():
                    kwargs = {} if views is None else {"sides": views[device](first, spec.k)}
                    run([cur[b] for b in index], [nxt[b] for b in index],
                        [flags[b] for b in index], spec, **kwargs)
                (cur, strips), (nxt, other) = (nxt, other), (cur, strips)
                first += spec.k
        return exchange.interiors(cur)

    window.sharded = True
    window.needs_t = needs_t
    window.specs = specs
    window.exchange = exchange
    return window


def _side_flags(mesh) -> list[list[int]]:
    """Every block's flags in a pass with side inputs: its edge flags, then
    its first cell in the grid (row and column in 2D, x, y and z in 3D)."""
    return [mesh.edge_flags(b) + list(mesh.block_origin(b)) for b in range(len(mesh))]


def _require_cartesian(grid) -> None:
    """Refuse the grids without decomposed windows of the Cartesian kernels:
    cylindrical grids (#8 has no radial helpers, as in ``pde_tpu``; the
    diffusion window takes them before this test), polar and spherical
    grids, and 1D grids."""
    if isinstance(grid, CylindricalSymGrid):
        raise KernelUnsupportedError("Sharded fused windows do not support cylindrical grids")
    if not isinstance(grid, CartesianGrid):
        raise KernelUnsupportedError(
            "Decomposed fused windows require a Cartesian grid (polar and spherical grids run "
            "the plain sharded stepper, as in pde_tpu)")
    if grid.num_axes not in (2, 3):
        raise KernelUnsupportedError("Decomposed fused windows require a 2D or 3D grid")


def make_fused_euler_window_sharded(
    mesh, *, diffusivity: float, dt: float, dtype=torch.float32, bcs=None, k: int | None = None,
) -> Callable:
    """Decomposed analogue of the serial diffusion windows
    (:func:`~..ops.cuda_cartesian.make_fused_euler_window_2d`,
    :func:`~..ops.cuda_cartesian_3d.make_fused_euler_window_3d`):
    ``window(blocks, steps) -> blocks`` (one plane or volume per block)
    through the affine ext kernel of the grid's rank, with a binary ladder k,
    k/2, ..., 1 from the serial window's top k (``TOP_STEPS`` of
    :mod:`~..ops.cuda_cartesian` in 2D, of :mod:`~..ops.cuda_cartesian_3d` in
    3D, ``RADIAL_TOP_STEPS`` on a ``CylindricalSymGrid``, whose passes take
    the radial mode, each block's flags carrying its first row;
    ``CORNER_TOP_STEPS`` under a 2D corner weight, whose passes take the
    9-point mode on row cuts of a fully periodic grid) unless `k` is given.
    An explicit `k` is honoured as ``pde_tpu``'s windows honour it, up to
    ``EXT_MAX_STEPS`` (16) in every 5-point mode of the 2D ext kernel (the
    passes past the register march's top take the deep march), halved only
    where the mode refuses it: past that, or past ``CORNER_TOP_STEPS`` in the
    9-point mode.

    The top k shrinks until the blocks can supply its halo (``h = k``).
    Axes must be periodic or carry constant affine BCs (``bcs``); on a 2D
    Cartesian or a cylindrical grid their consts may vary along a side or in
    time, as kernel #1's side inputs take them (``pde_tpu``'s ``bc_specs``,
    on a cylinder with ``radial=``; the ladder then tops at
    ``SIDES_TOP_STEPS``, on a cylinder at ``RADIAL_SIDES_TOP_STEPS``, each
    block's six flags carry its first row and column, it reads the global
    grid's tables at its origin, and where a const depends on time the window
    is ``window(blocks, t0, steps)``). Everything the serial kernel refuses,
    this refuses too, before anything is built (time-dependent ghost
    factors, which ``pde_tpu`` refuses here too, go to the expression
    window). Polar and spherical grids raise
    :class:`~..ops.cuda_cartesian.KernelUnsupportedError`, as ``pde_tpu``
    refuses them. bf16 blocks (B1(f)) go where the mesh cuts the columns, as
    ``pde_tpu``'s ``ext_cols`` gate takes them (the ext spec decides from
    the blocks' shape), on float32's ladder; every level is rounded to bf16,
    so the run equals the serial bf16 window bit for bit whatever the ladder.
    """
    grid = mesh.basegrid
    flags = None
    inputs = None
    if isinstance(grid, CylindricalSymGrid):
        top, make_spec, kernel = RADIAL_TOP_STEPS, affine_laplace_ext_spec, affine_laplace_ext_2d
        flags = [mesh.edge_flags(b) + [mesh.block_origin(b)[0]] for b in range(len(mesh))]
        if _has_side_inputs(grid, bcs):
            top, flags = RADIAL_SIDES_TOP_STEPS, _side_flags(mesh)
            inputs = AffineSideInputs(grid, bcs)
    else:
        _require_cartesian(grid)
        if grid.num_axes == 3:
            top, make_spec = cuda_cartesian_3d.TOP_STEPS, cuda_ext_3d.affine_laplace_ext_3d_spec
            kernel = cuda_ext_3d.affine_laplace_ext_3d
        else:
            top, make_spec, kernel = TOP_STEPS, affine_laplace_ext_spec, affine_laplace_ext_2d
            if _corner_weight() != 0:
                # the 9-point mode of #12 takes row cuts only, and k <= 8, as
                # pde_tpu's gate (pde_tpu/ops/pallas_cartesian.py:5856-5867)
                if mesh.decomposition[1] != 1:
                    raise KernelUnsupportedError(
                        "The fused 9-point corner-weight stencil supports row-cut "
                        "decompositions only, as pde_tpu's gate (pde_tpu/ops/"
                        "pallas_cartesian.py:5856-5867)")
                top = CORNER_TOP_STEPS
                while k is not None and k > top:
                    k //= 2
            elif _has_side_inputs(grid, bcs):
                top, flags = SIDES_TOP_STEPS, _side_flags(mesh)
                inputs = AffineSideInputs(grid, bcs)
    k = top if k is None else k
    while grid.num_axes == 2 and k > EXT_MAX_STEPS:
        k //= 2
    local = mesh.local_shape
    while k > 1 and min(local) < ext_halo_width(k):
        k //= 2
    halo = ext_halo_width(k)
    specs = []
    while k >= 1:
        specs.append(make_spec(grid, local, a=1.0, b=dt * diffusivity, k=k, halo=halo,
                               dtype=dtype, bcs=bcs))
        k //= 2

    def run(ins, outs, block_flags, spec, **kwargs):
        kernel([p[0] for p in ins], [p[0] for p in outs], block_flags, spec, **kwargs)

    if inputs is None:
        return sharded_window(mesh, specs, halo, 1, run, flags)

    def sides(t0, steps, device):
        def views(first, kk):
            times = [t0 + (first + s) * dt for s in range(kk)] if inputs.needs_t else ()
            return inputs.for_pass(dtype, device, times, row_pad=SIDE_PAD)

        return views

    return sharded_window(mesh, specs, halo, 1, run, flags, sides, inputs.needs_t)


def make_fused_multi_window_sharded(
    mesh, make_step: Callable, halo_per_step: int, n_fields: int, *, dtype=torch.float32,
    carry: bool = False, sides=None, dt: float | None = None,
) -> Callable:
    """Decomposed multi-field window: ``window(blocks, steps) -> blocks``
    advancing every block's ``n_fields`` planes (volumes in 3D) through the
    generated ext kernel of the grid's rank, one pass per k steps for all
    fields. On 3D grids this also covers ``pde_tpu``'s x-cut route through
    the y-chunked kernel's ``ext_x`` mode (TPU kernel #4), a VMEM matter.

    The ladder is the serial program's, cut to the k whose halo
    (``k * halo_per_step``) the blocks can supply; when even k = 1 does not
    fit it raises "Shard too small". Physical (scalar constant affine) BCs
    come through the helpers' ``bc=`` arguments of ``make_step``, gated by
    the blocks' edge flags. The ghosts may read side inputs (`sides`, the
    global grid's :class:`~..ops.cuda_stencil_2d.SideInputs`, ``pde_tpu``'s
    ``bc_inputs``; a 3D face's table over its two axes): each block reads
    the tables at its origin, the time-dependent ones evaluated on each
    device a block of steps at a time, and where they depend on time the
    window is ``window(blocks, t0, steps)`` of step `dt` (``needs_t``),
    RK4's stages at their times.

    The serial windows' schemes come through as they do there: an RK4 step
    is one program of halo ``4 * depth`` whose stage values the march stores
    (``carry=True``, :class:`~..ops.cuda_stencil_2d.StencilProgram`), an AB2
    step one of ``2n`` planes, the fields and their previous rates.

    Cylindrical grids are refused with ``pde_tpu``'s message (the ext
    kernel #8 has no radial helpers in either package): under the ``torch``
    engine their runs take the plain sharded stepper. bf16 planes (B1(f))
    go to #8 where the mesh cuts the columns, through the program's bf16
    entry points (each field's every level rounded to bf16, an AB2 window's
    rate planes too); elsewhere, as ``pde_tpu``'s gate, they are refused.
    """
    grid = mesh.basegrid
    _require_cartesian(grid)
    if dtype == torch.bfloat16:
        check_bf16_ext(grid.shape, mesh.local_shape)
    if grid.num_axes == 3:
        program = cuda_ext_3d.ExtStencilProgram3D(grid, make_step, halo_per_step, n_fields,
                                                  carry=carry, sides=sides)
        make_spec, kernel = cuda_ext_3d.multi_stencil_ext_3d_spec, cuda_ext_3d.multi_stencil_ext_3d
    else:
        program = ExtStencilProgram(grid, make_step, halo_per_step, n_fields, carry=carry,
                                    sides=sides, bf16=dtype == torch.bfloat16)
        make_spec, kernel = multi_stencil_ext_spec, multi_stencil_ext_2d
    local = mesh.local_shape
    ladder = [kk for kk in program.ladder if ext_halo_width(kk * halo_per_step) <= min(local)]
    if not ladder:
        raise KernelUnsupportedError(
            f"Shard too small for any temporal-blocking factor: blocks of {local} cells, "
            f"{halo_per_step} halo cells per step"
        )
    halo = ext_halo_width(ladder[0] * halo_per_step)
    specs = [make_spec(program, kk, dtype, local, halo) for kk in ladder]
    inputs = program.sides
    if inputs is None:
        window = sharded_window(mesh, specs, halo, n_fields, kernel)
    else:
        if inputs.needs_t and dt is None:
            raise ValueError("A window whose side inputs depend on time needs its dt")
        window = sharded_window(
            mesh, specs, halo, n_fields, kernel, _side_flags(mesh),
            lambda t0, steps, device: inputs.passes(t0, steps, dt, dtype, device),
            inputs.needs_t)
    window.program = program
    return window
