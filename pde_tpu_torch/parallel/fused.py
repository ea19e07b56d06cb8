"""Fused kernel windows on decomposed 2D grids: the halo exchange and the
window drivers.

Port of :mod:`pde_tpu.parallel.fused`. ``pde_tpu`` runs its temporal-blocking
kernels under ``shard_map`` and exchanges a halo of width h by paired
``lax.ppermute`` before every k-step kernel call, re-concatenating each
shard's whole block. The port holds every block in one process
(:class:`~.mesh.GridMesh`), so the exchange is a set of plain tensor copies,
and it copies only the halo strips: each block keeps two persistent extended
buffers of shape ``(n + 2h, m + 2h)``. A pass copies the halo strips from the
neighbours' interiors into the current buffers (:class:`HaloExchange`), then
one kernel launch per device writes every block's interior into the other
buffers (:func:`.cuda_ext_2d.affine_laplace_ext_2d`,
:func:`.cuda_ext_2d.multi_stencil_ext_2d`).

Exchange order: rows first, then the columns of the row-extended buffers, so
corner cells arrive from the diagonal neighbour in two hops (the order of
``make_halo_pad``). Periodic axes wrap, an axis with one block onto itself;
the halo beyond a non-periodic global edge is left as it is, and the kernels,
told by the block's edge flags, hold those cells at zero and rewrite the
ghosts. Copies between blocks on different devices are non-blocking
device-to-device copies; on one device they are strided copy kernels. The
strips cost about ``4h(n + m)`` cells per block and pass, against ``n*m`` for
the kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..grids.cartesian import CartesianGrid
from ..ops.cuda_cartesian import MAX_STEPS, KernelUnsupportedError
from ..ops.cuda_ext_2d import (
    ExtStencilProgram,
    affine_laplace_ext_2d,
    affine_laplace_ext_spec,
    check_block,
    ext_halo_width,
    multi_stencil_ext_2d,
    multi_stencil_ext_spec,
)


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    dst.copy_(src, non_blocking=dst.device != src.device)


class HaloExchange:
    """The halo strips of width `halo` between the blocks of a 2D mesh.

    ``HaloExchange.copies`` counts strip copies over all exchanges.
    """

    copies = 0

    def __init__(self, mesh, halo: int):
        if mesh.basegrid.num_axes != 2:
            raise KernelUnsupportedError(
                "The halo exchange of decomposed 3D windows is not ported yet "
                "(ROADMAP B9 rows 11 and 6)"
            )
        check_block(mesh.local_shape, halo)
        self.mesh = mesh
        self.halo = halo
        self.periodic = tuple(bool(p) for p in mesh.basegrid.periodic)

    def allocate(self, n_planes: int, dtype) -> list[list[torch.Tensor]]:
        """Zeroed extended buffers: ``n_planes`` per block, on its device."""
        n, m = self.mesh.local_shape
        h = self.halo
        return [
            [torch.zeros((n + 2 * h, m + 2 * h), dtype=dtype, device=device)
             for _ in range(n_planes)]
            for device in self.mesh.devices
        ]

    def load(self, buffers, blocks) -> None:
        """Copy each block's planes into the interiors of its buffers."""
        n, m = self.mesh.local_shape
        h = self.halo
        for bufs, planes in zip(buffers, blocks, strict=True):
            for buf, plane in zip(bufs, planes, strict=True):
                _copy(buf[h : h + n, h : h + m], plane)

    def interiors(self, buffers) -> list[list[torch.Tensor]]:
        """The blocks' planes, copied out of the buffers' interiors."""
        n, m = self.mesh.local_shape
        h = self.halo
        return [[buf[h : h + n, h : h + m].clone() for buf in bufs] for bufs in buffers]

    def _neighbour(self, index: tuple[int, int], axis: int, step: int) -> int | None:
        """Flat index of the block `step` blocks along `axis`, wrapped on a
        periodic axis; None past a non-periodic edge."""
        count = self.mesh.decomposition[axis]
        other = list(index)
        other[axis] += step
        if not 0 <= other[axis] < count:
            if not self.periodic[axis]:
                return None
            other[axis] %= count
        return other[0] * self.mesh.decomposition[1] + other[1]

    def strips(self, buffers) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The (destination, source) views of one exchange over `buffers` (per
        block, a list of planes), in copy order: the row strips of every
        block from the neighbours' interiors, then the column strips of the
        row-extended buffers. The views stay valid as long as the buffers."""
        n, m = self.mesh.local_shape
        h = self.halo
        cols = slice(h, h + m)
        row_strips = (  # (destination rows, source rows of the neighbour, step)
            (slice(0, h), slice(n, n + h), -1),
            (slice(h + n, n + 2 * h), slice(h, 2 * h), 1),
        )
        col_strips = (
            (slice(0, h), slice(m, m + h), -1),
            (slice(h + m, m + 2 * h), slice(h, 2 * h), 1),
        )
        blocks = [self.mesh.block_index(b) for b in range(len(buffers))]
        pairs = []
        for axis, strips in ((0, row_strips), (1, col_strips)):
            for b, index in enumerate(blocks):
                for dst_sl, src_sl, step in strips:
                    other = self._neighbour(index, axis, step)
                    if other is None:
                        continue
                    for dst, src in zip(buffers[b], buffers[other], strict=True):
                        if axis == 0:
                            pairs.append((dst[dst_sl, cols], src[src_sl, cols]))
                        else:
                            pairs.append((dst[:, dst_sl], src[:, src_sl]))
        return pairs

    @staticmethod
    def copy(strips) -> None:
        """Fill the halo rings: run the copies of :meth:`strips`, in order."""
        for dst, src in strips:
            _copy(dst, src)
        HaloExchange.copies += len(strips)


def sharded_window(mesh, specs, halo: int, n_planes: int, run: Callable) -> Callable:
    """``window(blocks, steps) -> blocks`` over the blocks of `mesh`:
    ``blocks[b]`` is the list of block b's ``n_planes`` planes.

    `steps` is split over the passes of `specs` (largest k first); a pass
    exchanges the halos of the current buffers, then calls
    ``run(ins, outs, flags, spec)`` once per device with that device's
    blocks. Two sets of extended buffers persist between calls; the returned
    planes are copies. The window carries ``sharded = True``, its ``specs``
    and its ``exchange``."""
    exchange = HaloExchange(mesh, halo)
    flags = [mesh.edge_flags(b) for b in range(len(mesh))]
    groups: dict[torch.device, list[int]] = {}
    for b, device in enumerate(mesh.devices):
        groups.setdefault(device, []).append(b)
    dtype = specs[0].dtype
    state: dict = {}

    def window(blocks, steps):
        if "sets" not in state:  # (buffers, their exchange's strips), twice
            buffers = [exchange.allocate(n_planes, dtype) for _ in range(2)]
            state["sets"] = [(b, exchange.strips(b)) for b in buffers]
        (cur, strips), (nxt, other) = state["sets"]
        exchange.load(cur, blocks)
        remaining = int(steps)
        for spec in specs:
            chunks, remaining = divmod(remaining, spec.k)
            for _ in range(chunks):
                exchange.copy(strips)
                for index in groups.values():
                    run([cur[b] for b in index], [nxt[b] for b in index],
                        [flags[b] for b in index], spec)
                (cur, strips), (nxt, other) = (nxt, other), (cur, strips)
        return exchange.interiors(cur)

    window.sharded = True
    window.specs = specs
    window.exchange = exchange
    return window


def _require_2d_cartesian(grid) -> None:
    if not isinstance(grid, CartesianGrid):
        raise KernelUnsupportedError(
            "Decomposed fused windows require a Cartesian grid (cylindrical grids and "
            "their radial term are ROADMAP A6 and B1(d))"
        )
    if grid.num_axes == 3:
        raise KernelUnsupportedError(
            "Decomposed 3D fused windows are not ported yet (ROADMAP B9 rows 11 and 6)"
        )
    if grid.num_axes != 2:
        raise KernelUnsupportedError("Decomposed fused windows require a 2D grid")


def make_fused_euler_window_sharded(
    mesh, *, diffusivity: float, dt: float, dtype=torch.float32, bcs=None, k: int = MAX_STEPS,
) -> Callable:
    """Decomposed analogue of :func:`~..ops.cuda_cartesian.make_fused_euler_window_2d`:
    ``window(blocks, steps) -> blocks`` (one plane per block) through the
    affine ext kernel, with a binary ladder k, k/2, ..., 1.

    The top k shrinks until the blocks can supply its halo (``h = k``).
    Axes must be periodic or carry scalar constant affine BCs (``bcs``);
    everything the serial kernel refuses, this refuses too, before anything
    is built.
    """
    grid = mesh.basegrid
    _require_2d_cartesian(grid)
    local = mesh.local_shape
    while k > 1 and min(local) < ext_halo_width(k):
        k //= 2
    halo = ext_halo_width(k)
    specs = []
    while k >= 1:
        specs.append(affine_laplace_ext_spec(grid, local, a=1.0, b=dt * diffusivity, k=k,
                                             halo=halo, dtype=dtype, bcs=bcs))
        k //= 2

    def run(ins, outs, flags, spec):
        affine_laplace_ext_2d([p[0] for p in ins], [p[0] for p in outs], flags, spec)

    return sharded_window(mesh, specs, halo, 1, run)


def make_fused_multi_window_sharded(
    mesh, make_step: Callable, halo_per_step: int, n_fields: int, *, dtype=torch.float32,
) -> Callable:
    """Decomposed multi-field window: ``window(blocks, steps) -> blocks``
    advancing every block's ``n_fields`` planes through the generated ext
    kernel, one pass per k steps for all fields.

    The ladder is the serial program's, cut to the k whose halo
    (``k * halo_per_step``) the blocks can supply; when even k = 1 does not
    fit it raises "Shard too small". Physical (scalar constant affine) BCs
    come through the helpers' ``bc=`` arguments of ``make_step``, gated by
    the blocks' edge flags. BC side inputs (``pde_tpu``'s ``bc_inputs`` and
    ``needs_t`` windows) are ROADMAP B2(b); the expression lowering refuses
    them before this point.
    """
    grid = mesh.basegrid
    _require_2d_cartesian(grid)
    program = ExtStencilProgram(grid, make_step, halo_per_step, n_fields)
    local = mesh.local_shape
    ladder = [kk for kk in program.ladder if ext_halo_width(kk * halo_per_step) <= min(local)]
    if not ladder:
        raise KernelUnsupportedError(
            f"Shard too small for any temporal-blocking factor: blocks of {local} cells, "
            f"{halo_per_step} halo cells per step"
        )
    halo = ext_halo_width(ladder[0] * halo_per_step)
    specs = [multi_stencil_ext_spec(program, kk, dtype, local, halo) for kk in ladder]
    window = sharded_window(mesh, specs, halo, n_fields, multi_stencil_ext_2d)
    window.program = program
    return window
