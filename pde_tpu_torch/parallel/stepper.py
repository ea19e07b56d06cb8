"""The plain decomposed stepper's evaluation over blocks.

Port of the per-shard evaluation inside ``pde_tpu``'s plain sharded stepper
(``_make_fixed_stepper_sharded`` of :mod:`pde_tpu.solvers.base`, which runs
the serial step under ``shard_map`` with :class:`~.boundaries.ShardedBoundaries`
exchanging one ghost layer per operator). Here one process holds every block,
and the solvers run their serial stepping formulas (Euler, Euler-Maruyama,
RK4, AB2, the adaptive estimates) unchanged on a flat list of every block's
leaves through :attr:`BlockedRun.rhs`: one halo exchange per rhs evaluation
(:meth:`.fused.HaloExchange.extend`, as deep as the rhs reads), the PDE's plain
rhs on each block's extended view, the halo trimmed. Every interior cell reads
the operands the serial run reads, in the same order, so a decomposed run
equals the serial plain run bit for bit. A global reduction in the rhs
(``integral``) takes a first pass over the blocks for their partial
integrals (:class:`~.mesh.GlobalReductions`), summed in block order, so
such a run agrees with the serial one to rounding.
"""

from __future__ import annotations

from typing import Callable

from ..fields.base import FieldBase
from ..fields.collection import FieldCollection
from ..models.base import state_from_leaves, state_leaves
from ..ops.common import wrap_with_bcs
from .fused import HaloExchange
from .mesh import GlobalReductions


def rhs_halo(pde, state: FieldBase) -> int:
    """The cells per side one rhs evaluation reads beyond a cell: the depth
    of the PDE's stencil lowering where it has one, else the operator calls
    of one evaluation of its plain rhs (each reads one cell further, so their
    count bounds the nesting; a deeper halo only recomputes more cells)."""
    depth = pde.stencil_depth(state)
    if depth is not None:
        return depth
    calls = wrap_with_bcs.calls
    pde.make_pde_rhs(state)(state_leaves(state), 0.0)
    return wrap_with_bcs.calls - calls


def _on_view(field: FieldBase, grid, device) -> FieldBase:
    """A zero field like `field` on an extended view's grid."""
    if isinstance(field, FieldCollection):
        return FieldCollection([_on_view(f, grid, device) for f in field], label=field.label)
    data = field.data.new_zeros((grid.dim,) * field.rank + tuple(grid.shape), device=device)
    return field.__class__(grid, data=data, label=field.label)


class BlockedRun:
    """A state's leaves split over the blocks of `mesh`, and the PDE's plain
    rhs, noise and post-step hook on them.

    The flat list of leaves is block-major: block b's leaves are
    ``flat[b * n : (b + 1) * n]`` for a state of n leaves, each on the block's
    device. :attr:`halo` is :func:`rhs_halo`.
    """

    def __init__(self, mesh, pde, state: FieldBase):
        self.mesh = mesh
        self.pde = pde
        self.device = state.device
        self.n_leaves = len(state_leaves(state))
        self.halo = rhs_halo(pde, state)
        self.exchange = HaloExchange(mesh, self.halo, spans=True)
        views = [mesh.extended_grid(b, self.halo) for b in range(len(mesh))]
        #: the global reductions of the rhs (``integral``), shared by the views
        self.reductions = GlobalReductions(mesh)
        for grid in views:
            grid.reductions = self.reductions
        #: whether the rhs reduces over the grid (known after its first evaluation)
        self._reduces: bool | None = None
        self._rhs = [pde.make_pde_rhs(_on_view(state, grid, device))
                     for grid, device in zip(views, mesh.devices, strict=True)]
        # each block's cells in its view
        self._interior = [(Ellipsis, *grid.interior()) for grid in views]

    def split(self, state_obj: FieldBase) -> list:
        """The flat list of every block's leaves (copies on the blocks' devices)."""
        return self.split_leaves(state_leaves(state_obj))

    def split_leaves(self, leaves) -> list:
        """The flat list of the blocks of global leaves."""
        per_leaf = [self.mesh.split_field_data(leaf) for leaf in leaves]
        return [blocks[b] for b in range(len(self.mesh)) for blocks in per_leaf]

    def _leaf_blocks(self, flat, leaf: int) -> list:
        return flat[leaf :: self.n_leaves]

    def combine_leaves(self, flat) -> list:
        """The global leaves of a flat list, on the state's device."""
        return [self.mesh.combine_field_data(self._leaf_blocks(flat, i), device=self.device)
                for i in range(self.n_leaves)]

    def combine(self, template: FieldBase, flat) -> FieldBase:
        """A state like `template` holding the blocks of a flat list."""
        return state_from_leaves(template, self.combine_leaves(flat))

    def rhs(self, flat, t) -> list:
        """The PDE's rates of every block: the leaves' extended views (one
        exchange a leaf), the plain rhs on each view, its halo trimmed. Where
        the rhs reduces over the grid, a first pass over the blocks records
        their partial integrals and a second evaluates the rates on their
        totals (:class:`~.mesh.GlobalReductions`)."""
        views = [self.exchange.extend(self._leaf_blocks(flat, i)) for i in range(self.n_leaves)]

        def evaluate():
            rates = []
            for b, (rhs, interior) in enumerate(zip(self._rhs, self._interior, strict=True)):
                rates += [rate[interior] for rate in rhs([v[b] for v in views], t)]
            return rates

        if self._reduces is False:
            return evaluate()
        self.reductions.record()
        try:
            rates = evaluate()
            self._reduces = self.reductions.total()
            if self._reduces:
                rates = evaluate()
        finally:
            self.reductions.done()
        return rates

    def noise_step(self, noise_step: Callable) -> Callable:
        """The serial Euler-Maruyama increments (`noise_step`, drawn on the
        global grid from the solver's generator, as the serial plain loop
        draws them) given to every block as its part."""

        def blocked(flat, t, generator, dt):
            noise = noise_step(self.combine_leaves(flat), t, generator, dt)
            return self.split_leaves(noise)

        return blocked

    def post_step_hook(self, state: FieldBase):
        """``(hook(flat, t, data) -> (flat, data), initial data)``: the PDE's
        hook on every block's own leaves, as ``pde_tpu`` runs it on every
        shard; the data carried on are block 0's (``pde_tpu`` returns shard
        0's replica)."""
        hooks = [self.pde.make_post_step_hook(block)[0] for block in self.mesh.split_field(state)]
        _, data = self.pde.make_post_step_hook(state)
        n = self.n_leaves

        def hook(flat, t, post_data):
            out, first = [], None
            for b, block_hook in enumerate(hooks):
                leaves, new_data = block_hook(flat[b * n : (b + 1) * n], t, post_data)
                out += list(leaves)
                first = new_data if b == 0 else first
            return out, first

        return hook, data
