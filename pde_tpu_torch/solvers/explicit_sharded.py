"""Explicit Euler solver over a decomposed grid.

Port of :mod:`pde_tpu.solvers.explicit_sharded`: any solver takes a
``decomposition``; this class gives the names ``explicit_sharded`` and
``explicit_mpi`` with ``decomposition="auto"`` by default. The blocks are held
by one process (:class:`~pde_tpu_torch.parallel.GridMesh`).
"""

from __future__ import annotations

from ..models.base import PDEBase
from .euler import EulerSolver


class ExplicitShardedSolver(EulerSolver):
    """Explicit Euler solver distributed over a mesh of blocks."""

    name = "explicit_sharded"

    def __init__(
        self,
        pde: PDEBase,
        *,
        backend: str = "auto",
        adaptive: bool = False,
        tolerance: float = 1e-4,
        decomposition="auto",
    ):
        super().__init__(pde, backend=backend, adaptive=adaptive, tolerance=tolerance,
                         decomposition=decomposition)


class ExplicitMPISolver(ExplicitShardedSolver):
    """Alias under the name of the MPI solver of py-pde."""

    name = "explicit_mpi"
