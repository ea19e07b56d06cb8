"""The MPI helpers of :mod:`pde_tpu.utils.mpi`, for one process.

The port runs a decomposed grid in one process that holds every block
(:class:`pde_tpu_torch.parallel.GridMesh`), so there is one rank: ``size`` is
1, ``rank`` is 0 and ``is_main`` is True. Runs over several processes
(``torch.distributed``) are ROADMAP A9's last item; until then the collectives
over one participant are the identity, and point-to-point messages raise.
"""

from __future__ import annotations

#: number of processes
size = 1
#: index of this process
rank = 0
#: whether this is the main process
is_main = True
#: whether a parallel environment was set up (one process always is)
initialized = True
#: whether more than one process takes part
parallel_run = False


def mpi_send(data, dest: int, tag: int = 0) -> None:
    raise NotImplementedError(
        "Point-to-point messaging is not exposed; the halos of a decomposed run move "
        "by copies between blocks (see pde_tpu_torch.parallel)"
    )


def mpi_recv(data, source: int, tag: int = 0) -> None:
    raise NotImplementedError(
        "Point-to-point messaging is not exposed; the halos of a decomposed run move "
        "by copies between blocks (see pde_tpu_torch.parallel)"
    )


def mpi_bcast(data, root: int = 0):
    """Broadcast over one process: returns `data` unchanged."""
    return data


def mpi_allreduce(data, operator: str = "SUM"):
    """All-reduce over one process: returns `data` unchanged."""
    if operator not in ("SUM", "MAX", "MIN"):
        raise ValueError(f"Unsupported operator `{operator}`")
    return data
