"""The port's mesh of blocks (``pde_tpu_torch.parallel``) against
``pde_tpu.parallel``: the decomposition, the subgrids, the checks; the
split/combine round trip; and the halo exchange (interior halos are the global
neighbours, periodic halos the wrap, corners arrive in two hops)."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.parallel import GridMesh as JaxGridMesh
from pde_tpu.parallel import _get_optimal_decomposition as jax_decomposition
from pde_tpu_torch.models.base import state_leaves
from pde_tpu_torch.parallel import GridMesh, HaloExchange, _get_optimal_decomposition
from pde_tpu_torch.utils import mpi

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


DECOMPOSITIONS = [
    ([32, 32], 8), ([64], 8), ([6, 4], 6), ([16, 8], 4), ([24, 20], 4), ([12, 10], 2),
    ([64, 64, 64], 8), ([128, 2], 4), ([12, 18], 6), ([30, 20], 6), ([7, 14], 7), ([16, 16], 1),
]


@pytest.mark.parametrize("shape, num", DECOMPOSITIONS)
def test_optimal_decomposition_matches_jax(shape, num):
    assert _get_optimal_decomposition(shape, num) == jax_decomposition(shape, num)


def test_optimal_decomposition_raises_like_jax():
    with pytest.raises(ValueError):
        jax_decomposition([5, 5], 8)
    with pytest.raises(ValueError, match="Cannot decompose"):
        _get_optimal_decomposition([5, 5], 8)


@pytest.mark.parametrize("decomposition", [[4, 2], [2, 4], [1, 8], [2, 1]])
def test_subgrids_match_jax(decomposition):
    args = ([(0, 4), (-1, 1)], (16, 8))
    jmesh = JaxGridMesh(jpde.CartesianGrid(*args, periodic=[True, False]), decomposition)
    mesh = GridMesh(tpde.CartesianGrid(*args, periodic=[True, False]), decomposition)
    assert len(mesh) == len(jmesh) and mesh.shape == jmesh.shape
    for i in range(len(mesh)):
        got, want = mesh.subgrid_for(i), jmesh.subgrid_for(i)
        assert got.shape == want.shape
        assert tuple(got.periodic) == tuple(want.periodic)
        np.testing.assert_allclose(got.axes_bounds, want.axes_bounds, rtol=0, atol=1e-15)
        np.testing.assert_allclose(got.discretization, want.discretization)
    assert mesh.subgrid.shape == jmesh.subgrid.shape


def test_mesh_checks():
    grid = tpde.UnitGrid([10, 10])
    with pytest.raises(ValueError, match="cannot be split"):
        GridMesh(grid, [3, 1])
    with pytest.raises(ValueError, match="length must match"):
        GridMesh(grid, [2])
    with pytest.raises(ValueError, match="needs 4096 devices, got 8"):
        GridMesh(tpde.UnitGrid([64, 64]), [64, 64])
    assert GridMesh.from_grid(tpde.UnitGrid([32, 32])).decomposition == [4, 2]
    assert GridMesh.from_grid(tpde.UnitGrid([32, 32]), 2).decomposition == [2, 1]


def test_default_devices_follow_the_config():
    assert GridMesh(tpde.UnitGrid([16, 16]), [4, 2]).devices == [torch.device("cpu")] * 8
    with tpde.config({"parallel.devices_per_device": 3}):
        with pytest.raises(ValueError, match="needs 4 devices, got 3"):
            GridMesh(tpde.UnitGrid([16, 16]), [2, 2])


def test_edge_flags():
    mesh = GridMesh(tpde.UnitGrid([16, 16], periodic=[False, True]), [4, 2])
    flags = [mesh.edge_flags(b) for b in range(len(mesh))]
    assert flags[0] == [1, 0, 0, 0] and flags[1] == [1, 0, 0, 0]
    assert flags[2] == [0, 0, 0, 0] and flags[7] == [0, 1, 0, 0]
    assert GridMesh(tpde.UnitGrid([16, 16]), [1, 1]).edge_flags(0) == [1, 1, 1, 1]


@pytest.mark.parametrize("decomposition", [[2, 2], [4, 2], [1, 8]])
def test_split_combine_round_trip(decomposition):
    grid = tpde.UnitGrid([8, 16], periodic=True)
    mesh = GridMesh(grid, decomposition)
    gen = np.random.default_rng(0)
    scalar = tpde.ScalarField(grid, gen.random((8, 16)), dtype=torch.float64)
    vector = tpde.VectorField(grid, gen.random((2, 8, 16)), dtype=torch.float64)
    collection = tpde.FieldCollection([scalar, vector])
    for field in (scalar, vector, collection):
        parts = mesh.split_field(field)
        assert len(parts) == len(mesh)
        combined = mesh.combine_field(parts)
        for a, b in zip(state_leaves(combined), state_leaves(field)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    first = mesh.split_field(scalar)[0]
    assert first.grid.shape == mesh.subgrid.shape
    blocks = mesh.scatter(vector.data, rank=1)
    assert blocks[0].shape == (2,) + mesh.local_shape
    torch.testing.assert_close(mesh.gather(blocks), vector.data, rtol=0, atol=0)
    torch.testing.assert_close(mesh.allgather(blocks), vector.data, rtol=0, atol=0)
    assert mesh.broadcast(3.5) == 3.5
    sub = mesh.extract_subfield(vector)
    assert sub.data.shape == (2,) + mesh.local_shape and not bool(sub.data.any())


def test_mpi_helpers_are_one_process():
    assert (mpi.size, mpi.rank, mpi.is_main, mpi.parallel_run) == (1, 0, True, False)
    assert mpi.mpi_allreduce(2.0) == 2.0 and mpi.mpi_bcast("x") == "x"
    with pytest.raises(NotImplementedError):
        mpi.mpi_send(1, 0)


EXCHANGES = [
    ((24, 20), [2, 2], (True, True), 3),
    ((24, 20), [4, 2], (True, True), 6),
    ((24, 20), [1, 2], (True, True), 4),
    ((24, 20), [4, 2], (False, True), 3),
    ((24, 20), [2, 2], (False, False), 5),
    ((16, 16), [2, 4], (True, False), 4),
]


@pytest.mark.parametrize("shape, decomposition, periodic, halo", EXCHANGES)
def test_halo_exchange(shape, decomposition, periodic, halo):
    """After one exchange each extended buffer holds the global neighbours of
    its block: np.pad(..., mode="wrap") of the global data on periodic axes,
    zeros beyond a non-periodic global edge (the kernels rewrite those)."""
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], shape, periodic=list(periodic))
    mesh = GridMesh(grid, decomposition)
    data = np.random.default_rng(1).random(shape)
    exchange = HaloExchange(mesh, halo)
    buffers = exchange.allocate(1, torch.float64)
    exchange.load(buffers, [[b] for b in mesh.split_field_data(torch.tensor(data))])
    copies = HaloExchange.copies
    exchange.copy(exchange.strips(buffers))
    expected = np.pad(data, halo, mode="wrap")
    for axis, per in enumerate(periodic):
        if not per:
            edge = [slice(None)] * 2
            edge[axis] = slice(0, halo)
            expected[tuple(edge)] = 0
            edge[axis] = slice(shape[axis] + halo, None)
            expected[tuple(edge)] = 0
    n, m = mesh.local_shape
    for b in range(len(mesh)):
        i, j = mesh.block_index(b)
        want = expected[i * n : i * n + n + 2 * halo, j * m : j * m + m + 2 * halo]
        np.testing.assert_array_equal(buffers[b][0].numpy(), want)
    # two row strips and two column strips per block, fewer at non-periodic edges
    strips = sum(
        (i > 0 or periodic[0]) + (i < decomposition[0] - 1 or periodic[0])
        + (j > 0 or periodic[1]) + (j < decomposition[1] - 1 or periodic[1])
        for i, j in map(mesh.block_index, range(len(mesh)))
    )
    assert HaloExchange.copies - copies == strips
    interiors = exchange.interiors(buffers)
    torch.testing.assert_close(
        mesh.combine_field_data([planes[0] for planes in interiors]), torch.tensor(data),
        rtol=0, atol=0,
    )


def test_halo_exchange_needs_blocks_as_wide_as_the_halo():
    mesh = GridMesh(tpde.UnitGrid([16, 16], periodic=True), [4, 2])
    with pytest.raises(tpde.KernelUnsupportedError, match="Shard too small"):
        HaloExchange(mesh, 5)


EXCHANGES_3D = [
    ((8, 6, 10), [2, 2, 2], (True, True, True), 2),
    ((8, 6, 10), [2, 1, 2], (True, False, True), 3),
    ((8, 6, 10), [1, 2, 2], (False, False, False), 2),
    ((12, 6, 8), [4, 1, 2], (False, True, True), 3),
    ((8, 8, 8), [1, 1, 1], (True, True, True), 4),
    ((8, 8, 8), [2, 2, 2], (False, True, False), 4),
]


@pytest.mark.parametrize("shape, decomposition, periodic, halo", EXCHANGES_3D)
def test_halo_exchange_3d(shape, decomposition, periodic, halo):
    """After one exchange each extended 3D buffer holds the global neighbours
    of its block, edge and corner cells included (they come from the
    diagonal neighbours in two and three hops): np.pad(..., mode="wrap") of
    the global data on periodic axes, zeros beyond a non-periodic global face
    (nothing is copied there)."""
    grid = tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)], shape, periodic=list(periodic))
    mesh = GridMesh(grid, decomposition)
    data = np.random.default_rng(2).random(shape)
    exchange = HaloExchange(mesh, halo)
    buffers = exchange.allocate(2, torch.float64)
    exchange.load(buffers, [[b, 2 * b] for b in mesh.split_field_data(torch.tensor(data))])
    copies = HaloExchange.copies
    strips = exchange.strips(buffers)
    exchange.copy(strips)
    expected = np.pad(data, halo, mode="wrap")
    for axis, per in enumerate(periodic):
        if not per:
            face = [slice(None)] * 3
            face[axis] = slice(0, halo)
            expected[tuple(face)] = 0
            face[axis] = slice(shape[axis] + halo, None)
            expected[tuple(face)] = 0
    local = mesh.local_shape
    for b in range(len(mesh)):
        index = mesh.block_index(b)
        want = expected[tuple(slice(i * n, i * n + n + 2 * halo) for i, n in zip(index, local))]
        np.testing.assert_array_equal(buffers[b][0].numpy(), want)
        np.testing.assert_array_equal(buffers[b][1].numpy(), 2 * want)
    # copy order: x, then y of the x-extended buffers, then z of the xy-extended
    # ones; two slabs per block and axis (fewer at non-periodic faces), per plane
    order = []
    for axis in range(3):
        slabs = sum((i > 0 or periodic[axis]) + (i < decomposition[axis] - 1 or periodic[axis])
                    for i in (mesh.block_index(b)[axis] for b in range(len(mesh))))
        slab = tuple(n + 2 * halo if a < axis else halo if a == axis else n
                     for a, n in enumerate(local))
        order += [slab] * (2 * slabs)
    assert [tuple(dst.shape) for dst, _ in strips] == order
    assert HaloExchange.copies - copies == len(strips)
    interiors = exchange.interiors(buffers)
    torch.testing.assert_close(
        mesh.combine_field_data([planes[0] for planes in interiors]), torch.tensor(data),
        rtol=0, atol=0,
    )


@pytest.mark.parametrize("shape, decomposition, copies", [
    ((16, 16), [2, 2], 16), ((16, 16), [4, 2], 32), ((8, 8, 8), [2, 2, 2], 48),
    ((16, 8, 8), [2, 1, 1], 12), ((8, 8, 8), [1, 1, 1], 6),
])
def test_copies_per_pass(shape, decomposition, copies):
    """Every axis is extended: two slabs per block and axis on a periodic grid
    (16 per 2x2 pass, 48 per 2x2x2 pass; an uncut axis wraps onto its own
    block)."""
    mesh = GridMesh(tpde.UnitGrid(list(shape), periodic=True), decomposition)
    exchange = HaloExchange(mesh, 2)
    assert len(exchange.strips(exchange.allocate(1, torch.float32))) == copies


def test_edge_flags_3d_follow_pde_tpu():
    shape, periodic = (16, 8, 8), [False, True, False]
    mesh = GridMesh(tpde.CartesianGrid([(0, 1)] * 3, shape, periodic=periodic), [2, 2, 2])
    jmesh = JaxGridMesh(jpde.CartesianGrid([(0, 1)] * 3, shape, periodic=periodic), [2, 2, 2])
    for b in range(len(mesh)):
        index = mesh.block_index(b)
        want = []
        for axis, i in enumerate(index):
            n = jmesh.decomposition[axis]
            want += [int(not periodic[axis] and i == 0), int(not periodic[axis] and i == n - 1)]
        assert mesh.edge_flags(b) == want
    assert mesh.edge_flags(0) == [1, 0, 0, 0, 1, 0] and mesh.edge_flags(7) == [0, 1, 0, 0, 0, 1]
