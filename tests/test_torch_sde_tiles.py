"""The tile plan of the two Euler-Maruyama kernels (``ops/cuda_sde_2d``) and
their tiling at every tile the plan can choose.

The redesigned kernels keep the deterministic program's tile per (dtype, k)
and add two int index tables of the window to a block's shared memory. The
tile emulation of both kernels is held against the plain pass at every tile
of the plan, on a 16² periodic grid (a window's halo wraps the seam more
than once) and a ragged no-flux grid, for staged increments and each law
drawn in the kernel.
"""

import numpy as np
import pytest
import torch

import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_sde_2d as sde
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.ops import philox

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
F32, F64 = torch.float32, torch.float64
GRIDS = {
    "16^2 periodic": lambda: tpde.UnitGrid([16, 16], periodic=True),
    "ragged no-flux": lambda: tpde.CartesianGrid([(0, 2), (0, 3)], [21, 27]),
}
# route: the config that selects it
ROUTES = {
    "staged": {},
    "irwin4": {"sde.increment_dist": "irwin4"},
    "rademacher": {"sde.increment_dist": "rademacher"},
    "normal": {"sde.kernel_noise": "on"},
}


def _kpz_window(grid, route, dtype=F64):
    data = np.random.default_rng(3).uniform(-0.5, 0.5, grid.shape)
    state = tpde.ScalarField(grid, torch.as_tensor(data, dtype=dtype))
    with tpde.config(ROUTES[route]):
        window = tpde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1) \
            .make_fused_euler_window(state, 1e-4)
    return window, state.data


def test_kpz_tile_plan():
    """The KPZ programs keep tile 64 at every k of the ladder in both dtypes
    (the plan the generated-source hash tests pin): the redesigned kernels add
    only the two int index tables of the window to a block's shared memory."""
    for route in ROUTES:
        window, _ = _kpz_window(tpde.UnitGrid([4096, 4096], periodic=True), route)
        stencil = window.program.stencil
        assert stencil.ladder == [8, 4, 2, 1] and stencil.n_planes == 2
        for dtype in (F32, F64):
            assert stencil.tiles[dtype] == {8: 64, 4: 64, 2: 64, 1: 64}
        assert [spec.tile for spec in window.specs] == [64] * 4
    w = 64 + 2 * 8
    assert 2 * w * w * 8 + 2 * w * 4 <= cs.SMEM_BUDGET  # fp64 at k = 8 with its tables


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_every_noise_pass_has_a_tile(depth):
    """Deeper rhs (more halo per step): fp64 keeps a tile at every k of the
    ladder, and its planes with the index tables fit the budget."""
    grid = tpde.UnitGrid([64, 64], periodic=True)
    expression = "laplace(c)"
    for _ in range(depth - 1):
        expression = f"laplace({expression}) - 0.1 * gradient_squared(c)"
    state = tpde.ScalarField(grid, 0.1, dtype=F64)
    window = tpde.PDE({"c": expression}, noise=0.1).make_fused_euler_window(state, 1e-6)
    stencil = window.program.stencil
    assert stencil.depth == depth
    for dtype, size in ((F32, 4), (F64, 8)):
        for k in stencil.ladder:
            tile = stencil.tiles[dtype][k]
            assert tile in cs.TILES
            w = tile + 2 * k * depth
            assert stencil.n_planes * w * w * size + 2 * w * 4 <= cs.SMEM_BUDGET


@pytest.mark.parametrize("tile", cs.TILES)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("grid_id", GRIDS)
def test_tile_emulation_matches_plain_at_every_planned_tile(grid_id, route, tile):
    """Every k of the ladder at every tile of the plan, in fp64."""
    window, data = _kpz_window(GRIDS[grid_id](), route)
    ctl = (0x1234ABCD, 0x0BADF00D, 1000)
    for spec in window.specs:
        if route == "staged":
            noise = torch.as_tensor(
                np.random.default_rng(spec.k).normal(0.0, 0.05, (spec.k, *spec.shape)))
            expected = sde.sde_stencil_2d_plain(data, noise, spec)
            got = sde.sde_stencil_2d_tiled(data, noise, spec, tile=tile)
        else:
            assert spec.program.noise in philox.LAWS
            expected = sde.sde_kernel_noise_2d_plain(data, ctl, spec)
            got = sde.sde_kernel_noise_2d_tiled(data, ctl, spec, tile=tile)
        np.testing.assert_allclose(got.numpy(), expected.numpy(), **TOL)
