"""The module holding the 3D affine Laplacian kernel (``ops/cuda_cartesian_3d``).

The port's plain version (what the wrapper runs for CPU tensors) and the
emulation of the kernel's tiling are held against ``pde_tpu``'s Pallas kernel
``make_affine_laplace_3d`` (kernel #3) in interpret mode on the same numpy
inputs, fp64, at rtol = atol = 1e-12, at every k the JAX kernel takes; the
ladder window against ``pde_tpu``'s ``make_fused_euler_window_3d``; and the
kernel's gate and wrapper.
"""

import functools

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import make_affine_laplace_3d as jax_affine_laplace_3d
from pde_tpu.ops.pallas_cartesian import make_fused_euler_window_3d as jax_euler_window_3d
from pde_tpu_torch.ops import cuda_cartesian_3d as c3

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)

# id: (bounds, shape, periodic, bc); the JAX kernel's band needs nx % 8 == 0
CASES = {
    "periodic": ([(0, 1)] * 3, (16, 8, 8), True, None),
    "noflux": ([(0, 1)] * 3, (16, 8, 8), False, {"derivative": 0}),
    "mixed-xy": ([(0, 1)] * 3, (16, 8, 8), [False, False, True],
                 {"x": {"value": 1}, "y": {"derivative": 0.5}, "z": "periodic"}),
    "mixed-yz": ([(0, 1)] * 3, (16, 8, 8), [True, False, False],
                 {"x": "periodic", "y": {"curvature": 0}, "z": {"value": 0.5}}),
    "anisotropic": ([(0, 1), (0, 2), (0, 3)], (16, 8, 8), True, None),
    "robin-16": ([(0, 1), (0, 2), (0, 1)], (16, 16, 16), False,
                 {"type": "mixed", "value": 2.0, "const": 0.5}),
}
B = 1e-3


def _grids(case_id):
    bounds, shape, periodic, bc = CASES[case_id]
    jgrid = jpde.CartesianGrid(bounds, shape, periodic=periodic)
    tgrid = tpde.CartesianGrid(bounds, shape, periodic=periodic)
    return jgrid, tgrid, bc


def _data(case_id):
    return np.random.default_rng(sorted(CASES).index(case_id)).random(CASES[case_id][1])


@functools.cache
def _jax_pass(case_id, k):
    """Kernel #3 in interpret mode: one k-step pass."""
    jgrid, _, bc = _grids(case_id)
    bcs = None if bc is None else jgrid.get_boundary_conditions(bc)
    kernel, k_used = jax_affine_laplace_3d(
        jgrid, a=1.0, b=B, k=k, dtype=np.float64, bcs=bcs, interpret=True
    )
    assert k_used == k
    return np.asarray(kernel(_data(case_id)))


def _spec(case_id, k):
    _, tgrid, bc = _grids(case_id)
    bcs = None if bc is None else tgrid.get_boundary_conditions(bc)
    return c3.affine_laplace_3d_spec(tgrid, a=1.0, b=B, k=k, dtype=torch.float64, bcs=bcs)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("case_id", CASES)
def test_plain_matches_jax_kernel(case_id, k):
    spec = _spec(case_id, k)
    launches = c3.affine_laplace_3d.launches
    got = c3.affine_laplace_3d(torch.tensor(_data(case_id)), spec)
    assert c3.affine_laplace_3d.launches == launches  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), _jax_pass(case_id, k), **TOL)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("case_id", CASES)
def test_tile_emulation_matches_jax_kernel(case_id, k):
    """Tiles of 4 x 4 x 4 (halos of up to 4 cells wrap the 8-cell axes'
    seams, on every axis at once where all are periodic)."""
    got = c3.affine_laplace_3d_tiled(torch.tensor(_data(case_id)), _spec(case_id, k), tile=(4, 4, 4))
    np.testing.assert_allclose(got.numpy(), _jax_pass(case_id, k), **TOL)


# -- the tile emulation at the kernel's own tiles, on edge grids --------------------------------
EDGE_CASES = {
    # the triple seam: halos deeper than the grid on every axis
    "8^3 periodic": ([(0, 1)] * 3, (8, 8, 8), True, None),
    "8^3 no-flux": ([(0, 1)] * 3, (8, 8, 8), False, {"derivative": 0}),
    # ragged tiles along every axis, anisotropic, faces that meet
    "ragged no-flux": ([(0, 1), (0, 2), (0, 3)], (18, 21, 34), False, {"derivative": 0}),
    "ragged mixed": ([(0, 1), (0, 2), (0, 3)], (18, 21, 34), [False, True, False],
                     {"x-": {"value": 1}, "x+": {"curvature": 0.5}, "y": "periodic",
                      "z": {"type": "mixed", "value": 1.0, "const": 0.2}}),
    "two cells": ([(0, 1)] * 3, (2, 3, 2), False, {"value": 1.5}),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case_id", EDGE_CASES)
def test_kernel_tiles_match_plain_at_every_k(case_id, dtype):
    bounds, shape, periodic, bc = EDGE_CASES[case_id]
    grid = tpde.CartesianGrid(bounds, shape, periodic=periodic)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    data = torch.tensor(np.random.default_rng(70).random(shape), dtype=dtype)
    for k in range(1, c3.MAX_STEPS + 1):
        spec = c3.affine_laplace_3d_spec(grid, a=1.0, b=2e-3, k=k, dtype=dtype, bcs=bcs)
        expected = c3.affine_laplace_3d_plain(data, spec)
        for tile in (None, (2, 3, 5)):
            got = c3.affine_laplace_3d_tiled(data, spec, tile=tile)
            torch.testing.assert_close(got, expected, rtol=0, atol=0)


# -- the ladder window ---------------------------------------------------------------------
@pytest.mark.parametrize("case_id", ["periodic", "mixed-xy"])
def test_window_matches_jax_window(case_id):
    """37 steps (not a multiple of any k): the port's ladder (4, 2, 1)
    against the JAX package's (4, 2, 1), in interpret mode."""
    jgrid, tgrid, bc = _grids(case_id)
    jbcs = None if bc is None else jgrid.get_boundary_conditions(bc)
    tbcs = None if bc is None else tgrid.get_boundary_conditions(bc)
    data = _data(case_id)
    expected = jax_euler_window_3d(
        jgrid, diffusivity=0.1, dt=0.01, dtype=np.float64, bcs=jbcs, interpret=True
    )(data, 37)
    window = c3.make_fused_euler_window_3d(
        tgrid, diffusivity=0.1, dt=0.01, dtype=torch.float64, bcs=tbcs
    )
    assert [spec.k for spec in window.specs] == [4, 2, 1]
    got = window(torch.tensor(data), 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("steps", [0, 1, 2, 5])
def test_window_matches_plain_steps(steps):
    grid = tpde.CartesianGrid([(0, 1)] * 3, (6, 5, 7))
    bcs = grid.get_boundary_conditions({"derivative": 0})
    window = c3.make_fused_euler_window_3d(
        grid, diffusivity=0.1, dt=1e-3, dtype=torch.float64, bcs=bcs
    )
    one = c3.affine_laplace_3d_spec(grid, a=1.0, b=1e-4, k=1, dtype=torch.float64, bcs=bcs)
    data = torch.tensor(np.random.default_rng(71).random((6, 5, 7)))
    expected = data
    for _ in range(steps):
        expected = c3.affine_laplace_3d_plain(expected, one)
    np.testing.assert_allclose(window(data, steps).numpy(), expected.numpy(), **TOL)


# -- the tile and k choice -------------------------------------------------------------------
def test_tiles_fit_the_budget():
    """The march's plan for any number of shared-memory planes per level: the
    largest y tile whose planes fit the budget, None when none does."""
    for levels, slots, halo in ((1, 2, 1), (4, 2, 4), (3, 3, 3), (2, 6, 4), (4, 6, 4)):
        for itemsize in (4, 8):
            plan = c3.march_plan(levels, slots, halo, itemsize)
            if plan is None:
                ty = c3.MARCH_TY[-1]
            else:
                cx, ty, tz = plan
                assert (cx, tz) == (c3.MARCH_CX, c3.MARCH_TZ) and ty in c3.MARCH_TY
                window = (ty + 2 * halo) * (tz + 2 * halo)
                assert levels * slots * window * itemsize <= c3.SMEM_BUDGET
                if ty == c3.MARCH_TY[0]:
                    continue
                ty = c3.MARCH_TY[c3.MARCH_TY.index(ty) - 1]  # the next wider tile
            window = (ty + 2 * halo) * (c3.MARCH_TZ + 2 * halo)
            assert levels * slots * window * itemsize > c3.SMEM_BUDGET
    # the affine kernels' plan is the march's at two planes per level
    for k in range(1, c3.MAX_STEPS + 1):
        assert c3.march_plan_3d(k, 4) == c3.march_plan(k, c3.MARCH_SLOTS, k, 4)
    assert c3.march_plan(4, 6, 4, 8) is None


# -- the gate and the wrapper ------------------------------------------------------------------
def test_gate_rejects():
    periodic = tpde.UnitGrid([8, 8, 8], periodic=True)
    with pytest.raises(tpde.KernelUnsupportedError, match="3D CartesianGrid"):
        c3.make_affine_laplace_3d(tpde.UnitGrid([8, 8], periodic=True), k=1)
    with pytest.raises(tpde.KernelUnsupportedError, match="1 <= k <= 4"):
        c3.make_affine_laplace_3d(periodic, k=5)
    with pytest.raises(tpde.KernelUnsupportedError, match="explicit boundary"):
        c3.make_affine_laplace_3d(tpde.UnitGrid([8, 8, 8]), k=1)
    for dtype in (torch.bfloat16, torch.float16):
        with pytest.raises(tpde.KernelUnsupportedError, match="float32 or float64"):
            c3.make_affine_laplace_3d(periodic, k=1, dtype=dtype)
    with pytest.raises(tpde.KernelUnsupportedError, match="Anti-periodic"):
        c3.make_affine_laplace_3d(periodic, k=1, bcs=periodic.get_boundary_conditions("anti-periodic"))
    grid = tpde.UnitGrid([8, 1, 8], periodic=[True, False, True])
    with pytest.raises(tpde.KernelUnsupportedError, match="at least 2 cells"):
        c3.make_affine_laplace_3d(grid, k=1, bcs=grid.get_boundary_conditions("auto_periodic_neumann"))
    grid = tpde.UnitGrid([8, 8, 8])
    face = np.linspace(0, 1, 64).reshape(8, 8)
    with pytest.raises(tpde.KernelUnsupportedError, match="B1\\(c\\)"):
        c3.make_affine_laplace_3d(grid, k=1, bcs=grid.get_boundary_conditions({"value": face}))
    # more x chunks than a CUDA grid's z extent holds
    assert -(-2**22 // c3.march_plan_3d(1, 4)[0]) > 65535
    with pytest.raises(tpde.KernelUnsupportedError, match="tiles"):
        c3.affine_laplace_3d_spec(tpde.UnitGrid([2**22, 2, 2], periodic=True), a=1.0, b=0.1, k=1,
                                  dtype=torch.float32)


def test_wrapper_checks_inputs():
    grid = tpde.UnitGrid([8, 8, 8], periodic=True)
    spec = c3.affine_laplace_3d_spec(grid, a=1.0, b=0.1, k=2, dtype=torch.float32)
    with pytest.raises(ValueError):
        c3.affine_laplace_3d(torch.zeros(8, 8, 8, dtype=torch.float64), spec)
    with pytest.raises(ValueError):
        c3.affine_laplace_3d(torch.zeros(8, 8, 9), spec)
    with pytest.raises(RuntimeError, match="No 3D affine Laplacian kernel"):
        c3.affine_laplace_3d(torch.zeros(8, 8, 8, device="meta"), spec)
    data = torch.rand(8, 8, 8, generator=torch.Generator().manual_seed(0))
    out = torch.empty_like(data)
    assert c3.affine_laplace_3d(data, spec, out=out) is out
    torch.testing.assert_close(out, c3.affine_laplace_3d_plain(data, spec), rtol=0, atol=0)


def test_build_unit_per_periodicity():
    """One generated source per periodicity of the three axes, every k and
    dtype at the plan the host picks."""
    unit = c3.kernel_source((True, False, True))
    assert unit is c3.kernel_source((1, 0, 1))
    assert unit.library == "affine_laplace_3d" and len(unit.digest) == 16
    assert 'extern "C" int affine_laplace_3d_f32' in unit.source
    for k in range(1, c3.MAX_STEPS + 1):
        cx, ty, tz = c3.march_plan_3d(k, 4)
        assert (f"case {k}: return pde_tpu_torch::launch_affine_3d<float, {k}, {cx}, {ty}, {tz}, "
                "true, false, true>") in unit.source
    assert c3.kernel_source((True,) * 3).digest != unit.digest
