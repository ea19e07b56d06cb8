"""The module holding the CUDA kernel: ``make_affine_laplace_2d`` of the port
(its plain version, which the wrapper runs for CPU tensors) against
``pde_tpu``'s Pallas kernel in interpret mode, fp64, at rtol = atol = 1e-12;
the tile emulation against the plain version; and the kernel's gate."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import make_affine_laplace_2d as jax_affine_laplace_2d
from pde_tpu_torch.ops import cuda_cartesian as cc

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)

BC_CASES = [
    {"value": 0},
    {"value": 1.5},
    {"derivative": 0},
    {"derivative": 0.3},
    {"type": "mixed", "value": 2.0, "const": 0.5},
    {"curvature": 0.0},
    {"curvature": 1.0},
]


def _compare(grid_args, grid_kwargs, bc, a, b, k, seed, cls="CartesianGrid"):
    jgrid = getattr(jpde, cls)(*grid_args, **grid_kwargs)
    tgrid = getattr(tpde, cls)(*grid_args, **grid_kwargs)
    data = np.random.default_rng(seed).random(jgrid.shape)
    jbcs = None if bc is None else jgrid.get_boundary_conditions(bc)
    tbcs = None if bc is None else tgrid.get_boundary_conditions(bc)
    expected = jax_affine_laplace_2d(
        jgrid, a=a, b=b, k=k, dtype=np.float64, bcs=jbcs, interpret=True
    )(data)
    kernel = cc.make_affine_laplace_2d(tgrid, a=a, b=b, k=k, dtype=torch.float64, bcs=tbcs)
    launches = cc.affine_laplace_2d.launches
    got = kernel(torch.tensor(data))
    assert cc.affine_laplace_2d.launches == launches  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("k", [1, 4, 8, 16])
def test_periodic_matches_jax(k):
    _compare(([32, 128],), {"periodic": True}, None, 1.0, 0.01, k, seed=k, cls="UnitGrid")


@pytest.mark.parametrize("k", [1, 4])
def test_anisotropic_matches_jax(k):
    _compare(([(0, 1), (0, 4)], (32, 128)), {"periodic": True}, None, 0.0 if k == 1 else 1.0,
             1.0 if k == 1 else 1e-4, k, seed=10 + k)


@pytest.mark.parametrize("bc", BC_CASES, ids=str)
def test_bc_cases_match_jax(bc):
    _compare(([(0, 1), (0, 2)], (32, 32)), {}, bc, 1.0, 1e-4, 3, seed=20)


@pytest.mark.parametrize("k", [1, 16])
def test_no_flux_matches_jax(k):
    _compare(([32, 32],), {}, {"derivative": 0}, 1.0, 0.1, k, seed=30 + k, cls="UnitGrid")


@pytest.mark.parametrize(
    "bc,periodic",
    [({"x": "periodic", "y": {"derivative": 0}}, [True, False]),
     ({"x": {"derivative": 0}, "y": "periodic"}, [False, True])],
    ids=["periodic-x", "periodic-y"],
)
def test_mixed_periodicity_matches_jax(bc, periodic):
    _compare(([(0, 1), (0, 1)], (24, 24)), {"periodic": periodic}, bc, 1.0, 2e-4, 4, seed=40)


# -- the tile emulation: the kernel's halo, wrap and ghost index maths -----------------------
TILED_CASES = [
    # (shape, periodic, bc, k, tile): tiles smaller than the halo wrap more than once,
    # shapes not divisible by the tile leave ragged edge tiles
    ((32, 32), True, None, 16, 8),
    ((32, 32), True, None, 16, 64),
    ((20, 36), True, None, 5, 16),
    ((20, 36), False, {"derivative": 0}, 16, 8),
    ((20, 36), False, {"value": 1.5}, 7, 16),
    ((20, 36), False, {"type": "mixed", "value": 2.0, "const": 0.5}, 3, 8),
    ((20, 36), False, {"curvature": 1.0}, 16, 16),
    ((21, 19), [True, False], {"x": "periodic", "y": {"derivative": 0.3}}, 9, 8),
    ((21, 19), [False, True], {"x": {"value": 1}, "y": "periodic"}, 16, 8),
    ((2, 5), False, {"curvature": 1.0}, 16, 8),
]


@pytest.mark.parametrize("shape,periodic,bc,k,tile", TILED_CASES)
def test_tile_emulation_matches_plain(shape, periodic, bc, k, tile):
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], shape, periodic=periodic)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    spec = cc.affine_laplace_spec(grid, a=1.0, b=1e-3, k=k, dtype=torch.float64, bcs=bcs)
    data = torch.tensor(np.random.default_rng(50).random(shape))
    expected = cc.affine_laplace_2d_plain(data, spec)
    got = cc.affine_laplace_2d_tiled(data, spec, tile=tile)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), **TOL)


# -- the ladder window ---------------------------------------------------------------------
@pytest.mark.parametrize("steps", [0, 1, 16, 37])
def test_window_matches_plain_steps(steps):
    grid = tpde.UnitGrid([12, 20])
    bcs = grid.get_boundary_conditions({"derivative": 0})
    window = cc.make_fused_euler_window_2d(
        grid, diffusivity=0.1, dt=0.1, dtype=torch.float64, bcs=bcs
    )
    spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=1, dtype=torch.float64, bcs=bcs)
    data = torch.tensor(np.random.default_rng(60).random((12, 20)))
    expected = data
    for _ in range(steps):
        expected = cc.affine_laplace_2d_plain(expected, spec)
    got = window(data, steps)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), **TOL)


# -- the gate and the wrapper ------------------------------------------------------------------
def test_gate_rejects_corner_weight():
    """The 9-point mode (B1(e)) takes a fully periodic grid at k <= 8; the gate
    rejects the corner weight where pde_tpu's does (:841-860): with
    conditions, on a bounded grid, and deeper than 8 steps."""
    grid = tpde.UnitGrid([16, 16], periodic=True)
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 0.5}):
        kernel = cc.make_affine_laplace_2d(grid, a=1.0, b=0.1, k=4, dtype=torch.float32)
        assert kernel.k == 4
        with pytest.raises(tpde.KernelUnsupportedError, match="850-860"):
            cc.make_affine_laplace_2d(grid, a=1.0, b=0.1, k=12, dtype=torch.float32)
        with pytest.raises(tpde.KernelUnsupportedError, match="841-849"):
            cc.make_affine_laplace_2d(grid, a=1.0, b=0.1, k=4, dtype=torch.float32,
                                      bcs=grid.get_boundary_conditions("periodic"))
        bounded = tpde.UnitGrid([16, 16])
        with pytest.raises(tpde.KernelUnsupportedError, match="841-849"):
            cc.make_affine_laplace_2d(bounded, a=1.0, b=0.1, k=4, dtype=torch.float32,
                                      bcs=bounded.get_boundary_conditions({"derivative": 0}))
    cc.make_affine_laplace_2d(grid, a=1.0, b=0.1, k=4, dtype=torch.float32)


def test_gate_rejects_array_bc_values():
    """Per-point consts are kernel #1's side inputs (B1(c)); per-point ghost
    factors (a Robin gamma varying along a side) go to kernel #7."""
    grid = tpde.UnitGrid([16, 16])
    bcs = grid.get_boundary_conditions({"value": np.linspace(0, 1, 16)})
    assert cc.affine_laplace_spec(grid, a=1.0, b=0.1, k=2, dtype=torch.float32,
                                  bcs=bcs).side_arrays == (True,) * 4
    bcs = grid.get_boundary_conditions({"mixed": np.linspace(1, 2, 16)})
    with pytest.raises(tpde.KernelUnsupportedError, match="B1\\(c\\)"):
        cc.make_affine_laplace_2d(grid, k=2, dtype=torch.float32, bcs=bcs)
    # a uniform array collapses to a scalar and is supported
    bcs = grid.get_boundary_conditions({"value": np.full(16, 0.5)})
    cc.make_affine_laplace_2d(grid, k=2, dtype=torch.float32, bcs=bcs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.complex64])
def test_gate_rejects_dtypes(dtype):
    """fp16 and complex data are refused; bf16 (B1(f)) is taken where the
    columns are periodic and refused where they are bounded, as pde_tpu's
    gates (pde_tpu/ops/pallas_cartesian.py:306-315, 775-790, 889-899)."""
    grid = tpde.UnitGrid([16, 16], periodic=True)
    if dtype == torch.bfloat16:
        assert cc.make_affine_laplace_2d(grid, k=1, dtype=dtype).k == 1
        bounded = tpde.UnitGrid([16, 16], periodic=[True, False])
        with pytest.raises(tpde.KernelUnsupportedError, match="775-790, 889-899"):
            cc.make_affine_laplace_2d(bounded, k=1, dtype=dtype,
                                      bcs=bounded.get_boundary_conditions("auto_periodic_neumann"))
        return
    with pytest.raises(tpde.KernelUnsupportedError):
        cc.make_affine_laplace_2d(grid, k=1, dtype=dtype)


def test_gate_rejects_geometry():
    # past the register march's 16 steps the deep march takes the pass, up to
    # pde_tpu's geometry gate of 32 (C18)
    assert cc.make_affine_laplace_2d(tpde.UnitGrid([16, 16], periodic=True), k=17).k == 17
    with pytest.raises(tpde.KernelUnsupportedError, match="1 <= k <= 32"):
        cc.make_affine_laplace_2d(tpde.UnitGrid([16, 16], periodic=True), k=33)
    with pytest.raises(tpde.KernelUnsupportedError, match="2D CartesianGrid"):
        cc.make_affine_laplace_2d(tpde.UnitGrid([16, 16, 16], periodic=True), k=1)
    with pytest.raises(tpde.KernelUnsupportedError, match="explicit boundary"):
        cc.make_affine_laplace_2d(tpde.UnitGrid([16, 16]), k=1)
    grid = tpde.UnitGrid([1, 16], periodic=[False, True])
    with pytest.raises(tpde.KernelUnsupportedError, match="at least 2 cells"):
        cc.make_affine_laplace_2d(grid, k=1, bcs=grid.get_boundary_conditions("auto_periodic_neumann"))
    grid = tpde.UnitGrid([16, 16], periodic=True)
    with pytest.raises(tpde.KernelUnsupportedError, match="Anti-periodic"):
        cc.make_affine_laplace_2d(grid, k=1, bcs=grid.get_boundary_conditions("anti-periodic"))


def test_wrapper_checks_inputs():
    grid = tpde.UnitGrid([8, 8], periodic=True)
    spec = cc.affine_laplace_spec(grid, a=1.0, b=0.1, k=2, dtype=torch.float32)
    with pytest.raises(ValueError):
        cc.affine_laplace_2d(torch.zeros(8, 8, dtype=torch.float64), spec)
    with pytest.raises(ValueError):
        cc.affine_laplace_2d(torch.zeros(8, 9), spec)
    with pytest.raises(RuntimeError, match="No affine Laplacian kernel"):
        cc.affine_laplace_2d(torch.zeros(8, 8, device="meta"), spec)
    data = torch.rand(8, 8, generator=torch.Generator().manual_seed(0))
    out = torch.empty_like(data)
    assert cc.affine_laplace_2d(data, spec, out=out) is out
    torch.testing.assert_close(out, cc.affine_laplace_2d_plain(data, spec), rtol=0, atol=0)
