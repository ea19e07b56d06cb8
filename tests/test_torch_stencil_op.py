"""The ``cuda`` engine's operator registry and the module holding its kernel
(``ops/cuda_stencil_op_2d``, the counterpart of ``pde_tpu``'s
``make_stencil_op_pallas``).

``get_backend("cuda").make_operator`` on CPU tensors runs the kernels' plain
versions; it is held against ``pde_tpu``'s ``get_backend("pallas")`` registry
in interpret mode on the same float32 inputs (rtol 1e-5, atol 1e-6, as
``pde_tpu``'s own registry test: its standalone kernels compute in float32),
and in float64 against ``pde_tpu``'s plain operators at 1e-12. The emulation
of the kernel's tiling is held against the plain version on grids whose tiles
touch the periodic seam and on ragged anisotropic ones. Also: the registry's
honesty (what it serves, and the raises for everything else).
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import KernelUnsupportedError
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_stencil_op_2d as so

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


RANK_IN = {"laplace": 0, "gradient": 0, "gradient_squared": 0, "divergence": 1,
           "vector_laplace": 1, "vector_gradient": 1, "tensor_divergence": 2}
# id: (bounds, shape, periodic, bc); the affine case is that of pde_tpu's
# tests/test_backends_depth.py::test_pallas_backend_operator_registry
CASES = {
    "periodic": ([(0, 16), (0, 16)], (16, 16), True, "periodic"),
    "affine": ([(0, 1), (0, 2)], (16, 16), False,
               {"x-": {"value": 0.3}, "x+": {"derivative": 0}, "y": {"derivative": 0.1}}),
}


def _inputs(case_id, op):
    bounds, shape, periodic, bc = CASES[case_id]
    rng = np.random.default_rng(sorted(RANK_IN).index(op) + 10 * sorted(CASES).index(case_id))
    data = rng.uniform(-1, 1, (2,) * RANK_IN[op] + shape)
    return (jpde.CartesianGrid(bounds, shape, periodic=periodic),
            tpde.CartesianGrid(bounds, shape, periodic=periodic), bc, data)


@pytest.mark.parametrize("case_id", CASES)
@pytest.mark.parametrize("op", RANK_IN)
def test_registry_matches_pallas_registry(case_id, op, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jgrid, tgrid, bc, data = _inputs(case_id, op)
    data32 = data.astype(np.float32)
    expected = np.asarray(jpde.get_backend("pallas").make_operator(jgrid, op, bc=bc)(data32))
    got = tpde.get_backend("cuda").make_operator(tgrid, op, bc=bc)(torch.tensor(data32))
    assert got.dtype == torch.float32 and got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case_id", CASES)
@pytest.mark.parametrize("op", RANK_IN)
def test_registry_fp64_matches_plain_operators(case_id, op):
    jgrid, tgrid, bc, data = _inputs(case_id, op)
    expected = np.asarray(jgrid.make_operator(op, bc=bc)(data))
    got = tpde.get_backend("cuda").make_operator(tgrid, op, bc=bc)(torch.tensor(data)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12 * np.abs(expected).max())
    # the torch engine serves the plain operator itself
    plain = tpde.get_backend("torch").make_operator(tgrid, op, bc=bc)(torch.tensor(data))
    np.testing.assert_allclose(plain.numpy(), expected, rtol=1e-12, atol=1e-12)


# id: (bounds, shape, periodic, bc)
TILE_GRIDS = {
    "periodic 16^2 (tiles touch the seam)": ([(0, 16), (0, 16)], (16, 16), True, None),
    "periodic 3x5 (halo wraps the whole grid)": ([(0, 3), (0, 5)], (3, 5), True, None),
    "ragged anisotropic no-flux 13x21": ([(0, 1), (0, 3)], (13, 21), False, {"derivative": 0}),
    "ragged mixed 19x11": (
        [(0, 2), (0, 1)], (19, 11), [False, True],
        {"x-": {"value": 1.5}, "x+": {"curvature": 0.5}, "y": "periodic"}),
    "ragged robin 70x45 (kernel tile)": (
        [(0, 7), (0, 9)], (70, 45), False,
        {"x": {"type": "mixed", "value": 2.0, "const": 0.5}, "y": {"value": -0.2}}),
}


@pytest.mark.parametrize("grid_id", TILE_GRIDS)
@pytest.mark.parametrize("op", so.OPERATORS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_tiled_matches_plain(grid_id, op, dtype):
    bounds, shape, periodic, bc = TILE_GRIDS[grid_id]
    grid = tpde.CartesianGrid(bounds, shape, periodic=periodic)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    spec = so.stencil_op_2d_spec(grid, op, dtype=dtype, bcs=bcs)
    rng = np.random.default_rng(sorted(TILE_GRIDS).index(grid_id))
    data = torch.as_tensor(rng.uniform(-1, 1, (spec.n_in, *shape)), dtype=dtype)
    plain = so.stencil_op_2d_plain(data, spec)
    tile = None if "kernel tile" in grid_id else 8
    tiled = so.stencil_op_2d_tiled(data, spec) if tile is None else so.stencil_op_2d_tiled(
        data, spec, tile=tile)
    assert plain.shape == (spec.n_out, *shape)
    np.testing.assert_array_equal(tiled.numpy(), plain.numpy())
    # the wrapper runs the plain version on the CPU and counts no launch
    launches = so.stencil_op_2d.launches
    out = torch.empty_like(plain)
    assert so.stencil_op_2d(data, spec, out=out) is out
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    assert so.stencil_op_2d.launches == launches


def test_registry_honesty():
    """The registry serves laplace and the six stencil operators on 2D
    Cartesian grids (through the MRO) and raises ``KernelUnsupportedError``
    for everything else, naming what it has."""
    cuda = tpde.get_backend("cuda")
    grid = tpde.UnitGrid([16, 16], periodic=True)
    ops = ["divergence", "gradient", "gradient_squared", "laplace", "tensor_divergence",
           "vector_gradient", "vector_laplace"]
    assert cuda.registered_operators(grid) == ops
    assert cuda.get_registered_factory(grid, "laplace") is not None
    assert cuda.get_registered_factory(grid, "poisson_solver") is None
    with pytest.raises(KernelUnsupportedError, match="poisson_solver.*registered"):
        cuda.make_operator(grid, "poisson_solver", bc="periodic")
    assert issubclass(KernelUnsupportedError, NotImplementedError)
    line = tpde.UnitGrid([16], periodic=True)
    for op in ("laplace", "gradient"):
        with pytest.raises(KernelUnsupportedError, match="2D CartesianGrid"):
            cuda.make_operator(line, op, bc="periodic")
    cube = tpde.UnitGrid([8, 8, 8], periodic=True)
    with pytest.raises(KernelUnsupportedError, match="2D CartesianGrid"):
        cuda.make_operator(cube, "vector_gradient", bc="periodic")
    walled = tpde.UnitGrid([16, 16])
    ramp = {"x-": {"value": np.linspace(0, 1, 16)}, "x+": {"derivative": 0},
            "y": "auto_periodic_neumann"}
    for op in ("gradient", "vector_laplace"):
        with pytest.raises(KernelUnsupportedError, match="array"):
            cuda.make_operator(walled, op, bc=ramp)
    # `laplace` is kernel #1 at k = 1, which takes per-point values (B1(c))
    data = torch.as_tensor(np.random.default_rng(1).uniform(size=(16, 16)))
    np.testing.assert_allclose(cuda.make_operator(walled, "laplace", bc=ramp)(data).numpy(),
                               walled.make_operator("laplace", bc=ramp)(data).numpy(),
                               rtol=1e-12, atol=1e-12)
    # a uniform array is a scalar value
    uniform = {"x": {"value": np.full(16, 0.25)}, "y": {"derivative": 0}}
    data = torch.as_tensor(np.random.default_rng(0).uniform(size=(2, 16, 16)))
    np.testing.assert_array_equal(
        cuda.make_operator(walled, "vector_laplace", bc=uniform)(data).numpy(),
        cuda.make_operator(walled, "vector_laplace", bc={"x": {"value": 0.25},
                                                         "y": {"derivative": 0}})(data).numpy())
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 1 / 3}):
        # pde_tpu's gates: #2 lowers the 5-point form only, and the registry's
        # laplace passes conditions, which the 9-point mode of #1 refuses
        with pytest.raises(KernelUnsupportedError, match="5-point.*1303-1306"):
            cuda.make_operator(grid, "vector_laplace", bc="periodic")
        with pytest.raises(KernelUnsupportedError, match="9-point.*841-849"):
            cuda.make_operator(grid, "laplace", bc="periodic")
        cuda.make_operator(grid, "vector_gradient", bc="periodic")  # no Laplacian in it
    op = cuda.make_operator(grid, "divergence", bc="periodic")
    with pytest.raises(ValueError, match="takes"):
        op(torch.zeros(16, 16, dtype=torch.float64))
    with pytest.raises(KernelUnsupportedError, match="float32 or float64"):
        op(torch.zeros(2, 16, 16, dtype=torch.float16))


def test_laplace_goes_through_the_affine_kernel_wrapper():
    """The registry's laplace is kernel #1's port at a = 0, b = 1, k = 1."""
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], (12, 20), periodic=[True, False])
    bc = {"x": "periodic", "y": {"value": 0.5}}
    data = torch.as_tensor(np.random.default_rng(1).uniform(size=(12, 20)))
    spec = cc.affine_laplace_spec(grid, a=0.0, b=1.0, k=1, dtype=torch.float64,
                                  bcs=grid.get_boundary_conditions(bc))
    np.testing.assert_array_equal(
        tpde.get_backend("pallas").make_operator(grid, "laplace", bc=bc)(data).numpy(),
        cc.affine_laplace_2d_plain(data, spec).numpy())


def test_fields_without_backend_take_the_plain_operators():
    """``field.gradient(...)`` and the other field methods run the plain
    operators, which the registry's operators equal in fp64."""
    grid = tpde.UnitGrid([16, 12], periodic=True)
    rng = np.random.default_rng(2)
    s = tpde.ScalarField(grid, rng.uniform(size=(16, 12)))
    v = tpde.VectorField(grid, rng.uniform(size=(2, 16, 12)))
    t = tpde.Tensor2Field(grid, rng.uniform(size=(2, 2, 16, 12)))
    cuda = tpde.get_backend("cuda")
    pairs = [(s.gradient("periodic"), "gradient", s), (s.gradient_squared("periodic"),
             "gradient_squared", s), (v.divergence("periodic"), "divergence", v),
             (v.laplace("periodic"), "vector_laplace", v), (v.gradient("periodic"),
             "vector_gradient", v), (t.divergence("periodic"), "tensor_divergence", t)]
    for field, op, source in pairs:
        np.testing.assert_allclose(
            cuda.make_operator(grid, op, bc="periodic")(source.data).numpy(),
            field.to_numpy(), rtol=1e-12, atol=1e-12)
