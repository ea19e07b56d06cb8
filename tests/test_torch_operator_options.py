"""The operator options and the axis operators (ROADMAP A4's third item)
against ``pde_tpu`` on the CPU in fp64, at 1e-12 of max|f|.

The options: ``laplace(spectral=True)`` on periodic Cartesian grids (and its
ValueError elsewhere), ``method="central"/"forward"/"backward"`` of the
gradient, divergence, vector gradient and tensor divergence, and
``gradient_squared(central=False)``; the axis operators ``d_d<axis>``,
``d_d<axis>_<method>`` and ``d2_d<axis>2`` of every grid class, also inside
expression PDEs (where the fused windows refuse them, as ``pde_tpu``'s
lowering does, and the plain loop runs). The ``cuda`` registry has no kernel
for any of them and raises ``KernelUnsupportedError``."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.backends import get_backend

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


METHODS = ("central", "forward", "backward")
# grid id -> (grid(pkg), conditions)
GRIDS = {
    "cartesian 1d periodic": (lambda p: p.CartesianGrid([(0, 3)], [24], periodic=True),
                              "periodic"),
    "cartesian 2d periodic": (lambda p: p.CartesianGrid([(0, 1), (0, 2)], [12, 10],
                                                        periodic=True), "periodic"),
    "cartesian 2d mixed": (lambda p: p.CartesianGrid([(0, 1), (0, 2)], [12, 10],
                                                     periodic=[True, False]),
                           {"x": "periodic", "y-": {"derivative": 0.3},
                            "y+": {"value": -1.0}}),
    "cartesian 3d mixed": (lambda p: p.CartesianGrid([(0, 1), (0, 2), (0, 3)], [6, 5, 7],
                                                     periodic=[True, False, True]),
                           {"x": "periodic", "y": {"derivative": 0.2}, "z": "periodic"}),
    "cartesian 3d periodic": (lambda p: p.UnitGrid([6, 5, 7], periodic=True), "periodic"),
    "polar": (lambda p: p.PolarSymGrid((0.5, 3.0), 16),
              {"r-": {"derivative": 0.1}, "r+": {"value": 1.0}}),
    "spherical": (lambda p: p.SphericalSymGrid((0.5, 3.0), 16),
                  {"r-": {"derivative": 0.1}, "r+": {"value": 1.0}}),
    "cylindrical": (lambda p: p.CylindricalSymGrid(3.0, (0, 4), (8, 10), periodic_z=True),
                    {"r": {"derivative": 0.0}, "z": "periodic"}),
}


def _cases():
    """(grid id, rank of the input, operator, options) of every case."""
    cases = []
    for grid_id in GRIDS:
        cartesian = grid_id.startswith("cartesian")
        grid = GRIDS[grid_id][0](tpde)
        if cartesian and all(grid.periodic):
            cases.append((grid_id, 0, "laplace", {"spectral": True}))
        if grid_id != "cylindrical":  # pde_tpu's cylindrical operators take no options
            cases += [(grid_id, 0, "gradient", {"method": m}) for m in METHODS]
            cases.append((grid_id, 0, "gradient_squared", {"central": False}))
        if cartesian or grid_id == "spherical":
            cases += [(grid_id, 1, op, {"method": m}) for m in ("forward", "backward")
                      for op in ("divergence", "vector_gradient")]
        if cartesian and grid.num_axes > 1:
            cases += [(grid_id, 2, "tensor_divergence", {"method": m})
                      for m in ("forward", "backward")]
        for axis in grid.axes:
            cases += [(grid_id, 0, name, {}) for name in (
                f"d_d{axis}", f"d_d{axis}_central", f"d_d{axis}_forward",
                f"d_d{axis}_backward", f"d2_d{axis}2")]
    return cases


CASES = _cases()


def _field(pkg, grid, rank, seed):
    shape = (grid.dim,) * rank + tuple(grid.shape)
    data = np.random.default_rng(seed).random(shape)
    cls = {0: pkg.ScalarField, 1: pkg.VectorField, 2: pkg.Tensor2Field}[rank]
    return cls(grid, torch.as_tensor(data) if pkg is tpde else data)


@pytest.mark.parametrize("case", CASES, ids=[f"{g}-{op}-{opts}" for g, _, op, opts in CASES])
def test_operator_matches_jax(case):
    grid_id, rank, op, options = case
    make_grid, bc = GRIDS[grid_id]
    results = []
    for pkg in (jpde, tpde):
        field = _field(pkg, make_grid(pkg), rank, seed=len(op) + rank)
        results.append(np.asarray(field.apply_operator(op, bc, **options).data))
    expected, got = results
    scale = max(np.abs(expected).max(), 1e-300)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("grid_id", ["cartesian 2d mixed", "cartesian 3d mixed"])
def test_spectral_laplace_refuses_bounded_grids(grid_id):
    make_grid, bc = GRIDS[grid_id]
    for pkg in (jpde, tpde):
        field = _field(pkg, make_grid(pkg), 0, seed=1)
        with pytest.raises(ValueError, match="periodic"):
            field.laplace(bc, spectral=True)
        with pytest.raises(ValueError, match="Unknown derivative method"):
            field.gradient(bc, method="sideways")


@pytest.mark.parametrize("option", [("laplace", {"spectral": True}),
                                    ("gradient", {"method": "forward"}),
                                    ("divergence", {"method": "backward"}),
                                    ("gradient_squared", {"central": False}),
                                    ("d_dx", {}), ("d2_dy2", {})])
def test_cuda_registry_has_no_kernel_for_the_options(option):
    op, options = option
    grid = tpde.UnitGrid([16, 16], periodic=True)
    with pytest.raises(tpde.KernelUnsupportedError, match="backend='cuda' has no kernel"):
        get_backend("cuda").make_operator(grid, op, "periodic", **options)


# expression PDEs with axis operators: pde_tpu's fused lowering refuses them, and so
# does the port's, so both run the plain loop
EXPRESSIONS = {
    "cartesian 2d periodic": {"c": "d_dx(c) + 0.1 * d2_dy2(c) - d_dy_forward(c) * c"},
    "cartesian 3d mixed": {"c": "0.1 * d2_dz2(c) + d_dy_backward(c)"},
    "cylindrical": {"c": "0.1 * d2_dr2(c) + d_dz(c)"},
}


@pytest.mark.parametrize("grid_id", EXPRESSIONS)
def test_axis_operators_in_expressions_match_jax(grid_id, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    make_grid, bc = GRIDS[grid_id]
    results = []
    for pkg in (jpde, tpde):
        eq = pkg.PDE(EXPRESSIONS[grid_id], bc=bc)
        result = eq.solve(_field(pkg, make_grid(pkg), 0, seed=9), t_range=0.05, dt=1e-3,
                          tracker=None)
        assert "fused_step" not in eq.diagnostics["solver"]
        results.append(np.asarray(result.data))
    assert "d2_d" in eq.diagnostics["solver"]["fused_unsupported"]
    expected, got = results
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-12 * np.abs(expected).max())
