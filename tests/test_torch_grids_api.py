"""The grid API of ROADMAP A4's second item against ``pde_tpu`` on the CPU in fp64.

Coordinates, cell volumes, copies, operator registries, the no-bc operators,
point transforms, containment, mirror points, distances, random points,
bounds, slices, the module-level registries and ``environment``, on every grid
class (1D, 2D and 3D Cartesian, polar, spherical, cylindrical) with points
from ``default_rng``; values at 1e-12.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.utils.cuboid import Cuboid as JCuboid
from pde_tpu_torch.utils.cuboid import Cuboid as TCuboid

torch.set_num_threads(1)
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


GRIDS = {
    "unit 8x6 periodic": lambda pkg: pkg.UnitGrid([8, 6], periodic=True),
    "cartesian 10x14 mixed": lambda pkg: pkg.CartesianGrid([(0, 2), (-1, 3)], [10, 14],
                                                          periodic=[True, False]),
    "unit 64 (1D)": lambda pkg: pkg.UnitGrid([64], periodic=True),
    "cartesian 4x5x6 (3D)": lambda pkg: pkg.CartesianGrid([(0, 1), (0, 2), (1, 2)], [4, 5, 6],
                                                          periodic=[False, True, False]),
    "polar 16": lambda pkg: pkg.PolarSymGrid((0.5, 3.0), 16),
    "spherical 12": lambda pkg: pkg.SphericalSymGrid(2.0, 12),
    "cylindrical 8x10": lambda pkg: pkg.CylindricalSymGrid(2.0, (0, 3), (8, 10), periodic_z=True),
}


def _grids(grid_id):
    return GRIDS[grid_id](jpde), GRIDS[grid_id](tpde)


def _points(grid, n=9, seed=0, margin=0.0):
    """Random points in grid coordinates within the grid's box (widened by `margin`)."""
    bounds = np.array(grid.axes_bounds)
    return np.random.default_rng(seed).uniform(bounds[:, 0] - margin, bounds[:, 1] + margin,
                                               (n, grid.num_axes))


@pytest.mark.parametrize("grid_id", GRIDS)
def test_geometry_matches_jax(grid_id):
    jgrid, tgrid = _grids(grid_id)
    for a, b in zip(tgrid.coordinate_arrays, jgrid.coordinate_arrays, strict=True):
        np.testing.assert_allclose(a, b, **TOL)
    assert tgrid.uniform_cell_volumes == jgrid.uniform_cell_volumes
    assert tgrid.cell_volume_data is jgrid.cell_volume_data is None
    assert tgrid.typical_discretization == pytest.approx(jgrid.typical_discretization, rel=1e-15)
    assert tgrid._shape_full == jgrid._shape_full and tgrid._idx_valid == jgrid._idx_valid
    copy = tgrid.copy()
    assert copy == tgrid and copy is not tgrid
    assert tgrid.operators() == jgrid.operators()


@pytest.mark.parametrize("grid_id", GRIDS)
def test_point_methods_match_jax(grid_id):
    jgrid, tgrid = _grids(grid_id)
    inside = _points(tgrid, seed=1)
    wide = _points(tgrid, seed=2, margin=1.5)
    for source, target in (("grid", "cartesian"), ("grid", "cell"), ("cell", "grid"),
                           ("grid", "grid")):
        np.testing.assert_allclose(tgrid.transform(inside, source, target),
                                   jgrid.transform(inside, source, target), **TOL)
    cart = jgrid.transform(inside, "grid", "cartesian")
    np.testing.assert_allclose(tgrid.transform(cart, "cartesian", "grid"),
                               jgrid.transform(cart, "cartesian", "grid"), **TOL)
    np.testing.assert_array_equal(tgrid.contains_point(wide, coords="grid"),
                                  jgrid.contains_point(wide, coords="grid"))
    np.testing.assert_array_equal(tgrid.contains_point(cart), jgrid.contains_point(cart))
    for reflect in (False, True):
        np.testing.assert_allclose(tgrid.normalize_point(wide, reflect=reflect),
                                   jgrid.normalize_point(wide, reflect=reflect), **TOL)
    for kwargs in ({}, {"with_self": True}, {"only_periodic": False}):
        got = list(tgrid.iter_mirror_points(inside[0], **kwargs))
        expected = list(jgrid.iter_mirror_points(inside[0], **kwargs))
        np.testing.assert_allclose(got, expected, **TOL)
    np.testing.assert_allclose(tgrid.difference_vector(inside, wide),
                               jgrid.difference_vector(inside, wide), **TOL)
    np.testing.assert_allclose(tgrid.distance(inside, wide), jgrid.distance(inside, wide), **TOL)
    np.testing.assert_allclose(tgrid._grid_to_fractional(inside),
                               np.asarray(jgrid._grid_to_fractional(inside)), **TOL)
    np.testing.assert_allclose(tgrid._grid_to_fractional(torch.as_tensor(inside)).numpy(),
                               np.asarray(jgrid._grid_to_fractional(inside)), **TOL)
    for coords in ("cartesian", "grid", "cell"):
        np.testing.assert_allclose(
            tgrid.get_random_point(coords=coords, rng=np.random.default_rng(3)),
            jgrid.get_random_point(coords=coords, rng=np.random.default_rng(3)), **TOL)


def test_random_point_options_and_errors():
    for grid_id in ("polar 16", "spherical 12"):
        jgrid, tgrid = _grids(grid_id)
        kw = {"boundary_distance": 0.3, "avoid_center": True}
        np.testing.assert_allclose(tgrid.get_random_point(rng=np.random.default_rng(4), **kw),
                                   jgrid.get_random_point(rng=np.random.default_rng(4), **kw),
                                   **TOL)
        with pytest.raises(RuntimeError, match="too close"):
            tgrid.get_random_point(boundary_distance=5)
    with pytest.raises(RuntimeError, match="too close"):
        tpde.UnitGrid([4, 4]).get_random_point(boundary_distance=3)
    with pytest.raises(tpde.DimensionError):
        tpde.UnitGrid([4, 4]).normalize_point([1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="coordinate system"):
        tpde.UnitGrid([4, 4]).transform([1.0, 2.0], "grid", "polar")


@pytest.mark.parametrize("grid_id", ["unit 8x6 periodic", "unit 64 (1D)",
                                     "cartesian 4x5x6 (3D)", "polar 16", "cylindrical 8x10"])
@pytest.mark.parametrize("operator", ["laplace", "gradient", "gradient_squared"])
def test_make_operator_no_bc_matches_jax(grid_id, operator):
    """The no-bc operators on data with ghost cells, as ``pde_tpu``'s."""
    jgrid, tgrid = _grids(grid_id)
    full = np.random.default_rng(5).random(jgrid._shape_full)
    got = tgrid.make_operator_no_bc(operator)(torch.as_tensor(full))
    expected = jgrid.make_operator_no_bc(operator)(full)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_axis_operators_raise_naming_a4():
    """The axis operators (ported with A4's third item) resolve on every route
    as pde_tpu's do; names of no axis stay undefined."""
    grid, jgrid = tpde.UnitGrid([8, 8]), jpde.UnitGrid([8, 8])
    data = np.random.default_rng(6).random((8, 8))
    field, jfield = tpde.ScalarField(grid, torch.as_tensor(data)), jpde.ScalarField(jgrid, data)
    full = np.random.default_rng(7).random((10, 10))
    for name in ("d_dx", "d_dy_forward", "d2_dx2"):
        bc = "auto_periodic_neumann"
        expected = np.asarray(jfield.apply_operator(name, bc).data)
        np.testing.assert_allclose(field.apply_operator(name, bc).data.numpy(), expected, **TOL)
        np.testing.assert_allclose(grid.make_operator(name, bc)(torch.as_tensor(data)).numpy(),
                                   expected, **TOL)
        np.testing.assert_allclose(grid.make_operator_no_bc(name)(torch.as_tensor(full)).numpy(),
                                   np.asarray(jgrid.make_operator_no_bc(name)(full)), **TOL)
    with pytest.raises(NotImplementedError, match="not defined"):
        grid.make_operator("d_dq", "auto_periodic_neumann")


@pytest.mark.parametrize("grid_id", ["cartesian 10x14 mixed", "cartesian 4x5x6 (3D)",
                                     "cylindrical 8x10"])
def test_slices_and_bounds_match_jax(grid_id):
    jgrid, tgrid = _grids(grid_id)
    indices = [[0], [1], ["y"]] if tgrid.num_axes == 2 else [[0, 2], ["y"], [1, 2]]
    if isinstance(tgrid, tpde.CylindricalSymGrid):
        indices = [[0], ["z"]]
    for index in indices:
        got, expected = tgrid.slice(index), jgrid.slice(index)
        assert got.state_serialized == expected.state_serialized
    bounds = tgrid.axes_bounds
    got = type(tgrid).from_bounds(bounds, tgrid.shape, tgrid.periodic)
    expected = type(jgrid).from_bounds(bounds, jgrid.shape, jgrid.periodic)
    assert got.state_serialized == expected.state_serialized


def test_registries_and_environment():
    # the views of decomposed grids are classes of their own, kept out of the registry
    mesh = tpde.GridMesh(tpde.UnitGrid([8, 8], periodic=True), [2, 2], devices=["cpu"] * 4)
    assert type(mesh.extended_grid(0, 1)).__name__ == "ExtendedCartesianGrid"
    assert tpde.registered_grids() == jpde.registered_grids()
    assert tpde.registered_operators() == jpde.registered_operators()
    assert issubclass(tpde.DomainError, ValueError)
    env = tpde.environment()
    assert env["torch version"] == torch.__version__
    assert env["package version"] == tpde.__version__ and "config" in env
    assert env["CUDA available"] is torch.cuda.is_available()
    assert "jax version" not in env


def test_cuboid_is_the_jax_package_copy():
    rng = np.random.default_rng(6)
    pos, size = rng.uniform(-1, 1, 3), rng.uniform(-2, 2, 3)
    jbox, tbox = JCuboid(pos, size), TCuboid(pos, size)
    for name in ("pos", "size", "corners", "bounds", "centroid", "volume", "diagonal",
                 "surface_area", "vertices"):
        if hasattr(jbox, name):
            np.testing.assert_allclose(np.asarray(getattr(tbox, name), dtype=float),
                                       np.asarray(getattr(jbox, name), dtype=float), **TOL)
    points = rng.uniform(-2, 2, (20, 3))
    np.testing.assert_array_equal(tbox.contains_point(points), jbox.contains_point(points))
    jb = JCuboid.from_points(pos, pos + size).buffer(0.25)
    tb = TCuboid.from_points(pos, pos + size).buffer(0.25)
    np.testing.assert_allclose(tb.pos, jb.pos, **TOL)
