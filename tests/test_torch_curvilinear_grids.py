"""Curvilinear grids of the port against ``pde_tpu``: coordinates, grids,
conditions and carried states.

The same numpy inputs go through ``pde_tpu`` and the port, fp64: every
method of the six coordinate systems (Cartesian in 2D and 3D, polar,
spherical, cylindrical, bipolar, bispherical) at seeded random points within
their limits (1e-13); the three grids' coordinates, discretisation, cell
volumes, volume, boundary names, state round trips (both ways) and Cartesian
covering grids; conditions keyed by axis name, by an alternative name and by
boundary name; volume integrals; and ``field_from_state`` on the three
grids.
"""

import json
import zlib

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.grids import coordinates as jc
from pde_tpu_torch.grids import coordinates as tc
from pde_tpu_torch.grids.base import GridBase

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-13, atol=1e-13)
FIELD_TOL = dict(rtol=1e-12, atol=1e-12)

# name: (constructor arguments, the ranges points are drawn from per coordinate)
SYSTEMS = {
    "cartesian 2d": ("CartesianCoordinates", (2,), [(-2, 2)] * 2),
    "cartesian 3d": ("CartesianCoordinates", (3,), [(-2, 2)] * 3),
    "polar": ("PolarCoordinates", (), [(0.5, 2), (0, 2 * np.pi)]),
    "spherical": ("SphericalCoordinates", (), [(0.5, 2), (0.3, np.pi - 0.3), (0, 2 * np.pi)]),
    "cylindrical": ("CylindricalCoordinates", (), [(0.5, 2), (0, 2 * np.pi), (-1, 1)]),
    "bipolar": ("BipolarCoordinates", (1.5,), [(0.3, 2 * np.pi - 0.3), (-1, 1)]),
    "bispherical": ("BisphericalCoordinates", (0.7,), [(0.3, np.pi - 0.3), (-1, 1),
                                                      (0, 2 * np.pi)]),
}
METHODS = ("pos_to_cart", "pos_from_cart", "distance", "scale_factors", "mapping_jacobian",
           "volume_factor", "cell_volume", "metric", "basis_rotation", "vec_to_cart")


def _points(ranges, rng, n=7):
    return np.stack([rng.uniform(lo, hi, n) for lo, hi in ranges], axis=-1)


def _call(system, method, rng):
    """The arguments of `method` (seeded) for the coordinate system `system`."""
    _, _, ranges = SYSTEMS[system]
    points = _points(ranges, rng)
    if method == "pos_from_cart":
        return (np.asarray(jc.CartesianCoordinates(len(ranges)).pos_to_cart(points)) * 0.9,)
    if method == "distance":
        return points, _points(ranges, rng)
    if method == "cell_volume":
        return points, points + rng.uniform(0.01, 0.1, points.shape)
    if method == "vec_to_cart":
        return points, rng.normal(size=(len(ranges), len(points)))
    return (points,)


def _system(module, system):
    name, args, _ = SYSTEMS[system]
    return getattr(module, name)(*args)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_coordinate_methods_match(system, method):
    rng = np.random.default_rng(zlib.crc32(f"{system} {method}".encode()))
    args = _call(system, method, rng)
    jsys, tsys = _system(jc, system), _system(tc, system)
    try:
        expected = getattr(jsys, method)(*args)
    except NotImplementedError:  # bispherical coordinates have no Jacobian in pde_tpu either
        with pytest.raises(NotImplementedError):
            getattr(tsys, method)(*args)
        return
    got = getattr(tsys, method)(*args)
    np.testing.assert_allclose(got, expected, **TOL)
    assert tsys == tc.__dict__[SYSTEMS[system][0]](*SYSTEMS[system][1])
    assert (tsys.dim, list(tsys.axes)) == (jsys.dim, list(jsys.axes))


# id: (pde_tpu grid, port grid) from the same arguments
GRIDS = {
    "polar": ("PolarSymGrid", (3.0, 16)),
    "polar hole": ("PolarSymGrid", ((0.5, 3.0), 10)),
    "spherical": ("SphericalSymGrid", (3.0, 16)),
    "spherical hole": ("SphericalSymGrid", ((1.0, 2.5), 9)),
    "cylindrical": ("CylindricalSymGrid", (2.0, (0, 3), (8, 12))),
    "cylindrical periodic": ("CylindricalSymGrid", ((0.5, 2.0), (-1, 3), (6, 10), True)),
}


def _grids(case):
    name, args = GRIDS[case]
    return getattr(jpde, name)(*args), getattr(tpde, name)(*args)


@pytest.mark.parametrize("case", GRIDS)
def test_grid_geometry_matches(case):
    jgrid, tgrid = _grids(case)
    assert tgrid.shape == jgrid.shape and tgrid.dim == jgrid.dim
    assert tgrid.axes == jgrid.axes and tgrid.periodic == jgrid.periodic
    assert tgrid.axes_bounds == jgrid.axes_bounds
    assert tgrid.boundary_names == jgrid.boundary_names
    assert tgrid.coordinate_constraints == jgrid.coordinate_constraints
    assert tgrid.radius == jgrid.radius and tgrid.has_hole == jgrid.has_hole
    for t, j in zip(tgrid.axes_coords, jgrid.axes_coords, strict=True):
        np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(tgrid.discretization, jgrid.discretization, **TOL)
    np.testing.assert_allclose(tgrid.cell_volumes, jgrid.cell_volumes, **TOL)
    np.testing.assert_allclose(tgrid.cell_coords, jgrid.cell_coords, **TOL)
    for t, j in zip(tgrid._axis_volume_factors, jgrid._axis_volume_factors, strict=True):
        np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(tgrid.volume, jgrid.volume, **TOL)
    np.testing.assert_allclose(np.sum(tgrid.cell_volumes), tgrid.volume, rtol=1e-12)


@pytest.mark.parametrize("case", GRIDS)
def test_grid_state_round_trips(case):
    jgrid, tgrid = _grids(case)
    assert json.loads(tgrid.state_serialized) == json.loads(jgrid.state_serialized)
    assert GridBase.from_state(jgrid.state_serialized) == tgrid
    assert jpde.grids.base.GridBase.from_state(tgrid.state_serialized) == jgrid
    assert type(tgrid).from_state(tgrid.state) == tgrid
    assert hash(GridBase.from_state(tgrid.state_serialized)) == hash(tgrid)


@pytest.mark.parametrize("mode", ["valid", "full"])
@pytest.mark.parametrize("case", ["polar", "spherical", "cylindrical", "cylindrical periodic"])
def test_cartesian_covering_grid_matches(case, mode):
    jgrid, tgrid = _grids(case)
    jcart, tcart = jgrid.get_cartesian_grid(mode), tgrid.get_cartesian_grid(mode)
    assert tcart.shape == jcart.shape
    np.testing.assert_allclose(tcart.axes_bounds, jcart.axes_bounds, **TOL)


@pytest.mark.parametrize("case", GRIDS)
def test_points_convert_like_pde_tpu(case):
    jgrid, tgrid = _grids(case)
    rng = np.random.default_rng(3)
    lo = np.array([b[0] for b in jgrid.axes_bounds])
    hi = np.array([b[1] for b in jgrid.axes_bounds])
    points = rng.uniform(lo + 0.1, hi, (5, jgrid.num_axes))
    cart = tgrid.point_to_cartesian(points)
    np.testing.assert_allclose(cart, jgrid.point_to_cartesian(points), **TOL)
    np.testing.assert_allclose(tgrid.point_from_cartesian(cart),
                               jgrid.point_from_cartesian(cart), **TOL)
    np.testing.assert_allclose(tgrid.point_from_cartesian(cart), points, rtol=1e-12, atol=1e-12)


# conditions keyed by axis name, alternative name, side and boundary name
BCS = {
    "polar": [{"r": {"derivative": 0.2}}, {"radius": {"value": 1.0}},
              {"inner": {"derivative": 0}, "outer": {"type": "mixed", "value": 2.0, "const": 0.5}},
              {"r-": {"curvature": 0.3}, "r+": {"value": -1.0}}],
    "cylindrical": [{"r": {"derivative": 0}, "z": {"value": 0.5}},
                    {"radius": {"value": 1.0}, "z-": {"derivative": 0.1}, "z+": {"value": 0}},
                    {"inner": {"derivative": 0}, "outer": {"value": 1}, "bottom": {"value": 0.2},
                     "top": {"curvature": 0.1}},
                    {"*": {"derivative": 0}, "top": {"value": 1}}],
}


@pytest.mark.parametrize("index", range(4))
@pytest.mark.parametrize("case", ["polar", "polar hole", "spherical", "cylindrical"])
def test_conditions_by_axis_and_boundary_name(case, index):
    jgrid, tgrid = _grids(case)
    bc = BCS["cylindrical" if case.startswith("cylindrical") else "polar"][index]
    data = np.random.default_rng(index).uniform(-1, 1, jgrid.shape)
    expected = np.asarray(jpde.ScalarField(jgrid, data).laplace(bc).data)
    got = tpde.ScalarField(tgrid, data, dtype=torch.float64).laplace(bc).data.numpy()
    np.testing.assert_allclose(got, expected, **FIELD_TOL)
    jbcs, tbcs = jgrid.get_boundary_conditions(bc), tgrid.get_boundary_conditions(bc)
    for jpair, tpair in zip(jbcs, tbcs, strict=True):
        for jside, tside in zip(jpair, tpair, strict=True):
            assert type(tside).__name__ == type(jside).__name__


def test_conditions_reject_what_pde_tpu_rejects():
    _, tgrid = _grids("cylindrical")
    field = tpde.ScalarField(tgrid, 1.0, dtype=torch.float64)
    with pytest.raises(KeyError, match="specified twice"):
        field.laplace({"r": {"value": 0}, "radius": {"value": 1}, "z": "auto_periodic_neumann"})
    with pytest.raises(tpde.grids.PeriodicityError):
        field.laplace({"r": "periodic", "z": {"value": 0}})
    _, periodic = _grids("cylindrical periodic")
    with pytest.raises(tpde.grids.PeriodicityError):
        tpde.ScalarField(periodic, 1.0).laplace({"r": {"value": 0}, "z": {"value": 0}})


@pytest.mark.parametrize("case", GRIDS)
def test_integrals_and_averages_match(case):
    jgrid, tgrid = _grids(case)
    rng = np.random.default_rng(5)
    data = rng.uniform(-1, 1, jgrid.shape)
    jfield, tfield = jpde.ScalarField(jgrid, data), tpde.ScalarField(tgrid, data,
                                                                     dtype=torch.float64)
    np.testing.assert_allclose(float(tfield.integral), float(jfield.integral), **FIELD_TOL)
    np.testing.assert_allclose(float(tfield.average), float(jfield.average), **FIELD_TOL)
    np.testing.assert_allclose(float(tfield.fluctuations), float(jfield.fluctuations),
                               **FIELD_TOL)
    for axes in range(tgrid.num_axes):
        np.testing.assert_allclose(tgrid.integrate(torch.as_tensor(data), axes=axes).numpy(),
                                   np.asarray(jgrid.integrate(data, axes=axes)), **FIELD_TOL)


@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("case", ["polar", "spherical hole", "cylindrical periodic"])
def test_field_from_state_rebuilds_curvilinear_fields(case, rank):
    jgrid, tgrid = _grids(case)
    cls = ["ScalarField", "VectorField", "Tensor2Field"][rank]
    data = np.random.default_rng(rank).uniform(-1, 1, (jgrid.dim,) * rank + jgrid.shape)
    jfield = getattr(jpde, cls)(jgrid, data, label="carried")
    field = tpde.field_from_state(jfield.attributes_serialized, np.asarray(jfield.data))
    assert type(field).__name__ == cls and field.grid == tgrid and field.label == "carried"
    assert field.data.dtype == torch.float64 and field.data.device.type == "cpu"
    np.testing.assert_array_equal(field.data.numpy(), np.asarray(jfield.data))


def test_cylindrical_slices_and_errors():
    _, tgrid = _grids("cylindrical periodic")
    assert tgrid.slice(["r"]) == tpde.PolarSymGrid((0.5, 2.0), 6)
    assert tgrid.slice([1]) == tpde.CartesianGrid([(-1, 3)], [10], periodic=[True])
    assert tgrid.get_axis_index("radius") == 0
    with pytest.raises(ValueError, match="Inner radius"):
        tpde.CylindricalSymGrid((-1, 2), (0, 1), 4)
    with pytest.raises(ValueError, match="larger than inner"):
        tpde.SphericalSymGrid((2, 1), 4)
    with pytest.raises(ValueError, match="single number"):
        tpde.PolarSymGrid(1.0, (4, 4))
    # until A8's second item grid.plot() raised naming A8; now it draws what pde_tpu's does
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    jgrid = _grids("cylindrical periodic")[0]
    for grids in ((jgrid, tgrid), (jpde.SphericalSymGrid(1.0, 4), tpde.SphericalSymGrid(1.0, 4))):
        drawn = [(len(ax.lines), len(ax.patches), ax.get_xlim(), ax.get_ylim())
                 for ax in (grid.plot() for grid in grids)]
        assert drawn[1] == drawn[0] and drawn[1][0] + drawn[1][1] > 0
    plt.close("all")
