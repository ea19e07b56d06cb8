"""Grids, fields, boundary conditions and the plain Laplacian of the port
against ``pde_tpu`` (fp64, CPU)."""

import json

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import affine_bc_params
from pde_tpu_torch.ops.cuda_cartesian import affine_bc_specs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


GRIDS = [
    ("UnitGrid", ([32, 128],), {"periodic": True}),
    ("UnitGrid", ([32, 32],), {}),
    ("CartesianGrid", ([(0, 1), (0, 2)], (32, 32)), {}),
    ("CartesianGrid", ([(0, 1), (0, 4)], (16, 24)), {"periodic": [True, False]}),
]

# the BC cases of tests/ops/test_pallas_kernels.py, plus periodic
BC_CASES = [
    {"value": 0},
    {"value": 1.5},
    {"derivative": 0},
    {"derivative": 0.3},
    {"type": "mixed", "value": 2.0, "const": 0.5},
    {"curvature": 0.0},
    {"curvature": 1.0},
]
PER_SIDE = {"x-": {"value": 1}, "x+": {"derivative": 0.5},
            "y-": {"type": "mixed", "value": 1.0, "const": 2.0}, "y+": {"curvature": 0.0}}


def _grid_pair(name, args, kwargs):
    return getattr(jpde, name)(*args, **kwargs), getattr(tpde, name)(*args, **kwargs)


@pytest.mark.parametrize("name,args,kwargs", GRIDS)
def test_grid_state_round_trip(name, args, kwargs):
    jgrid, tgrid = _grid_pair(name, args, kwargs)
    assert tgrid.state_serialized == jgrid.state_serialized
    for restored in (
        tpde.GridBase.from_state(jgrid.state_serialized),
        type(tgrid).from_state(json.loads(json.dumps(jgrid.state))),
    ):
        assert restored == tgrid
        assert restored.shape == jgrid.shape
        assert restored.periodic == jgrid.periodic
        np.testing.assert_array_equal(restored.discretization, jgrid.discretization)
        for a, b in zip(restored.axes_coords, jgrid.axes_coords, strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("target", [None, torch.float32])
def test_field_from_jax_state(target):
    jgrid = jpde.CartesianGrid([(0, 1), (0, 2)], (8, 12), periodic=[True, False])
    data = np.random.default_rng(3).random((8, 12))
    jfield = jpde.ScalarField(jgrid, data, label="c")
    for attributes in (jfield.attributes_serialized, jfield.attributes):
        field = tpde.field_from_state(
            attributes, np.asarray(jfield.data), device="cpu", dtype=target
        )
        assert isinstance(field, tpde.ScalarField)
        assert field.grid.state_serialized == jgrid.state_serialized
        assert field.label == "c"
        assert field.dtype == (target or torch.float64)
        np.testing.assert_array_equal(field.to_numpy(), data.astype(field.to_numpy().dtype))


def _side_triplets(specs):
    if specs is None:
        return None
    return tuple(
        None if pair is None else tuple(side.scalar_triplet() for side in pair) for pair in specs
    )


@pytest.mark.parametrize("bc", BC_CASES + ["periodic", PER_SIDE], ids=str)
def test_virtual_point_data_and_affine_specs(bc):
    periodic = bc == "periodic"
    jgrid, tgrid = _grid_pair("CartesianGrid", ([(0, 1), (0, 2)], (32, 32)), {"periodic": periodic})
    jbcs = jgrid.get_boundary_conditions(bc)
    tbcs = tgrid.get_boundary_conditions(bc)
    assert tbcs.periodic == jbcs.periodic
    for jpair, tpair in zip(jbcs, tbcs, strict=True):
        for jside, tside in zip(jpair, tpair, strict=True):
            assert type(tside).__name__.lstrip("_") == type(jside).__name__.lstrip("_")
            if jpair.periodic:
                continue
            for a, b in zip(jside.get_virtual_point_data(),
                            tside.get_virtual_point_data(), strict=True):
                np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-15, atol=0)
    expected = affine_bc_params(jgrid, jbcs)
    got = _side_triplets(affine_bc_specs(tgrid, tbcs))
    if expected is None:
        assert got is None
    else:
        np.testing.assert_allclose(np.array(got, dtype=float), np.array(expected, dtype=float),
                                   rtol=1e-15, atol=0)


@pytest.mark.parametrize("bc", BC_CASES + [PER_SIDE], ids=str)
def test_plain_laplace_matches_jax(bc):
    jgrid, tgrid = _grid_pair("CartesianGrid", ([(0, 1), (0, 2)], (16, 20)), {})
    data = np.random.default_rng(5).random((16, 20))
    expected = np.asarray(jgrid.make_operator("laplace", bc=bc)(data))
    got = tgrid.make_operator("laplace", bc=bc)(torch.tensor(data))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("periodic", [True, False])
def test_plain_laplace_corner_weight_matches_jax(periodic):
    jgrid, tgrid = _grid_pair("UnitGrid", ([12, 10],), {"periodic": periodic})
    data = np.random.default_rng(6).random((12, 10))
    key = "operators.cartesian.laplacian_2d_corner_weight"
    with jpde.config({key: 0.5}), tpde.config({key: 0.5}):
        expected = np.asarray(jgrid.make_operator("laplace", bc="auto_periodic_neumann")(data))
        got = tgrid.make_operator("laplace", bc="auto_periodic_neumann")(torch.tensor(data))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12, atol=1e-12)


def test_field_laplace_and_average_match_jax():
    jgrid, tgrid = _grid_pair("UnitGrid", ([16, 16],), {})
    data = np.random.default_rng(7).random((16, 16))
    jfield = jpde.ScalarField(jgrid, data)
    tfield = tpde.ScalarField(tgrid, torch.tensor(data))
    np.testing.assert_allclose(
        tfield.laplace({"derivative": 0.2}).to_numpy(),
        np.asarray(jfield.laplace({"derivative": 0.2}).data), rtol=1e-12, atol=1e-12,
    )
    assert float(tfield.average) == pytest.approx(float(jfield.average), rel=1e-14)


def test_bc_errors():
    grid = tpde.UnitGrid([8, 8])
    with pytest.raises(tpde.grids.PeriodicityError):
        grid.get_boundary_conditions("periodic")
    # a string value is an expression of the coordinates (no longer refused)
    side = list(grid.get_boundary_conditions({"value": "x + y"}))[0].low
    np.testing.assert_array_equal(side.value, grid.axes_coords[1])
    with pytest.raises(RuntimeError, match="unexpected variables"):
        grid.get_boundary_conditions({"value": "x + t"})
    with pytest.raises(ValueError):
        grid.get_boundary_conditions("unknown_condition")
