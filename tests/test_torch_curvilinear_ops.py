"""The plain operators of polar, spherical and cylindrical grids against
``pde_tpu``, and the plain solves of BASELINE config 4.

The same numpy inputs go through ``pde_tpu`` and the port, fp64, at 1e-12:
every operator of ``ops/polar.py``, ``ops/spherical.py`` and
``ops/cylindrical.py`` on ``PolarSymGrid(3.0, 16)``, ``SphericalSymGrid(3.0,
16)`` and ``CylindricalSymGrid(2.0, (0, 3), (8, 12))`` (the grids of
``pde_tpu``'s reference-parity tests) and on grids with a hole, under value,
derivative and mixed sides and a periodic z axis, with the config key
``operators.conservative_stencil`` on and off, and each option of the
derivative methods; the field methods that apply them; ``DiffusionPDE``
solves of the plain loop on the three grids; and config 4 as written
(diffusion on the spherical and cylindrical grids, then the vector and
tensor operators of the fields it gives).
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)

GRIDS = {
    "polar": ("PolarSymGrid", (3.0, 16)),
    "polar hole": ("PolarSymGrid", ((0.5, 3.0), 12)),
    "spherical": ("SphericalSymGrid", (3.0, 16)),
    "spherical hole": ("SphericalSymGrid", ((1.0, 3.0), 12)),
    "cylindrical": ("CylindricalSymGrid", (2.0, (0, 3), (8, 12))),
    "cylindrical periodic": ("CylindricalSymGrid", ((0.5, 2.0), (0, 3), (8, 12), True)),
}

# the operators of each grid class, with their input rank
OPERATORS = {
    "PolarSymGrid": {"laplace": 0, "gradient": 0, "gradient_squared": 0, "divergence": 1,
                     "vector_gradient": 1, "tensor_divergence": 2},
    "SphericalSymGrid": {"laplace": 0, "gradient": 0, "gradient_squared": 0, "divergence": 1,
                         "vector_gradient": 1, "tensor_divergence": 2,
                         "tensor_double_divergence": 2},
    "CylindricalSymGrid": {"laplace": 0, "gradient": 0, "gradient_squared": 0,
                           "divergence": 1, "vector_gradient": 1, "vector_laplace": 1,
                           "tensor_divergence": 2},
}
BCS = {
    "value": {"value": 0.7},
    "derivative": {"derivative": -0.3},
    "mixed": {"type": "mixed", "value": 2.0, "const": 0.5},
    "sides": None,  # per side: SIDES
}
SIDES = {
    "PolarSymGrid": {"inner": {"derivative": 0}, "outer": {"value": 1.0}},
    "SphericalSymGrid": {"r-": {"curvature": 0.2}, "r+": {"type": "mixed", "value": 1.0,
                                                           "const": -0.5}},
    "CylindricalSymGrid": {"r": {"derivative": 0}, "z-": {"value": 0.3},
                           "z+": {"derivative": 0.1}},
}


def _grids(case):
    name, args = GRIDS[case]
    return getattr(jpde, name)(*args), getattr(tpde, name)(*args)


def _bc(jgrid, bc_id):
    """The conditions `bc_id` on `jgrid`; on a periodic z axis, for r only."""
    name = type(jgrid).__name__
    bc = SIDES[name] if bc_id == "sides" else BCS[bc_id]
    if name == "CylindricalSymGrid" and jgrid.periodic[1]:
        sides = {"inner": {"derivative": 0}, "outer": {"value": 0.2}}
        return {**(sides if bc_id == "sides" else {"r": bc}), "z": "periodic"}
    return bc


# the config key operators.conservative_stencil selects the spherical stencils only
CASES = [(case, op, conservative) for case, (name, _) in GRIDS.items() for op in OPERATORS[name]
         for conservative in ((True, False) if name == "SphericalSymGrid" else (True,))]


@pytest.mark.parametrize("bc_id", BCS)
@pytest.mark.parametrize("case, op, conservative", CASES,
                         ids=[f"{c} {o} {'conservative' if k else 'naive'}" for c, o, k in CASES])
def test_operator_matches_pde_tpu(case, op, bc_id, conservative):
    jgrid, tgrid = _grids(case)
    rank = OPERATORS[type(jgrid).__name__][op]
    bc = _bc(jgrid, bc_id)
    data = np.random.default_rng(rank + len(op)).uniform(-1, 1, (jgrid.dim,) * rank + jgrid.shape)
    key = {"operators.conservative_stencil": conservative}
    with jpde.config(key):
        expected = np.asarray(jgrid.make_operator(op, bc)(data))
    with tpde.config(key):
        got = tgrid.make_operator(op, bc)(torch.as_tensor(data)).numpy()
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, **TOL)


# options of the derivative methods: (grid case, operator, rank, keyword arguments)
OPTIONS = [
    ("polar", "gradient", 0, {"method": "forward"}),
    ("polar", "gradient", 0, {"method": "backward"}),
    ("polar", "gradient_squared", 0, {"central": False}),
    ("spherical", "gradient", 0, {"method": "forward"}),
    ("spherical", "gradient", 0, {"method": "backward"}),
    ("spherical", "gradient_squared", 0, {"central": False}),
    ("spherical", "divergence", 1, {"method": "forward"}),
    ("spherical", "divergence", 1, {"method": "backward"}),
    ("spherical", "divergence", 1, {"method": "forward", "conservative": False}),
    ("spherical", "divergence", 1, {"method": "backward", "conservative": False}),
    ("spherical", "laplace", 0, {"conservative": False}),
    ("spherical", "tensor_divergence", 2, {"conservative": False}),
    ("spherical", "tensor_double_divergence", 2, {"conservative": False}),
    ("spherical", "vector_gradient", 1, {"method": "forward"}),
    ("spherical", "vector_gradient", 1, {"method": "backward"}),
    ("cylindrical", "gradient_squared", 0, {"central": False}),
]


@pytest.mark.parametrize("case, op, rank, kwargs", OPTIONS,
                         ids=[f"{c} {o} {k}" for c, o, _, k in OPTIONS])
def test_operator_options_match_pde_tpu(case, op, rank, kwargs):
    jgrid, tgrid = _grids(case)
    bc = SIDES[type(jgrid).__name__]
    data = np.random.default_rng(7).uniform(-1, 1, (jgrid.dim,) * rank + jgrid.shape)
    expected = np.asarray(jgrid.make_operator(op, bc, **kwargs)(data))
    got = tgrid.make_operator(op, bc, **kwargs)(torch.as_tensor(data)).numpy()
    np.testing.assert_allclose(got, expected, **TOL)


def test_unknown_methods_raise():
    for name in ("PolarSymGrid", "SphericalSymGrid"):
        grid = getattr(tpde, name)(1.0, 8)
        with pytest.raises(ValueError, match="Unknown derivative method"):
            grid.make_operator("gradient", "auto_periodic_neumann", method="sideways")(
                torch.zeros(8, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="not defined for grid PolarSymGrid"):
        tpde.PolarSymGrid(1.0, 8).make_operator("vector_laplace", "auto_periodic_neumann")


# field methods: (grid case, field rank, method, its output class)
METHODS = [
    ("polar", 0, "laplace", "ScalarField"), ("polar", 0, "gradient", "VectorField"),
    ("polar", 1, "divergence", "ScalarField"), ("polar", 1, "gradient", "Tensor2Field"),
    ("polar", 2, "divergence", "VectorField"),
    ("spherical", 0, "gradient_squared", "ScalarField"),
    ("spherical", 1, "divergence", "ScalarField"), ("spherical", 1, "gradient", "Tensor2Field"),
    ("spherical", 2, "divergence", "VectorField"),
    ("spherical", 2, "double_divergence", "ScalarField"),
    ("cylindrical", 0, "gradient", "VectorField"), ("cylindrical", 1, "laplace", "VectorField"),
    ("cylindrical", 1, "gradient", "Tensor2Field"), ("cylindrical", 2, "divergence", "VectorField"),
]


@pytest.mark.parametrize("case, rank, method, out", METHODS,
                         ids=[f"{c} rank {r} {m}" for c, r, m, _ in METHODS])
def test_field_methods_match_pde_tpu(case, rank, method, out):
    jgrid, tgrid = _grids(case)
    cls = ["ScalarField", "VectorField", "Tensor2Field"][rank]
    data = np.random.default_rng(11).uniform(-1, 1, (jgrid.dim,) * rank + jgrid.shape)
    bc = SIDES[type(jgrid).__name__]
    expected = getattr(getattr(jpde, cls)(jgrid, data), method)(bc)
    got = getattr(getattr(tpde, cls)(tgrid, data, dtype=torch.float64), method)(bc)
    assert type(got).__name__ == type(expected).__name__ == out
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)


def _plain_solve(jgrid, tgrid, bc, data, t_range, dt, conservative=True):
    """pde_tpu's and the port's plain step loops of ``DiffusionPDE(0.1)``."""
    key = {"operators.conservative_stencil": conservative}
    with jpde.config(key):
        expected = jpde.DiffusionPDE(0.1, bc=bc).solve(
            jpde.ScalarField(jgrid, data), t_range=t_range, dt=dt, backend="numpy",
            tracker=None)
    with tpde.config(key):
        got = tpde.DiffusionPDE(0.1, bc=bc).solve(
            tpde.ScalarField(tgrid, data, dtype=torch.float64), t_range=t_range, dt=dt,
            backend="numpy", tracker=None)
    return np.asarray(expected.data), got


@pytest.mark.parametrize("conservative", [True, False], ids=["conservative", "naive"])
@pytest.mark.parametrize("bc_id", ["derivative", "value", "sides"])
@pytest.mark.parametrize("case", GRIDS)
def test_diffusion_plain_solves_match(case, bc_id, conservative):
    jgrid, tgrid = _grids(case)
    data = np.random.default_rng(2).uniform(0, 1, jgrid.shape)
    dt = 0.2 * float(np.min(jgrid.discretization)) ** 2
    expected, got = _plain_solve(jgrid, tgrid, _bc(jgrid, bc_id), data, 50 * dt, dt,
                                 conservative)
    assert got.data.dtype == torch.float64
    np.testing.assert_allclose(got.data.numpy(), expected, **TOL)


def test_config_4_as_written():
    """BASELINE config 4: diffusion on SphericalSymGrid and CylindricalSymGrid,
    then vector and tensor field operators, all on the port's plain path
    against pde_tpu."""
    rng = np.random.default_rng(4)
    for case, bc in (("spherical", {"r": {"derivative": 0}}),
                     ("cylindrical", {"r": {"derivative": 0}, "z": {"value": 0}})):
        jgrid, tgrid = _grids(case)
        data = rng.uniform(0, 1, jgrid.shape)
        dt = 0.2 * float(np.min(jgrid.discretization)) ** 2
        expected, got = _plain_solve(jgrid, tgrid, bc, data, 100 * dt, dt)
        np.testing.assert_allclose(got.data.numpy(), expected, **TOL)
        jfield = jpde.ScalarField(jgrid, expected)
        grad_j, grad_t = jfield.gradient(bc), got.gradient(bc)
        np.testing.assert_allclose(grad_t.data.numpy(), np.asarray(grad_j.data), **TOL)
        vec_bc = {"derivative": 0}
        tensor_j, tensor_t = grad_j.gradient(vec_bc), grad_t.gradient(vec_bc)
        np.testing.assert_allclose(tensor_t.data.numpy(), np.asarray(tensor_j.data), **TOL)
        np.testing.assert_allclose(tensor_t.divergence(vec_bc).data.numpy(),
                                   np.asarray(tensor_j.divergence(vec_bc).data), **TOL)
        np.testing.assert_allclose(grad_t.divergence(vec_bc).data.numpy(),
                                   np.asarray(grad_j.divergence(vec_bc).data), **TOL)
        if case == "spherical":
            np.testing.assert_allclose(
                tensor_t.double_divergence(vec_bc).data.numpy(),
                np.asarray(tensor_j.double_divergence(vec_bc).data), **TOL)
        else:
            np.testing.assert_allclose(grad_t.laplace(vec_bc).data.numpy(),
                                       np.asarray(grad_j.laplace(vec_bc).data), **TOL)


@pytest.mark.parametrize("case", ["spherical", "spherical hole"])
def test_conservative_diffusion_conserves_mass(case):
    """The flux form conserves the integral under no-flux sides (the reason it
    is the default), as in pde_tpu."""
    _, tgrid = _grids(case)
    field = tpde.ScalarField(tgrid, np.random.default_rng(0).uniform(0, 1, tgrid.shape),
                             dtype=torch.float64)
    dt = 0.2 * float(tgrid.discretization[0]) ** 2
    with tpde.config({"operators.conservative_stencil": True}):
        result = tpde.DiffusionPDE(1.0).solve(field, t_range=200 * dt, dt=dt, tracker=None)
    np.testing.assert_allclose(float(result.integral), float(field.integral), rtol=1e-12)
