"""Boundary conditions that vary in time and space, the plain layer: the
expression layer (``utils/expressions.py``), the grids' boundary coordinates,
string values, the expression conditions (``value_expression``,
``derivative_expression``, ``mixed_expression``, ``virtual_point``, callable
values, ``value_cell``) and ``user`` conditions, whose ghost setters take the
operator's ``t`` and ``args``; ``solve`` on the ``torch`` engine (Euler, RK4,
AB2, adaptive Euler, RKF45) and the plain sharded stepper. Everything is held
against ``pde_tpu`` on the CPU in fp64 at 1e-12 relative, from seeded numpy
inputs; decomposed runs against the port's serial run bit for bit.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.utils import expressions as jexpr
from pde_tpu_torch.utils import expressions as texpr

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
TIMES = (0.0, 0.3, 1.7)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


# -- the expression layer ---------------------------------------------------------------------
@pytest.mark.parametrize("text", ["sin(x) * t + 2", "3.5", "x**2 * exp(-t) + Heaviside(x)"])
def test_scalar_expression_matches_jax(text):
    sig = ["x", "t"]
    j, t = jexpr.ScalarExpression(text, signature=sig), texpr.ScalarExpression(text, signature=sig)
    assert (t.constant, t.vars, t.expression) == (j.constant, j.vars, j.expression)
    if j.constant:
        assert t.value == j.value and t.is_zero == j.is_zero
    x = np.linspace(-1, 2, 7)
    np.testing.assert_allclose(t(x, 0.4), j(x, 0.4), **TOL)
    got = torch.as_tensor(t._get_function()(torch.tensor(x), 0.4)).numpy()
    np.testing.assert_allclose(got, j(x, 0.4), **TOL)
    for var in sig:
        assert t.differentiate(var).expression == j.differentiate(var).expression
    assert t.derivatives.expression == j.derivatives.expression
    np.testing.assert_allclose(t.derivatives(0.3, 0.4), j.derivatives(0.3, 0.4), **TOL)


def test_tensor_expression_matches_jax():
    j = jexpr.TensorExpression("[x * y, sin(y)]", signature=["x", "y"])
    t = texpr.TensorExpression("[x * y, sin(y)]", signature=["x", "y"])
    assert (t.shape, t.rank, t.constant) == (j.shape, j.rank, j.constant)
    x, y = np.linspace(0, 1, 5), np.linspace(1, 2, 5)
    np.testing.assert_allclose(t(x, y), j(x, y), **TOL)
    got = t._get_function()(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, j(x, y), **TOL)
    assert t[1].expression == j[1].expression
    assert t.differentiate("y").expression == j.differentiate("y").expression
    assert t.derivatives.shape == j.derivatives.shape
    assert tpde.TensorExpression is texpr.TensorExpression


# -- grids ------------------------------------------------------------------------------------
def _grid_pair(kind: str):
    if kind == "cartesian":
        args, kwargs = ([(0, 1), (0, 2)], (6, 5)), {}
        cls = "CartesianGrid"
    elif kind == "polar":
        args, kwargs, cls = ((0.5, 2.0), 8), {}, "PolarSymGrid"
    elif kind == "spherical":
        args, kwargs, cls = ((0.5, 2.0), 8), {}, "SphericalSymGrid"
    else:
        args, kwargs, cls = ((0.5, 2.0), (0, 3), (6, 5)), {}, "CylindricalSymGrid"
    return getattr(jpde, cls)(*args, **kwargs), getattr(tpde, cls)(*args, **kwargs)


GRID_KINDS = ["cartesian", "polar", "spherical", "cylindrical"]


@pytest.mark.parametrize("kind", GRID_KINDS)
def test_boundary_coordinates(kind):
    jgrid, tgrid = _grid_pair(kind)
    for axis in range(tgrid.num_axes):
        for upper in (False, True):
            for offset in (0.0, 0.25):
                np.testing.assert_array_equal(
                    tgrid._boundary_coordinates(axis, upper, offset=offset),
                    jgrid._boundary_coordinates(axis, upper, offset=offset))


# -- ghost cells of the conditions --------------------------------------------------------
STRING_BCS = {
    "cartesian": {"x-": {"value": "sin(y) + x"}, "x+": {"derivative": "y**2"},
                  "y-": {"mixed": "1 + x", "const": "cos(x)"}, "y+": {"curvature": "x*y"}},
    "polar": {"r-": {"value": "r**2"}, "r+": {"derivative": "2*r"}},
    "spherical": {"r-": {"derivative": "r"}, "r+": {"mixed": "r", "const": "1/r"}},
    "cylindrical": {"r-": {"derivative": "sin(z)"}, "r+": {"value": "r*z"},
                    "z": {"value": "cos(r)"}},
}


@pytest.mark.parametrize("kind", GRID_KINDS)
def test_string_values_on_every_grid(kind):
    """A string value is an expression of the side's coordinates, evaluated
    once (``pde_tpu``'s ``_value_from_expression``)."""
    jgrid, tgrid = _grid_pair(kind)
    bc = STRING_BCS[kind]
    data = np.random.default_rng(3).uniform(size=tgrid.shape)
    expected = np.asarray(jgrid.make_operator("laplace", bc)(data))
    got = tgrid.make_operator("laplace", bc)(torch.tensor(data)).numpy()
    np.testing.assert_allclose(got, expected, **TOL)


EXPRESSION_BCS = {
    "value and derivative expressions": {
        "x-": {"value_expression": "sin(3*t) + y"}, "x+": {"derivative_expression": "0.5*cos(t)"},
        "y-": {"value_expr": "x*t"}, "y+": {"derivative_expr": "x**2 - t"}},
    "mixed expressions": {
        "x": {"mixed_expression": "1 + y*t", "const": "2*t"},
        "y-": {"robin_expr": "2 + sin(x)", "const": "x"}, "y+": {"mixed_expr": "t"}},
    "virtual point and value cell": {
        "x-": {"virtual_point": "0.5*value + t*y"}, "x+": {"value": 1.0},
        "y-": {"value_expression": "x", "value_cell": 2},
        "y+": {"type": "virtual_point", "value": "value*dx + sin(t)"}},
    "callable values": {
        "x-": {"value": lambda adj, dx, x, y, t: np.sin(y) + t},
        "x+": {"derivative": lambda adj, dx, x, y, t: 0 * y + t},
        "y-": {"mixed": lambda adj, dx, x, y, t: 1 + x * 0, "const": 0.5},
        "y+": {"virtual_point": lambda adj, dx, x, y, t: 0.5 * adj + t}},
    "user functions": {
        "x": {"value_expression": "f(t) + y", "user_funcs": {"f": lambda t: 2 * t}},
        "y": {"derivative": 0}},
}


def _callable_for(pkg, bc):
    """`bc` with its callables on `pkg`'s arrays: numpy's ``sin`` becomes the
    package's (jax or torch) function."""
    if pkg is jpde:
        import jax.numpy as xp
    else:
        xp = torch
    out = {}
    for side, data in bc.items():
        data = dict(data) if isinstance(data, dict) else data
        if isinstance(data, dict):
            for key, value in list(data.items()):
                if callable(value) and key != "user_funcs":
                    data[key] = _with_module(value, xp)
        out[side] = data
    return out


def _with_module(fn, xp):
    globs = dict(fn.__globals__)
    globs["np"] = xp
    import types

    return types.FunctionType(fn.__code__, globs, fn.__name__, fn.__defaults__, fn.__closure__)


@pytest.mark.parametrize("case", EXPRESSION_BCS)
def test_expression_conditions_ghosts_at_several_times(case):
    """Every expression condition's ghosts, read through the Laplacian, at
    several times (the operator's `t`, or ``args={"t": t}``)."""
    jgrid, tgrid = _grid_pair("cartesian")
    jbc, tbc = _callable_for(jpde, EXPRESSION_BCS[case]), _callable_for(tpde, EXPRESSION_BCS[case])
    data = np.random.default_rng(5).uniform(size=tgrid.shape)
    jop, top = jgrid.make_operator("laplace", jbc), tgrid.make_operator("laplace", tbc)
    for t in TIMES:
        expected = np.asarray(jop(data, t))
        np.testing.assert_allclose(top(torch.tensor(data), t).numpy(), expected, **TOL)
        np.testing.assert_allclose(top(torch.tensor(data), args={"t": t}).numpy(), expected,
                                   **TOL)


def test_expression_conditions_on_curvilinear_grids():
    for kind, bc in (("polar", {"r-": {"derivative": 0}, "r+": {"value_expression": "t*r"}}),
                     ("cylindrical", {"r": {"value_expression": "sin(z - t)"},
                                      "z-": {"derivative_expression": "r*t"},
                                      "z+": {"mixed_expression": "1 + t", "const": "r"}})):
        jgrid, tgrid = _grid_pair(kind)
        data = np.random.default_rng(6).uniform(size=tgrid.shape)
        jop, top = jgrid.make_operator("laplace", bc), tgrid.make_operator("laplace", bc)
        for t in TIMES:
            np.testing.assert_allclose(top(torch.tensor(data), t).numpy(),
                                       np.asarray(jop(data, t)), **TOL)


@pytest.mark.parametrize("args", [None, {"value": 0.7}, {"derivative": -1.5},
                                  {"virtual_point": 3.0}, {"t": 1.0},
                                  {"value": np.linspace(0, 1, 5)}], ids=str)
def test_user_condition_takes_args(args):
    jgrid, tgrid = _grid_pair("cartesian")
    bc = {"x-": "user", "x+": {"value": 1.0}, "y": {"derivative": 0}}
    data = np.random.default_rng(7).uniform(size=tgrid.shape)
    expected = np.asarray(jgrid.make_operator("laplace", bc)(data, 0.0, args))
    got = tgrid.make_operator("laplace", bc)(torch.tensor(data), 0.0, args).numpy()
    np.testing.assert_allclose(got, expected, **TOL)


def test_condition_objects():
    """Names, keys, copies and representations of the new conditions."""
    jgrid, tgrid = _grid_pair("cartesian")
    data = {"value_expression": "sin(t) + y"}
    jbc = jgrid.get_boundary_conditions({"x-": data, "x+": "user", "y": {"derivative": 0}})
    tbc = tgrid.get_boundary_conditions({"x-": data, "x+": "user", "y": {"derivative": 0}})
    for jside, tside in zip(list(jbc)[0], list(tbc)[0], strict=True):
        assert type(tside).__name__ == type(jside).__name__
        assert tside.get_mathematical_representation("c") == \
            jside.get_mathematical_representation("c")
    low = list(tbc)[0].low
    assert low == tgrid.get_boundary_conditions({"x-": data, "x+": "user",
                                                 "y": {"derivative": 0}})._axes[0].low
    assert low._value_key() == ("sin(t) + y", "0", "value", None)
    copy = low.copy_for(tgrid, upper=True)
    assert (type(copy), copy.upper, copy._value_key()) == (type(low), True, low._value_key())
    names = set(tpde.registered_boundary_condition_names())
    assert {"value_expression", "derivative_expr", "mixed_expression", "robin_expr",
            "virtual_point", "user"} <= names
    assert set(jpde.registered_boundary_condition_names()) == names
    assert set(jpde.registered_boundary_condition_classes()) == \
        set(tpde.registered_boundary_condition_classes())
    with pytest.raises(NotImplementedError, match="scalar fields"):
        tgrid.get_boundary_conditions({"value_expression": "t"}, rank=1)
    with pytest.raises(tpde.BCDataError, match="empty"):
        tgrid.get_boundary_conditions({"x": {}, "y": {"derivative": 0}})
    with pytest.raises(RuntimeError, match="unexpected variables"):
        tgrid.get_boundary_conditions({"value": "sin(t)"})


# -- solve ------------------------------------------------------------------------------------
SOLVE_BC = {"x-": {"value_expression": "sin(3*t) + y"}, "x+": {"derivative_expression": "0.5*cos(t)"},
            "y-": {"value": "x**2"}, "y+": {"mixed_expression": "1 + t", "const": "sin(x - 2*t)"}}
SOLVE_BC_CYL = {"r-": {"derivative_expression": "0.1*t"}, "r+": {"value_expression": "sin(z - t)"},
                "z": {"value": "r"}}
SOLVERS = {
    "euler": dict(solver="euler", dt=1e-3),
    "rk4": dict(solver="runge-kutta", dt=1e-3),
    "ab2": dict(solver="adams-bashforth", dt=1e-3),
    "adaptive euler": dict(solver="euler", adaptive=True, tolerance=1e-5),
    "rkf45": dict(solver="runge-kutta", adaptive=True, tolerance=1e-6),
}


@pytest.mark.parametrize("grid_kind", ["cartesian", "cylindrical"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_solve_with_time_and_space_dependent_sides(solver, grid_kind):
    """``solve`` on the torch engine (its windows, where they apply, run the
    kernels' plain versions here) against pde_tpu, from t = 0.3: the rhs
    receives each step's, stage's and trial's time."""
    results = []
    bc = SOLVE_BC if grid_kind == "cartesian" else SOLVE_BC_CYL
    for pkg in (jpde, tpde):
        if grid_kind == "cartesian":
            grid = pkg.CartesianGrid([(0, 1), (0, 2)], (8, 10))
        else:
            grid = pkg.CylindricalSymGrid((0.5, 2.0), (0, 3), (8, 10))
        data = np.random.default_rng(11).uniform(size=grid.shape)
        state = pkg.ScalarField(grid, data) if pkg is jpde else \
            pkg.ScalarField(grid, data, dtype=torch.float64)
        eq = pkg.PDE({"c": "0.1 * laplace(c) - c**3"}, bc=bc)
        res = eq.solve(state, t_range=[0.3, 0.35], tracker=None, **SOLVERS[solver],
                       **({} if pkg is jpde else {"backend": "torch"}))
        results.append(np.asarray(res.data) if pkg is jpde else res.data.numpy())
    np.testing.assert_allclose(results[1], results[0], **TOL)


def test_integration_time_dependent_side_in_2d():
    """``tests/test_integration.py:65-76`` held in 2D (1D Cartesian grids
    are ROADMAP A4's): the side's value follows t / (t + 1)."""
    results = []
    for pkg in (jpde, tpde):
        grid = pkg.CartesianGrid([(0, 1), (0, 1)], (16, 4), periodic=[False, True])
        state = pkg.ScalarField(grid, 0.0) if pkg is jpde else \
            pkg.ScalarField(grid, 0.0, dtype=torch.float64)
        eq = pkg.DiffusionPDE(1.0, bc={"x-": {"value": 0},
                                       "x+": {"value_expression": "t / (t + 1)"}, "y": "periodic"})
        res = eq.solve(state, t_range=5, dt=1e-3, tracker=None,
                       **({} if pkg is jpde else {"backend": "torch"}))
        results.append(np.asarray(res.data) if pkg is jpde else res.data.numpy())
    np.testing.assert_allclose(results[1], results[0], **TOL)
    expected = (grid.axes_coords[0] * (5 / 6))[:, None]
    np.testing.assert_allclose(results[1], np.broadcast_to(expected, (16, 4)), atol=0.05)


@pytest.mark.parametrize("decomposition", [[2, 2], [1, 4]], ids=str)
def test_sharded_plain_stepper_is_serial(decomposition):
    """Expression and string-valued sides on the plain sharded stepper: each
    view reads its part of the global side's coordinates, so decomposed
    runs equal the serial plain run bit for bit."""
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], (16, 16))
    state = tpde.ScalarField.random_uniform(grid, dtype=torch.float64,
                                            rng=np.random.default_rng(13))
    bc = {"x-": {"value_expression": "sin(3*t) + y"}, "x+": {"derivative": "y"},
          "y-": {"mixed_expression": "1 + x", "const": "t"}, "y+": "user"}
    eq = tpde.PDE({"c": "0.1 * laplace(c) + 0.1 * gradient_squared(c)"}, bc=bc)
    kwargs = dict(t_range=[0.2, 0.25], dt=1e-3, tracker=None, backend="torch")
    serial = eq.solve(state, **kwargs)
    split, info = eq.solve(state, decomposition=decomposition, ret_info=True, **kwargs)
    assert info["solver"]["sharded_halo"] >= 1
    assert torch.equal(split.data, serial.data)
