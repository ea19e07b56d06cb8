"""Faults C1-C4 of the port (ROADMAP §C), each held against ``pde_tpu`` on the
CPU in fp64 on the 12x10 grid of the re-anchor with inputs from
``default_rng(0)``. The old max differences are recorded beside each case."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.grids.boundaries import BCDataError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
SHAPE = (12, 10)


def _grids():
    return jpde.UnitGrid(list(SHAPE)), tpde.UnitGrid(list(SHAPE))


def _data(rank):
    return np.random.default_rng(0).random((2,) * rank + SHAPE)


# -- C1: the normal_* conditions ------------------------------------------------------------
# Before the repair the whole-grid form fell back to auto_periodic_neumann; the
# max differences from pde_tpu were 7.47 (ScalarField.laplace, normal_value),
# 2.00 (VectorField.laplace, normal_value) and 1.00 (normal_derivative)
NORMAL_BCS = {
    "normal_value": {"normal_value": 1.0},
    "normal_derivative": {"normal_derivative": 0.5},
    "normal_mixed": {"normal_mixed": 2.0},
    "normal_curvature": {"normal_curvature": 0.3},
    "per axis": {"x": {"normal_value": 1.0}, "y": {"normal_derivative": -0.5}},
    "per side": {"x-": {"normal_dirichlet": 0.2}, "x+": {"type": "normal_robin", "value": 1.0,
                                                         "const": 0.5},
                 "y": "derivative"},
}


@pytest.mark.parametrize("bc", NORMAL_BCS, ids=list(NORMAL_BCS))
def test_normal_conditions_match_jax(bc):
    jgrid, tgrid = _grids()
    bc = NORMAL_BCS[bc]
    for rank, jcls, tcls in ((0, jpde.ScalarField, tpde.ScalarField),
                             (1, jpde.VectorField, tpde.VectorField)):
        data = _data(rank)
        expected = jcls(jgrid, data).laplace(bc).data
        got = tcls(tgrid, data, dtype=torch.float64).laplace(bc).data
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_normal_value_vector_laplace_euler_steps_match_jax():
    """Ten Euler steps of PDE({"u": "vector_laplace(u)"}) at dt = 0.01 (old
    difference 0.148); the kernels apply one condition to every plane, so the
    port runs its plain loop here and says why."""
    jgrid, tgrid = _grids()
    data = _data(1)
    bc = {"normal_value": 1.0}
    expected = jpde.PDE({"u": "vector_laplace(u)"}, bc=bc).solve(
        jpde.VectorField(jgrid, data), t_range=0.1, dt=0.01, tracker=None)
    eq = tpde.PDE({"u": "vector_laplace(u)"}, bc=bc)
    got = eq.solve(tpde.VectorField(tgrid, data, dtype=torch.float64), t_range=0.1, dt=0.01,
                   tracker=None)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)
    assert "normal conditions" in eq.diagnostics["solver"]["fused_unsupported"]
    with pytest.raises(RuntimeError, match="normal conditions"):
        eq.solve(tpde.VectorField(tgrid, data, dtype=torch.float64), t_range=0.1, dt=0.01,
                 tracker=None, backend="cuda")


def test_unknown_condition_names_raise():
    _, tgrid = _grids()
    field = tpde.ScalarField(tgrid, _data(0), dtype=torch.float64)
    for bc in ({"nromal_value": 1.0}, {"x": "periodic", "z": {"value": 1}}):
        with pytest.raises(BCDataError):
            field.laplace(bc)
    with pytest.raises(BCDataError):
        field.laplace({"x": {"normal_velocity": 1}})


# -- C2: the engine names -------------------------------------------------------------------
def test_registered_backends_match_jax():
    """Before the repair `numba`, `numba_mpi` and `scipy` raised "Unknown
    backend"; the port adds its own engine `cuda`."""
    ours = set(tpde.registered_backends())
    assert ours - {"cuda"} == set(jpde.registered_backends())
    _, tgrid = _grids()
    state = tpde.ScalarField(tgrid, _data(0), dtype=torch.float64)
    eq = tpde.DiffusionPDE(0.1)
    reference = eq.solve(state, t_range=0.05, dt=0.01, tracker=None)
    for name in ("numba", "numba_mpi", "scipy"):
        got = eq.solve(state, t_range=0.05, dt=0.01, tracker=None, backend=name)
        torch.testing.assert_close(got.data, reference.data, rtol=0, atol=0)


# -- C3: solve's arguments ------------------------------------------------------------------
def test_solve_arguments_match_jax():
    """Before the repair ret_info raised TypeError, `explicit` and solver
    classes raised "Unknown solver method" (tests/solvers of pde_tpu)."""
    jgrid, tgrid = _grids()
    data = _data(0)
    expected, jinfo = jpde.DiffusionPDE(0.1).solve(
        jpde.ScalarField(jgrid, data), t_range=0.05, dt=0.01, tracker=None, ret_info=True,
        solver="explicit", backend="numpy",
    )
    eq = tpde.DiffusionPDE(0.1)
    state = tpde.ScalarField(tgrid, data, dtype=torch.float64)
    got, info = eq.solve(state, t_range=0.05, dt=0.01, tracker=None, ret_info=True,
                         solver="explicit")
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)
    assert {"controller", "solver"} <= set(info) and {"controller", "solver"} <= set(jinfo)
    assert info["solver"]["class"] == jinfo["solver"]["class"] == "ExplicitSolver"
    assert info["solver"]["steps"] == jinfo["solver"]["steps"] == 5
    by_class = eq.solve(state, t_range=0.05, dt=0.01, tracker=None, solver=tpde.EulerSolver,
                        gather_mode="main")
    torch.testing.assert_close(by_class.data, got.data, rtol=0, atol=0)
    with pytest.raises(TypeError, match="not an instance"):
        eq.solve(state, t_range=0.05, dt=0.01, tracker=None, solver=tpde.EulerSolver(eq))
    with pytest.raises(ValueError, match="gather_mode"):
        eq.solve(state, t_range=0.05, dt=0.01, tracker=None, gather_mode="some")


# -- C4: negative component indices ---------------------------------------------------------
def test_negative_component_indices_match_jax():
    """Before the repair `VectorField[-1]` raised (get_axis_index rejects
    negative integers); pde_tpu indexes the data."""
    jgrid, tgrid = _grids()
    vec, ten = _data(1), _data(2)
    jvec, tvec = jpde.VectorField(jgrid, vec), tpde.VectorField(tgrid, vec, dtype=torch.float64)
    jten = jpde.Tensor2Field(jgrid, ten)
    tten = tpde.Tensor2Field(tgrid, ten, dtype=torch.float64)
    for key in (-1, -2, 1, "x", "y"):
        np.testing.assert_array_equal(tvec[key].data.numpy(), np.asarray(jvec[key].data))
    for key in ((-1, 0), (0, -1), (-2, -2), ("y", -1)):
        np.testing.assert_array_equal(tten[key].data.numpy(), np.asarray(jten[key].data))
    tvec[-1] = tpde.ScalarField(tgrid, np.ones(SHAPE), dtype=torch.float64)
    jvec[-1] = jpde.ScalarField(jgrid, np.ones(SHAPE))
    np.testing.assert_array_equal(tvec.data.numpy(), np.asarray(jvec.data))
    tten[-1, 0] = 2.0
    jten[-1, 0] = 2.0
    np.testing.assert_array_equal(tten.data.numpy(), np.asarray(jten.data))
