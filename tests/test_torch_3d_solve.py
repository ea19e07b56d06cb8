"""The 3D slice as a whole: ``solve`` of 3D diffusion, expression PDEs and
``AllenCahnPDE`` in the port against ``pde_tpu`` (fp64, CPU), on the
configurations of ``pde_tpu``'s 3D fused-window tests, at 1e-12; the plain 3D
operators against ``pde_tpu``'s; the routing of what the 3D kernels do not
take; and the device default.

The JAX side runs with ``PDE_TPU_PALLAS_INTERPRET=1``, so it takes its fused
Pallas windows (kernels #3 and #5 in interpret mode); the port's fused windows
run the kernels' plain versions on CPU tensors. Both must report
``info["fused_step"]``.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_cartesian_3d as c3
from pde_tpu_torch.ops import cuda_stencil_3d as s3

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-13)
UNIT = [(0, 1)] * 3


def _carry(jstate):
    return tpde.field_from_state(jstate.attributes_serialized, np.asarray(jstate.data))


def _scalar(periodic, lo=0.0, hi=1.0):
    def make(rng):
        grid = jpde.CartesianGrid(UNIT, (16, 8, 8), periodic=periodic)
        return jpde.ScalarField.random_uniform(grid, lo, hi, rng=rng, label="c")

    return make


def _brusselator_state(rng):
    grid = jpde.CartesianGrid(UNIT, (16, 8, 8), periodic=True)
    u = jpde.ScalarField.random_uniform(grid, rng=rng, label="u")
    v = jpde.ScalarField.random_uniform(grid, rng=rng, label="v")
    return jpde.FieldCollection([u, v])


def _expression(rhs, bc):
    return lambda p: p.PDE({"c": rhs}, bc=bc)


# id: (make the JAX state, make the PDE in one package, t_range, dt, the port's kernel);
# the rhs list is that of pde_tpu's tests/ops/test_pallas_3d.py
CASES = {
    "diffusion periodic": (_scalar(True), lambda p: p.DiffusionPDE(0.05), 0.01, 1e-4,
                           c3.affine_laplace_3d),
    "diffusion no-flux": (_scalar(False), lambda p: p.DiffusionPDE(0.05, bc={"derivative": 0}),
                          0.01, 1e-4, c3.affine_laplace_3d),
    "allen-cahn": (_scalar(True, -0.1, 0.1), _expression("0.1 * laplace(c) - c**3", "periodic"),
                   0.01, 1e-3, s3.multi_stencil_3d),
    "cahn-hilliard": (_scalar(True, -0.1, 0.1),
                      _expression("laplace(0.5 * c**3 - c - 0.1 * laplace(c))", "periodic"),
                      0.01, 1e-3, s3.multi_stencil_3d),
    "ac-noflux": (_scalar(False, -0.1, 0.1),
                  _expression("0.1 * laplace(c) + c - c**3", {"derivative": 0}), 0.01, 1e-3,
                  s3.multi_stencil_3d),
    "kpz": (_scalar(True, -0.1, 0.1),
            _expression("0.2 * laplace(c) - 0.1 * gradient_squared(c)", "periodic"), 0.01, 1e-3,
            s3.multi_stencil_3d),
    "dot-grad": (_scalar(False, -0.1, 0.1),
                 _expression("0.1 * laplace(c) + 0.05 * dot(gradient(c), gradient(c))",
                             {"derivative": 0}), 0.01, 1e-3, s3.multi_stencil_3d),
    "div-grad": (_scalar(True, -0.1, 0.1),
                 _expression("0.1 * divergence(gradient(c)) - c", "periodic"), 0.01, 1e-3,
                 s3.multi_stencil_3d),
    "brusselator": (_brusselator_state,
                    lambda p: p.PDE({"u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
                                     "v": "0.05 * laplace(v) + u - u**2 * v"}),
                    0.01, 1e-3, s3.multi_stencil_3d),
    "AllenCahnPDE": (_scalar(True, -0.1, 0.1), lambda p: p.AllenCahnPDE(interface_width=0.5),
                     0.005, 1e-4, s3.multi_stencil_3d),
}


@pytest.mark.parametrize("case_id", CASES)
def test_solve_matches_jax(case_id, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    make_state, make_eq, t_range, dt, _ = CASES[case_id]
    jstate = make_state(np.random.default_rng(sorted(CASES).index(case_id)))
    tstate = _carry(jstate)
    jeq, teq = make_eq(jpde), make_eq(tpde)
    jres = jeq.solve(jstate, t_range=t_range, dt=dt, tracker=None)
    tres = teq.solve(tstate, t_range=t_range, dt=dt, tracker=None)
    assert jeq.diagnostics["solver"]["fused_step"] is True
    assert teq.diagnostics["solver"]["fused_step"] is True
    assert teq.diagnostics["solver"]["steps"] == jeq.diagnostics["solver"]["steps"]
    np.testing.assert_allclose(tres.to_numpy(), np.asarray(jres.data), **TOL)


@pytest.mark.parametrize("case_id", ["diffusion no-flux", "ac-noflux"])
def test_solve_with_default_trackers_and_stepper(case_id):
    """``solve`` with the default trackers and a 37-step ``make_stepper`` run
    (a ladder remainder) take the window and equal the plain loop."""
    make_state, make_eq, _, dt, wrapper = CASES[case_id]
    state = _carry(make_state(np.random.default_rng(5)))
    eq = make_eq(tpde)
    solved = eq.solve(state, t_range=0.01, dt=dt, tracker="auto")
    assert eq.diagnostics["solver"]["fused_step"] is True
    plain = eq.solve(state, t_range=0.01, dt=dt, tracker=None, backend="numpy")
    np.testing.assert_allclose(solved.to_numpy(), plain.to_numpy(), **TOL)
    solver = tpde.EulerSolver(eq)
    out, t = solver.make_stepper(state, dt=dt)(state, 0.0, 37 * dt)
    plain_out, _ = tpde.EulerSolver(eq, backend="numpy").make_stepper(state, dt=dt)(
        state, 0.0, 37 * dt)
    assert solver.info["fused_step"] is True and solver.info["steps"] == 37
    assert t == pytest.approx(37 * dt)
    np.testing.assert_allclose(out.to_numpy(), plain_out.to_numpy(), **TOL)
    if case_id == "diffusion no-flux":  # no-flux diffusion conserves the integral
        assert float(out.integral) == pytest.approx(float(state.integral), rel=1e-12)


def test_ragged_anisotropic_grid():
    """The ragged anisotropic grid of the card's checks, diffusion with mixed
    faces and Allen-Cahn no-flux, fused against the plain loop."""
    grid = tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)], (30, 34, 38))
    state = tpde.ScalarField.random_uniform(grid, -0.1, 0.1, dtype=torch.float64,
                                            rng=np.random.default_rng(6))
    mixed = {"x-": {"value": 1}, "x+": {"derivative": 0.5}, "y": {"curvature": 0},
             "z": {"type": "mixed", "value": 2.0, "const": 0.5}}
    for eq in (tpde.DiffusionPDE(0.1, bc=mixed), tpde.AllenCahnPDE(0.5, bc={"derivative": 0})):
        fused = eq.solve(state, t_range=0.005, dt=1e-3, tracker=None)
        assert eq.diagnostics["solver"]["fused_step"] is True
        plain = eq.solve(state, t_range=0.005, dt=1e-3, tracker=None, backend="numpy")
        np.testing.assert_allclose(fused.to_numpy(), plain.to_numpy(), **TOL)


def test_allen_cahn_model_matches_jax():
    jeq, teq = jpde.AllenCahnPDE(0.5, mobility=2.0), tpde.AllenCahnPDE(0.5, mobility=2.0)
    assert teq.expression == jeq.expression
    assert teq._fused_rhs()[0] == jeq._fused_rhs()[0]
    jstate = _scalar(False, -0.5, 0.5)(np.random.default_rng(7))
    rate = teq.evolution_rate(_carry(jstate))
    np.testing.assert_allclose(rate.to_numpy(), np.asarray(jeq.evolution_rate(jstate).data), **TOL)


# -- the plain 3D operators ------------------------------------------------------------------
OPERATOR_BCS = {
    "periodic": (True, "periodic"),
    "dirichlet": (False, {"value": 1.5}),
    "neumann": (False, {"derivative": 0.3}),
    "mixed": ([False, True, False], {"x-": {"value": 1}, "x+": {"curvature": 0.5},
                                     "y": "periodic",
                                     "z": {"type": "mixed", "value": 2.0, "const": 0.5}}),
}


@pytest.mark.parametrize("operator", ["laplace", "gradient", "gradient_squared", "divergence"])
@pytest.mark.parametrize("bc_id", OPERATOR_BCS)
def test_plain_operator_matches_jax(operator, bc_id):
    periodic, bc = OPERATOR_BCS[bc_id]
    args = ([(0, 1), (0, 2), (0, 3)], (7, 6, 9))
    jgrid = jpde.CartesianGrid(*args, periodic=periodic)
    tgrid = tpde.CartesianGrid(*args, periodic=periodic)
    shape = (3, 7, 6, 9) if operator == "divergence" else (7, 6, 9)
    data = np.random.default_rng(8).random(shape)
    expected = np.asarray(jgrid.make_operator(operator, bc=bc)(data))
    got = tgrid.make_operator(operator, bc=bc)(torch.tensor(data))
    assert tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, **TOL)


def test_3d_boundary_metadata():
    grid = tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)], (4, 5, 6), periodic=[True, False, False])
    assert grid.cell_volumes.shape == (4, 5, 6)
    assert grid.cell_volumes[0, 0, 0] == pytest.approx(1 / 4 * 2 / 5 * 3 / 6)
    assert set(grid.boundary_names) >= {"back", "front"}
    bcs = grid.get_boundary_conditions(
        {"y": {"value": 1}, "back": {"value": 0}, "front": {"derivative": 2}})
    assert [b.periodic for b in bcs] == [True, False, False]
    z_axis = list(bcs)[2]
    assert type(z_axis.low).__name__ == "DirichletBC"
    assert type(z_axis.high).__name__ == "NeumannBC"


# -- routing ----------------------------------------------------------------------------------
def _face_array_bc():
    return {"x-": {"value": np.linspace(0, 1, 64).reshape(8, 8)}, "x+": {"derivative": 0},
            "y": {"derivative": 0}, "z": {"derivative": 0}}


UNSUPPORTED = {
    "sde": (lambda grid: tpde.KPZInterfacePDE(noise=0.1, rng=np.random.default_rng(0)),
            True, "3D SDE"),
    # per-face arrays: the side inputs of the 3D expression window take them
    # now (diffusion reroutes to it, as in pde_tpu), so match is None
    "face-array-bc": (lambda grid: tpde.DiffusionPDE(0.1, bc=_face_array_bc()), False, None),
    "face-array-bc expression": (lambda grid: tpde.PDE({"c": "laplace(c)"}, bc=_face_array_bc()),
                                 False, None),
}


@pytest.mark.parametrize("case_id", UNSUPPORTED)
def test_unsupported_falls_back_under_torch_and_raises_under_cuda(case_id):
    """What no 3D kernel takes runs the plain loop under torch and raises
    under cuda; the cases a kernel now takes (match None) fuse under torch
    and ask for the card under cuda."""
    make_eq, periodic, match = UNSUPPORTED[case_id]
    grid = tpde.UnitGrid([8, 8, 8], periodic=periodic)
    state = tpde.ScalarField.random_uniform(grid, -0.1, 0.1, dtype=torch.float64,
                                            rng=np.random.default_rng(9))
    eq = make_eq(grid)
    solver = tpde.EulerSolver(eq)
    out, _ = solver.make_stepper(state, dt=1e-4)(state, 0.0, 1e-3)
    if match is None:
        assert solver.info["fused_step"] and "fused_unsupported" not in solver.info
        assert np.all(np.isfinite(out.to_numpy()))
        program = eq.make_fused_euler_window(state, 1e-4).program
        assert program.library == "multi_stencil_3d" and program.sides is not None
        with pytest.raises(RuntimeError, match="CUDA device"):
            tpde.EulerSolver(eq, backend="cuda").make_stepper(state, dt=1e-4)
        return
    assert "fused_step" not in solver.info
    assert solver.info["fused_unsupported"]
    assert np.all(np.isfinite(out.to_numpy()))
    with pytest.raises(tpde.KernelUnsupportedError, match=match):
        eq.make_fused_euler_window(state, 1e-4)
    with pytest.raises(RuntimeError, match="backend='cuda'"):
        tpde.EulerSolver(eq, backend="cuda").make_stepper(state, dt=1e-4)


def test_cuda_backend_requires_a_cuda_state():
    state = tpde.ScalarField(tpde.UnitGrid([8, 8, 8], periodic=True), 0.1, dtype=torch.float64)
    for eq in (tpde.DiffusionPDE(0.1), tpde.AllenCahnPDE()):
        with pytest.raises(RuntimeError, match="CUDA device"):
            tpde.EulerSolver(eq, backend="cuda").make_stepper(state, dt=1e-3)


# -- the device default -----------------------------------------------------------------------
def test_field_without_device_asks_for_the_card():
    """With the config key at its default ("cuda"), a field made from numbers,
    an array or a string lands on the card: on a machine without one that
    raises torch's own error, and nothing falls back to the CPU."""
    assert tpde.config["device"] == "cpu"  # the fixture's request
    grid = tpde.UnitGrid([4, 4, 4], periodic=True)
    with tpde.config({"device": "cuda"}):
        if torch.cuda.is_available():
            assert tpde.ScalarField(grid, 0.0).device.type == "cuda"
            return
        for make in (
            lambda: tpde.ScalarField(grid, 0.0),
            lambda: tpde.ScalarField(grid),
            lambda: tpde.ScalarField(grid, np.ones((4, 4, 4))),
            lambda: tpde.ScalarField.random_uniform(grid, rng=np.random.default_rng(0)),
        ):
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                make()
        # a tensor keeps its own device, and an explicit device wins
        assert tpde.ScalarField(grid, torch.zeros(4, 4, 4)).device.type == "cpu"
        assert tpde.ScalarField(grid, 0.0, device="cpu").device.type == "cpu"


def test_field_from_state_follows_the_key():
    jstate = jpde.ScalarField.random_uniform(jpde.UnitGrid([4, 4, 4]), rng=np.random.default_rng(1))
    field = tpde.field_from_state(jstate.attributes_serialized, np.asarray(jstate.data))
    assert field.device.type == "cpu"
    np.testing.assert_array_equal(field.to_numpy(), np.asarray(jstate.data))
    pair = jpde.FieldCollection([jstate, jstate.copy()])
    if torch.cuda.is_available():
        return
    with tpde.config({"device": "cuda"}):
        for attrs, data in ((jstate.attributes_serialized, jstate.data),
                            (pair.attributes_serialized, pair.data)):
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                tpde.field_from_state(attrs, np.asarray(data))
        field = tpde.field_from_state(jstate.attributes_serialized, np.asarray(jstate.data),
                                      device="cpu")
        assert field.device.type == "cpu"
