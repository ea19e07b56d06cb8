"""Vector-state expression PDEs through the fused multi-field windows.

A ``VectorField`` enters the port's generated multi-field kernels (2D and 3D)
as its ``grid.dim`` component planes, as in ``pde_tpu`` (ROADMAP B2(e)). The
cases are those of ``pde_tpu``'s ``tests/ops/test_pallas_vector.py``: each
runs the same numpy inputs through ``pde_tpu``'s fused window (kernels #7 and
#5 in interpret mode) and the port's (the kernels' plain versions on CPU
tensors), fp64, at 1e-12; both report ``info["fused_step"]``. Also: the gates
``pde_tpu`` falls back on, which ``backend="cuda"`` turns into raises, and a
scalar state's window, which keeps one plane per field.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import KernelUnsupportedError
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.ops import cuda_stencil_3d as s3

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-13)
GL = "0.1 * vector_laplace(u) + u - dot(u, u) * u"
COUPLED = {
    "u": "0.1 * laplace(u) - divergence(v)",
    "v": "0.05 * vector_laplace(v) + gradient(u) - dot(v, v) * v",
}


def _carry(jstate):
    return tpde.field_from_state(jstate.attributes_serialized, np.asarray(jstate.data))


def _vector(shape, periodic=True):
    def make(rng):
        grid = jpde.UnitGrid(shape, periodic=periodic)
        return jpde.VectorField.random_uniform(grid, rng=rng, label="u")

    return make


def _pair(shape=(16, 16)):
    def make(rng):
        grid = jpde.UnitGrid(list(shape), periodic=True)
        u = jpde.ScalarField.random_uniform(grid, rng=rng, label="u")
        v = jpde.VectorField.random_uniform(grid, rng=rng, label="v")
        return jpde.FieldCollection([u, v])

    return make


# id: (make the JAX state, make the PDE in one package, t_range, dt, the port's kernel)
CASES = {
    "ginzburg-landau 2d": (_vector([16, 16]), lambda p: p.PDE({"u": GL}), 0.05, 1e-3,
                           cs.multi_stencil_2d),
    "vector 3d": (_vector([8, 8, 8]),
                  lambda p: p.PDE({"u": "0.05 * vector_laplace(u) - dot(u, u) * u"}),
                  0.02, 1e-3, s3.multi_stencil_3d),
    "coupled collection": (_pair(), lambda p: p.PDE(COUPLED), 0.05, 5e-3, cs.multi_stencil_2d),
    "scalar bcs": (_vector([16, 16], periodic=False),
                   lambda p: p.PDE({"u": "0.05 * vector_laplace(u)"},
                                   bc={"x": {"value": 0.5}, "y": {"derivative": 0}}),
                   0.02, 1e-3, cs.multi_stencil_2d),
    "scalar rhs broadcast": (_pair(),
                             lambda p: p.PDE({"u": "0.1 * laplace(u)",
                                              "v": "divergence(gradient(u)) - dot(v, v)"}),
                             0.02, 1e-3, cs.multi_stencil_2d),
}


@pytest.mark.parametrize("case_id", CASES)
def test_vector_solve_matches_jax(case_id, monkeypatch):
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
    assert type(tres).__name__ == type(jres).__name__
    np.testing.assert_allclose(tres.to_numpy(), np.asarray(jres.data), **TOL)


@pytest.mark.parametrize("case_id", ["ginzburg-landau 2d", "vector 3d", "coupled collection"])
def test_vector_window_equals_plain_loop(case_id):
    """A 37-step ``make_stepper`` run (a ladder remainder) takes the window,
    keeps the state's classes and equals the plain loop; the window advances
    ``grid.dim`` planes per vector field."""
    make_state, make_eq, _, dt, _ = CASES[case_id]
    state = _carry(make_state(np.random.default_rng(7)))
    eq = make_eq(tpde)
    solver = tpde.EulerSolver(eq)
    out, t = solver.make_stepper(state, dt=dt)(state, 0.0, 37 * dt)
    plain, _ = tpde.EulerSolver(eq, backend="numpy").make_stepper(state, dt=dt)(
        state, 0.0, 37 * dt)
    assert solver.info["fused_step"] is True and solver.info["steps"] == 37
    assert type(out) is type(state)
    np.testing.assert_allclose(out.to_numpy(), plain.to_numpy(), **TOL)
    window = eq.make_fused_euler_window(state, dt)
    dim = state.grid.dim
    assert window.program.n_fields == (dim + 1 if case_id == "coupled collection" else dim)


def test_vector_window_tiled_matches_plain():
    """One pass of the vector Ginzburg-Landau program through the replay of
    the kernel's row march (strips and chunks of 8, seams wrapped) equals the
    plain pass."""
    make_state, make_eq, _, dt, _ = CASES["ginzburg-landau 2d"]
    state = _carry(make_state(np.random.default_rng(3)))
    window = make_eq(tpde).make_fused_euler_window(state, dt)
    planes = [state.data[0], state.data[1]]
    for spec in window.specs:
        tiled = cs.multi_stencil_2d_marched(planes, spec, plan=(8, 8))
        plain = cs.multi_stencil_2d_plain(planes, spec)
        for a, b in zip(tiled, plain, strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _fused_reason(eq, state):
    solver = tpde.EulerSolver(eq)
    out, _ = solver.make_stepper(state, dt=1e-3)(state, 0.0, 0.01)
    assert solver.info.get("fused_step") is None
    assert np.isfinite(out.to_numpy()).all()
    with pytest.raises(RuntimeError, match="does not support"):
        tpde.EulerSolver(eq, backend="cuda").make_stepper(state, dt=1e-3)
    return solver.info["fused_unsupported"], out


def test_vector_gates_fall_back_or_raise(monkeypatch):
    """Configurations ``pde_tpu`` sends to its plain path record the same
    reason and run the plain loop here; ``backend="cuda"`` raises."""
    rng = np.random.default_rng(11)
    grid = jpde.UnitGrid([16, 16], periodic=True)
    state = _carry(jpde.VectorField.random_uniform(grid, rng=rng))

    # noise on a vector state
    reason, _ = _fused_reason(tpde.PDE({"u": "0.1 * vector_laplace(u)"}, noise=0.1), state)
    assert "noise" in reason

    # per-boundary-point array values are ambiguous on vector states; the plain
    # path applies the array along the boundary to every component, as pde_tpu's
    monkeypatch.setenv("PDE_TPU_DISABLE_FUSED", "1")
    jgrid_n = jpde.UnitGrid([16, 16])
    jstate_n = jpde.VectorField.random_uniform(jgrid_n, rng=rng)
    bc = {"x-": {"value": np.linspace(0, 1, 16)}, "x+": {"derivative": 0},
          "y": {"derivative": 0}}
    reason, out = _fused_reason(tpde.PDE({"u": "0.05 * vector_laplace(u)"}, bc=bc),
                                _carry(jstate_n))
    assert "scalar BC values" in reason
    jeq = jpde.PDE({"u": "0.05 * vector_laplace(u)"}, bc=bc)
    jout, _ = jpde.EulerSolver(jeq).make_stepper(jstate_n, dt=1e-3)(jstate_n, 0.0, 0.01)
    np.testing.assert_allclose(out.to_numpy(), np.asarray(jout.data), **TOL)

    # `laplace` of a vector names the operator to use; the plain path cannot
    # lower it either
    solver = tpde.EulerSolver(tpde.PDE({"u": "laplace(u)"}))
    with pytest.raises(Exception):
        solver.make_stepper(state, dt=1e-3)(state, 0.0, 0.01)
    assert "vector_laplace" in solver.info["fused_unsupported"]

    # tensor states have no window
    tgrid = tpde.UnitGrid([8, 8], periodic=True)
    tensor = tpde.Tensor2Field(tgrid, np.ones((2, 2, 8, 8)))
    with pytest.raises(KernelUnsupportedError, match="scalar or vector"):
        tpde.PDE({"s": "s"}).make_fused_euler_window(tensor, 1e-3)


def test_vector_laplace_needs_the_5_point_stencil():
    """Under a corner weight the plain vector Laplacian is the 9-point one,
    which the kernels do not take: the window is refused and the plain loop
    runs."""
    grid = tpde.UnitGrid([16, 16], periodic=True)
    state = tpde.VectorField.random_uniform(grid, rng=np.random.default_rng(2))
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 0.5}):
        with pytest.raises(KernelUnsupportedError, match="5-point"):
            tpde.PDE({"u": GL}).make_fused_euler_window(state, 1e-3)


def test_scalar_window_planes_unchanged():
    """A scalar state's window keeps one plane per field and no adapter."""
    grid = tpde.UnitGrid([16, 16], periodic=True)
    state = tpde.ScalarField.random_uniform(grid, rng=np.random.default_rng(4))
    window = tpde.PDE({"c": "laplace(c**3 - c - laplace(c))"}).make_fused_euler_window(
        state, 1e-3)
    assert window.program.n_fields == 1
    assert window.__name__ == "window"
