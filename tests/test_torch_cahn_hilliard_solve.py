"""The whole slice: ``solve`` and ``make_stepper`` of expression PDEs and
``CahnHilliardPDE`` in the port against ``pde_tpu`` (fp64, CPU), on the
configurations of ``pde_tpu``'s fused multi-field window tests, at their
tolerances.

The JAX side runs with ``PDE_TPU_PALLAS_INTERPRET=1``, so it takes its fused
Pallas window (kernel #7 in interpret mode); the port's fused window runs the
generated kernel's plain version on CPU tensors. Both must report
``info["fused_step"]``.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_stencil_2d as cs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


CORNER_KEY = "operators.cartesian.laplacian_2d_corner_weight"


def _carry(jstate):
    return tpde.field_from_state(jstate.attributes_serialized, np.asarray(jstate.data))


def _two_fields(grid, rng, v=None):
    u = jpde.ScalarField.random_uniform(grid, rng=rng, label="u")
    v = jpde.ScalarField.random_uniform(grid, rng=rng, label="v") if v is None else v
    return jpde.FieldCollection([u, v])


def _brusselator_neumann_state(rng):
    grid = jpde.UnitGrid([16, 16])
    u = jpde.ScalarField(grid, 1.0, label="u")
    v = 3.0 + 0.1 * jpde.ScalarField.random_normal(grid, rng=rng, label="v")
    return jpde.FieldCollection([u, v])


# id: (make the JAX state from a numpy generator, make the PDE in one package,
#      t_range, dt, rtol, atol)
CASES = {
    "brusselator": (
        lambda rng: _two_fields(jpde.UnitGrid([16, 16], periodic=True), rng),
        lambda p: p.PDE({"u": "1 + u**2 * v - 2.2 * u + 0.1 * laplace(u)",
                         "v": "1.2 * u - u**2 * v + 0.02 * laplace(v)"}),
        0.1, 0.01, 1e-12, 1e-13),
    "wave-system": (
        lambda rng: _two_fields(
            jpde.UnitGrid([16, 32], periodic=True), rng,
            v=jpde.ScalarField(jpde.UnitGrid([16, 32], periodic=True), data=0.0, label="v")),
        lambda p: p.PDE({"u": "v", "v": "0.5 * laplace(u)"}),
        0.1, 0.01, 1e-12, 1e-13),
    "gradient-divergence": (
        lambda rng: jpde.ScalarField.random_uniform(
            jpde.CartesianGrid([(0, 1), (0, 1)], (16, 16), periodic=True), rng=rng),
        lambda p: p.PDE({"c": "0.001 * divergence(gradient(c))"}),
        0.05, 0.01, 1e-12, 1e-13),
    "dot-gradients": (
        lambda rng: _two_fields(jpde.UnitGrid([16, 16], periodic=True), rng),
        lambda p: p.PDE({"u": "0.1 * laplace(u) + 0.05 * dot(gradient(u), gradient(v))",
                         "v": "0.1 * laplace(v)"}),
        0.1, 0.01, 1e-12, 1e-13),
    "brusselator-neumann": (
        _brusselator_neumann_state,
        lambda p: p.PDE({"u": "laplace(u) + 1 - 4 * u + u**2 * v",
                         "v": "0.1 * laplace(v) + 3 * u - u**2 * v"}),
        0.1, 0.01, 1e-12, 1e-12),
    "cahn-hilliard-noflux": (
        lambda rng: jpde.ScalarField.random_uniform(
            jpde.CartesianGrid([(0, 8), (0, 8)], (16, 16)), -0.1, 0.1, rng=rng),
        lambda p: p.CahnHilliardPDE(interface_width=1.0, bc_c={"derivative": 0},
                                    bc_mu={"derivative": 0}),
        0.05, 1e-3, 1e-11, 1e-12),
    "expression-mixed-bcs": (
        lambda rng: jpde.ScalarField.random_uniform(
            jpde.CartesianGrid([(0, 1), (0, 1)], (16, 16)), rng=rng, label="c"),
        lambda p: p.PDE(
            {"c": "0.001 * laplace(c) - 0.1 * c"},
            bc={"x-": {"value": 1}, "x+": {"derivative": 0},
                "y-": {"derivative": 0.2}, "y+": {"type": "mixed", "value": 1.0, "const": 0.3}}),
        0.05, 1e-3, 1e-11, 1e-12),
}


@pytest.mark.parametrize("case_id", CASES)
def test_solve_matches_jax(case_id, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    make_state, make_eq, t_range, dt, rtol, atol = CASES[case_id]
    jstate = make_state(np.random.default_rng(sorted(CASES).index(case_id)))
    tstate = _carry(jstate)
    jeq, teq = make_eq(jpde), make_eq(tpde)
    jres = jeq.solve(jstate, t_range=t_range, dt=dt, tracker=None)
    tres = teq.solve(tstate, t_range=t_range, dt=dt, tracker=None)
    assert jeq.diagnostics["solver"]["fused_step"] is True
    assert teq.diagnostics["solver"]["fused_step"] is True
    assert teq.diagnostics["solver"]["steps"] == jeq.diagnostics["solver"]["steps"]
    assert type(tres).__name__ == type(jres).__name__
    np.testing.assert_allclose(tres.to_numpy(), np.asarray(jres.data), rtol=rtol, atol=atol)
    if case_id == "cahn-hilliard-noflux":  # no-flux Cahn-Hilliard conserves mass
        assert float(tres.integral) == pytest.approx(float(tstate.integral), rel=1e-9)


@pytest.mark.parametrize("model", ["expression", "class"])
def test_make_stepper_matches_jax(model, monkeypatch):
    """The BASELINE form: periodic Cahn-Hilliard, 13 steps (a ladder remainder)."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jstate = jpde.ScalarField.random_uniform(
        jpde.UnitGrid([16, 32], periodic=True), -0.1, 0.1, rng=np.random.default_rng(21)
    )
    tstate = _carry(jstate)
    if model == "expression":
        jeq = jpde.PDE({"c": "laplace(c**3 - c - laplace(c))"})
        teq = tpde.PDE({"c": "laplace(c**3 - c - laplace(c))"})
    else:
        jeq, teq = jpde.CahnHilliardPDE(), tpde.CahnHilliardPDE()
    jsolver = jpde.EulerSolver(jeq, adaptive=False)
    tsolver = tpde.EulerSolver(teq, adaptive=False)
    jout, jt = jsolver.make_stepper(jstate, dt=1e-3)(jstate, 0.0, 0.013)
    tout, tt = tsolver.make_stepper(tstate, dt=1e-3)(tstate, 0.0, 0.013)
    assert jsolver.info.get("fused_step") is True
    assert tsolver.info.get("fused_step") is True
    assert tsolver.info["steps"] == jsolver.info["steps"] == 13
    assert tt == pytest.approx(jt)
    np.testing.assert_allclose(tout.to_numpy(), np.asarray(jout.data), rtol=1e-11, atol=1e-12)
    assert float(tout.average) == pytest.approx(float(tstate.average), abs=1e-14)


def _brusselator_states(seed):
    jstate = _two_fields(jpde.UnitGrid([16, 16], periodic=True), np.random.default_rng(seed))
    return jstate, _carry(jstate)


BRUSSELATOR = {"u": "1 + u**2 * v - 2.2 * u + 0.1 * laplace(u)",
               "v": "1.2 * u - u**2 * v + 0.02 * laplace(v)"}


def test_tracker_auto_and_engines_agree():
    """The default trackers on a collection; the numpy engine's plain loop
    agrees with the fused window; the kernel is not launched on the CPU."""
    _, tstate = _brusselator_states(31)
    eq = tpde.PDE(BRUSSELATOR)
    launches = cs.multi_stencil_2d.launches
    fused = eq.solve(tstate, t_range=0.3, dt=0.01, tracker="auto")
    assert eq.diagnostics["solver"]["fused_step"] is True
    assert eq.diagnostics["controller"]["successful"]
    plain = eq.solve(tstate, t_range=0.3, dt=0.01, tracker=None, backend="numpy")
    assert "fused_step" not in eq.diagnostics["solver"]
    assert cs.multi_stencil_2d.launches == launches
    np.testing.assert_allclose(fused.to_numpy(), plain.to_numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_corner_weight_runs_plain_loop(backend):
    jstate, tstate = _brusselator_states(32)
    with jpde.config({CORNER_KEY: 0.5}), tpde.config({CORNER_KEY: 0.5}):
        jres = jpde.PDE(BRUSSELATOR).solve(jstate, t_range=0.1, dt=0.01, tracker=None)
        solver = tpde.EulerSolver(tpde.PDE(BRUSSELATOR), backend=backend)
        tres, _ = solver.make_stepper(tstate, dt=0.01)(tstate, 0.0, 0.1)
    assert "fused_step" not in solver.info
    if backend == "torch":  # #7 refuses the key, as pde_tpu's gate does
        assert "pde_tpu/models/pde.py:750-762" in solver.info["fused_unsupported"]
    np.testing.assert_allclose(tres.to_numpy(), np.asarray(jres.data), rtol=1e-12, atol=1e-12)


def test_cuda_backend_raises_without_kernel_path():
    _, tstate = _brusselator_states(33)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tpde.EulerSolver(tpde.PDE(BRUSSELATOR), backend="cuda").make_stepper(tstate, dt=0.01)
    with tpde.config({CORNER_KEY: 0.5}):
        solver = tpde.EulerSolver(tpde.CahnHilliardPDE(), backend="cuda")
        with pytest.raises(RuntimeError, match="cahn_hilliard.py:57-63"):
            solver.make_stepper(tstate[0], dt=1e-3)


def test_post_step_hook_keeps_plain_path():
    jstate, tstate = _brusselator_states(34)
    rhs = {"c": "laplace(c) - c**3"}
    jeq = jpde.PDE(rhs, post_step_hook=lambda c, t: c.clip(0.2, 0.8))
    teq = tpde.PDE(rhs, post_step_hook=lambda c, t: c.clip(0.2, 0.8))
    jres = jeq.solve(jstate[0], t_range=0.1, dt=0.01, tracker=None)
    tres = teq.solve(tstate[0], t_range=0.1, dt=0.01, tracker=None)
    assert "fused_step" not in teq.diagnostics["solver"]
    assert "post-step hook" in teq.diagnostics["solver"]["fused_unsupported"]
    np.testing.assert_allclose(tres.to_numpy(), np.asarray(jres.data), rtol=1e-12, atol=1e-12)


def test_float32_cahn_hilliard_matches_float64():
    """The fp32 window on the CPU, held against the fp64 one."""
    grid = tpde.UnitGrid([32, 32], periodic=True)
    state = tpde.ScalarField.random_uniform(grid, -0.1, 0.1, rng=np.random.default_rng(35))
    assert state.dtype == torch.float32
    eq = tpde.PDE({"c": "laplace(c**3 - c - laplace(c))"})
    result = eq.solve(state, t_range=0.2, dt=1e-3, tracker=None)
    ref = eq.solve(state.copy(dtype=torch.float64), t_range=0.2, dt=1e-3, tracker=None)
    assert result.dtype == torch.float32
    np.testing.assert_allclose(result.to_numpy(), ref.to_numpy(), rtol=1e-4, atol=1e-6)
