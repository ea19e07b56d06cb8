"""The whole slice: Euler diffusion in the port against ``pde_tpu`` (fp64,
CPU), and the engines' fused-window policy.

The JAX side runs with ``PDE_TPU_PALLAS_INTERPRET=1``, so it takes its fused
Pallas window in interpret mode; the port's fused window runs the kernel's
plain version on CPU tensors. Both must report ``info["fused_step"]``.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_cartesian as cc

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
GRIDS = {
    "periodic-32x128": ([32, 128], True),
    "noflux-32x32": ([32, 32], False),
}
CORNER_KEY = "operators.cartesian.laplacian_2d_corner_weight"


def _states(grid_id, seed):
    shape, periodic = GRIDS[grid_id]
    jgrid = jpde.UnitGrid(shape, periodic=periodic)
    jstate = jpde.ScalarField(jgrid, np.random.default_rng(seed).random(shape))
    tstate = tpde.field_from_state(
        jstate.attributes_serialized, np.asarray(jstate.data), device="cpu"
    )
    assert tstate.dtype == torch.float64
    return jstate, tstate


@pytest.mark.parametrize("steps", [1, 16, 37])
@pytest.mark.parametrize("grid_id", GRIDS)
def test_stepper_matches_jax(grid_id, steps, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jstate, tstate = _states(grid_id, seed=steps)
    jsolver = jpde.EulerSolver(jpde.DiffusionPDE(0.1), adaptive=False)
    jout, jt = jsolver.make_stepper(jstate, dt=0.1)(jstate, 0.0, 0.1 * steps)
    tsolver = tpde.EulerSolver(tpde.DiffusionPDE(0.1), adaptive=False)
    tout, tt = tsolver.make_stepper(tstate, dt=0.1)(tstate, 0.0, 0.1 * steps)
    assert jsolver.info.get("fused_step") is True
    assert tsolver.info.get("fused_step") is True
    assert tsolver.info["steps"] == jsolver.info["steps"] == steps
    assert tt == pytest.approx(jt)
    np.testing.assert_allclose(tout.to_numpy(), np.asarray(jout.data), **TOL)


@pytest.mark.parametrize("tracker", ["auto", None])
@pytest.mark.parametrize("grid_id", GRIDS)
def test_solve_matches_jax(grid_id, tracker, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jstate, tstate = _states(grid_id, seed=7)
    jeq, teq = jpde.DiffusionPDE(0.1), tpde.DiffusionPDE(0.1)
    jres = jeq.solve(jstate, t_range=3.7, dt=0.1, tracker=tracker)
    tres = teq.solve(tstate, t_range=3.7, dt=0.1, tracker=tracker)
    assert jeq.diagnostics["solver"]["fused_step"] is True
    assert teq.diagnostics["solver"]["fused_step"] is True
    assert teq.diagnostics["solver"]["steps"] == jeq.diagnostics["solver"]["steps"] == 37
    assert teq.diagnostics["controller"]["successful"]
    np.testing.assert_allclose(tres.to_numpy(), np.asarray(jres.data), **TOL)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_corner_weight_runs_plain_loop(backend):
    """The 9-point corner weight (B1(e)): on a periodic grid the 'torch'
    engine takes the 9-point window, the 'numpy' engine the plain loop; on a
    bounded grid, which the kernel refuses as pde_tpu's does, the plain loop
    under both. Each matches pde_tpu."""
    for grid_id in GRIDS:
        jstate, tstate = _states(grid_id, seed=3)
        with jpde.config({CORNER_KEY: 0.5}), tpde.config({CORNER_KEY: 0.5}):
            jres = jpde.DiffusionPDE(0.1).solve(jstate, t_range=1.0, dt=0.1, tracker=None)
            solver = tpde.EulerSolver(tpde.DiffusionPDE(0.1), backend=backend)
            tres, _ = solver.make_stepper(tstate, dt=0.1)(tstate, 0.0, 1.0)
        fused = backend == "torch" and grid_id.startswith("periodic")
        assert solver.info.get("fused_step") is (True if fused else None)
        if backend == "torch" and not fused:
            assert "841-849" in solver.info["fused_unsupported"]
        np.testing.assert_allclose(tres.to_numpy(), np.asarray(jres.data), **TOL)


def test_cuda_backend_rejects_unsupported_configuration():
    """The 9-point corner weight on a bounded grid has no kernel (pde_tpu's
    gate): backend='cuda' raises naming it."""
    _, tstate = _states("noflux-32x32", seed=4)
    with tpde.config({CORNER_KEY: 0.5}):
        solver = tpde.EulerSolver(tpde.DiffusionPDE(0.1), backend="cuda")
        with pytest.raises(RuntimeError, match="841-849"):
            solver.make_stepper(tstate, dt=0.1)


@pytest.mark.parametrize("backend", ["cuda", "pallas"])
def test_cuda_backend_rejects_cpu_state(backend):
    _, tstate = _states("noflux-32x32", seed=5)
    solver = tpde.EulerSolver(tpde.DiffusionPDE(0.1), backend=backend)
    with pytest.raises(RuntimeError, match="CUDA device"):
        solver.make_stepper(tstate, dt=0.1)


def test_kernel_is_not_launched_for_cpu_state():
    _, tstate = _states("periodic-32x128", seed=6)
    launches = cc.affine_laplace_2d.launches
    tpde.DiffusionPDE(0.1).solve(tstate, t_range=2.0, dt=0.1, tracker=None)
    assert cc.affine_laplace_2d.launches == launches


def test_float32_state_matches_float64_reference():
    """The default fp32 README flow on the CPU, held against fp64."""
    grid = tpde.UnitGrid([16, 16])
    state = tpde.ScalarField.random_uniform(grid, rng=np.random.default_rng(8))
    assert state.dtype == torch.float32
    result = tpde.DiffusionPDE(0.1).solve(state, t_range=2.0, dt=0.1, tracker=None)
    ref = tpde.DiffusionPDE(0.1).solve(
        state.copy(dtype=torch.float64), t_range=2.0, dt=0.1, tracker=None
    )
    assert result.dtype == torch.float32
    np.testing.assert_allclose(result.to_numpy(), ref.to_numpy(), rtol=1e-5, atol=1e-6)
    assert float(result.average) == pytest.approx(float(state.average), rel=1e-5)


def test_torch_generator_initial_state():
    grid = tpde.UnitGrid([8, 8], periodic=True)
    gen = torch.Generator().manual_seed(0)
    state = tpde.ScalarField.random_uniform(grid, 2, 3, dtype=torch.float64, rng=gen)
    assert state.dtype == torch.float64 and state.device.type == "cpu"
    assert 2 <= float(state.data.min()) and float(state.data.max()) < 3


def test_solver_errors():
    eq = tpde.DiffusionPDE(0.1)
    state = tpde.ScalarField(tpde.UnitGrid([8, 8], periodic=True))
    # no dt: adaptive stepping (ported), which the kernel-only engine refuses
    eq.solve(state, t_range=1.0, tracker=None)
    assert eq.diagnostics["solver"]["dt_adaptive"] is True
    with pytest.raises(RuntimeError, match="no adaptive-dt kernel path"):
        eq.solve(state, t_range=1.0, tracker=None, backend="cuda")
    with pytest.raises(ValueError, match="Unknown backend"):
        tpde.EulerSolver(eq, backend="tpu")
    noisy = tpde.DiffusionPDE(0.1, noise=0.5, rng=np.random.default_rng(0))
    assert noisy.is_sde and not eq.is_sde
    result = noisy.solve(state.copy(dtype=torch.float64), t_range=0.5, dt=0.1, tracker=None)
    assert noisy.diagnostics["solver"]["stochastic"] is True
    assert noisy.diagnostics["solver"]["fused_step"] is True
    assert float(result.fluctuations) > 0
    assert tpde.get_backend("auto").fused_windows == "auto"
    assert tpde.get_backend("pallas").name == "cuda"
    assert tpde.get_backend("numpy").fused_windows == "never"
