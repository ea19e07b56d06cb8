"""The whole slice: stochastic KPZ and the other additive-noise equations,
in the port against ``pde_tpu`` (fp64, CPU), and the routing of the noise.

Noise streams differ between the packages (torch's generators and Philox
against threefry), so the slice is compared where it is deterministic
(``noise=0``, to <= 1e-12), in distribution (variance growth within 6
standard errors), and, inside the port, fused window against plain loop on
the same staged stream (to rounding). The JAX side runs with
``PDE_TPU_PALLAS_INTERPRET=1`` where it takes a fused window.
"""

import math

import jax
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
    "periodic-16x16": ("UnitGrid", ([16, 16],), True),
    "noflux-ragged-20x34": ("CartesianGrid", ([(0, 10), (0, 17)], [20, 34]), False),
}


def _states(grid_id, seed=0, zero=False):
    cls, args, periodic = GRIDS[grid_id]
    jgrid = getattr(jpde, cls)(*args, periodic=periodic)
    data = np.zeros(jgrid.shape) if zero else np.random.default_rng(seed).uniform(-0.5, 0.5, jgrid.shape)
    jstate = jpde.ScalarField(jgrid, data)
    tstate = tpde.field_from_state(jstate.attributes_serialized, np.asarray(jstate.data))
    assert tstate.dtype == torch.float64
    return jstate, tstate


# -- deterministic part against pde_tpu -----------------------------------------------------
@pytest.mark.parametrize("grid_id", GRIDS)
@pytest.mark.parametrize(
    "make_eq",
    [lambda p: p.KPZInterfacePDE(nu=1.0, lmbda=1.0),
     lambda p: p.PDE({"c": "0.5 * laplace(c) + gradient_squared(c)"}, noise=0)],
    ids=["kpz", "expression"],
)
def test_noise_free_solve_matches_jax(make_eq, grid_id, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jstate, tstate = _states(grid_id, seed=1)
    jeq, teq = make_eq(jpde), make_eq(tpde)
    assert not teq.is_sde and not jeq.is_sde
    jres = jeq.solve(jstate, t_range=0.37, dt=0.01, tracker=None)
    tres = teq.solve(tstate, t_range=0.37, dt=0.01, tracker=None)
    assert jeq.diagnostics["solver"]["fused_step"] is True
    assert teq.diagnostics["solver"]["fused_step"] is True
    assert teq.diagnostics["solver"]["stochastic"] is False
    np.testing.assert_allclose(tres.to_numpy(), np.asarray(jres.data), **TOL)


def test_kpz_evolution_rate_matches_jax():
    jstate, tstate = _states("noflux-ragged-20x34", seed=2)
    jeq = jpde.KPZInterfacePDE(nu=0.7, lmbda=1.3, noise=0.2)
    teq = tpde.KPZInterfacePDE(nu=0.7, lmbda=1.3, noise=0.2)
    np.testing.assert_allclose(
        teq.evolution_rate(tstate).to_numpy(), np.asarray(jeq.evolution_rate(jstate).data), **TOL
    )
    assert teq.expression == jeq.expression
    assert teq.is_sde and jeq.is_sde


# -- in distribution against pde_tpu --------------------------------------------------------
@pytest.mark.parametrize("law", ["normal", "irwin4"])
def test_pure_noise_variance_matches_theory_in_both_packages(law):
    """``DiffusionPDE(0.0, noise=1.0)`` from zero: each cell is a sum of n
    independent increments of variance ``dt * noise / cell_volume``. The
    spatial variance over 64² cells must lie within 6 standard errors of
    ``n dt noise / cell_volume`` (relative standard error sqrt(2 / 4096)),
    the spatial mean within 6 standard errors of 0."""
    steps, dt, noise = 10, 0.01, 1.0
    grid_args = ([(0, 32), (0, 48)], [64, 64])
    jstate = jpde.ScalarField(jpde.CartesianGrid(*grid_args, periodic=True), 0.0)
    tstate = tpde.ScalarField(tpde.CartesianGrid(*grid_args, periodic=True), 0.0,
                              dtype=torch.float64)
    cell = 0.5 * 0.75
    target = steps * dt * noise / cell
    n = 64 * 64
    variances, means = [], []
    with jpde.config({"sde.increment_dist": law}), tpde.config({"sde.increment_dist": law}):
        jres = jpde.DiffusionPDE(0.0, noise=noise, rng=np.random.default_rng(3)).solve(
            jstate, t_range=steps * dt, dt=dt, tracker=None)
        teq = tpde.DiffusionPDE(0.0, noise=noise, rng=np.random.default_rng(3))
        tres = teq.solve(tstate, t_range=steps * dt, dt=dt, tracker=None)
    assert teq.diagnostics["solver"]["steps"] == steps
    for values in (np.asarray(jres.data), tres.to_numpy()):
        means.append(values.mean())
        variances.append(values.var())
    for mean, var in zip(means, variances, strict=True):
        assert abs(var - target) <= 6 * target * math.sqrt(2 / n), (var, target)
        assert abs(mean) <= 6 * math.sqrt(target / n), mean


def test_stochastic_kpz_roughens_in_both_packages(monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jstate, tstate = _states("periodic-16x16", zero=True)
    jres = jpde.KPZInterfacePDE(noise=0.2, rng=np.random.default_rng(7)).solve(
        jstate, t_range=0.05, dt=1e-3, tracker=None)
    teq = tpde.KPZInterfacePDE(noise=0.2, rng=np.random.default_rng(7))
    tres = teq.solve(tstate, t_range=0.05, dt=1e-3, tracker=None)
    assert teq.diagnostics["solver"]["fused_step"] is True
    assert teq.diagnostics["solver"]["stochastic"] is True
    assert float(jres.fluctuations) > 0 and float(tres.fluctuations) > 0
    assert np.isfinite(tres.to_numpy()).all()
    # both are rough at the same scale: the stationary KPZ width is far off at t = 0.05
    assert 0.5 < float(tres.fluctuations) / float(jres.fluctuations) < 2.0


def test_noise_scale_matches_jax_on_anisotropic_grid():
    """``|increment| = sqrt(dt) sqrt(var / cell_volume)`` under the two-point law."""
    grid_args = ([(0, 2), (0, 3)], [16, 24])
    jstate = jpde.ScalarField(jpde.CartesianGrid(*grid_args), 0.0)
    tstate = tpde.ScalarField(tpde.CartesianGrid(*grid_args), 0.0, dtype=torch.float64)
    dt = 1e-3
    with jpde.config({"sde.increment_dist": "rademacher"}), \
            tpde.config({"sde.increment_dist": "rademacher"}):
        jinc = jpde.KPZInterfacePDE(noise=0.3).make_sde_noise_step(jstate)(
            [jstate.data], 0.0, jax.random.key(0), dt)[0]
        tinc = tpde.KPZInterfacePDE(noise=0.3).make_sde_noise_step(tstate)(
            [tstate.data], 0.0, torch.Generator().manual_seed(0), dt)[0]
    expected = math.sqrt(dt * 0.3 / ((2 / 16) * (3 / 24)))
    np.testing.assert_allclose(np.unique(np.abs(np.asarray(jinc))), [expected], rtol=1e-15)
    np.testing.assert_allclose(np.unique(tinc.abs().numpy()), [expected], rtol=1e-15)


# -- fused against plain inside the port ----------------------------------------------------
FUSED_CASES = {
    "kpz-periodic-normal": ("periodic-16x16", lambda: tpde.KPZInterfacePDE(
        nu=1.0, lmbda=1.0, noise=0.1, rng=np.random.default_rng(1)), {}),
    "kpz-noflux-irwin4-staged": ("noflux-ragged-20x34", lambda: tpde.KPZInterfacePDE(
        noise=0.2, rng=np.random.default_rng(2)),
        {"sde.increment_dist": "irwin4", "sde.kernel_noise": "off"}),
    "diffusion-rademacher-staged": ("noflux-ragged-20x34", lambda: tpde.DiffusionPDE(
        0.1, noise=1.0, rng=np.random.default_rng(3)),
        {"sde.increment_dist": "rademacher", "sde.kernel_noise": "off"}),
    "expression-periodic-normal": ("periodic-16x16", lambda: tpde.PDE(
        {"c": "0.1 * laplace(c)"}, noise=0.5, rng=np.random.default_rng(4)), {}),
}


@pytest.mark.parametrize("tracker", [None, "auto"])
@pytest.mark.parametrize("case_id", FUSED_CASES)
def test_fused_window_matches_plain_loop(case_id, tracker):
    """The staged window's increments are the plain loop's, step for step
    and window for window (same solver seed): the trajectories agree to
    rounding, as ``pde_tpu`` asserts of itself."""
    grid_id, make_eq, cfg = FUSED_CASES[case_id]
    _, tstate = _states(grid_id, seed=5)
    results = {}
    with tpde.config(cfg):
        for backend in ("torch", "numpy"):
            eq = make_eq()
            results[backend] = eq.solve(tstate, t_range=0.05, dt=1e-3, tracker=tracker,
                                        backend=backend)
            info = eq.diagnostics["solver"]
            assert info["stochastic"] is True and info["steps"] == 50
            assert info.get("fused_step", False) is (backend == "torch")
    np.testing.assert_allclose(results["torch"].to_numpy(), results["numpy"].to_numpy(), **TOL)
    assert float(results["torch"].fluctuations) > 0


def test_stepper_windows_draw_fresh_seeds():
    """Each stepper call draws a new window seed: two windows differ, and a
    solver built from the same rng repeats them."""
    _, tstate = _states("periodic-16x16", zero=True)
    outs = []
    for _ in range(2):
        solver = tpde.EulerSolver(tpde.KPZInterfacePDE(noise=0.1, rng=np.random.default_rng(9)))
        stepper = solver.make_stepper(tstate, dt=1e-3)
        first, t = stepper(tstate, 0.0, 0.008)
        second, _ = stepper(tstate, t, t + 0.008)
        outs.append((first.to_numpy(), second.to_numpy()))
        assert solver.info["fused_step"] is True
    assert not np.allclose(outs[0][0], outs[0][1])
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


# -- routing --------------------------------------------------------------------------------
ROUTES = [
    ({}, "staged"),
    ({"sde.increment_dist": "irwin4"}, "irwin4"),
    ({"sde.increment_dist": "rademacher"}, "rademacher"),
    ({"sde.kernel_noise": "on"}, "normal"),
    ({"sde.kernel_noise": "off", "sde.increment_dist": "irwin4"}, "staged"),
    ({"sde.kernel_noise": "off", "sde.increment_dist": "rademacher"}, "staged"),
]


@pytest.mark.parametrize("cfg,noise", ROUTES, ids=[r[1] + str(i) for i, r in enumerate(ROUTES)])
def test_kernel_noise_routing_matches_jax(cfg, noise):
    """``_sde_kernel_noise_spec`` as ``pde_tpu`` routes it (without its TPU
    opt-in), and the window each route builds."""
    jgrid = jpde.UnitGrid([256, 256], periodic=True)
    tgrid = tpde.UnitGrid([256, 256], periodic=True)
    with jpde.config(cfg), tpde.config(cfg):
        jspec = jpde.PDE({"c": "laplace(c)"}, noise=0.5)._sde_kernel_noise_spec(jgrid, 1e-4, False)
        tspec = tpde.PDE({"c": "laplace(c)"}, noise=0.5)._sde_kernel_noise_spec(tgrid, 1e-4)
        assert tspec == jspec
        _, tstate = _states("periodic-16x16")
        window = tpde.KPZInterfacePDE(noise=0.5).make_fused_euler_window(tstate, 1e-4)
    assert window.program.noise == noise
    library = "sde_stencil_2d" if noise == "staged" else "sde_kernel_noise_2d"
    assert window.program.library == library
    if noise != "staged":
        assert all(spec.scale == pytest.approx(math.sqrt(1e-4 * 0.5)) for spec in window.specs)


def test_unknown_kernel_noise_mode_raises():
    with tpde.config({"sde.kernel_noise": "sometimes"}), pytest.raises(ValueError, match="sometimes"):
        tpde.PDE({"c": "laplace(c)"}, noise=0.5)._sde_kernel_noise_spec(tpde.UnitGrid([8, 8]), 1e-3)


def test_adaptive_stepping_with_noise_raises_in_both_packages():
    jstate, tstate = _states("periodic-16x16")
    with pytest.raises(RuntimeError, match="adaptive stepping with stochastic"):
        jpde.EulerSolver(jpde.KPZInterfacePDE(noise=0.1), adaptive=True).make_stepper(jstate)
    with pytest.raises(RuntimeError, match="adaptive stepping with stochastic"):
        tpde.EulerSolver(tpde.KPZInterfacePDE(noise=0.1), adaptive=True)
    with pytest.raises(RuntimeError, match="adaptive stepping with stochastic"):
        tpde.KPZInterfacePDE(noise=0.1).solve(tstate, t_range=0.1, tracker=None)


UNSUPPORTED = {
    "stratonovich": (lambda: tpde.PDE({"c": "laplace(c)"}, noise=0.1,
                                      noise_interpretation="stratonovich",
                                      rng=np.random.default_rng(0)), 1, "Itô"),
    "noise-array": (lambda: tpde.PDE({"c": "laplace(c)"}, noise={"c": 0.1},
                                     rng=np.random.default_rng(0)), 1, "scalar noise"),
    "two-fields": (lambda: tpde.PDE({"u": "laplace(u) - v", "v": "laplace(v)"}, noise=0.1,
                                    rng=np.random.default_rng(0)), 2, "one field"),
}


@pytest.mark.parametrize("case_id", UNSUPPORTED)
def test_unsupported_noise_falls_back_under_torch_and_raises_under_cuda(case_id):
    make_eq, n_fields, reason = UNSUPPORTED[case_id]
    _, field = _states("periodic-16x16", seed=6)
    state = field if n_fields == 1 else tpde.FieldCollection(
        [field, field.copy()], labels=["u", "v"])
    solver = tpde.EulerSolver(make_eq())
    fused, _ = solver.make_stepper(state, dt=1e-3)(state, 0.0, 0.01)
    assert "fused_step" not in solver.info and reason in solver.info["fused_unsupported"]
    plain, _ = tpde.EulerSolver(make_eq(), backend="numpy").make_stepper(state, dt=1e-3)(
        state, 0.0, 0.01)
    np.testing.assert_array_equal(fused.to_numpy(), plain.to_numpy())
    assert solver.info["stochastic"] is True
    with pytest.raises(RuntimeError, match=reason):
        tpde.EulerSolver(make_eq(), backend="cuda").make_stepper(state, dt=1e-3)


def test_cuda_backend_rejects_cpu_state_for_sde():
    _, tstate = _states("periodic-16x16")
    solver = tpde.EulerSolver(tpde.KPZInterfacePDE(noise=0.1), backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        solver.make_stepper(tstate, dt=1e-3)


def test_fluctuations_match_jax():
    jstate, tstate = _states("noflux-ragged-20x34", seed=8)
    assert float(tstate.fluctuations) == pytest.approx(float(jstate.fluctuations), rel=1e-12)
    assert float(tpde.ScalarField(tstate.grid, 2.0, dtype=torch.float64).fluctuations) == 0.0


def test_noise_realization_term_matches_jax():
    """A model with its own noise realization (here a constant forcing) is an
    SDE; it takes the plain loop in both packages, which add ``sqrt(dt)``
    times the realization at every step."""
    import jax.numpy as jnp

    class JaxForced(jpde.KPZInterfacePDE):
        use_noise_realization = True

        def make_noise_realization(self, state, backend="jax"):
            return lambda leaves, t, key: [jnp.full_like(x, 0.3) for x in leaves]

    class TorchForced(tpde.KPZInterfacePDE):
        use_noise_realization = True

        def make_noise_realization(self, state):
            return lambda leaves, t, generator: [torch.full_like(x, 0.3) for x in leaves]

    jstate, tstate = _states("periodic-16x16", seed=9)
    jres = JaxForced(noise=0).solve(jstate, t_range=0.05, dt=1e-3, tracker=None)
    teq = TorchForced(noise=0)
    tres = teq.solve(tstate, t_range=0.05, dt=1e-3, tracker=None)
    assert teq.is_sde and "Itô" in teq.diagnostics["solver"]["fused_unsupported"]
    np.testing.assert_allclose(tres.to_numpy(), np.asarray(jres.data), **TOL)
