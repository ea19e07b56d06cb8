"""The Milstein solver and the rest of the noise (ROADMAP A7).

The port's Milstein step is held against ``pde_tpu``'s on the same normal
increments (``jax.random.normal`` replaced by the numbers the port's
generator draws), for multiplicative noise in the three interpretations,
additive noise and a collection, at 1e-12 in fp64; its fused path, the Euler
window of additive noise, against its own loop at 1e-12; the interpretations'
order and one step's moments against ``pde_tpu``'s within 6 standard errors;
decomposed runs bit-equal to serial ones ([2, 2], and radial blocks, whose
noise takes each cell's own volume). ``make_correlated_noise_torch`` against
``pde_tpu``'s scaling and transform on the same normals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers.milstein import MilsteinSolver as JaxMilstein
from pde_tpu.utils.spectral import make_correlated_noise_jax
from pde_tpu_torch.utils.spectral import make_correlated_noise_torch

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64
INTERPRETATIONS = ["ito", "stratonovich", "anti-ito"]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _multiplicative(pkg):
    """``pde_tpu``'s test model: diffusion with variance ``noise (1 + c²)``."""

    class MultiplicativeDiffusion(pkg.DiffusionPDE):
        def make_noise_variance(self, state, *, ret_diff=False):
            base = super().make_noise_variance(state, ret_diff=False)

            def var_fn(leaves, t):
                return [v * (1 + y**2) for v, y in zip(base(leaves, t), leaves, strict=True)]

            if not ret_diff:
                return var_fn

            def var_diff_fn(leaves, t):
                return var_fn(leaves, t), [v * 2 * y for v, y in
                                           zip(base(leaves, t), leaves, strict=True)]

            return var_diff_fn

    return MultiplicativeDiffusion


def _squared(pkg):
    """``pde_tpu``'s ``MultiplicativeNoisePDE``: variance c², derivative 2c."""

    class SquaredNoise(pkg.models.base.SDEBase):
        def __init__(self, noise_interpretation="ito"):
            super().__init__(noise=1.0, noise_interpretation=noise_interpretation)

        def evolution_rate(self, state, t=0.0):
            return state.laplace(bc="auto_periodic_neumann", args={"t": t})

        def make_noise_variance(self, state, *, ret_diff=False):
            def noise_var_diff(leaves, t):
                return [y * y for y in leaves], [2 * y for y in leaves]

            return noise_var_diff if ret_diff else (lambda leaves, t: [y * y for y in leaves])

    return SquaredNoise


def _interpreted(make, interpretation):
    eq = make()
    eq.noise_interpretation = interpretation
    return eq


# id: (make the model in one package, grid args, periodic, collection)
STEP_CASES = {
    **{f"multiplicative-{i}": (lambda p, i=i: _interpreted(
        lambda: _multiplicative(p)(0.1, noise=0.1), i), [12, 10], True, False)
       for i in INTERPRETATIONS},
    "squared-1d": (lambda p: _squared(p)(), [16], True, False),
    "squared-stratonovich-bounded": (lambda p: _squared(p)("stratonovich"), [10, 8], False,
                                     False),
    "additive-kpz": (lambda p: p.KPZInterfacePDE(noise=0.3), [12, 10], False, False),
    "additive-collection": (lambda p: p.PDE({"a": "laplace(a) - b", "b": "0.5 * laplace(b)"},
                                            noise=[0.1, 0.2]), [8, 8], True, True),
}


def _states(grid_args, periodic, collection, seed=0):
    rng = np.random.default_rng(seed)
    jgrid = jpde.UnitGrid(grid_args, periodic=periodic)
    tgrid = tpde.UnitGrid(grid_args, periodic=periodic)
    datas = [rng.uniform(-1, 1, tuple(grid_args)) for _ in range(2 if collection else 1)]
    jfields = [jpde.ScalarField(jgrid, d) for d in datas]
    tfields = [tpde.ScalarField(tgrid, d, dtype=F64) for d in datas]
    if collection:
        return jpde.FieldCollection(jfields), tpde.FieldCollection(tfields)
    return jfields[0], tfields[0]


def _leaves(state):
    return [f.data for f in state] if isinstance(state, (jpde.FieldCollection,
                                                         tpde.FieldCollection)) else [state.data]


@pytest.mark.parametrize("case", STEP_CASES)
def test_milstein_step_matches_jax_on_the_same_increments(case, monkeypatch):
    make, grid_args, periodic, collection = STEP_CASES[case]
    jstate, tstate = _states(grid_args, periodic, collection)
    dt = 1e-3
    jstep = JaxMilstein(make(jpde))._make_single_step_fixed_dt(jstate, dt)
    tstep = tpde.MilsteinSolver(make(tpde))._make_single_step_fixed_dt(tstate, dt)
    # the normals the port draws: one tensor per leaf, in leaf order
    replay = torch.Generator().manual_seed(9)
    normals = [torch.empty_like(x).normal_(generator=replay).numpy() for x in _leaves(tstate)]
    drawn = iter(normals)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(
        next(drawn), dtype=dtype))
    for t in (0.0, 0.25):
        drawn = iter(normals)
        jout = jstep([jnp.asarray(x) for x in _leaves(jstate)], t, jax.random.key(0))
        tout = tstep(_leaves(tstate), t, torch.Generator().manual_seed(9))
        for a, b in zip(jout, tout, strict=True):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("grid_id", ["periodic", "bounded"])
def test_milstein_equals_euler_at_zero_noise(grid_id):
    grid = tpde.UnitGrid([12, 10], periodic=grid_id == "periodic")
    state = tpde.ScalarField(grid, np.random.default_rng(1).uniform(0, 1, (12, 10)), dtype=F64)
    for backend in ("torch", "numpy"):
        runs = [tpde.KPZInterfacePDE(noise=0).solve(state, t_range=0.02, dt=1e-3, tracker=None,
                                                    solver=solver, backend=backend)
                for solver in ("euler", "milstein")]
        assert torch.equal(runs[0].data, runs[1].data)


def test_fused_milstein_additive_exact_and_gating():
    """pde_tpu's test of that name: Milstein's fused path is the Euler window,
    equal to its plain loop for additive noise (its correction is zero there,
    and the window stages the loop's increments); state-dependent variance
    keeps the plain loop, whose correction the window would drop."""
    grid = tpde.UnitGrid([16, 16], periodic=True)
    state = tpde.ScalarField(grid, np.random.default_rng(2).uniform(0, 1, (16, 16)), dtype=F64)

    def solve(eq, backend):
        solver = tpde.MilsteinSolver(eq, backend=backend)
        out, _ = solver.make_stepper(state, dt=1e-3)(state, 0.0, 0.01)
        return out, solver.info

    fused, info = solve(tpde.DiffusionPDE(0.1, noise=0.1, rng=np.random.default_rng(5)), "torch")
    plain, _ = solve(tpde.DiffusionPDE(0.1, noise=0.1, rng=np.random.default_rng(5)), "numpy")
    assert info.get("fused_step") is True
    np.testing.assert_allclose(fused.data.numpy(), plain.data.numpy(), rtol=1e-12, atol=1e-13)
    eq = _multiplicative(tpde)(0.1, noise=0.1, rng=np.random.default_rng(5))
    out, info = solve(eq, "torch")
    assert info.get("fused_step") is None and "additive" in info["fused_unsupported"]
    assert torch.isfinite(out.data).all()
    with pytest.raises(RuntimeError, match="additive scalar noise"):
        solve(eq, "cuda")


@pytest.mark.parametrize("solver", ["euler", "milstein"])
def test_multiplicative_noise_interpretations(solver):
    """pde_tpu's test of that name: the drift term shifts the mean, Itô <
    Stratonovich < anti-Itô, in both packages."""
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([16], periodic=True)
        state = pkg.ScalarField(grid, 1.0) if pkg is jpde else pkg.ScalarField(grid, 1.0,
                                                                                dtype=F64)
        results = {}
        for interpretation in INTERPRETATIONS:
            eq = _squared(pkg)(interpretation)
            eq.rng = np.random.default_rng(42)
            res = eq.solve(state, t_range=0.2, dt=1e-3, tracker=None, solver=solver)
            assert np.isfinite(np.asarray(res.data) if pkg is jpde else res.data.numpy()).all()
            results[interpretation] = float(res.average)
        assert results["ito"] < results["stratonovich"] < results["anti-ito"], (pkg, results)


@pytest.mark.parametrize("interpretation", INTERPRETATIONS)
def test_one_step_moments_match_jax(interpretation):
    """The mean and variance of one Milstein step's increment over 64² cells
    of a uniform state, the port's stream against pde_tpu's: within 6
    standard errors."""
    n, dt = 64, 1e-2
    moments = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([n, n], periodic=True)
        state = pkg.ScalarField(grid, 0.8) if pkg is jpde else pkg.ScalarField(grid, 0.8,
                                                                                dtype=F64)
        eq = _interpreted(lambda p=pkg: _multiplicative(p)(0.1, noise=0.5), interpretation)
        solver = (JaxMilstein if pkg is jpde else tpde.MilsteinSolver)(eq)
        step = solver._make_single_step_fixed_dt(state, dt)
        if pkg is jpde:
            (out,) = step([state.data], 0.0, jax.random.key(3))
            inc = np.asarray(out) - 0.8
        else:
            (out,) = step([state.data], 0.0, torch.Generator().manual_seed(3))
            inc = out.numpy() - 0.8
        moments.append((inc.mean(), inc.var(), inc.size))
    (m_j, v_j, size), (m_t, v_t, _) = moments
    assert abs(m_t - m_j) < 6 * np.sqrt(2 * v_j / size)
    assert abs(v_t - v_j) < 6 * v_j * np.sqrt(2 / (size - 1)) * np.sqrt(2)


@pytest.mark.parametrize("case", ["multiplicative", "additive"])
def test_milstein_on_a_mesh_equals_serial(case):
    """[2, 2] through the plain sharded stepper: each block's rates on its
    halo-extended view, the noise terms on the combined leaves; bit-equal to
    the serial run on the same stream."""
    grid = tpde.UnitGrid([16, 12], periodic=[True, False])
    state = tpde.ScalarField(grid, np.random.default_rng(6).uniform(0, 1, (16, 12)), dtype=F64)

    def make():
        if case == "additive":
            return tpde.KPZInterfacePDE(noise=0.1, rng=np.random.default_rng(7))
        return _interpreted(lambda: _multiplicative(tpde)(0.1, noise=0.1,
                                                           rng=np.random.default_rng(7)),
                            "stratonovich")

    runs = []
    for kwargs in ({}, {"decomposition": [2, 2]}):
        res, info = make().solve(state, t_range=0.01, dt=1e-3, tracker=None, solver="milstein",
                                 backend="numpy" if not kwargs else "torch", ret_info=True,
                                 **kwargs)
        runs.append(res.data)
    assert info["solver"]["decomposition"] == [2, 2] and "fused_step" not in info["solver"]
    assert torch.equal(runs[0], runs[1])


def test_milstein_radial_noise_scaling():
    """pde_tpu's test of that name: on PolarSymGrid(1, 64) with
    decomposition=[4], every block's noise takes its own cells' volumes; the
    port's decomposed runs equal the serial ones, so the noise profile is the
    serial one."""
    grid = tpde.PolarSymGrid(1.0, 64)
    field = tpde.ScalarField(grid, np.zeros(64), dtype=F64)
    eq = tpde.DiffusionPDE(0.0, noise=1e-4)

    def profile(decomposition):
        outs = []
        for seed in (1, 2, 3, 4):
            eq.rng = np.random.default_rng(seed)
            solver = tpde.MilsteinSolver(eq, decomposition=decomposition)
            res = tpde.Controller(solver, t_range=0.01, tracker=None).run(field, 1e-4)
            outs.append(res.data.numpy())
        return np.stack(outs)

    serial, decomposed = profile(None), profile([4])
    np.testing.assert_array_equal(decomposed, serial)
    ratio = np.std(decomposed, axis=0).reshape(4, 16).mean(axis=1) / \
        np.std(serial, axis=0).reshape(4, 16).mean(axis=1)
    assert np.all(ratio < 2.0) and np.all(ratio > 0.5)
    # inner cells (small volume) are noisier
    std = np.std(serial, axis=0)
    assert std[:8].mean() > std[-8:].mean()


def test_milstein_requires_noise_variance_and_is_registered():
    class Realized(tpde.DiffusionPDE):
        use_noise_variance = False
        use_noise_realization = True

    with pytest.raises(RuntimeError, match="use_noise_variance"):
        tpde.MilsteinSolver(Realized(0.1))
    assert "milstein" in tpde.registered_solvers()
    solver = tpde.SolverBase.from_name("milstein", pde=tpde.DiffusionPDE(0.1, noise=0.1))
    assert type(solver) is tpde.MilsteinSolver
    with pytest.raises(RuntimeError, match="adaptive"):
        tpde.MilsteinSolver(tpde.DiffusionPDE(0.1, noise=0.1), adaptive=True)


# -- correlated noise inside SDE steps -------------------------------------------------------------
CORRELATIONS = {
    "none": {},
    "gaussian": {"length_scale": 2.0},
    "power law": {"exponent": -2},
    "cosine": {"length_scale": 0.3, "sharpness": 4},
}


@pytest.mark.parametrize("correlation", CORRELATIONS)
@pytest.mark.parametrize("shape, dx", [((16, 12), (1.0, 0.5)), ((32,), 0.25)])
def test_correlated_noise_matches_jax_on_the_same_normals(correlation, shape, dx, monkeypatch):
    """``make_correlated_noise_torch`` against ``make_correlated_noise_jax``:
    the same scaling and inverse transform of the same two normal fields."""
    kwargs = CORRELATIONS[correlation]
    noise = make_correlated_noise_torch(shape, correlation, discretization=dx, **kwargs)
    got = noise(torch.Generator().manual_seed(4))
    assert got.shape == shape and got.dtype == F64
    replay = torch.Generator().manual_seed(4)
    normals = iter([torch.randn(shape, generator=replay, dtype=F64).numpy() for _ in range(2)])
    monkeypatch.setattr(jax.random, "normal", lambda key, shape_, dtype=None: jnp.asarray(
        next(normals)))
    expected = make_correlated_noise_jax(shape, correlation, discretization=dx,
                                         **kwargs)(jax.random.key(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_custom_noise_example_in_the_port():
    """``examples/custom_noise.py``'s model against the port: diffusion driven
    by a correlated realization, drawn from the solver's generator on the
    state's device; the realization's spectrum follows the target's."""

    class CorrelatedNoiseDiffusion(tpde.DiffusionPDE):
        use_noise_variance = False
        use_noise_realization = True

        def make_noise_realization(self, state, backend="torch"):
            noise_fn = make_correlated_noise_torch(
                tuple(state.data.shape), correlation="gaussian",
                discretization=state.grid.discretization, length_scale=2.0,
                dtype=state.data.dtype)
            amplitude = float(np.sqrt(self.noise))
            return lambda leaves, t, generator: [amplitude * noise_fn(generator) for _ in leaves]

    grid = tpde.UnitGrid([32, 32], periodic=True)
    state = tpde.ScalarField(grid, 0.0, dtype=F64)
    eq = CorrelatedNoiseDiffusion(0.1, noise=0.1, rng=np.random.default_rng(0))
    result, info = eq.solve(state, t_range=0.05, dt=1e-3, tracker=None, ret_info=True)
    assert info["solver"]["stochastic"] and "fused_step" not in info["solver"]
    assert torch.isfinite(result.data).all() and float(result.fluctuations) > 0
    # many draws of the realization: their mean power per mode against the target's
    noise_fn = make_correlated_noise_torch((32, 32), "gaussian", length_scale=2.0)
    generator = torch.Generator().manual_seed(1)
    power = torch.stack([torch.fft.fftn(noise_fn(generator)).abs() ** 2
                         for _ in range(200)]).mean(0).numpy()
    k2 = np.add.outer(np.fft.fftfreq(32) ** 2, np.fft.fftfreq(32) ** 2)
    target = np.exp(-0.5 * 2.0**2 * k2)  # the Gaussian's power spectrum, length scale 2
    target[0, 0] = 0
    target *= power.sum() / target.sum()
    strong = target > 0.05 * target.max()
    # 200 draws of a mode's power (exponential law): about 7 % relative scatter
    np.testing.assert_allclose(power[strong], target[strong], rtol=0.4)
