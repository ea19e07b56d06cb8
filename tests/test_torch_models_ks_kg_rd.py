"""The last three predefined models and 1D grids against ``pde_tpu`` on the CPU in fp64.

``KuramotoSivashinskyPDE``, ``KleinGordonPDE`` and ``ReactionDiffusionPDE``:
evolution rates and 20-step Euler solves at 1e-12 of max|f| (KS through the
plain versions of its generated kernel #7 window; KG and RD plain torch, as
``pde_tpu``'s are plain XLA); KS's generated #7 program replayed in the
kernel's own march against its plain version (the harness of Cahn-Hilliard's
tests); noisy KS through the Euler-Maruyama windows (#10 staged, equal to the
plain loop on the same stream; #9's in-kernel law); KS under ETDRK4; and 1D
diffusion and KS. Inputs from ``default_rng`` on 8²-32² grids and 64 cells.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_stencil_2d as cs

torch.set_num_threads(1)
F64 = torch.float64
EXACT = dict(rtol=0, atol=0)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


def _close(got, expected):
    expected = np.asarray(getattr(expected, "data", expected))
    got = getattr(got, "data", got).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-12 * np.abs(expected).max())


GRIDS = {
    "periodic 16x12": lambda pkg: pkg.UnitGrid([16, 12], periodic=True),
    "no-flux 10x14": lambda pkg: pkg.CartesianGrid([(0, 5), (0, 7)], [10, 14]),
    "1D 64": lambda pkg: pkg.CartesianGrid([(0, 32)], [64], periodic=True),
}


def _scalar(pkg, grid_id, seed=0, amplitude=0.5):
    grid = GRIDS[grid_id](pkg)
    data = np.random.default_rng(seed).uniform(-amplitude, amplitude, grid.shape)
    return pkg.ScalarField(grid, data) if pkg is jpde else pkg.ScalarField(grid, data, dtype=F64)


def _pair_state(grid_id, n_fields, seed=0):
    states = []
    for pkg in (jpde, tpde):
        fields = [_scalar(pkg, grid_id, seed + i) + 1.0 for i in range(n_fields)]
        states.append(pkg.FieldCollection(fields, labels=["u", "v", "w"][:n_fields]))
    return states


MODELS = {
    "ks": (lambda pkg: pkg.KuramotoSivashinskyPDE(nu=1.0), 1),
    "ks nu 0.5 dirichlet": (lambda pkg: pkg.KuramotoSivashinskyPDE(
        nu=0.5, bc={"value": 0.1}), 1),
    "ks bc_lap": (lambda pkg: pkg.KuramotoSivashinskyPDE(
        bc={"derivative": 0}, bc_lap={"value": 0.0}), 1),
    "klein-gordon": (lambda pkg: pkg.KleinGordonPDE(speed=1.5, mass=0.7), 2),
    "klein-gordon dirichlet": (lambda pkg: pkg.KleinGordonPDE(bc={"value": 0.2}), 2),
    "brusselator": (lambda pkg: pkg.ReactionDiffusionPDE(
        ["u", "v"], [1.0, 0.1], ["1 - (3 + 1) * u + u**2 * v", "3 * u - u**2 * v"]), 2),
    "rd dict bc_ops t": (lambda pkg: pkg.ReactionDiffusionPDE(
        ["u", "v", "w"], 0.2, {"u": "sin(t) * v", "w": "u * v - w"},
        bc={"derivative": 0.1}, bc_ops={"v": {"value": 0.5}}), 3),
}


def _model_states(model_id, grid_id):
    make, n_fields = MODELS[model_id]
    if n_fields == 1:
        return [_scalar(pkg, grid_id, 1) for pkg in (jpde, tpde)]
    return _pair_state(grid_id, n_fields, 2)


def _cases(model_ids):
    """(model, grid) pairs: conditions that name side values need a bounded grid."""
    return [(m, g) for m in model_ids for g in GRIDS
            if not ("dirichlet" in m or "bc" in m) or g == "no-flux 10x14"]


@pytest.mark.parametrize("model_id,grid_id", _cases(MODELS))
def test_evolution_rate_matches_jax(model_id, grid_id):
    make, _ = MODELS[model_id]
    jstate, tstate = _model_states(model_id, grid_id)
    expected = make(jpde).evolution_rate(jstate, t=0.3)
    got = make(tpde).evolution_rate(tstate, t=0.3)
    if isinstance(got, tpde.FieldCollection):
        for g, e in zip(got, expected, strict=True):
            _close(g, e)
    else:
        _close(got, expected)


@pytest.mark.parametrize("model_id,grid_id", _cases(
    ["ks", "ks nu 0.5 dirichlet", "ks bc_lap", "klein-gordon", "brusselator",
     "rd dict bc_ops t"]))
def test_euler_solves_match_jax(model_id, grid_id):
    """Twenty Euler steps; KS takes its #7 window (the kernel's plain version on
    the CPU) where the conditions allow it, the others the plain loop."""
    make, _ = MODELS[model_id]
    jstate, tstate = _model_states(model_id, grid_id)
    dt = 1e-3 if model_id.startswith("ks") else 1e-2
    expected = make(jpde).solve(jstate, t_range=20 * dt, dt=dt, tracker=None)
    eq = make(tpde)
    got = eq.solve(tstate, t_range=20 * dt, dt=dt, tracker=None)
    info = eq.diagnostics["solver"]
    assert info["steps"] == 20
    fused = model_id in ("ks", "ks nu 0.5 dirichlet") and grid_id != "1D 64"
    assert info.get("fused_step", False) is fused, info.get("fused_unsupported")
    if isinstance(got, tpde.FieldCollection):
        for g, e in zip(got, expected, strict=True):
            _close(g, e)
    else:
        _close(got, expected)


def test_ks_bc_lap_refusals_match_jax():
    """Both routes need ``bc_lap == bc``, as in ``pde_tpu``; the solve then
    takes the plain loop (ETDRK4 raises)."""
    _, tstate = _model_states("ks", "no-flux 10x14")
    eq = tpde.KuramotoSivashinskyPDE(bc={"derivative": 0}, bc_lap={"value": 0.0})
    for call in (lambda: eq.make_fused_euler_window(tstate, 1e-3),
                 lambda: eq.make_etdrk_parts(tstate),
                 lambda: eq.make_fused_rk4_window(tstate, 1e-3)):
        with pytest.raises(NotImplementedError, match="bc_lap == bc"):
            call()
    with pytest.raises(NotImplementedError, match="bc_lap == bc"):
        jpde.KuramotoSivashinskyPDE(bc={"derivative": 0}, bc_lap={"value": 0.0})._fused_rhs()


# -- KS's generated #7 program, replayed ---------------------------------------------------------
PLANS = ((5, 7), (8, 3), None)


@pytest.mark.parametrize("grid_id", ["periodic 16x12", "no-flux 10x14"])
def test_ks_program_replay_matches_plain(grid_id):
    """The kernel's own march (strips, chunks, rings of rows) over KS's two-deep
    program equals its plain version bit for bit at every k of its ladder."""
    _, tstate = _model_states("ks", grid_id)
    window = tpde.KuramotoSivashinskyPDE().make_fused_euler_window(tstate, 1e-3)
    program, specs = window.program, window.specs
    assert [spec.k for spec in specs] == program.ladder
    assert program.ladder[0] == cs.TOP_HALO // 2  # two-deep: as Cahn-Hilliard's
    datas = [tstate.data]
    for spec in specs:
        expected = cs.multi_stencil_2d_plain(datas, spec)
        for plan in PLANS:
            for g, e in zip(cs.multi_stencil_2d_marched(datas, spec, plan=plan), expected,
                            strict=True):
                torch.testing.assert_close(g, e, **EXACT)


# -- noisy KS through the Euler-Maruyama windows --------------------------------------------------
@pytest.mark.parametrize("cfg,library", [
    ({}, "sde_stencil_2d"),
    ({"sde.increment_dist": "irwin4"}, "sde_kernel_noise_2d"),
    ({"sde.kernel_noise": "on"}, "sde_kernel_noise_2d"),
])
def test_noisy_ks_takes_the_sde_windows(cfg, library):
    _, tstate = _model_states("ks", "periodic 16x12")
    with tpde.config(cfg):
        window = tpde.KuramotoSivashinskyPDE(noise=0.1).make_fused_euler_window(tstate, 1e-3)
        assert window.needs_key and window.program.library == library
        eq = tpde.KuramotoSivashinskyPDE(noise=0.1, rng=np.random.default_rng(3))
        result = eq.solve(tstate, t_range=0.02, dt=1e-3, tracker=None)
    assert eq.diagnostics["solver"]["fused_step"] is True
    assert np.isfinite(result.to_numpy()).all()
    assert not np.allclose(result.to_numpy(), tstate.to_numpy())


@pytest.mark.parametrize("grid_id", ["periodic 16x12", "no-flux 10x14"])
def test_noisy_ks_staged_window_matches_plain_loop(grid_id):
    """#10's window draws the plain loop's increments (same solver seed), so the
    trajectories agree to rounding."""
    _, tstate = _model_states("ks", grid_id)
    results = {}
    for backend in ("torch", "numpy"):
        eq = tpde.KuramotoSivashinskyPDE(noise=0.1, rng=np.random.default_rng(4))
        results[backend] = eq.solve(tstate, t_range=0.02, dt=1e-3, tracker=None,
                                    backend=backend)
        assert eq.diagnostics["solver"].get("fused_step", False) is (backend == "torch")
    _close(results["torch"], results["numpy"].to_numpy())


def test_noisy_ks_matches_jax_noise_free_and_in_distribution():
    """noise = 0 is deterministic KS; with noise both packages roughen the
    state by the same variance per step (their streams differ)."""
    jstate, tstate = _model_states("ks", "periodic 16x12")
    zero = [pkg.KuramotoSivashinskyPDE(noise=0.0).solve(s, t_range=0.01, dt=1e-3, tracker=None)
            for pkg, s in ((jpde, jstate), (tpde, tstate))]
    _close(zero[1], zero[0])
    grid = tpde.UnitGrid([32, 32], periodic=True)
    flat = tpde.ScalarField(grid, 0.0, dtype=F64)
    eq = tpde.KuramotoSivashinskyPDE(nu=0.0, noise=1.0, rng=np.random.default_rng(5))
    # with nu = 0 and a flat start the first step is pure noise: variance dt / cell volume
    out = eq.solve(flat, t_range=1e-3, dt=1e-3, tracker=None)
    var = float(out.data.var())
    assert abs(var - 1e-3) < 6 * 1e-3 * np.sqrt(2 / grid.num_cells)


# -- KS under ETDRK4 -----------------------------------------------------------------------------
@pytest.mark.parametrize("bc", ["periodic", {"derivative": 0}])
def test_ks_etdrk4_equals_the_expression_pde(bc):
    """``make_etdrk_parts`` goes through the expression compiler: its ETDRK4 run
    equals the expression PDE's, bit for bit, and ``pde_tpu``'s at 1e-12."""
    grid_id = "periodic 16x12" if bc == "periodic" else "no-flux 10x14"
    jstate, tstate = _model_states("ks", grid_id)
    eq = tpde.KuramotoSivashinskyPDE(bc=bc)
    rhs = "-1.0 * laplace(laplace(c)) - laplace(c) - 0.5 * gradient_squared(c)"
    got = eq.solve(tstate, t_range=0.1, dt=0.01, solver="etdrk4", tracker=None)
    same = tpde.PDE({"c": rhs}, bc=bc).solve(tstate, t_range=0.1, dt=0.01, solver="etdrk4",
                                              tracker=None)
    torch.testing.assert_close(got.data, same.data, **EXACT)
    expected = jpde.KuramotoSivashinskyPDE(bc=bc).solve(jstate, t_range=0.1, dt=0.01,
                                                        solver="etdrk4", tracker=None)
    _close(got, expected)


# -- Klein-Gordon and reaction-diffusion specifics ------------------------------------------------
def test_klein_gordon_initial_condition_and_expressions():
    for pkg in (jpde, tpde):
        eq = pkg.KleinGordonPDE(speed=2.0, mass=0.5)
        u = _scalar(pkg, "periodic 16x12", 6)
        state = eq.get_initial_condition(u)
        assert state.labels == ["u", "v"] and float(abs(state[1].data).max()) == 0
    assert tpde.KleinGordonPDE(2.0, 0.5).expressions == jpde.KleinGordonPDE(2.0, 0.5).expressions
    rd = [pkg.ReactionDiffusionPDE(["u", "v"], [1, 0.1], ["u - v", "v**2"])
          for pkg in (jpde, tpde)]
    assert rd[1].expressions == rd[0].expressions
    assert tpde.KuramotoSivashinskyPDE(0.5).expression == jpde.KuramotoSivashinskyPDE(
        0.5).expression


def test_reaction_diffusion_post_step_hook_matches_jax():
    """The user's hook ``(leaves, t, data) -> (leaves, data)`` after every step."""
    jstate, tstate = _pair_state("no-flux 10x14", 2, 7)

    def hook(leaves, t, data):
        return [leaf.clip(0.6, 1.4) for leaf in leaves], data

    def jhook(leaves, t, data):
        import jax.numpy as jnp

        return [jnp.clip(leaf, 0.6, 1.4) for leaf in leaves], data

    sources = ["u**2 * v - u", "1 - u**2 * v"]
    expected = jpde.ReactionDiffusionPDE(["u", "v"], [0.5, 0.2], sources,
                                         post_step_hook=jhook).solve(
        jstate, t_range=0.2, dt=1e-2, tracker=None)
    got = tpde.ReactionDiffusionPDE(["u", "v"], [0.5, 0.2], sources, post_step_hook=hook).solve(
        tstate, t_range=0.2, dt=1e-2, tracker=None)
    for g, e in zip(got, expected, strict=True):
        _close(g, e)
    with pytest.raises(ValueError, match="Number of sources"):
        tpde.ReactionDiffusionPDE(["u", "v"], 1.0, ["u"])


# -- 1D grids ---------------------------------------------------------------------------------
@pytest.mark.parametrize("model,bc", [
    (model, bc) for model in ("diffusion", "ks")
    for bc in ("auto_periodic_neumann", {"value": 1.0}, {"derivative": 0.3})
] + [("poisson", "auto_periodic_neumann")])
def test_1d_matches_jax(model, bc):
    periodic = bc == "auto_periodic_neumann"
    results = []
    for pkg in (jpde, tpde):
        grid = pkg.CartesianGrid([(0, 32)], [64], periodic=periodic)
        data = np.random.default_rng(8).uniform(-0.5, 0.5, 64)
        state = pkg.ScalarField(grid, data, **({"dtype": F64} if pkg is tpde else {}))
        if model == "diffusion":
            results.append(pkg.DiffusionPDE(0.5, bc=bc).solve(state, t_range=0.2, dt=0.01,
                                                              tracker=None))
        elif model == "ks":
            results.append(pkg.KuramotoSivashinskyPDE(bc=bc).solve(
                state, t_range=0.02, dt=1e-3, tracker=None))
        else:  # the FFT solve; bounded 1D grids take BiCGStab (tests/test_torch_poisson.py)
            results.append(pkg.solve_poisson_equation(state - state.average, bc=bc))
    _close(results[1], results[0])


@pytest.mark.parametrize("model", ["diffusion", "ks", "wave"])
def test_decomposed_1d_equals_serial(model):
    """1D runs on a mesh take the plain sharded stepper: bit-equal to the serial
    plain loop, and within 1e-12 of ``pde_tpu``'s serial run (its
    ``tests/parallel/test_sharded.py`` decomposes the 1D wave so)."""
    results = []
    for pkg in (jpde, tpde):
        grid = pkg.CartesianGrid([(0, 10)], 64, periodic=True)
        u0 = pkg.ScalarField.from_expression(grid, "exp(-(x-5)**2)",
                                             **({"dtype": F64} if pkg is tpde else {}))
        eq = {"diffusion": lambda: pkg.DiffusionPDE(0.5),
              "ks": lambda: pkg.KuramotoSivashinskyPDE(),
              "wave": lambda: pkg.WavePDE(speed=1)}[model]()
        state = eq.get_initial_condition(u0) if model == "wave" else u0
        dt = 5e-5 if model == "ks" else 5e-3  # KS: stable below 7.4e-5 at dx = 10/64
        results.append(eq.solve(state, t_range=10 * dt, dt=dt, tracker=None))
    with tpde.config({"parallel.devices_per_device": 8}):
        decomposed = eq.solve(state, t_range=10 * dt, dt=dt, tracker=None,
                              solver="explicit_sharded", adaptive=False, decomposition=[4])
        assert eq.diagnostics["solver"]["decomposition"] == [4]
    torch.testing.assert_close(decomposed.data, results[1].data, **EXACT)
    _close(results[1], results[0].data)
