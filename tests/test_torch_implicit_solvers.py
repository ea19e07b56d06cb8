"""The port's implicit Euler, Crank-Nicolson and scipy solvers against
``pde_tpu``'s, fp64 on the CPU.

The cases mirror ``tests/solvers/test_solver_matrix.py:13-107`` on 2D grids
(the port's 1D Laplacian is ROADMAP A4's) with numpy initial data. Implicit
Euler and Crank-Nicolson match ``pde_tpu`` at 1e-12 (the same fixed-point
iteration, stopped at the same iterate); scipy at ``solve_ivp``'s own
``rtol``/``atol``. Decomposed runs (the plain sharded stepper) equal the
serial runs bit for bit, in ``tests/test_torch_sharded_plain.py``.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.solvers import implicit as timplicit

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
FIXED_POINT_SOLVERS = ["implicit", "crank-nicolson"]


def _leaves(state):
    fields = list(state) if hasattr(state, "fields") else [state]
    return [np.asarray(f.data) for f in fields]


def _assert_close(port, reference, **tol):
    for a, b in zip(_leaves(port), _leaves(reference), strict=True):
        np.testing.assert_allclose(a, b, **(tol or TOL))


def _scalar(pkg, grid, data, label=None):
    kw = {"dtype": torch.float64} if pkg is tpde else {}
    return pkg.ScalarField(grid, data, label=label, **kw)


def _decay(pkg):
    class DecayPDE(pkg.PDEBase):
        """du/dt = -u with exact solution u0 * exp(-t)."""

        def evolution_rate(self, state, t=0):
            return -state

    return DecayPDE()


@pytest.mark.parametrize("solver", FIXED_POINT_SOLVERS)
def test_solver_converges_to_exact_decay(solver):
    """test_solver_matrix.py::test_solver_converges_to_exact_decay on a 4x4 grid."""
    out = []
    for pkg in (jpde, tpde):
        state = _scalar(pkg, pkg.UnitGrid([4, 4]), 1.0)
        out.append(_decay(pkg).solve(state, t_range=1.0, dt=1e-3, solver=solver, tracker=None))
    _assert_close(out[1], out[0])
    order = {"implicit": 2e-3, "crank-nicolson": 1e-5}[solver]
    np.testing.assert_allclose(out[1].data.numpy(), np.exp(-1.0), rtol=3 * order)


@pytest.mark.parametrize("solver", FIXED_POINT_SOLVERS)
def test_solver_field_collection_state(solver):
    """test_solver_matrix.py::test_solver_field_collection_state: a coupled
    two-field state, against pde_tpu."""
    gen = np.random.default_rng(0)
    u, v = gen.random((8, 8)), gen.random((8, 8))
    out = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([8, 8], periodic=True)
        state = pkg.FieldCollection([_scalar(pkg, grid, u, "u"), _scalar(pkg, grid, v, "v")])
        eq = pkg.PDE({"u": "0.1 * laplace(u) - 0.5 * v", "v": "0.5 * u"})
        out.append(eq.solve(state, t_range=0.1, dt=1e-3, solver=solver, tracker=None))
    assert isinstance(out[1], tpde.FieldCollection)
    _assert_close(out[1], out[0])


# label -> (equation(pkg), shape, periodic, t_range, dt, solver keywords)
DIFFUSION_CASES = {
    "diffusion periodic dt=1": (lambda p: p.DiffusionPDE(0.1), (24, 16), True, 5.0, 1.0, {}),
    "diffusion dirichlet": (lambda p: p.DiffusionPDE(0.2, bc={"value": 0.5}), (16, 12), False,
                            1.0, 0.25, {}),
    "allen-cahn no-flux": (lambda p: p.AllenCahnPDE(0.5), (16, 16), False, 1.0, 0.1, {}),
    "cahn-hilliard": (lambda p: p.PDE({"c": "laplace(c**3 - c - laplace(c))"}), (16, 16), True,
                      0.1, 0.01, {}),
    "tight maxerror": (lambda p: p.DiffusionPDE(0.1), (16, 16), True, 2.0, 0.5,
                       {"maxerror": 1e-8, "maxiter": 500}),
}


@pytest.mark.parametrize("solver", FIXED_POINT_SOLVERS)
@pytest.mark.parametrize("case", DIFFUSION_CASES)
def test_fixed_point_solvers_match_jax(case, solver):
    make_eq, shape, periodic, t_range, dt, kwargs = DIFFUSION_CASES[case]
    data = np.random.default_rng(1).uniform(-0.5, 0.5, shape)
    out = []
    for pkg in (jpde, tpde):
        state = _scalar(pkg, pkg.UnitGrid(list(shape), periodic=periodic), data)
        out.append(make_eq(pkg).solve(state, t_range=t_range, dt=dt, solver=solver,
                                      tracker=None, ret_info=True, **kwargs))
    (jax_run, _), (port_run, info) = out
    _assert_close(port_run, jax_run)
    steps = round(t_range / dt)
    assert info["solver"]["steps"] == steps
    iterations = info["solver"]["fixed_point_iterations"]
    assert iterations >= steps
    # one host read per FIXED_POINT_CHUNK iterations of a step (and its first), and
    # one a window
    assert info["solver"]["host_syncs"] <= iterations + 2 * steps


def test_crank_nicolson_explicit_fraction():
    data = np.random.default_rng(2).uniform(0, 1, (12, 12))
    out = []
    for pkg in (jpde, tpde):
        state = _scalar(pkg, pkg.UnitGrid([12, 12], periodic=True), data)
        solver = pkg.CrankNicolsonSolver(pkg.DiffusionPDE(0.3), explicit_fraction=0.3,
                                         maxiter=200)
        out.append(pkg.Controller(solver, t_range=1.0, tracker=None).run(state, dt=0.1))
    _assert_close(out[1], out[0])


def test_fixed_point_windows_equal_one_run():
    """Tracker interrupts split the run into windows; the state is the same."""
    from pde_tpu_torch.trackers.interrupts import ConstantInterrupts

    state = _scalar(tpde, tpde.UnitGrid([16, 16], periodic=True),
                    np.random.default_rng(3).random((16, 16)))
    eq = tpde.DiffusionPDE(0.1)
    for solver in FIXED_POINT_SOLVERS:
        tracker = tpde.ConsistencyTracker(interrupts=ConstantInterrupts(0.3))
        windows = eq.solve(state, t_range=1.0, dt=0.1, solver=solver, tracker=tracker)
        one = eq.solve(state, t_range=1.0, dt=0.1, solver=solver, tracker=None)
        assert torch.equal(windows.data, one.data)


def test_implicit_solver_convergence_error():
    """test_solver_matrix.py::test_implicit_solver_convergence_error on a 2D
    grid: the stiff cubic diverges, both packages raise ConvergenceError."""
    for pkg in (jpde, tpde):
        class StiffPDE(pkg.PDEBase):
            def evolution_rate(self, state, t=0):
                return -1e6 * state**3

        state = _scalar(pkg, pkg.UnitGrid([4, 4]), 2.0)
        with pytest.raises(pkg.ConvergenceError, match="Implicit Euler step did not converge"):
            StiffPDE().solve(state, t_range=1.0, dt=1.0, solver="implicit", tracker=None)
    assert issubclass(tpde.ConvergenceError, RuntimeError)


@pytest.mark.parametrize("solver", FIXED_POINT_SOLVERS)
def test_maxiter_bounds_the_iteration(solver):
    """Too few iterations for maxerror: NaN, then ConvergenceError, in both."""
    data = np.random.default_rng(4).random((16, 16))
    for pkg in (jpde, tpde):
        state = _scalar(pkg, pkg.UnitGrid([16, 16], periodic=True), data)
        with pytest.raises(pkg.ConvergenceError, match="did not converge"):
            pkg.DiffusionPDE(0.2).solve(state, t_range=1.0, dt=1.0, solver=solver, maxiter=3,
                                        maxerror=1e-10, tracker=None)


def test_fixed_point_gating():
    """The gated loop stops at the iterate pde_tpu's while_loop stops at: the
    same count of updates as a loop that tests after every iteration."""
    def update(leaves):
        return [0.5 * leaves[0] + 1.0]

    start = [torch.zeros(3, dtype=torch.float64)]
    leaves, converged, n, reads = timplicit._fixed_point(update, start, 100, 1e-12)
    # x_k = 2 - 2^(1-k) reaches a squared change < 1e-12 after k = 21 updates
    expected, x, k = None, 0.0, 0
    while True:
        new = 0.5 * x + 1.0
        k += 1
        if (new - x) ** 2 < 1e-12 or k >= 100:
            expected = new
            break
        x = new
    assert bool(converged) and int(n) == k
    assert float(leaves[0][0]) == expected
    assert reads == -(-(k - 1) // timplicit.FIXED_POINT_CHUNK)
    _, converged, n, _ = timplicit._fixed_point(update, start, 5, 1e-12)
    assert not bool(converged) and int(n) == 5


def test_implicit_sde_adds_the_noise_first():
    """An SDE's increments are added before the iteration; with zero noise the
    run equals the deterministic one, and a noisy run draws the explicit
    Euler-Maruyama stream of the same seed."""
    data = np.random.default_rng(5).random((16, 16))
    grid = tpde.UnitGrid([16, 16], periodic=True)
    state = _scalar(tpde, grid, data)
    det = tpde.DiffusionPDE(0.1).solve(state, t_range=0.5, dt=0.1, solver="implicit",
                                       tracker=None)
    zero = tpde.DiffusionPDE(0.1, noise=0).solve(state, t_range=0.5, dt=0.1,
                                                 solver="implicit", tracker=None)
    _assert_close(zero, det, rtol=0, atol=0)
    # with D = 0 the implicit step is y + noise, as Euler-Maruyama's
    noisy = tpde.DiffusionPDE(0.0, noise=0.3, rng=np.random.default_rng(1)).solve(
        state, t_range=0.5, dt=0.1, solver="implicit", tracker=None)
    em = tpde.DiffusionPDE(0.0, noise=0.3, rng=np.random.default_rng(1)).solve(
        state, t_range=0.5, dt=0.1, solver="euler", backend="numpy", tracker=None)
    _assert_close(noisy, em)
    assert not np.allclose(noisy.data.numpy(), data)
    with pytest.raises(RuntimeError, match="Crank-Nicolson"):
        tpde.DiffusionPDE(0.1, noise=0.1).solve(state, t_range=0.1, dt=0.1,
                                                solver="crank-nicolson", tracker=None)


# -- scipy -----------------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [{}, {"method": "LSODA", "rtol": 1e-8, "atol": 1e-10}],
                         ids=["RK45", "LSODA"])
def test_scipy_solver_matches_jax_and_euler(kwargs):
    """test_solver_matrix.py::test_scipy_solver_matches_euler on an 8x8 grid:
    solve_ivp on the host, the rhs in torch; against pde_tpu's scipy run at
    solve_ivp's own tolerances and against a fine Euler run."""
    data = np.random.default_rng(6).random((8, 8))
    out = []
    for pkg in (jpde, tpde):
        state = _scalar(pkg, pkg.UnitGrid([8, 8], periodic=True), data)
        out.append(pkg.DiffusionPDE(0.5).solve(state, t_range=0.5, solver="scipy",
                                               tracker=None, ret_info=True, **kwargs))
    (jax_run, jax_info), (port_run, info) = out
    rtol, atol = kwargs.get("rtol", 1e-3), kwargs.get("atol", 1e-6)
    _assert_close(port_run, jax_run, rtol=rtol, atol=atol)
    assert info["solver"]["steps"] > 0 and port_run.data.device.type == "cpu"
    ref = tpde.DiffusionPDE(0.5).solve(_scalar(tpde, port_run.grid, data), t_range=0.5, dt=1e-4,
                                       tracker=None)
    # RK45's default rtol bounds its error, Euler's own is about 1e-5
    np.testing.assert_allclose(port_run.data.numpy(), ref.data.numpy(), rtol=max(rtol, 1e-4),
                               atol=1e-6)


def test_scipy_solver_collection_and_refusals():
    gen = np.random.default_rng(7)
    u, v = gen.random((8, 8)), gen.random((8, 8))
    out = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([8, 8], periodic=True)
        state = pkg.FieldCollection([_scalar(pkg, grid, u, "u"), _scalar(pkg, grid, v, "v")])
        eq = pkg.PDE({"u": "0.1 * laplace(u) - 0.5 * v", "v": "0.5 * u"})
        out.append(eq.solve(state, t_range=0.2, solver="scipy", tracker=None, rtol=1e-9,
                            atol=1e-12))
    _assert_close(out[1], out[0], rtol=1e-9, atol=1e-12)
    state = _scalar(tpde, tpde.UnitGrid([8, 8], periodic=True), u)
    with pytest.raises(RuntimeError, match="stochastic"):
        tpde.DiffusionPDE(0.1, noise=0.1).solve(state, t_range=0.1, solver="scipy", tracker=None)


@pytest.mark.parametrize("solver", ["implicit", "crank-nicolson", "scipy", "etdrk4"])
def test_cuda_engine_refuses_the_plain_solvers(solver):
    """The four solvers have no fused kernel window: backend='cuda' raises, as
    for every such solver; 'auto' and 'torch' run them."""
    state = _scalar(tpde, tpde.UnitGrid([8, 8], periodic=True), 0.5)
    with pytest.raises(RuntimeError, match="backend='cuda' is not supported"):
        tpde.DiffusionPDE(0.1).solve(state, t_range=0.1, dt=0.05, solver=solver,
                                     backend="cuda", tracker=None)
    result = tpde.DiffusionPDE(0.1).solve(state, t_range=0.1, dt=0.05, solver=solver,
                                          backend="torch", tracker=None)
    assert torch.isfinite(result.data).all()
