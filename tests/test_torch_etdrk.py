"""The port's ETDRK4 solver and spectral split against ``pde_tpu``'s, fp64 on
the CPU.

The cases mirror ``tests/solvers/test_etdrk.py`` on 2D grids (the port's 1D
Laplacian is ROADMAP A4's; ``KuramotoSivashinskyPDE`` is A4's too, so the
Kuramoto-Sivashinsky cases take the expression PDE) with numpy initial data.
ETDRK4 runs match ``pde_tpu``'s at 1e-12; where ``pde_tpu``'s test holds its
run against a fine explicit reference, the port's run is held against
``pde_tpu``'s reference (a jitted loop of 10^4-10^5 steps) at the same
tolerance. The phi coefficients, evaluated in torch, match ``pde_tpu``'s
numpy formula at 1e-14 (E, E2, Q) and 2e-13 (f1-f3, see ``PHI_ATOL``). Decomposed runs equal the serial runs bit for bit on
every axis kind (the transforms run on the global leaves).
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers import etdrk as jetdrk
from pde_tpu_torch.solvers import etdrk as tetdrk

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
CAHN_HILLIARD = {"c": "laplace(c**3 - c - laplace(c))"}
KURAMOTO_SIVASHINSKY = {"u": "-laplace(u) - laplace(laplace(u)) - gradient_squared(u) / 2"}
GRAY_SCOTT = {"u": "0.2 * laplace(u) - u * v**2 + 0.04 * (1 - u)",
              "v": "0.1 * laplace(v) + u * v**2 - 0.1 * v"}


def _leaves(state):
    fields = list(state) if hasattr(state, "fields") else [state]
    return [np.asarray(f.data) for f in fields]


def _assert_close(port, reference, **tol):
    for a, b in zip(_leaves(port), _leaves(reference), strict=True):
        np.testing.assert_allclose(a, b, **(tol or TOL))


def _assert_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


def _scalar(pkg, grid, data, label=None, dtype=torch.float64):
    kw = {"dtype": dtype} if pkg is tpde else {}
    return pkg.ScalarField(grid, data, label=label, **kw)


def _both(make_state, make_eq, **solve):
    """The same run in pde_tpu and in the port: (jax result, port result, port info)."""
    (jax_run, _), (port_run, info) = [
        make_eq(pkg).solve(make_state(pkg), tracker=None, ret_info=True, **solve)
        for pkg in (jpde, tpde)]
    return jax_run, port_run, info["solver"]


def _periodic_2pi(pkg, n=32):
    return pkg.CartesianGrid([(0, 2 * np.pi)] * 2, (n, n), periodic=True)


def _sin_cos(grid):
    x, y = np.meshgrid(*grid.axes_coords, indexing="ij")
    return np.sin(x) * np.cos(2 * y)


def test_registered_name():
    assert "etdrk4" in tpde.solvers.registered_solvers()
    assert tpde.ETDRK4Solver.dt_default == jpde.ETDRK4Solver.dt_default


def test_linear_diffusion_exact():
    """With N = 0 the integrator is EXACT for the FD semi-discretization at
    any dt: each rfft mode decays with exp(lambda_fd * t)."""
    jax_run, port_run, info = _both(
        lambda p: _scalar(p, _periodic_2pi(p), _sin_cos(_periodic_2pi(p))),
        lambda p: p.PDE({"u": "0.3 * laplace(u)"}), t_range=1.0, dt=0.5, solver="etdrk4")
    dx = 2 * np.pi / 32
    lam = -(4 / dx**2) * (np.sin(1 * dx / 2) ** 2 + np.sin(2 * dx / 2) ** 2)
    exact = _sin_cos(_periodic_2pi(tpde)) * np.exp(0.3 * lam * 1.0)
    np.testing.assert_allclose(port_run.data.numpy(), exact, atol=1e-12)
    _assert_close(port_run, jax_run)
    assert info["etdrk_axis_kinds"] == ("periodic", "periodic")
    assert info["solver_scheme"].startswith("etdrk4")
    assert info["etdrk_coefficient_seconds"] >= 0 and info["etdrk_split_seconds"] > 0


def test_corner_weight_diffusion_exact():
    """ETDRK4 honors the configured 9-point corner-weight Laplacian: each mode
    decays with a·λx + b·λy + c·λx·λy, cross-checked against the stencil."""
    w = 0.5
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": w}), \
            jpde.config({"operators.cartesian.laplacian_2d_corner_weight": w}):
        jax_run, port_run, _ = _both(
            lambda p: _scalar(p, _periodic_2pi(p), _sin_cos(_periodic_2pi(p))),
            lambda p: p.PDE({"u": "0.3 * laplace(u)"}), t_range=1.0, dt=0.5, solver="etdrk4")
        field = _scalar(tpde, _periodic_2pi(tpde), _sin_cos(_periodic_2pi(tpde)))
        lap = field.laplace("periodic")
    dx = 2 * np.pi / 32
    lx = -(4 / dx**2) * np.sin(1 * dx / 2) ** 2
    ly = -(4 / dx**2) * np.sin(2 * dx / 2) ** 2
    s = dx**-2
    a = (1 - w) + 2 * s * w / (2 * s)
    c = 2 * s * w / (4 * s * s)
    lam9 = a * lx + a * ly + c * lx * ly
    np.testing.assert_allclose(lap.data.numpy(), lam9 * field.data.numpy(), atol=1e-10)
    exact = field.data.numpy() * np.exp(0.3 * lam9 * 1.0)
    np.testing.assert_allclose(port_run.data.numpy(), exact, atol=1e-12)
    _assert_close(port_run, jax_run)


def test_corner_weight_nonperiodic_raises():
    field = _scalar(tpde, tpde.UnitGrid([16, 16]), np.zeros((16, 16)))
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 0.5}):
        with pytest.raises(NotImplementedError, match="corner-weight"):
            tpde.PDE({"u": "laplace(u)"}).solve(field, t_range=0.1, dt=0.05, solver="etdrk4",
                                                tracker=None)


def test_cahn_hilliard_matches_euler():
    """test_etdrk.py::test_cahn_hilliard_matches_euler: the same FD
    semi-discretization as the explicit solvers, so the run at dt = 1e-2 tracks
    pde_tpu's Euler run at dt = 1e-5 (10^5 jitted steps) to 2e-6."""
    data = np.random.default_rng(0).uniform(-0.1, 0.1, (32, 32))
    jax_run, port_run, _ = _both(
        lambda p: _scalar(p, p.UnitGrid([32, 32], periodic=True), data),
        lambda p: p.PDE(CAHN_HILLIARD), t_range=1.0, dt=1e-2, solver="etdrk4")
    _assert_close(port_run, jax_run)
    ref = jpde.PDE(CAHN_HILLIARD).solve(
        jpde.ScalarField(jpde.UnitGrid([32, 32], periodic=True), data), t_range=1.0, dt=1e-5,
        solver="euler", tracker=None)
    np.testing.assert_allclose(port_run.data.numpy(), np.asarray(ref.data), atol=2e-6)


def test_kuramoto_sivashinsky_matches_rk4():
    """KS (biharmonic stiffness, gradient_squared nonlinearity) in 2D at 50x
    the RK4 step size of pde_tpu's reference run."""
    def state(p):
        grid = p.CartesianGrid([(0, 16 * np.pi)] * 2, (32, 32), periodic=True)
        x, y = np.meshgrid(*grid.axes_coords, indexing="ij")
        return _scalar(p, grid, np.cos(x / 8) * (1 + np.sin(y / 8)))

    jax_run, port_run, _ = _both(state, lambda p: p.PDE(KURAMOTO_SIVASHINSKY), t_range=2.0,
                                 dt=0.05, solver="etdrk4")
    _assert_close(port_run, jax_run)
    ref = jpde.PDE(KURAMOTO_SIVASHINSKY).solve(state(jpde), t_range=2.0, dt=1e-3,
                                               solver="runge-kutta", adaptive=False,
                                               tracker=None)
    np.testing.assert_allclose(port_run.data.numpy(), np.asarray(ref.data), atol=1e-4)


def test_fourth_order_convergence():
    """Self-convergence at about fourth order in dt on Cahn-Hilliard."""
    data = np.random.default_rng(1).uniform(-0.1, 0.1, (16, 16))
    field = _scalar(tpde, tpde.UnitGrid([16, 16], periodic=True), data)
    eq = tpde.PDE(CAHN_HILLIARD)

    def solve(dt):
        return eq.solve(field, t_range=0.5, dt=dt, solver="etdrk4", tracker=None).data.numpy()

    fine = solve(1e-3)
    err = [np.max(np.abs(solve(dt) - fine)) for dt in (2e-2, 1e-2, 5e-3)]
    assert err[0] / err[1] > 6  # ~2^4 = 16 expected
    assert err[1] / err[2] > 6


def test_time_dependent_nonlinearity():
    """The nonlinear remainder receives the stage times."""
    jax_run, port_run, _ = _both(
        lambda p: _scalar(p, p.CartesianGrid([(0, 2 * np.pi)] * 2, (16, 16), periodic=True),
                          np.zeros((16, 16))),
        lambda p: p.PDE({"u": "laplace(u) + sin(t)"}), t_range=1.0, dt=0.05, solver="etdrk4")
    _assert_close(port_run, jax_run)
    np.testing.assert_allclose(port_run.data.numpy(), 1 - np.cos(1.0), atol=1e-6)


def test_trackers_and_windows():
    """Tracker interrupts split the run into several windows; the state is the
    one-shot run's."""
    from pde_tpu_torch.trackers.interrupts import ConstantInterrupts

    field = _scalar(tpde, tpde.UnitGrid([16, 16], periodic=True),
                    np.random.default_rng(2).random((16, 16)))
    eq = tpde.PDE({"u": "laplace(u)"})
    tracker = tpde.ConsistencyTracker(interrupts=ConstantInterrupts(0.25))
    res = eq.solve(field, t_range=1.0, dt=0.05, solver="etdrk4", tracker=tracker)
    one_shot = eq.solve(field, t_range=1.0, dt=0.05, solver="etdrk4", tracker=None)
    np.testing.assert_allclose(res.data.numpy(), one_shot.data.numpy(), rtol=1e-12, atol=1e-14)


BAD_BCS = [
    {"x": {"derivative": 0}, "y": {"mixed": 1.0}},  # Robin
    {"x": {"value": 1.0}, "y": {"derivative": 0}},  # inhomogeneous value
    {"x-": {"value": 0}, "x+": {"derivative": 0}, "y": {"derivative": 0}},  # mixed per side
]


@pytest.mark.parametrize("bad_bc", BAD_BCS, ids=["robin", "inhomogeneous", "per-side"])
def test_unsupported_conditions(bad_bc):
    """Conditions without a diagonalizing modal basis raise, as in pde_tpu."""
    data = np.random.default_rng(3).random((16, 16))
    for pkg in (jpde, tpde):
        field = _scalar(pkg, pkg.UnitGrid([16, 16]), data)
        with pytest.raises(NotImplementedError, match="periodic|Neumann|Dirichlet"):
            pkg.PDE({"u": "laplace(u)"}, bc=bad_bc).solve(field, t_range=0.1, dt=0.01,
                                                         solver="etdrk4", tracker=None)


def test_unsupported_configurations():
    """test_etdrk.py::test_unsupported_configurations: SDEs, fields with
    different laplace conditions, PDEs without a split, complex states,
    anti-periodic axes, mismatched field counts, curvilinear grids."""
    with pytest.raises(RuntimeError, match="deterministic"):
        tpde.ETDRK4Solver(tpde.PDE({"u": "laplace(u)"}, noise=0.1))
    with pytest.raises((RuntimeError, NotImplementedError), match="deterministic"):
        tpde.KPZInterfacePDE(noise=0.1).solve(
            _scalar(tpde, tpde.UnitGrid([16, 16], periodic=True), 0.0), t_range=0.1, dt=0.01,
            solver="etdrk4", tracker=None)
    grid = tpde.UnitGrid([16, 16])
    coll = tpde.FieldCollection([_scalar(tpde, grid, 0.1, label=k) for k in "uv"])
    with pytest.raises(NotImplementedError, match="share"):
        tpde.PDE({"u": "laplace(u)", "v": "laplace(v)"}, bc={"derivative": 0},
                 bc_ops={"v:laplace": {"value": 0}}).solve(coll, t_range=0.1, dt=0.01,
                                                           solver="etdrk4", tracker=None)

    class Custom(tpde.PDEBase):
        def evolution_rate(self, state, t=0):
            return state.laplace("periodic")

    field = _scalar(tpde, tpde.UnitGrid([16, 16], periodic=True), 0.1)
    with pytest.raises(NotImplementedError, match="make_etdrk_parts"):
        Custom().solve(field, t_range=0.1, dt=0.01, solver="etdrk4", tracker=None)
    cgrid = tpde.CartesianGrid([(0, 2 * np.pi)] * 2, (16, 16), periodic=True)
    cfield = tpde.ScalarField(cgrid, np.exp(1j * np.arange(16) * 0.1)[:, None] * np.ones(16))
    with pytest.raises(NotImplementedError, match="complex"):
        tpde.PDE({"u": "1j * laplace(u)"}).solve(cfield, t_range=0.1, dt=0.01, solver="etdrk4",
                                                 tracker=None)
    with pytest.raises(NotImplementedError, match="periodic"):
        tpde.PDE({"u": "laplace(u)"}, bc="anti-periodic").solve(
            field, t_range=0.1, dt=0.01, solver="etdrk4", tracker=None)

    class TwoFieldSplit(tpde.PDEBase):  # a split of two fields for a one-field state
        def evolution_rate(self, state, t=0):
            return state

        def make_etdrk_parts(self, state, rhs_state=None):
            from pde_tpu_torch.models.base import EtdrkParts

            return EtdrkParts(np.zeros((16, 9, 2, 2)), None, ("periodic", "periodic"), 2)

    with pytest.raises(NotImplementedError, match="field count"):
        TwoFieldSplit().solve(field, t_range=0.1, dt=0.01, solver="etdrk4", tracker=None)
    with pytest.raises(NotImplementedError, match="Cartesian"):
        tpde.DiffusionPDE(0.1).solve(_scalar(tpde, tpde.PolarSymGrid(1.0, 16), 0.1),
                                     t_range=0.1, dt=0.01, solver="etdrk4", tracker=None)


def test_float32_path():
    """fp32 states run the spectral step in complex64 without promotion, and
    stay within fp32 rounding of the fp64 run."""
    data = np.random.default_rng(4).random((32, 32))
    grid = tpde.UnitGrid([32, 32], periodic=True)
    eq = tpde.PDE({"u": "laplace(u) - u**3"})
    res32 = eq.solve(_scalar(tpde, grid, data, dtype=torch.float32), t_range=0.5, dt=0.05,
                     solver="etdrk4", tracker=None)
    res64 = eq.solve(_scalar(tpde, grid, data), t_range=0.5, dt=0.05, solver="etdrk4",
                     tracker=None)
    assert res32.data.dtype == torch.float32 and torch.isfinite(res32.data).all()
    np.testing.assert_allclose(res32.data.double().numpy(), res64.data.numpy(), atol=1e-5)


PREDEFINED = {
    "diffusion": lambda p: p.DiffusionPDE(0.1),
    "cahn-hilliard": lambda p: p.CahnHilliardPDE(),
    "allen-cahn": lambda p: p.AllenCahnPDE(),
    "swift-hohenberg": lambda p: p.SwiftHohenbergPDE(),
    "kpz": lambda p: p.KPZInterfacePDE(noise=0),
}


@pytest.mark.parametrize("model", PREDEFINED)
def test_predefined_models(model):
    """Every predefined scalar model the port has exposes the split: its run
    matches pde_tpu's, and pde_tpu's RK4 reference at 100x the step size."""
    data = np.random.default_rng(5).uniform(-0.1, 0.1, (32, 32))
    jax_run, port_run, _ = _both(
        lambda p: _scalar(p, p.UnitGrid([32, 32], periodic=True), data), PREDEFINED[model],
        t_range=0.1, dt=0.01, solver="etdrk4")
    _assert_close(port_run, jax_run)
    jparts, parts = (PREDEFINED[model](pkg).make_etdrk_parts(
        _scalar(pkg, pkg.UnitGrid([32, 32], periodic=True), data)) for pkg in (jpde, tpde))
    np.testing.assert_allclose(parts.L_vals, jparts.L_vals, rtol=1e-14, atol=0)
    assert parts.axis_kinds == jparts.axis_kinds
    ref = PREDEFINED[model](jpde).solve(
        jpde.ScalarField(jpde.UnitGrid([32, 32], periodic=True), data), t_range=0.1, dt=1e-4,
        solver="runge-kutta", adaptive=False, tracker=None)
    np.testing.assert_allclose(port_run.data.numpy(), np.asarray(ref.data), atol=1e-6)


def test_three_dimensional():
    data = np.random.default_rng(6).random((12, 12, 12))
    jax_run, port_run, _ = _both(
        lambda p: _scalar(p, p.UnitGrid([12, 12, 12], periodic=True), data),
        lambda p: p.PDE({"u": "laplace(u) - u**3"}), t_range=0.2, dt=0.02, solver="etdrk4")
    _assert_close(port_run, jax_run)


def test_linear_split_machinery():
    """Unit-level contracts of the symbolic linear/nonlinear split."""
    import sympy

    from pde_tpu_torch.models.pde import PDE

    u, q = sympy.Symbol("u"), sympy.Symbol("q")
    lap = sympy.Function("laplace")
    expr = lap(u**3 - u - 2 * lap(u))
    out = PDE._distribute_linear_ops(expr)
    assert out == lap(u**3) - lap(u) - 2 * lap(lap(u))
    assert out == jpde.PDE._distribute_linear_ops(expr)
    assert PDE._linear_term_symbol(3 * u, u, q) == 3
    assert PDE._linear_term_symbol(-lap(u), u, q) == q**2
    assert PDE._linear_term_symbol(2 * lap(lap(u)), u, q) == 2 * q**4
    assert PDE._linear_term_symbol(lap(u**3), u, q) is None
    assert PDE._linear_term_symbol(u**2, u, q) is None
    assert PDE._linear_term_symbol(sympy.Integer(1), u, q) is None
    assert PDE._linear_term_symbol(u * lap(u), u, q) is None


@pytest.mark.parametrize("periodic", [True, False, [True, False]],
                         ids=["periodic", "no-flux", "periodic x no-flux y"])
def test_split_symbol_values(periodic):
    """L_vals equals pde_tpu's (the summed discrete eigenvalue chains); the
    remainder reproduces rhs - L u."""
    data = np.random.default_rng(7).random((16, 12))
    parts = []
    for pkg in (jpde, tpde):
        field = _scalar(pkg, pkg.UnitGrid([16, 12], periodic=periodic), data)
        parts.append((pkg.PDE(CAHN_HILLIARD).make_etdrk_parts(field), field))
    (jparts, _), (tparts, field) = parts
    np.testing.assert_allclose(tparts.L_vals, jparts.L_vals, rtol=1e-14, atol=0)
    assert tparts.axis_kinds == jparts.axis_kinds and tparts.n_fields == 1
    L_vals, n_rhs = tparts
    from pde_tpu_torch.ops.common import laplace_eigenvalues_1d

    if periodic is True:
        lam = (laplace_eigenvalues_1d(16, 1.0)[:, None]
               + laplace_eigenvalues_1d(12, 1.0, real_half=True)[None, :])
        np.testing.assert_allclose(L_vals, -lam - lam**2, rtol=1e-12)
        (full,) = tpde.PDE(CAHN_HILLIARD).make_pde_rhs(field)([field.data], 0.0)
        (rest,) = n_rhs([field.data], 0.0)
        lin = np.fft.irfftn(L_vals * np.fft.rfftn(data), s=(16, 12), axes=(0, 1))
        np.testing.assert_allclose(rest.numpy() + lin, full.numpy(), atol=1e-10)
    (jrest,) = jparts.nonlinear_rhs([np.asarray(data)], 0.0)
    (trest,) = n_rhs([field.data], 0.0)
    np.testing.assert_allclose(trest.numpy(), np.asarray(jrest), **TOL)


def test_bc_lap_mismatch_rejected():
    field = _scalar(tpde, tpde.UnitGrid([16, 16], periodic=True), 0.1)
    with pytest.raises(NotImplementedError):
        tpde.SwiftHohenbergPDE(bc="periodic", bc_lap={"value": 0}).make_etdrk_parts(field)
    with pytest.raises(NotImplementedError, match="bc_c == bc_mu"):
        tpde.CahnHilliardPDE(bc_c="periodic", bc_mu={"value": 0}).make_etdrk_parts(field)


def test_scalar_consts_enter_linear_part():
    """`D*laplace(c)` with consts={'D': ...} lands in the linear part."""
    grid = tpde.CartesianGrid([(0, 2 * np.pi)] * 2, (32, 32), periodic=True)
    x, _ = np.meshgrid(*grid.axes_coords, indexing="ij")
    field = _scalar(tpde, grid, np.sin(x))
    eq = tpde.PDE({"c": "D * laplace(c)"}, consts={"D": 0.7})
    L_vals, nonlinear_rhs = eq.make_etdrk_parts(field)
    dx = 2 * np.pi / 32
    lam1 = -(4 / dx**2) * np.sin(dx / 2) ** 2
    np.testing.assert_allclose(L_vals[1, 0], 0.7 * lam1, rtol=1e-12)
    (rest,) = nonlinear_rhs([field.data], 0.0)
    np.testing.assert_allclose(rest.numpy(), 0.0, atol=1e-14)
    res = eq.solve(field, t_range=1.0, dt=0.5, solver="etdrk4", tracker=None)
    np.testing.assert_allclose(res.data.numpy(), np.sin(x) * np.exp(0.7 * lam1), atol=1e-12)


def test_neumann_diffusion_exact():
    """No-flux axes go through DCT-II modes: linear diffusion is exact."""
    n = 32
    x = (np.arange(n) + 0.5) / n
    data = np.cos(2 * np.pi * x)[:, None] * np.cos(3 * np.pi * x)[None, :]
    jax_run, port_run, info = _both(
        lambda p: _scalar(p, p.CartesianGrid([(0, 1)] * 2, (n, n)), data),
        lambda p: p.PDE({"u": "0.01 * laplace(u)"}, bc={"derivative": 0}),
        t_range=1.0, dt=0.5, solver="etdrk4")
    dx = 1.0 / n
    lam = -(4 / dx**2) * (np.sin(np.pi * 2 / (2 * n)) ** 2 + np.sin(np.pi * 3 / (2 * n)) ** 2)
    np.testing.assert_allclose(port_run.data.numpy(), data * np.exp(0.01 * lam), atol=1e-11)
    _assert_close(port_run, jax_run)
    assert info["etdrk_axis_kinds"] == ("neumann", "neumann")


def test_dirichlet_diffusion_exact():
    """Homogeneous-Dirichlet axes go through DST-II modes."""
    n, m = 24, 16
    x = (np.arange(n) + 0.5) / n
    y = (np.arange(m) + 0.5) / m
    modes = [(1, 1, 1.0), (4, 2, 0.3)]
    data = sum(a * np.sin(kx * np.pi * x)[:, None] * np.sin(ky * np.pi * y)[None, :]
               for kx, ky, a in modes)
    jax_run, port_run, _ = _both(
        lambda p: _scalar(p, p.CartesianGrid([(0, 2), (0, 1)], (n, m)), data),
        lambda p: p.PDE({"u": "0.05 * laplace(u)"}, bc={"value": 0}),
        t_range=2.0, dt=1.0, solver="etdrk4")
    dx, dy = 2.0 / n, 1.0 / m
    exact = 0
    for kx, ky, a in modes:
        lam = (-(4 / dx**2) * np.sin(np.pi * kx / (2 * n)) ** 2
               - (4 / dy**2) * np.sin(np.pi * ky / (2 * m)) ** 2)
        exact = exact + a * np.sin(kx * np.pi * x)[:, None] * np.sin(ky * np.pi * y)[None, :] \
            * np.exp(0.05 * lam * 2.0)
    np.testing.assert_allclose(port_run.data.numpy(), exact, atol=1e-11)
    _assert_close(port_run, jax_run)


@pytest.mark.parametrize(
    "bc", [{"x": "periodic", "y": {"derivative": 0}}, {"x": {"derivative": 0}, "y": {"value": 0}}],
    ids=["mixed-periodic-neumann", "neumann-dirichlet"])
def test_nonperiodic_nonlinear_matches_euler(bc):
    """Nonlinear problems on mixed axes: the port's run matches pde_tpu's, and
    pde_tpu's fine Euler run to 2e-6."""
    periodic = [bc.get("x") == "periodic", bc.get("y") == "periodic"]
    data = np.random.default_rng(8).uniform(-0.1, 0.1, (16, 16))
    rhs = {"u": "0.02 * laplace(u) + u - u**3"}
    jax_run, port_run, _ = _both(
        lambda p: _scalar(p, p.CartesianGrid([(0, 1), (0, 1)], (16, 16), periodic=periodic),
                          data),
        lambda p: p.PDE(rhs, bc=bc), t_range=1.0, dt=1e-2, solver="etdrk4")
    _assert_close(port_run, jax_run)
    ref = jpde.PDE(rhs, bc=bc).solve(
        jpde.ScalarField(jpde.CartesianGrid([(0, 1), (0, 1)], (16, 16), periodic=periodic), data),
        t_range=1.0, dt=1e-4, solver="euler", tracker=None)
    np.testing.assert_allclose(port_run.data.numpy(), np.asarray(ref.data), atol=2e-6)


def test_coupled_linear_rotation_exact():
    """u_t = D∇²u + ωv, v_t = D∇²v - ωu is integrated exactly by the per-mode
    matrix exponential at any dt."""
    n, D, w = 32, 0.2, 1.3

    def state(p):
        grid = _periodic_2pi(p, n)
        x, _ = np.meshgrid(*grid.axes_coords, indexing="ij")
        return p.FieldCollection([_scalar(p, grid, np.sin(x), "u"), _scalar(p, grid, 0.0, "v")])

    jax_run, port_run, _ = _both(
        state, lambda p: p.PDE({"u": f"{D} * laplace(u) + {w} * v",
                                "v": f"{D} * laplace(v) - {w} * u"}),
        t_range=1.0, dt=0.5, solver="etdrk4")
    dx = 2 * np.pi / n
    lam = -(4 / dx**2) * np.sin(dx / 2) ** 2
    u0 = _leaves(state(tpde))[0]
    decay = np.exp(D * lam)
    np.testing.assert_allclose(port_run[0].data.numpy(), u0 * decay * np.cos(w), atol=1e-11)
    np.testing.assert_allclose(port_run[1].data.numpy(), -u0 * decay * np.sin(w), atol=1e-11)
    _assert_close(port_run, jax_run)


def _gray_scott_state(pkg, n=24):
    grid = pkg.UnitGrid([n, n], periodic=True)
    v0 = np.zeros((n, n))
    v0[n // 3:2 * n // 3, n // 3:2 * n // 3] = 0.5
    v0 = v0 + 0.01 * np.random.default_rng(9).random((n, n))
    return pkg.FieldCollection([_scalar(pkg, grid, 1.0, "u"), _scalar(pkg, grid, v0, "v")])


def test_coupled_gray_scott_matches_rk4():
    """Stiff coupled Gray-Scott at 100x the explicit step size: the port's run
    matches pde_tpu's, and pde_tpu's RK4 reference to 2e-4."""
    jax_run, port_run, _ = _both(_gray_scott_state, lambda p: p.PDE(GRAY_SCOTT),
                                 t_range=20.0, dt=1.0, solver="etdrk4")
    _assert_close(port_run, jax_run)
    ref = jpde.PDE(GRAY_SCOTT).solve(_gray_scott_state(jpde), t_range=20.0, dt=0.01,
                                     solver="runge-kutta", adaptive=False, tracker=None)
    _assert_close(port_run, ref, rtol=0, atol=2e-4)


def test_coupled_schnakenberg_neumann():
    """A coupled system on no-flux axes: DCT modes and per-mode 2x2 matrices."""
    gen = np.random.default_rng(10)
    a0, b0 = 1.0 + 0.1 * gen.random((16, 16)), 0.9 + 0.1 * gen.random((16, 16))

    def state(p):
        grid = p.UnitGrid([16, 16])
        return p.FieldCollection([_scalar(p, grid, a0, "a"), _scalar(p, grid, b0, "b")])

    jax_run, port_run, _ = _both(
        state, lambda p: p.PDE({"a": "laplace(a) + 0.1 - a + a**2 * b",
                                "b": "10 * laplace(b) + 0.9 - a**2 * b"}, bc={"derivative": 0}),
        t_range=0.5, dt=0.05, solver="etdrk4")
    _assert_close(port_run, jax_run)


def test_coupled_split_matrix_values():
    """Per-mode (N, N) matrices with laplace chains on the diagonal and
    constant cross couplings, as pde_tpu's."""
    out = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([8, 8], periodic=True)
        state = pkg.FieldCollection([_scalar(pkg, grid, 0.0, "u"), _scalar(pkg, grid, 0.0, "v")])
        eq = pkg.PDE({"u": "2 * laplace(u) + 3 * v + u * v", "v": "-laplace(laplace(v)) - 0.5 * u"})
        out.append(eq.make_etdrk_parts(state))
    jparts, parts = out
    assert parts.n_fields == 2 and parts.axis_kinds == ("periodic", "periodic")
    assert parts.L_vals.shape == (8, 5, 2, 2)
    np.testing.assert_allclose(parts.L_vals, jparts.L_vals, rtol=1e-14, atol=0)
    np.testing.assert_allclose(parts.L_vals[..., 0, 1], 3.0)
    rest = parts.nonlinear_rhs([torch.full((8, 8), 2.0, dtype=torch.float64),
                                torch.full((8, 8), 3.0, dtype=torch.float64)], 0.0)
    np.testing.assert_allclose(rest[0].numpy(), 6.0, atol=1e-12)
    np.testing.assert_allclose(rest[1].numpy(), 0.0, atol=1e-12)


def test_ks_neumann():
    """Kuramoto-Sivashinsky on a no-flux domain, through the DCT basis."""
    def state(p):
        grid = p.CartesianGrid([(0, 16 * np.pi), (0, 8 * np.pi)], (48, 24))
        x, y = np.meshgrid(*grid.axes_coords, indexing="ij")
        return _scalar(p, grid, np.cos(x / 8) * (1 + np.sin(y / 8)))

    jax_run, port_run, _ = _both(
        state, lambda p: p.PDE(KURAMOTO_SIVASHINSKY, bc={"derivative": 0}), t_range=1.0,
        dt=0.02, solver="etdrk4")
    _assert_close(port_run, jax_run)


# -- the phi coefficients ------------------------------------------------------------------
# E, E2 and Q match the numpy formula to 1e-14; f1-f3 to 2e-13 (absolute, values up
# to 1/2): their quadrature terms cancel where a point z = mu + r of the unit circle
# comes near 0 (|mu| near 1), and 1/z^3 magnifies one ulp of numpy's or torch's
# complex exp there (measured up to 1.1e-13)
PHI_ATOL = (1e-14, 1e-14, 1e-14, 2e-13, 2e-13, 2e-13)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_phi_scalars_match_the_numpy_formula(kind):
    """The torch fp64 quadrature against pde_tpu's numpy one, mu from the
    stiff end through |mu| = 1 to 0."""
    gen = np.random.default_rng(11)
    mu = -np.concatenate([np.logspace(-12, 4, 300), [0.0]])
    if kind == "complex":
        mu = mu + 1j * gen.uniform(-3, 3, mu.shape)
    want = jetdrk._phi_scalars(mu, 64)
    got = tetdrk._phi_scalars(torch.as_tensor(mu))
    for g, w, atol in zip(got, want, PHI_ATOL, strict=True):
        g = g.numpy()
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def test_phi_coefficients_match_the_numpy_formula():
    L = -np.linspace(0, 5e3, 257).reshape(1, 257)
    want = jetdrk._phi_coefficients(L, 0.05)
    got = tetdrk._phi_coefficients(L, 0.05, torch.device("cpu"))
    for g, w, atol in zip(got, want, PHI_ATOL, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)
    # coupled: per-mode matrices assembled from numpy's eigendecomposition
    gen = np.random.default_rng(12)
    Lm = gen.uniform(-2, 0.5, (6, 5, 2, 2))
    want = jetdrk._phi_coefficient_matrices(Lm, 0.3)
    got = tetdrk._phi_coefficient_matrices(Lm, 0.3, torch.device("cpu"))
    for g, w, atol in zip(got, want, PHI_ATOL, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)
    defective = np.zeros((3, 2, 2))
    defective[..., 0, 1] = 1.0  # a Jordan block
    with pytest.raises(NotImplementedError, match="defective"):
        tetdrk._phi_coefficient_matrices(defective, 0.1, torch.device("cpu"))


# -- decomposed runs --------------------------------------------------------------------------
def _serial_and_decomposed(eq, state, t_range, dt, decomposition, tracker_every=None):
    from pde_tpu_torch.trackers.interrupts import ConstantInterrupts

    runs = []
    for dec in (None, decomposition):
        solver = tpde.ETDRK4Solver(eq, decomposition=dec)
        tracker = None if tracker_every is None else tpde.ConsistencyTracker(
            interrupts=ConstantInterrupts(tracker_every))
        runs.append((tpde.Controller(solver, t_range=t_range, tracker=tracker).run(state, dt=dt),
                     solver.info))
    return runs


@pytest.mark.parametrize("decomposition", [[2, 1], [1, 2], [2, 2], [4, 2]])
def test_decomposed_matches_serial_periodic(decomposition):
    """Decomposed runs (the remainder over the blocks, the transforms on the
    global leaves) equal the serial run bit for bit, and match pde_tpu's
    decomposed run."""
    data = np.random.default_rng(13).uniform(-0.1, 0.1, (32, 32))
    state = _scalar(tpde, tpde.UnitGrid([32, 32], periodic=True), data)
    (serial, _), (decomposed, info) = _serial_and_decomposed(
        tpde.PDE(CAHN_HILLIARD), state, 1.0, 0.05, decomposition)
    assert info["etdrk_sharding"] == "global transforms, blocked remainder"
    assert info["sharded_halo"] == 1
    _assert_equal(decomposed, serial)
    jsolver = jpde.ETDRK4Solver(jpde.PDE(CAHN_HILLIARD), decomposition=decomposition)
    jax_run = jpde.Controller(jsolver, t_range=1.0, tracker=None).run(
        jpde.ScalarField(jpde.UnitGrid([32, 32], periodic=True), data), dt=0.05)
    _assert_close(decomposed, jax_run)


@pytest.mark.parametrize(
    "bc, periodic",
    [({"derivative": 0}, False), ({"value": 0}, False),
     ({"x": "periodic", "y": {"derivative": 0}}, [True, False])],
    ids=["dct", "dst", "mixed-fft-dct"])
def test_decomposed_matches_serial_matrix_bases(bc, periodic):
    """DCT/DST axes too are bit-equal to serial (pde_tpu's are within 2 ulp:
    its matrix products run on gathered shards inside a compiled loop)."""
    data = np.random.default_rng(14).uniform(-0.1, 0.1, (32, 32))
    state = _scalar(tpde, tpde.UnitGrid([32, 32], periodic=periodic), data)
    (serial, _), (decomposed, _) = _serial_and_decomposed(
        tpde.PDE({"u": "0.5 * laplace(u) + u - u**3"}, bc=bc), state, 1.0, 0.1, [2, 2])
    _assert_equal(decomposed, serial)


def test_decomposed_coupled_and_linear():
    """Coupled systems decompose; so does a run whose remainder reads no
    neighbour (pure diffusion: a halo of 0)."""
    gen = np.random.default_rng(15)
    grid = tpde.UnitGrid([32, 32], periodic=True)
    state = tpde.FieldCollection([_scalar(tpde, grid, gen.uniform(0.3, 0.7, (32, 32)), "u"),
                                  _scalar(tpde, grid, gen.uniform(0.1, 0.3, (32, 32)), "v")])
    eq = tpde.PDE({"u": "0.08 * laplace(u) - u*v**2 + 0.035 * (1 - u)",
                   "v": "0.04 * laplace(v) + u*v**2 - 0.1 * v"})
    (serial, _), (decomposed, _) = _serial_and_decomposed(eq, state, 5.0, 0.5, [2, 2])
    _assert_equal(decomposed, serial)
    (serial, _), (decomposed, info) = _serial_and_decomposed(
        tpde.DiffusionPDE(0.3), state[0], 1.0, 0.25, [2, 2])
    assert info["sharded_halo"] == 0
    _assert_equal(decomposed, serial)


def test_decomposed_trackers_and_windows():
    data = np.random.default_rng(16).uniform(-0.1, 0.1, (32, 32))
    state = _scalar(tpde, tpde.UnitGrid([32, 32], periodic=True), data)
    (serial, _), (decomposed, _) = _serial_and_decomposed(
        tpde.PDE({"c": "0.1 * laplace(c) - c**3"}), state, 1.0, 0.05, [2, 2], tracker_every=0.25)
    _assert_equal(decomposed, serial)
