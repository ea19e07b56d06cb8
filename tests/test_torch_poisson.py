"""The port's Poisson solvers (``ops/poisson.py``) and ``models/laplace.py``
against ``pde_tpu``'s, fp64 on the CPU.

The cases mirror ``tests/models/test_laplace.py`` and
``tests/ops/test_poisson_depth.py`` on 2D grids (the port's 1D Laplacian is
ROADMAP A4's) with numpy initial data (``from_expression`` is A4's too).
Tolerances: 1e-12 for the FFT solves and the periodic Helmholtz projection,
1e-8 of max|u| for BiCGStab, which runs the same recurrence with another
reduction order; the BiCGStab recurrence itself is held against JAX's
``bicgstab`` on small dense systems.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import poisson as tpoisson

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


FFT_TOL = dict(rtol=0, atol=1e-12)


def _field(pkg, grid, data):
    kw = {"dtype": torch.float64} if pkg is tpde else {}
    return pkg.ScalarField(grid, data, **kw)


def _assert_bicgstab_close(port, reference):
    port, reference = np.asarray(port), np.asarray(reference)
    np.testing.assert_allclose(port, reference, rtol=0, atol=1e-8 * np.abs(reference).max())


# label -> (grid(pkg), bc, rhs(grid coordinates, rng), exact solution or None, its atol)
GRID_CASES = {
    # test_poisson_depth.py::test_poisson_manufactured_2d
    "cartesian dirichlet": (
        lambda p: p.CartesianGrid([(0, 1), (0, 1)], (32, 32)), {"value": 0},
        lambda x, y, g: -2 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y),
        lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y), 5e-3),
    "cartesian dirichlet 1.5 random": (
        lambda p: p.UnitGrid([24, 20]), {"value": 1.5},
        lambda x, y, g: g.uniform(-1, 1, x.shape), None, None),
    "cartesian mixed sides": (
        lambda p: p.UnitGrid([16, 24]), {"x-": {"value": 1.0}, "x+": {"derivative": 0.5},
                                         "y": {"type": "mixed", "value": 2.0, "const": 0.5}},
        lambda x, y, g: g.uniform(-1, 1, x.shape), None, None),
    "cartesian neumann zero mean": (
        lambda p: p.UnitGrid([16, 16]), {"derivative": 0},
        lambda x, y, g: (lambda f: f - f.mean())(g.uniform(-1, 1, x.shape)), None, None),
    "cartesian periodic x neumann y": (
        lambda p: p.UnitGrid([16, 12], periodic=[True, False]),
        {"x": "periodic", "y": {"value": 0.25}},
        lambda x, y, g: g.uniform(-1, 1, x.shape), None, None),
    # test_poisson_depth.py::test_poisson_polar: u(r) = (r²-1)/4
    "polar": (lambda p: p.PolarSymGrid(1, 32), {"value": 0},
              lambda r, _y, g: np.ones_like(r), lambda r, _y: (r**2 - 1) / 4, 2e-3),
    # test_poisson_depth.py::test_poisson_spherical: u(r) = (r²-1)/6
    "spherical": (lambda p: p.SphericalSymGrid(1, 32), {"value": 0},
                  lambda r, _y, g: np.ones_like(r), lambda r, _y: (r**2 - 1) / 6, 2e-3),
    # test_laplace.py::test_poisson_spherical: u = r² with r+ = 4 and no flux at r-
    "spherical radius 2": (
        lambda p: p.SphericalSymGrid(2, 32), {"r-": {"derivative": 0}, "r+": {"value": 4.0}},
        lambda r, _y, g: np.full_like(r, 6.0), lambda r, _y: r**2, 1e-2),
    "cylindrical": (
        lambda p: p.CylindricalSymGrid(2.0, (0, 3), (16, 12)),
        {"r": {"value": 0.5}, "z": {"derivative": 0.2}},
        lambda r, z, g: g.uniform(-1, 1, r.shape), None, None),
    "cylindrical periodic z": (
        lambda p: p.CylindricalSymGrid(2.0, (0, 3), (12, 16), periodic_z=True),
        {"r": {"value": 1.0}, "z": "periodic"},
        lambda r, z, g: g.uniform(-1, 1, r.shape), None, None),
}


def _coordinates(grid):
    coords = [np.asarray(c) for c in grid.axes_coords]
    if len(coords) == 1:
        return coords[0], None
    return np.meshgrid(*coords, indexing="ij")


@pytest.mark.parametrize("case", GRID_CASES)
def test_poisson_matches_jax(case):
    make_grid, bc, make_rhs, exact, exact_atol = GRID_CASES[case]
    results = []
    for pkg in (jpde, tpde):
        grid = make_grid(pkg)
        x, y = _coordinates(grid)
        rhs = make_rhs(x, y, np.random.default_rng(3))
        results.append(pkg.solve_poisson_equation(_field(pkg, grid, rhs), bc))
    jax_u, port_u = results
    assert port_u.data.dtype == torch.float64 and port_u.label == jax_u.label
    _assert_bicgstab_close(port_u.data, jax_u.data)
    if exact is not None:
        np.testing.assert_allclose(port_u.data.numpy(), exact(*_coordinates(port_u.grid)),
                                   atol=exact_atol)
    # the residual through the grid's own laplace
    lap = port_u.grid.make_operator("laplace", bc=bc)
    residual = lap(port_u.data) - _field(tpde, port_u.grid, make_rhs(
        *_coordinates(port_u.grid), np.random.default_rng(3))).data
    assert float(residual.abs().max()) < 1e-6


@pytest.mark.parametrize("shape", [(16, 16), (32, 24), (8, 12, 10)])
def test_fft_poisson_matches_jax(shape):
    """test_laplace.py::test_poisson_fft_periodic and test_poisson_depth.py::
    test_poisson_periodic_zero_mean: the FFT path solves the discrete periodic
    problem exactly, with zero mean."""
    gen = np.random.default_rng(len(shape))
    rhs = gen.uniform(-1, 1, shape)
    rhs -= rhs.mean()
    grids = [pkg.CartesianGrid([(0, 2 * np.pi)] * len(shape), list(shape), periodic=True)
             for pkg in (jpde, tpde)]
    jax_u = jpde.solve_poisson_equation(_field(jpde, grids[0], rhs), "periodic")
    port_u = tpde.solve_poisson_equation(_field(tpde, grids[1], rhs), "periodic")
    np.testing.assert_allclose(port_u.data.numpy(), np.asarray(jax_u.data), **FFT_TOL)
    residual = port_u.laplace("periodic").data - torch.as_tensor(rhs)
    assert float(residual.abs().max()) < 1e-10
    assert abs(float(port_u.average)) < 1e-10


def test_fft_poisson_keeps_fp32():
    """An fp32 rhs is solved in complex64 and returned in fp32 (pde_tpu's
    fp64 eigenvalues would promote it), within fp32 rounding of fp64."""
    gen = np.random.default_rng(1)
    rhs = gen.uniform(-1, 1, (32, 32))
    rhs -= rhs.mean()
    grid = tpde.UnitGrid([32, 32], periodic=True)
    u32 = tpde.solve_poisson_equation(tpde.ScalarField(grid, rhs, dtype=torch.float32),
                                      "periodic")
    u64 = tpde.solve_poisson_equation(_field(tpde, grid, rhs), "periodic")
    assert u32.data.dtype == torch.float32
    np.testing.assert_allclose(u32.data.double().numpy(), u64.data.numpy(), rtol=0,
                               atol=1e-5 * float(u64.data.abs().max()))


@pytest.mark.parametrize("method", ["fft", "bicgstab"])
def test_methods_on_periodic_grids(method):
    """`method` picks the route, as in pde_tpu: "fft" is the FFT solve, any
    other name BiCGStab with the nullspace regularized."""
    gen = np.random.default_rng(5)
    rhs = gen.uniform(-1, 1, (16, 12))
    rhs -= rhs.mean()
    out = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([16, 12], periodic=True)
        out.append(pkg.solve_poisson_equation(_field(pkg, grid, rhs), "periodic",
                                              method=method))
    if method == "fft":
        np.testing.assert_allclose(out[1].data.numpy(), np.asarray(out[0].data), **FFT_TOL)
    else:
        _assert_bicgstab_close(out[1].data, out[0].data)


def test_laplace_equation_harmonic():
    """test_poisson_depth.py::test_laplace_equation_harmonic with the sides'
    values given as arrays (expression conditions are ROADMAP A4's): the
    solution is harmonic inside and matches pde_tpu's."""
    results = []
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # the port's rhs of zeros takes the default dtype
    try:
        for pkg in (jpde, tpde):
            grid = pkg.CartesianGrid([(0, 1), (0, 1)], (24, 24))
            x, y = (np.asarray(c) for c in grid.axes_coords)
            bc = {"x-": {"value": 0.0}, "x+": {"value": y}, "y-": {"value": 0.0},
                  "y+": {"value": x}}
            results.append((pkg.solve_laplace_equation(grid, bc), bc))
    finally:
        torch.set_default_dtype(previous)
    (jax_u, _), (port_u, bc) = results
    assert port_u.label == "Solution to Laplace's equation"
    _assert_bicgstab_close(port_u.data, jax_u.data)
    lap = port_u.laplace(bc).data.numpy()
    assert np.abs(lap[4:-4, 4:-4]).max() < 1e-4


def test_incompatible_rhs_raises():
    """test_laplace.py::test_poisson_solver_1d's inconsistent problem in 2D: a
    non-neutral rhs with pure Neumann conditions has no solution."""
    grid = tpde.CartesianGrid([[0, 1], [0, 1]], 8)
    field = tpde.ScalarField(grid, 1.0, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="Neumann"):
        tpde.solve_poisson_equation(field, {"derivative": 0})
    with pytest.raises(RuntimeError, match="Neumann"):
        jpde.solve_poisson_equation(jpde.ScalarField(jpde.CartesianGrid([[0, 1], [0, 1]], 8), 1.0),
                                    {"derivative": 0})
    # a vector field whose divergence is not neutral under no-flux sides
    data = np.random.default_rng(9).uniform(-1, 1, (2, 16, 12))
    for pkg in (jpde, tpde):
        kw = {"dtype": torch.float64} if pkg is tpde else {}
        with pytest.raises(RuntimeError, match="Neumann"):
            pkg.helmholtz_decomposition(pkg.VectorField(pkg.UnitGrid([16, 12]), data, **kw),
                                        bc={"derivative": 0})


def test_helmholtz_decomposition_periodic():
    """test_poisson_depth.py::test_helmholtz_decomposition on numpy data: the
    Fourier projection with the discrete symbols, the reconstruction, and a
    divergence-free solenoidal part."""
    gen = np.random.default_rng(7)
    data = gen.normal(size=(2, 16, 16))
    out = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([16, 16], periodic=True)
        kw = {"dtype": torch.float64} if pkg is tpde else {}
        out.append(pkg.helmholtz_decomposition(pkg.VectorField(grid, data, **kw), bc="periodic"))
    (jphi, jsol), (phi, sol) = out
    np.testing.assert_allclose(phi.data.numpy(), np.asarray(jphi.data), **FFT_TOL)
    np.testing.assert_allclose(sol.data.numpy(), np.asarray(jsol.data), **FFT_TOL)
    assert isinstance(sol, tpde.VectorField) and phi.label == "potential"
    recon = phi.gradient("periodic") + sol
    np.testing.assert_allclose(recon.data.numpy(), data, atol=1e-8)
    assert float(sol.divergence("periodic").data.abs().max()) < 1e-6


def test_helmholtz_decomposition_fp32():
    gen = np.random.default_rng(8)
    grid = tpde.UnitGrid([32, 32], periodic=True)
    field = tpde.VectorField(grid, gen.normal(size=(2, 32, 32)), dtype=torch.float32)
    phi, sol = tpde.helmholtz_decomposition(field, "periodic")
    assert phi.data.dtype == sol.data.dtype == torch.float32
    div_f = float(field.divergence("periodic").data.abs().max())
    assert float(sol.divergence("periodic").data.abs().max()) <= 1e-5 * div_f


@pytest.mark.parametrize("bc", [{"value": 0}, {"x": {"value": 0.5}, "y": {"derivative": 0}}],
                         ids=["dirichlet", "dirichlet x neumann y"])
def test_helmholtz_decomposition_bounded(bc):
    """On a bounded grid the decomposition goes through the divergence, the
    BiCGStab Poisson solve and the gradient, as in pde_tpu."""
    gen = np.random.default_rng(9)
    data = gen.uniform(-1, 1, (2, 16, 12))
    out = []
    for pkg in (jpde, tpde):
        grid = pkg.UnitGrid([16, 12])
        kw = {"dtype": torch.float64} if pkg is tpde else {}
        out.append(pkg.helmholtz_decomposition(pkg.VectorField(grid, data, **kw), bc=bc))
    (jphi, jsol), (phi, sol) = out
    _assert_bicgstab_close(phi.data, jphi.data)
    np.testing.assert_allclose(sol.data.numpy(), np.asarray(jsol.data), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(jsol.data)).max())


def test_refusals():
    # 1D grids solve since their Laplacian is ported (ROADMAP A4's second item); until
    # then this raised naming A4: BiCGStab on a Dirichlet line against pde_tpu's
    rhs = np.random.default_rng(0).uniform(-1, 1, 24)
    jsol, tsol = (pkg.solve_poisson_equation(
        pkg.ScalarField(pkg.CartesianGrid([(0, 3)], [24]), rhs, **kw), bc={"value": 0.5})
        for pkg, kw in ((jpde, {}), (tpde, {"dtype": torch.float64})))
    _assert_bicgstab_close(tsol.data, jsol.data)
    mesh = tpde.GridMesh(tpde.UnitGrid([16, 16], periodic=True), [2, 2])
    view = mesh.extended_grid(0, 1)
    with pytest.raises(NotImplementedError, match="decomposed"):
        view.make_operator("poisson_solver", bc="periodic")
    assert tpoisson._is_singular(tpde.UnitGrid([4, 4]).get_boundary_conditions(
        {"derivative": 0}))
    assert not tpoisson._is_singular(tpde.UnitGrid([4, 4]).get_boundary_conditions(
        {"x": {"derivative": 0}, "y-": {"value": 1}, "y+": {"derivative": 0}}))


def test_solver_records_its_statistics():
    """The solver function records the last solve's iterations and host reads
    (one per BICGSTAB_CHUNK iterations, plus the last)."""
    grid = tpde.UnitGrid([24, 24])
    solve = grid.make_operator("poisson_solver", bc={"value": 0})
    rhs = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (24, 24)))
    solve(rhs)
    info = solve.info
    assert info["iterations"] == info["code"] > 0
    assert info["host_reads"] == -(-info["iterations"] // tpoisson.BICGSTAB_CHUNK) + 1


# -- the BiCGStab recurrence against JAX's ---------------------------------------------------
@pytest.mark.parametrize("size, tol, seed", [(6, 1e-5, 0), (12, 1e-10, 1), (20, 1e-12, 2)])
def test_bicgstab_matches_jax(size, tol, seed, monkeypatch):
    """JAX's bicgstab and the port's on a nonsymmetric dense system, from any
    host-read chunk: the same iterate (the chunk changes nothing)."""
    import jax.numpy as jnp
    from jax.scipy.sparse.linalg import bicgstab as jax_bicgstab

    gen = np.random.default_rng(seed)
    a = np.eye(size) * 4 + gen.uniform(-1, 1, (size, size))
    b = gen.uniform(-1, 1, size)
    want, _ = jax_bicgstab(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), tol=tol, maxiter=200)
    mat = torch.as_tensor(a)
    runs = []
    for chunk in (1, 3, 16):
        monkeypatch.setattr(tpoisson, "BICGSTAB_CHUNK", chunk)
        runs.append(tpoisson.bicgstab(lambda v: mat @ v, torch.as_tensor(b), tol=tol,
                                      maxiter=200))
    for x, _ in runs[1:]:
        assert torch.equal(x, runs[0][0])
    assert len({stats["iterations"] for _, stats in runs}) == 1
    np.testing.assert_allclose(runs[0][0].numpy(), np.asarray(want), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(a @ runs[0][0].numpy(), b, atol=10 * tol * np.linalg.norm(b))


def test_bicgstab_maxiter_and_breakdown():
    """The iteration stops at `maxiter`; a zero rhs stops before the first
    iteration; a breakdown sets JAX's code."""
    gen = np.random.default_rng(4)
    a = torch.as_tensor(np.eye(8) * 4 + gen.uniform(-1, 1, (8, 8)))
    b = torch.as_tensor(gen.uniform(-1, 1, 8))
    _, stats = tpoisson.bicgstab(lambda v: a @ v, b, tol=1e-14, maxiter=2)
    assert stats["iterations"] == stats["code"] == 2
    x, stats = tpoisson.bicgstab(lambda v: a @ v, torch.zeros(8, dtype=torch.float64),
                                 tol=1e-10, maxiter=50)
    assert stats["iterations"] == 0 and not x.any()
    # the rotation by 90 degrees: rhat . A p = 0 in the first iteration, so the
    # step is infinite and the iteration ends on a non-finite residual, as JAX's
    import jax.numpy as jnp
    from jax.scipy.sparse.linalg import bicgstab as jax_bicgstab

    rot = np.array([[0.0, -1.0], [1.0, 0.0]])
    want, _ = jax_bicgstab(lambda v: jnp.asarray(rot) @ v, jnp.asarray([1.0, 0.0]), tol=1e-10,
                           maxiter=50)
    got, stats = tpoisson.bicgstab(lambda v: torch.as_tensor(rot) @ v,
                                   torch.as_tensor([1.0, 0.0]).double(), tol=1e-10, maxiter=50)
    assert stats["iterations"] == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
