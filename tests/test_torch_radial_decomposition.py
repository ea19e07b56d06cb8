"""Decomposed polar, spherical and cylindrical grids on the port's plain
sharded stepper (``GridMesh``'s annular blocks, their halo-extended views of
the base grid's class, ``ShardedBoundaries``), against the port's serial
plain run bit for bit and against ``pde_tpu``'s decomposed runs (its plain
``shard_map`` stepper on its 8 virtual CPU devices) at 1e-12, fp64. The cases
are ``tests/parallel/test_radial_decomposition.py``'s; where a decomposed
window would take a cylindrical run through ``solve``, the test calls
``solver._make_fixed_stepper_sharded`` itself (the window is
``tests/test_torch_radial_ext.py``'s). Noisy runs equal the serial plain loop
with the same seed (``pde_tpu``'s streams fold in the shard index, so only its
own check applies to its run)."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.parallel import GridMesh

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
GRIDS = {  # id: (grid of a package, decomposition)
    "polar-4": (lambda p: p.PolarSymGrid(1.0, 64), [4]),
    "polar-8": (lambda p: p.PolarSymGrid(1.0, 64), [8]),
    "spherical-4": (lambda p: p.SphericalSymGrid(1.0, 64), [4]),
    "spherical-hole-4": (lambda p: p.SphericalSymGrid((0.5, 1.5), 64), [4]),
    "cyl-r4z2": (lambda p: p.CylindricalSymGrid(1.0, (0, 2), (32, 16)), [4, 2]),
    "cyl-r8": (lambda p: p.CylindricalSymGrid(1.0, (0, 2), (32, 16)), [8, 1]),
    "cyl-periodic-z-r2z4": (
        lambda p: p.CylindricalSymGrid((0.5, 1.5), (0, 2), (16, 32), periodic_z=True), [2, 4]),
}


def _field(pkg, grid_id, seed=0, rank=0):
    grid = GRIDS[grid_id][0](pkg)
    data = np.random.default_rng(seed).uniform(size=(grid.dim,) * rank + grid.shape)
    kw = {"dtype": torch.float64} if pkg is tpde else {}
    cls = pkg.ScalarField if rank == 0 else pkg.VectorField
    return cls(grid, data, **kw)


def _sharded(eq, state, t_range, dt, decomposition, solver="euler", **kwargs):
    """The port's plain sharded stepper, driven directly (a decomposed window
    takes a cylindrical diffusion run through `solve`)."""
    solver_obj = tpde.solvers.SolverBase.from_name(solver, eq, decomposition=decomposition,
                                                   **kwargs)
    stepper = solver_obj._make_fixed_stepper_sharded(state, dt, solver_obj._get_mesh(state))
    result, t = stepper(state, 0.0, t_range)
    assert t == pytest.approx(t_range)
    assert solver_obj.info["sharded_halo"] >= 1
    return result


def _check(got, serial, jax_run):
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
    np.testing.assert_allclose(got.data.numpy(), np.asarray(jax_run.data), **TOL)


def _pair(make_eq, grid_id, t_range=0.01, dt=1e-4, seed=0, rank=0, **kwargs):
    """(port decomposed, port serial plain, pde_tpu decomposed) of one case."""
    decomposition = GRIDS[grid_id][1]
    state = _field(tpde, grid_id, seed, rank)
    got = _sharded(make_eq(tpde), state, t_range, dt, decomposition, **kwargs)
    serial = make_eq(tpde).solve(state, t_range=t_range, dt=dt, tracker=None, backend="numpy",
                                 **kwargs)
    jax_run = make_eq(jpde).solve(_field(jpde, grid_id, seed, rank), t_range=t_range, dt=dt,
                                  tracker=None, decomposition=decomposition, **kwargs)
    return got, serial, jax_run


@pytest.mark.parametrize("grid_id", GRIDS)
def test_radial_diffusion_matches_jax_and_serial(grid_id):
    bc = ({"r": {"derivative": 0}, "z": "periodic"} if "periodic-z" in grid_id
          else "auto_periodic_neumann")
    _check(*_pair(lambda p: p.DiffusionPDE(0.1, bc=bc), grid_id))


def test_radial_nonconservative_stencil():
    """The naive (non-flux-form) spherical stencil on blocks."""
    with tpde.config({"operators.conservative_stencil": False}), \
            jpde.config({"operators.conservative_stencil": False}):
        _check(*_pair(lambda p: p.DiffusionPDE(0.1), "spherical-4"))


@pytest.mark.parametrize("bc", [
    {"r-": {"derivative": 0}, "r+": {"value": 1.0}},
    {"r-": {"derivative": 0}, "r+": {"type": "mixed", "value": 2.0, "const": 1.0}},
    {"inner": {"curvature": 0.5}, "outer": {"derivative": 0.3}},
], ids=["dirichlet", "robin", "curvature-neumann"])
@pytest.mark.parametrize("grid_id", ["polar-4", "spherical-hole-4", "cyl-r4z2"])
def test_radial_physical_bcs(grid_id, bc):
    """The r sides apply only in the blocks at the global edges (r = 0 or the
    hole's rim, and the outer rim); the blocks between them take their halo."""
    if grid_id.startswith("cyl"):
        bc = {**bc, "z": {"value": -0.5}}
    _check(*_pair(lambda p: p.DiffusionPDE(0.1, bc=bc), grid_id))


def test_time_dependent_side_waits_for_a4():
    """pde_tpu's time-dependent r+ side (`value_expression`, an expression
    condition of A4) on blocks: each view's side reads the step's time."""
    bc = {"r-": {"derivative": 0}, "r+": {"value_expression": "t**2"}}
    _check(*_pair(lambda p: p.DiffusionPDE(0.1, bc=bc), "polar-4"))


@pytest.mark.parametrize("grid_id", ["polar-4", "cyl-r4z2"])
def test_radial_coordinate_dependent_rhs(grid_id):
    """An rhs reading r gets each view's global coordinates."""
    _check(*_pair(lambda p: p.PDE({"u": "laplace(u) + r**2"}), grid_id))


def test_radial_adaptive_rkf45():
    """Adaptive Runge-Kutta-Fehlberg over the blocks of a spherical grid: the
    error maximum over the blocks gives the serial run's steps."""
    state = _field(tpde, "spherical-4")

    def run(pkg, state, **kwargs):
        return pkg.DiffusionPDE(0.1).solve(state, t_range=0.02, solver="runge-kutta",
                                           adaptive=True, tracker=None, ret_info=True, **kwargs)

    (got, info), (serial, serial_info) = run(tpde, state, decomposition=[4]), run(tpde, state)
    jax_run, jax_info = run(jpde, _field(jpde, "spherical-4"), decomposition=[4])
    assert info["solver"]["steps"] == serial_info["solver"]["steps"] > 5
    assert info["solver"]["sharded_halo"] == 1
    _check(got, serial, jax_run)


def _grad_div(pkg):
    class GradDivPDE(pkg.PDEBase):
        def evolution_rate(self, state, t=0):
            grad = state.gradient({"r-": {"derivative": 0}, "r+": {"value": 0}})
            return 0.1 * grad.divergence(
                {"r-": {"normal_derivative": 0}, "r+": {"normal_value": 0}})

    return GradDivPDE()


@pytest.mark.parametrize("grid_id", ["spherical-4", "polar-8"])
def test_radial_operator_chain(grid_id):
    """gradient -> divergence of a custom PDEBase: vector conditions in their
    normal forms on the views, a halo of two operator calls."""
    _check(*_pair(_grad_div, grid_id, t_range=0.005))


def test_cylindrical_vector_laplace():
    """A vector state on cylindrical blocks (components r, z, φ) with the
    normal conditions on r."""
    bc = {"r": {"normal_derivative": 0}, "z": {"value": 0.1}}
    _check(*_pair(lambda p: p.PDE({"u": "0.1 * vector_laplace(u)"}, bc=bc), "cyl-r4z2",
                  t_range=0.002, rank=1))


def test_radial_additive_noise():
    """Additive noise on polar blocks: drawn on the global grid and scaled by
    the global cell volumes, so the run equals the serial plain loop with
    the same seed; pde_tpu's own check (finite values) on its run."""
    state = _field(tpde, "polar-4")
    got = _sharded(tpde.DiffusionPDE(0.1, noise=0.01, rng=np.random.default_rng(3)), state,
                   0.01, 1e-4, [4])
    serial = tpde.DiffusionPDE(0.1, noise=0.01, rng=np.random.default_rng(3)).solve(
        state, t_range=0.01, dt=1e-4, tracker=None, backend="numpy")
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
    assert not np.allclose(got.data.numpy(), tpde.DiffusionPDE(0.1).solve(
        state, t_range=0.01, dt=1e-4, tracker=None).data.numpy())
    jax_run = jpde.DiffusionPDE(0.1, noise=0.01).solve(
        _field(jpde, "polar-4"), t_range=0.01, dt=1e-4, tracker=None, decomposition=[4])
    assert np.all(np.isfinite(np.asarray(jax_run.data)))


def test_radial_integral_in_rhs_waits_for_a9():
    """pde_tpu's test_radial_integral_in_rhs: a global reduction in a
    decomposed plain rhs, each block's partial integral weighted by its own
    rows' cell volumes and summed over the blocks, matches pde_tpu's
    decomposed run at 1e-12 and the serial run to rounding (the partial
    sums run in another order than the serial grid's one sum)."""
    state = _field(tpde, "polar-4")
    eq = tpde.PDE({"u": "laplace(u) - integral(u)"})
    serial = eq.solve(state, t_range=1e-3, dt=1e-4, tracker=None)
    got, info = eq.solve(state, t_range=1e-3, dt=1e-4, tracker=None, decomposition=[4],
                         ret_info=True)
    assert info["solver"]["decomposition"] == [4]
    np.testing.assert_allclose(got.data.numpy(), serial.data.numpy(), rtol=1e-14, atol=1e-14)
    jax_run = jpde.PDE({"u": "laplace(u) - integral(u)"}).solve(
        _field(jpde, "polar-4"), t_range=1e-3, dt=1e-4, tracker=None, decomposition=[4])
    np.testing.assert_allclose(got.data.numpy(), np.asarray(jax_run.data), rtol=1e-12,
                               atol=1e-12)


# -- the pieces ------------------------------------------------------------------------------
@pytest.mark.parametrize("grid_id", GRIDS)
def test_annular_subgrids_match_jax(grid_id):
    """Polar and spherical grids split along r, cylindrical ones along r and
    z (periodic_z kept), into the subgrids pde_tpu builds; split and combine
    round-trip."""
    decomposition = GRIDS[grid_id][1]
    tgrid, jgrid = GRIDS[grid_id][0](tpde), GRIDS[grid_id][0](jpde)
    mesh = GridMesh(tgrid, decomposition)
    jmesh = jpde.GridMesh(jgrid, decomposition)
    for b in range(len(mesh)):
        sub, jsub = mesh.subgrid_for(b), jmesh.subgrid_for(b)
        assert type(sub).__name__ == type(jsub).__name__
        assert sub.state == jsub.state
        np.testing.assert_array_equal(sub.axes_coords[0], jsub.axes_coords[0])
        assert mesh.block_origin(b)[0] == mesh.block_index(b)[0] * mesh.local_shape[0]
    for rank in (0, 1):
        state = _field(tpde, grid_id, rank=rank)
        blocks = mesh.split_field(state)
        assert all(type(f.grid) is type(tgrid) for f in blocks)
        back = mesh.combine_field(blocks)
        assert back.grid is tgrid
        np.testing.assert_array_equal(back.data.numpy(), state.data.numpy())


@pytest.mark.parametrize("grid_id", ["spherical-hole-4", "cyl-periodic-z-r2z4"])
@pytest.mark.parametrize("halo", [1, 3, 9])
def test_views_take_the_global_cells_and_factors(grid_id, halo):
    """A view is a grid of the base grid's class whose coordinates, spacing
    and coordinate-dependent factors are the global grid's at its cells, as
    pde_tpu's bit-identity rule asks; integrate on it is the global
    reduction of the run's GlobalReductions: the block's partial integral of
    its own cells while they record, the total of the blocks' partials
    after, and an error outside a run."""
    from pde_tpu_torch.parallel.mesh import GlobalReductions
    from pde_tpu_torch.grids.base import radial_factor
    from pde_tpu_torch.ops.common import radial_factor_on

    grid = GRIDS[grid_id][0](tpde)
    mesh = GridMesh(grid, GRIDS[grid_id][1])
    compute = lambda rs: (rs + 0.5 * grid.discretization[0]) ** 3 / rs  # noqa: E731
    like = torch.zeros((), dtype=torch.float64)
    for b in range(len(mesh)):
        view = mesh.extended_grid(b, halo)
        assert isinstance(view, type(grid)) and view.mesh is mesh
        for axis in range(grid.num_axes):
            index = view.indices[axis]
            np.testing.assert_array_equal(view.axes_coords[axis], grid.axes_coords[axis][index])
            assert view.at_edge(axis, False) == (not grid.periodic[axis]
                                                 and view.ranges[axis][0] == 0)
        np.testing.assert_array_equal(view.discretization, grid.discretization)
        rows = view.indices[0]
        np.testing.assert_array_equal(radial_factor(view, compute),
                                      radial_factor(grid, compute)[rows])
        np.testing.assert_array_equal(radial_factor_on(view, compute)(like).numpy(),
                                      radial_factor_on(grid, compute)(like).numpy()[rows])
        data = torch.rand(view.shape, dtype=torch.float64)
        with pytest.raises(NotImplementedError, match="needs the run's blocks"):
            view.integrate(data)
        if view.num_axes > 1:
            with pytest.raises(NotImplementedError, match="every axis"):
                view.integrate(data, axes=0)
    # the global reduction over the views of every block: partials, then totals
    reductions = GlobalReductions(mesh)
    views = [mesh.extended_grid(b, halo) for b in range(len(mesh))]
    datas = [torch.rand(view.shape, dtype=torch.float64) for view in views]
    reductions.record()
    partials = []
    for b, (view, data) in enumerate(zip(views, datas, strict=True)):
        view.reductions = reductions
        partials.append(view.integrate(data))
        own = data[(Ellipsis, *view.interior())]
        torch.testing.assert_close(partials[-1], mesh.subgrid_for(b).integrate(own),
                                   rtol=1e-14, atol=0)
    assert reductions.total()
    for view, data in zip(views, datas, strict=True):
        torch.testing.assert_close(view.integrate(data), sum(partials), rtol=0, atol=0)
    reductions.done()


def test_one_dimensional_exchange():
    """The plain pass's exchange on a 1D mesh: each view holds its cells, from
    as many blocks as the halo spans, stopped at the radial edges."""
    from pde_tpu_torch.parallel import HaloExchange

    grid = tpde.PolarSymGrid(1.0, 24)
    mesh = GridMesh(grid, [6])
    data = torch.arange(24, dtype=torch.float64)
    for halo in (1, 4, 9):
        exchange = HaloExchange(mesh, halo, spans=True)
        for b, view in enumerate(exchange.extend(mesh.split_field_data(data))):
            lo, hi = mesh.view_ranges(b, halo)[0]
            assert (lo, hi) == (max(0, 4 * b - halo), min(24, 4 * b + 4 + halo))
            np.testing.assert_array_equal(view.numpy(), np.arange(lo, hi))
