"""The plain decomposed stepper's remaining pieces: global reductions
(``integral``) in a decomposed rhs, anti-periodic conditions on the axes a
mesh cuts, and ``FieldBase.split_mpi``; against ``pde_tpu``'s decomposed runs
on its 8 virtual CPU devices at 1e-12, and against the port's serial runs,
fp64.

A run with a reduction is not bit-equal to the serial run: each block sums
its own cells' partial integral and the partials are added in block order,
where the serial grid sums every cell in one ``sum``; the two orders round
differently, by up to a few units in the last place of the integral (the
largest difference below is asserted at 1e-14, and is 1.1e-16 on these
grids). Anti-periodic runs are bit-equal to serial: the operators negate the
cells across the wrap exactly.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.parallel import GridMesh

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _solve(eq, state, dt, steps, decomposition=None, **kw):
    if decomposition is None:
        return eq.solve(state, t_range=steps * dt, dt=dt, tracker=None, **kw)
    return eq.solve(state, t_range=steps * dt, dt=dt, tracker=None, solver="explicit_sharded",
                    adaptive=False, decomposition=decomposition, **kw)


def _field(pkg, grid, seed):
    data = np.random.default_rng(seed).uniform(0.0, 1.0, grid.shape)
    return pkg.ScalarField(grid, data, **({"dtype": F64} if pkg is tpde else {}))


# -- global reductions -----------------------------------------------------------------------
REDUCTION_GRIDS = {  # id: (grid of a package, decomposition, PDE keywords)
    "cartesian periodic [2, 2]": (lambda p: p.UnitGrid([16, 12], periodic=True), [2, 2], {}),
    "cartesian bounded [4, 2]": (lambda p: p.CartesianGrid([(0, 1), (0, 2)], [16, 12]),
                                 [4, 2], {"bc": {"derivative": 0}}),
    "polar [4]": (lambda p: p.PolarSymGrid(1.0, 64), [4], {}),
    "spherical [4]": (lambda p: p.SphericalSymGrid((0.5, 2.0), 32), [4], {}),
    "cylindrical [2, 2]": (lambda p: p.CylindricalSymGrid(1.0, (0, 2), (16, 12)), [2, 2], {}),
    "1d [4]": (lambda p: p.UnitGrid([32], periodic=True), [4], {}),
}


@pytest.mark.parametrize("grid_id", REDUCTION_GRIDS)
def test_integral_in_a_decomposed_rhs(grid_id):
    """``laplace(u) - integral(u)`` on a mesh: every block reads the global
    integral (its partial, weighted by the global cell volumes of its own
    cells, summed over the blocks), as pde_tpu's test_radial_integral_in_rhs
    psums its shards'; within 1e-12 of pde_tpu's decomposed run and within
    1e-14 of the port's serial run (not bit-equal: see the module's
    docstring)."""
    make_grid, decomposition, kw = REDUCTION_GRIDS[grid_id]
    rhs = {"u": "laplace(u) - integral(u)"}
    state = _field(tpde, make_grid(tpde), 5)
    got, info = _solve(tpde.PDE(rhs, **kw), state, 1e-4, 20, decomposition,
                       ret_info=True)
    assert info["solver"]["decomposition"] == decomposition
    assert info["solver"]["sharded_halo"] == 1
    serial = _solve(tpde.PDE(rhs, **kw), state, 1e-4, 20, backend="numpy")
    difference = float((got.data - serial.data).abs().max())
    assert difference <= 1e-14
    jax_run = _solve(jpde.PDE(rhs, **kw), _field(jpde, make_grid(jpde), 5), 1e-4, 20,
                     decomposition)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(jax_run.data), **TOL)


def test_integrals_of_several_operands_and_fields():
    """Two fields, each rhs with its own reductions (of an expression and of
    an operator's result), read in the order the rhs makes them; the rhs is
    evaluated twice a step, the second time on the totals."""
    rhs = {"u": "0.1 * laplace(u) - integral(u * v) * u",
           "v": "0.1 * laplace(v) + integral(laplace(u)) - integral(v**2) * v"}

    def state(pkg):
        grid = pkg.UnitGrid([16, 16], periodic=True)
        return pkg.FieldCollection([_field(pkg, grid, 1), _field(pkg, grid, 2)],
                                   labels=["u", "v"])

    got = _solve(tpde.PDE(rhs), state(tpde), 1e-3, 10, [2, 2])
    serial = _solve(tpde.PDE(rhs), state(tpde), 1e-3, 10, backend="numpy")
    jax_run = _solve(jpde.PDE(rhs), state(jpde), 1e-3, 10, [2, 2])
    for a, b, c in zip(got, serial, jax_run, strict=True):
        np.testing.assert_allclose(a.data.numpy(), b.data.numpy(), rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(a.data.numpy(), np.asarray(c.data), **TOL)


def test_a_rhs_without_reductions_is_evaluated_once():
    """The first evaluation finds no reduction, and later ones run a single
    pass over the blocks (a plain rhs stays bit-equal to serial)."""
    from pde_tpu_torch.models.base import state_leaves
    from pde_tpu_torch.parallel.stepper import BlockedRun

    state = _field(tpde, tpde.UnitGrid([16, 16], periodic=True), 3)
    for rhs, reduces in (("laplace(u)", False), ("laplace(u) - integral(u)", True)):
        run = BlockedRun(GridMesh(state.grid, [2, 2]), tpde.PDE({"u": rhs}), state)
        calls = []
        for b, fn in enumerate(run._rhs):
            run._rhs[b] = (lambda f: lambda *a: calls.append(1) or f(*a))(fn)
        flat = run.split(state)
        run.rhs(flat, 0.0)
        run.rhs(flat, 0.0)
        assert run._reduces is reduces
        assert len(calls) == (4 * 4 if reduces else 4 + 4)
        rates = run.combine_leaves(run.rhs(flat, 0.0))
        serial = tpde.PDE({"u": rhs}).make_pde_rhs(state)(state_leaves(state), 0.0)
        torch.testing.assert_close(rates[0], serial[0], rtol=1e-14, atol=1e-14)


# -- anti-periodic conditions on cut axes ----------------------------------------------------------
ANTI_RHS = {
    "diffusion": "0.1 * laplace(c)",
    "laplace of an even power": "0.1 * laplace(c**2) - c",
    "a first derivative squared": "0.1 * laplace(c) + 0.1 * d_dx(c)**2",
    "a two-deep rhs": "0.01 * laplace(c**3 - c - 0.01 * laplace(c))",
}
ANTI_MESHES = {  # decomposition: conditions
    "2x1": ([2, 1], {"x": "anti-periodic", "y": "periodic"}),
    "4x1": ([4, 1], {"x": "anti-periodic", "y": "periodic"}),
    "1x2": ([1, 2], {"x": "periodic", "y": "anti-periodic"}),
    "2x2": ([2, 2], {"x": "anti-periodic", "y": "anti-periodic"}),
}


@pytest.mark.parametrize("mesh_id", ANTI_MESHES)
@pytest.mark.parametrize("rhs_id", ANTI_RHS)
def test_anti_periodic_cut_axes(rhs_id, mesh_id):
    """pde_tpu's exchanger negates the cells across the global wrap of a cut
    anti-periodic axis for every operator; the port's operators negate them
    on entry and their results there on exit, so that nonlinear rhs (not odd
    in c) read the serial run's operands: bit-equal to the serial run, within
    1e-12 of pde_tpu's decomposed run. The kernels take no anti-periodic
    axis, so the run is plain."""
    decomposition, bc = ANTI_MESHES[mesh_id]
    rhs = {"c": ANTI_RHS[rhs_id]}

    def state(pkg):
        return _field(pkg, pkg.UnitGrid([16, 16], periodic=True), 4)

    got, info = _solve(tpde.PDE(rhs, bc=bc), state(tpde), 1e-3, 10, decomposition,
                       ret_info=True)
    assert "fused_step" not in info["solver"]
    serial = _solve(tpde.PDE(rhs, bc=bc), state(tpde), 1e-3, 10, backend="numpy")
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
    jax_run = _solve(jpde.PDE(rhs, bc=bc), state(jpde), 1e-3, 10, decomposition)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(jax_run.data), **TOL)


def test_anti_periodic_diffusion_on_a_mesh_under_both_engines():
    """``DiffusionPDE`` with an anti-periodic cut axis: the torch engine runs
    the plain sharded stepper, bit-equal to serial; the cuda engine names the
    kernels' refusal."""
    state = _field(tpde, tpde.UnitGrid([16, 12], periodic=True), 6)
    eq = tpde.DiffusionPDE(0.1, bc={"x": "anti-periodic", "y": "periodic"})
    got, info = eq.solve(state, t_range=0.05, dt=0.01, tracker=None, decomposition=[2, 1],
                         ret_info=True)
    assert "Anti-periodic" in info["solver"]["fused_unsupported"]
    serial = eq.solve(state, t_range=0.05, dt=0.01, tracker=None)
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
    with pytest.raises(RuntimeError, match="Anti-periodic"):
        eq.solve(state, t_range=0.05, dt=0.01, tracker=None, decomposition=[2, 1],
                 backend="cuda")


# -- split_mpi -------------------------------------------------------------------------------------
def _split_states(pkg):
    grid = pkg.UnitGrid([16, 12], periodic=True)
    gen = np.random.default_rng(9)
    kw = {"dtype": F64} if pkg is tpde else {}
    scalar = pkg.ScalarField(grid, gen.random((16, 12)), **kw)
    return {
        "scalar": scalar,
        "vector": pkg.VectorField(grid, gen.random((2, 16, 12)), **kw),
        "tensor": pkg.Tensor2Field(grid, gen.random((2, 2, 16, 12)), **kw),
        "collection": pkg.FieldCollection([scalar, pkg.ScalarField(grid, gen.random((16, 12)),
                                                                   **kw)], labels=["a", "b"]),
    }


@pytest.mark.parametrize("decomposition", ["auto", 2, 4, [2, 2]], ids=str)
@pytest.mark.parametrize("kind", ["scalar", "vector", "tensor", "collection"])
def test_split_mpi(kind, decomposition):
    """``split_mpi`` takes pde_tpu's arguments and chooses its decomposition
    ("auto" over the eight devices, or a device count); the copy holds data
    equal to the field's on the same grid, on the mesh's first device, and
    keeps the mesh, which ``GridMesh.combine_field`` takes back."""
    field, jax_field = _split_states(tpde)[kind], _split_states(jpde)[kind]
    split = field.split_mpi(decomposition)
    jax_split = jax_field.split_mpi(decomposition)
    jax_mesh = jpde.GridMesh.from_grid(jax_field.grid, decomposition)
    assert split.mesh.decomposition == list(jax_mesh.decomposition)
    assert split is not field and split.grid is field.grid and split.device == field.device
    if kind == "collection":
        assert all(f.mesh is split.mesh for f in split)
        pairs = zip(split, jax_split, strict=True)
    else:
        pairs = [(split, jax_split)]
    for part, jax_part in pairs:
        np.testing.assert_array_equal(part.data.numpy(), np.asarray(jax_part.data))
    back = split.mesh.combine_field(split)
    assert not hasattr(back, "mesh") and type(back) is type(field)
    np.testing.assert_array_equal(back.data.numpy() if kind != "collection" else
                                  back[0].data.numpy(),
                                  field.data.numpy() if kind != "collection" else
                                  field[0].data.numpy())
    with pytest.raises(ValueError, match="not placed on this mesh"):
        GridMesh.from_grid(field.grid, [2, 1]).combine_field(split)


def test_split_field_runs_on_its_mesh():
    """A solver with ``decomposition="auto"`` takes a split field's mesh;
    the run equals the serial one."""
    state = _split_states(tpde)["scalar"]
    split = state.split_mpi([4, 1])
    eq = tpde.PDE({"c": "0.1 * laplace(c) - c**3"})
    got, info = eq.solve(split, t_range=0.01, dt=1e-3, tracker=None, decomposition="auto",
                         ret_info=True)
    assert info["solver"]["decomposition"] == [4, 1]
    serial = eq.solve(state, t_range=0.01, dt=1e-3, tracker=None)
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
