"""The port's plain sharded stepper (``ShardedBoundaries``, the blocks'
halo-extended views of ``parallel/stepper.py``) and adaptive steps over blocks,
against ``pde_tpu``'s decomposed runs on its virtual 8-device CPU mesh (its
plain ``shard_map`` stepper) at 1e-12 and against the port's serial plain run
bit for bit, fp64. The cases mirror ``tests/parallel/test_sharded.py``; where
a decomposed window would take the run, the test calls
``solver._make_fixed_stepper_sharded`` itself. Noisy runs equal the serial
plain loop with the same seed and pass ``pde_tpu``'s own checks (its stream
folds in the shard index, so the two packages' noise differs)."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.parallel import GridMesh, HaloExchange, ShardedBoundaries

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
CAHN_HILLIARD = {"c": "laplace(c**3 - c - laplace(c))"}
CONFIG3_BC = {"x": "periodic", "y-": {"value": 0}, "y+": {"derivative": 0}}


def _leaves(state):
    fields = list(state) if hasattr(state, "fields") else [state]
    return [np.asarray(f.data) for f in fields]


def _state(pkg, shape, periodic=True, seed=0, low=0.0, high=1.0, kind="scalar",
           bounds=None):
    grid = (pkg.CartesianGrid(bounds, list(shape), periodic=periodic) if bounds
            else pkg.UnitGrid(list(shape), periodic=periodic))
    gen = np.random.default_rng(seed)
    kw = {"dtype": torch.float64} if pkg is tpde else {}
    if kind == "vector":
        return pkg.VectorField(grid, gen.uniform(low, high, (len(shape), *shape)), **kw)
    fields = [pkg.ScalarField(grid, gen.uniform(low, high, shape), label=label, **kw)
              for label in ("uv" if kind == "pair" else "c")]
    return fields[0] if len(fields) == 1 else pkg.FieldCollection(fields)


def _plain_sharded(eq, state, t_range, dt, decomposition, solver="euler"):
    """The port's plain sharded stepper driven directly (a decomposed window
    would take the run through `solve`)."""
    solver_obj = tpde.solvers.SolverBase.from_name(solver, eq, decomposition=decomposition)
    stepper = solver_obj._make_fixed_stepper_sharded(state, dt, solver_obj._get_mesh(state))
    result, t = stepper(state, 0.0, t_range)
    assert t == pytest.approx(t_range)
    return result, solver_obj.info


def _assert_leaves(got, want, exact: bool):
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **TOL)


# label -> (equation(pkg), (shape, state kwargs), t_range, dt, decomposition,
#           solver, through `solve` (else the stepper directly))
CASES = {
    # tests/parallel/test_sharded.py:48-58 on a 16x12 grid, every cut form
    **{f"diffusion periodic {dec}": (
        lambda p: p.DiffusionPDE(0.2), ((16, 12), {}), 0.5, 0.01, dec, "euler", False)
       for dec in ([2, 1], [1, 2], [2, 2], [4, 2], 2, -1)},
    "diffusion dirichlet [2, 2]": (
        lambda p: p.DiffusionPDE(0.2, bc={"value": 0.5}), ((16, 12), {"periodic": False}),
        0.5, 0.01, [2, 2], "euler", False),
    "diffusion mixed sides [4, 2]": (
        lambda p: p.DiffusionPDE(0.2, bc={"x": "periodic", "y-": {"value": 1},
                                          "y+": {"derivative": 0}}),
        ((16, 12), {"periodic": [True, False]}), 0.5, 0.01, [4, 2], "euler", False),
    # :76-85, through the plain stepper
    "cahn-hilliard [2, 2]": (
        lambda p: p.PDE(CAHN_HILLIARD), ((16, 16), {"low": -0.1, "high": 0.1}), 0.2, 0.005,
        [2, 2], "explicit_mpi", False),
    # :251-262, :265-278 (the vector case is a custom PDEBase below)
    "two fields [2, 2]": (
        lambda p: p.PDE({"u": "0.1 * laplace(u) + v - u", "v": "0.2 * laplace(v) - v + u"}),
        ((16, 16), {"kind": "pair"}), 0.1, 0.01, [2, 2], "explicit_sharded", False),
    "vector_laplace [2, 2]": (
        lambda p: p.PDE({"u": "0.3 * vector_laplace(u)"}), ((16, 16), {"kind": "vector"}),
        0.1, 0.01, [2, 2], "explicit_sharded", True),
    # :237-248
    "rk4 [2, 2]": (lambda p: p.DiffusionPDE(0.2), ((16, 16), {}), 0.1, 0.01, [2, 2],
                   "runge-kutta", False),
    "ab2 [2, 2]": (lambda p: p.DiffusionPDE(0.2), ((16, 16), {}), 0.1, 0.01, [2, 2],
                   "adams-bashforth", False),
    # :198-234, through the plain stepper (`solve` takes the decomposed side-input
    # windows, tests/test_torch_sharded_sides.py)
    "array bc values [2, 2]": (
        lambda p: p.DiffusionPDE(0.2, bc={"x-": {"value": np.linspace(0.0, 2.0, 16)},
                                          "x+": {"derivative": 0}, "y": {"derivative": 0}}),
        ((16, 16), {"periodic": False, "bounds": [(0, 1), (0, 1)]}), 0.1, 0.005, [2, 2],
        "explicit_sharded", False),
    "array robin values [4, 2]": (
        lambda p: p.PDE({"c": "0.1 * laplace(c) - c**2"}, bc={
            "x": {"type": "mixed", "value": np.linspace(0.5, 1.5, 12), "const": 0.2},
            "y-": {"curvature": np.linspace(-1, 1, 16)}, "y+": {"value": 1.0}}),
        ((16, 12), {"periodic": False}), 0.05, 0.005, [4, 2], "explicit_sharded", False),
    # an rhs reading x across the periodic wrap (the halo's x is the wrapped cell's)
    "laplace(x * c) [4, 2]": (
        lambda p: p.PDE({"c": "laplace(x * c) - c"}), ((16, 12), {"bounds": [(0, 2), (0, 1)]}),
        0.05, 1e-3, [4, 2], "explicit_sharded", True),
    "laplace(c) + x * c [2, 2]": (
        lambda p: p.PDE({"c": "laplace(c) + x * c"}), ((16, 12), {"bounds": [(0, 2), (0, 1)]}),
        0.05, 1e-3, [2, 2], "explicit_sharded", True),
    # blocks of one row: the halo of Cahn-Hilliard comes from two blocks a side
    "cahn-hilliard (8, 1) blocks": (
        lambda p: p.PDE(CAHN_HILLIARD), ((8, 16), {"low": -0.1, "high": 0.1}), 0.01, 1e-3,
        [8, 1], "explicit_sharded", True),
    "cahn-hilliard no-flux (1, 6) blocks": (
        lambda p: p.PDE(CAHN_HILLIARD, bc={"derivative": 0}),
        ((4, 12), {"periodic": False, "low": -0.1, "high": 0.1}), 0.01, 1e-3, [4, 2],
        "explicit_sharded", True),
    "diffusion 3d [2, 2, 2]": (
        lambda p: p.DiffusionPDE(0.1, bc={"x": {"value": 0.5}, "y": "periodic",
                                          "z": {"derivative": 0.1}}),
        ((8, 8, 8), {"periodic": [False, True, False]}), 0.05, 0.01, [2, 2, 2],
        "explicit_sharded", False),
}


@pytest.mark.parametrize("case", CASES)
def test_plain_sharded_matches_jax_and_serial(case):
    make_eq, (shape, kwargs), t_range, dt, decomposition, solver, through_solve = CASES[case]
    state = _state(tpde, shape, **kwargs)
    eq = make_eq(tpde)
    if through_solve:
        got, info = eq.solve(state, t_range=t_range, dt=dt, solver=solver, tracker=None,
                             decomposition=decomposition, ret_info=True)
        info = info["solver"]
        assert "fused_step" not in info and info["sharded_halo"] >= 1
    else:
        got, info = _plain_sharded(eq, state, t_range, dt, decomposition, solver)
    serial = make_eq(tpde).solve(state, t_range=t_range, dt=dt, tracker=None, backend="numpy",
                                 solver=solver if solver in ("runge-kutta", "adams-bashforth")
                                 else "euler")
    _assert_leaves(got, serial, exact=True)
    jax_solver = solver if solver in ("runge-kutta", "adams-bashforth") else "explicit_sharded"
    jax_decomposition = "auto" if decomposition == -1 else decomposition
    kw = {"adaptive": False} if jax_solver == "explicit_sharded" else {}
    jax_run = make_eq(jpde).solve(_state(jpde, shape, **kwargs), t_range=t_range, dt=dt,
                                  tracker=None, solver=jax_solver,
                                  decomposition=jax_decomposition, **kw)
    _assert_leaves(got, jax_run, exact=False)
    assert info["decomposition"] == GridMesh.from_grid(state.grid, decomposition).decomposition


def test_vector_state_of_a_python_rhs():
    """tests/parallel/test_sharded.py:265-278: a custom PDEBase's vector rhs;
    its halo is counted from the operator calls of one evaluation."""

    def make(pkg):
        class VectorDiffusion(pkg.PDEBase):
            def evolution_rate(self, s, t=0):
                return 0.3 * s.laplace("periodic")

        return VectorDiffusion()

    state = _state(tpde, (16, 16), kind="vector")
    got, info = make(tpde).solve(state, t_range=0.1, dt=0.01, solver="explicit_sharded",
                                 decomposition=[2, 2], tracker=None, ret_info=True)
    assert info["solver"]["sharded_halo"] == 1
    _assert_leaves(got, make(tpde).solve(state, t_range=0.1, dt=0.01, tracker=None), True)
    jax_run = make(jpde).solve(_state(jpde, (16, 16), kind="vector"), t_range=0.1, dt=0.01,
                               solver="explicit_sharded", adaptive=False,
                               decomposition=[2, 2], tracker=None)
    _assert_leaves(got, jax_run, exact=False)


@pytest.mark.parametrize("decomposition", [[2, 1], [1, 2], [2, 2], [4, 1]])
def test_nine_point_corner_weight(decomposition):
    """:334-385: the 9-point Laplacian on a mesh. Row cuts take #12's 9-point
    mode, bit-equal to the serial window (#1's); a cut of the columns refuses
    it, as pde_tpu does, and takes the plain sharded stepper, where the
    serial corner rule on each view is exact wherever an interior cell reads
    a corner (bit-equal to the serial plain loop)."""
    state = _state(tpde, (16, 16))
    row_cut = decomposition[1] == 1
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 1 / 3}):
        got, info = tpde.DiffusionPDE(0.1).solve(state, t_range=0.05, dt=1e-3, tracker=None,
                                                 decomposition=decomposition, ret_info=True)
        if row_cut:
            assert info["solver"]["fused_step"] is True
        else:
            assert "5856-5867" in info["solver"]["fused_unsupported"]
        serial = tpde.DiffusionPDE(0.1).solve(state, t_range=0.05, dt=1e-3, tracker=None,
                                              backend="torch" if row_cut else "numpy")
    with jpde.config({"operators.cartesian.laplacian_2d_corner_weight": 1 / 3}):
        jax_run = jpde.DiffusionPDE(0.1).solve(_state(jpde, (16, 16)), t_range=0.05, dt=1e-3,
                                               tracker=None, solver="explicit_sharded",
                                               adaptive=False, decomposition=decomposition)
    _assert_leaves(got, serial, exact=True)
    _assert_leaves(got, jax_run, exact=False)


def test_post_step_hook_runs_per_block():
    def hook(data, t):
        return data.clip(0.2, 0.8)

    state = _state(tpde, (16, 12))
    eq = tpde.PDE({"c": "laplace(c) + 0.5 * c"}, post_step_hook=hook)
    got, info = eq.solve(state, t_range=0.1, dt=0.01, decomposition=[4, 2], tracker=None,
                         ret_info=True)
    assert info["solver"]["fused_unsupported"] == "the PDE has a post-step hook"
    _assert_leaves(got, eq.solve(state, t_range=0.1, dt=0.01, tracker=None), exact=True)
    jax_run = jpde.PDE({"c": "laplace(c) + 0.5 * c"}, post_step_hook=hook).solve(
        _state(jpde, (16, 12)), t_range=0.1, dt=0.01, solver="explicit_sharded",
        adaptive=False, decomposition=[4, 2], tracker=None)
    _assert_leaves(got, jax_run, exact=False)


def test_field_constant_is_sliced_to_the_blocks():
    gen = np.random.default_rng(9)

    def run(pkg, **kwargs):
        state = _state(pkg, (16, 12))
        kw = {"dtype": torch.float64} if pkg is tpde else {}
        k = pkg.ScalarField(state.grid, gen_data, **kw)
        eq = pkg.PDE({"c": "laplace(c) - k * c"}, consts={"k": k})
        return eq.solve(state, t_range=0.05, dt=0.01, tracker=None, **kwargs)

    gen_data = gen.random((16, 12))
    got = run(tpde, decomposition=[4, 2])
    _assert_leaves(got, run(tpde), exact=True)
    _assert_leaves(got, run(jpde, solver="explicit_sharded", adaptive=False,
                            decomposition=[4, 2]), exact=False)


def test_adaptive_euler_over_blocks():
    """:60-73: the error maximum over the blocks gives serial's steps."""
    state = _state(tpde, (16, 12))
    got, info = tpde.DiffusionPDE(0.2).solve(
        state, t_range=0.5, solver="explicit_sharded", adaptive=True, tolerance=1e-5,
        decomposition=[4, 2], tracker=None, ret_info=True)
    serial, serial_info = tpde.DiffusionPDE(0.2).solve(
        state, t_range=0.5, solver="euler", adaptive=True, tolerance=1e-5, tracker=None,
        ret_info=True)
    jax_run, jax_info = jpde.DiffusionPDE(0.2).solve(
        _state(jpde, (16, 12)), t_range=0.5, solver="explicit_sharded", adaptive=True,
        tolerance=1e-5, decomposition=[4, 2], tracker=None, ret_info=True)
    steps = info["solver"]["steps"]
    assert steps == serial_info["solver"]["steps"] == jax_info["solver"]["steps"] > 10
    assert info["solver"]["dt"] == serial_info["solver"]["dt"]
    _assert_leaves(got, serial, exact=True)
    _assert_leaves(got, jax_run, exact=False)


def test_adaptive_rkf45_swift_hohenberg_over_blocks():
    """Config 3's Swift-Hohenberg with its mixed sides, RKF45 on [2, 2]."""

    def run(pkg, **kwargs):
        state = _state(pkg, (16, 12), periodic=[True, False], low=-0.1, high=0.1)
        return pkg.SwiftHohenbergPDE(rate=0.1, bc=CONFIG3_BC).solve(
            state, t_range=2.0, solver="runge-kutta", tolerance=1e-6, tracker=None,
            ret_info=True, **kwargs)

    (got, info), (serial, serial_info) = run(tpde, decomposition=[2, 2]), run(tpde)
    jax_run, jax_info = run(jpde, decomposition=[2, 2])
    steps = info["solver"]["steps"]
    assert steps == serial_info["solver"]["steps"] == jax_info["solver"]["steps"] > 10
    assert info["solver"]["sharded_halo"] == 2
    _assert_leaves(got, serial, exact=True)
    _assert_leaves(got, jax_run, exact=False)


def test_kpz_with_noise_is_config_5():
    """BASELINE config 5 (:88-101): KPZ with noise on [4, 2] equals the serial
    plain loop with the same seed, and passes pde_tpu's checks."""
    state = _state(tpde, (16, 16), low=0.0, high=0.0)
    got, info = tpde.KPZInterfacePDE(noise=0.1, rng=np.random.default_rng(5)).solve(
        state, t_range=0.5, dt=0.01, solver="explicit_sharded", decomposition=[4, 2],
        tracker=None, ret_info=True)
    assert info["solver"]["fused_unsupported"] == "Sharded fused windows do not support noise"
    assert info["solver"]["sharded_halo"] == 1
    serial = tpde.KPZInterfacePDE(noise=0.1, rng=np.random.default_rng(5)).solve(
        state, t_range=0.5, dt=0.01, tracker=None, backend="numpy")
    _assert_leaves(got, serial, exact=True)
    data = got.data.numpy()
    assert np.all(np.isfinite(data)) and data.std() > 0.01
    assert not np.allclose(data[:8, :8], data[8:, :8])


def test_3d_diffusion_with_noise():
    state = _state(tpde, (8, 8, 8))
    got = tpde.DiffusionPDE(0.1, noise=0.1, rng=np.random.default_rng(2)).solve(
        state, t_range=0.05, dt=0.01, decomposition=[2, 1, 1], tracker=None)
    serial = tpde.DiffusionPDE(0.1, noise=0.1, rng=np.random.default_rng(2)).solve(
        state, t_range=0.05, dt=0.01, tracker=None, backend="numpy")
    _assert_leaves(got, serial, exact=True)
    assert np.all(np.isfinite(got.data.numpy()))
    assert not np.allclose(got.data.numpy()[:4], got.data.numpy()[4:])


def test_consistency_tracker_windows_on_a_mesh():
    """Trackers interrupt the plain sharded stepper: windows of 3 and 4 steps
    (AB2's previous rates carry over, per block) equal one serial run."""
    from pde_tpu_torch.trackers.interrupts import ConstantInterrupts

    state = _state(tpde, (16, 12), low=-0.5, high=0.5)
    eq = tpde.PDE({"c": "0.1 * laplace(c) + c - c**3"}, post_step_hook=lambda d, t: d)
    for solver in ("euler", "adams-bashforth"):
        tracker = tpde.ConsistencyTracker(interrupts=ConstantInterrupts(0.03))
        got, info = eq.solve(state, t_range=0.1, dt=0.01, solver=solver, tracker=tracker,
                             decomposition=[2, 2], ret_info=True)
        assert info["solver"]["steps"] == 10
        serial = eq.solve(state, t_range=0.1, dt=0.01, solver=solver, tracker=None)
        _assert_leaves(got, serial, exact=True)


def test_implicit_solvers_wait_for_their_port():
    """:237-248's implicit and Crank-Nicolson cases: both run on the plain
    sharded stepper, bit-equal to their serial runs and within 1e-12 of
    pde_tpu's decomposed runs; an unknown name stays a ValueError."""
    state = _state(tpde, (16, 16))
    jstate = _state(jpde, (16, 16))
    for solver in ("implicit", "crank-nicolson"):
        serial = tpde.DiffusionPDE(0.2).solve(state, t_range=0.1, dt=0.01, solver=solver,
                                              tracker=None)
        got, info = tpde.DiffusionPDE(0.2).solve(state, t_range=0.1, dt=0.01, solver=solver,
                                                 tracker=None, decomposition=[2, 2],
                                                 ret_info=True)
        assert info["solver"]["sharded_halo"] == 1
        _assert_leaves(got, serial, exact=True)
        jax_run = jpde.DiffusionPDE(0.2).solve(jstate, t_range=0.1, dt=0.01, solver=solver,
                                               tracker=None, decomposition=[2, 2])
        _assert_leaves(got, jax_run, exact=False)
    with pytest.raises(ValueError, match="Unknown solver"):
        tpde.DiffusionPDE(0.2).solve(state, t_range=0.1, dt=0.01, solver="no-such-solver")


def test_cuda_engine_raises_where_only_the_plain_stepper_runs():
    state = _state(tpde, (16, 16), low=0.0, high=0.0)
    with pytest.raises(RuntimeError, match="do not support noise"):
        tpde.KPZInterfacePDE(noise=0.1).solve(state, t_range=0.1, dt=0.01, backend="cuda",
                                              decomposition=[2, 2], tracker=None)
    with pytest.raises(RuntimeError, match="no adaptive-dt kernel path"):
        tpde.DiffusionPDE(0.1).solve(state, t_range=0.1, backend="cuda",
                                     decomposition=[2, 2], tracker=None)
    with pytest.raises(RuntimeError, match="backend='numpy'"):
        tpde.KPZInterfacePDE(noise=0.1).solve(state, t_range=0.1, dt=0.01, backend="numpy",
                                              decomposition=[2, 2], tracker=None)


# -- the pieces ------------------------------------------------------------------------------
@pytest.mark.parametrize("shape, decomposition, periodic, halo", [
    ((16, 12), [4, 2], (True, True), 1),
    ((16, 12), [8, 1], (True, True), 5),
    ((16, 12), [4, 3], (False, True), 6),
    ((8, 6, 10), [2, 3, 2], (True, False, True), 3),
])
def test_extended_views(shape, decomposition, periodic, halo):
    """Each view holds the global cells of its ranges (wrapped on cut
    periodic axes, clipped at global edges, whole on uncut periodic axes),
    from as many blocks as the halo spans; its grid's coordinates are those
    cells'."""
    grid = tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)][: len(shape)], shape,
                              periodic=list(periodic))
    mesh = GridMesh(grid, decomposition, devices=["cpu"] * 12)
    data = torch.tensor(np.random.default_rng(3).random((2, *shape)))
    exchange = HaloExchange(mesh, halo, spans=True)
    copies = HaloExchange.copies
    views = exchange.extend(mesh.split_field_data(data))
    assert HaloExchange.copies - copies == sum(len(exchange.view_pieces(b))
                                               for b in range(len(mesh)))
    for b, view in enumerate(views):
        vgrid = mesh.extended_grid(b, halo)
        index = np.ix_(*vgrid.indices)
        np.testing.assert_array_equal(view.numpy(), data.numpy()[(slice(None), *index)])
        np.testing.assert_array_equal(vgrid.restrict(data).numpy(), view.numpy())
        for axis, (lo, hi) in enumerate(vgrid.ranges):
            i, n, d = mesh.block_index(b)[axis], mesh.local_shape[axis], decomposition[axis]
            if periodic[axis] and d == 1:
                assert (lo, hi) == (0, n)
            elif periodic[axis]:
                assert (lo, hi) == (i * n - halo, (i + 1) * n + halo)
            else:
                assert (lo, hi) == (max(0, i * n - halo), min(n * d, (i + 1) * n + halo))
                assert vgrid.at_edge(axis, False) == (lo == 0)
            np.testing.assert_array_equal(vgrid.axes_coords[axis],
                                          grid.axes_coords[axis][vgrid.indices[axis]])
        np.testing.assert_array_equal(vgrid.discretization, grid.discretization)


def test_sharded_boundaries():
    grid = tpde.UnitGrid([16, 12], periodic=[False, True])
    mesh = GridMesh(grid, [4, 1])
    values = np.linspace(0, 1, 12)
    bcs = grid.get_boundary_conditions({"x-": {"value": values}, "x+": {"derivative": 2}})
    top, middle = (mesh.extract_boundary_conditions(bcs, b, halo=2) for b in (0, 2))
    assert isinstance(top, ShardedBoundaries)
    assert top.grid.shape == (6, 12) and middle.grid.shape == (8, 12)
    assert top.grid.get_boundary_conditions(bcs) == top
    assert top.grid.get_boundary_conditions(top) is top
    assert top.get_mathematical_representation("c").splitlines()[-1] == "c(y=0.0) = c(y=12.0)"
    # the view of block 0 stops at x = 0, where the Dirichlet ghost is set from the
    # values of its columns; block 2's view has no global edge and sets no x ghost;
    # the uncut periodic axis wraps in both
    view = torch.arange(6.0 * 12).reshape(6, 12).double()
    out = top.make_ghost_setter()(torch.nn.functional.pad(view, (1, 1, 1, 1)))
    torch.testing.assert_close(out[0, 1:-1], 2 * torch.tensor(values) - view[0])
    torch.testing.assert_close(out[1:-1, 0], view[:, -1])
    inner = middle.make_ghost_setter()(torch.nn.functional.pad(
        torch.ones(8, 12).double(), (1, 1, 1, 1)))
    assert float(inner[0, 1:-1].abs().max()) == 0 == float(inner[-1, 1:-1].abs().max())
    assert float(inner[1:-1, 0].min()) == 1
    with pytest.raises(NotImplementedError, match="per-axis"):
        ShardedBoundaries(top.grid, {"x": "periodic"})
    # a cut anti-periodic axis: no ghost setter there, the view's cells past the
    # global wrap flipped for the operators; an integral needs the run's blocks
    anti = tpde.UnitGrid([16, 12], periodic=True).get_boundary_conditions("anti-periodic")
    cut = GridMesh(tpde.UnitGrid([16, 12], periodic=True), [2, 1])
    first = cut.extract_boundary_conditions(anti, 0, halo=1)
    assert first.make_ghost_setter() is not None
    np.testing.assert_array_equal(first.flip[:, 0], [-1.0] + [1.0] * 9)
    assert first.flip.shape == first.grid.shape == (10, 12)
    assert cut.extract_boundary_conditions(
        tpde.UnitGrid([16, 12], periodic=True).get_boundary_conditions("periodic"), 0,
        halo=1).flip is None
    with pytest.raises(NotImplementedError, match="needs the run's blocks"):
        top.grid.integrate(torch.zeros(top.grid.shape))


def test_anti_periodic_on_an_uncut_axis():
    """An anti-periodic axis the mesh does not cut wraps locally, sign and
    all. The kernels take no anti-periodic axis: the serial Euler window
    refuses it (it used to run it as periodic) and both runs are plain."""
    state = tpde.ScalarField(tpde.UnitGrid([16, 12], periodic=True),
                             np.random.default_rng(4).random((16, 12)), dtype=torch.float64)
    eq = tpde.DiffusionPDE(0.1, bc={"x": "periodic", "y": "anti-periodic"})
    got, info = eq.solve(state, t_range=0.05, dt=0.01, decomposition=[4, 1], tracker=None,
                         ret_info=True)
    serial, serial_info = eq.solve(state, t_range=0.05, dt=0.01, tracker=None, ret_info=True)
    for run in (info, serial_info):
        assert "Anti-periodic" in run["solver"]["fused_unsupported"]
    assert info["solver"]["sharded_halo"] == 1
    _assert_leaves(got, serial, exact=True)
    _assert_leaves(got, eq.solve(state, t_range=0.05, dt=0.01, tracker=None, backend="numpy"),
                   exact=True)
    jax_run = jpde.DiffusionPDE(0.1, bc={"x": "periodic", "y": "anti-periodic"}).solve(
        jpde.ScalarField(jpde.UnitGrid([16, 12], periodic=True),
                         np.random.default_rng(4).random((16, 12))),
        t_range=0.05, dt=0.01, tracker=None, solver="explicit_sharded", adaptive=False,
        decomposition=[4, 1])
    _assert_leaves(got, jax_run, exact=False)


def test_rhs_halo():
    from pde_tpu_torch.parallel.stepper import rhs_halo

    state = _state(tpde, (16, 12))
    assert rhs_halo(tpde.PDE(CAHN_HILLIARD), state) == 2
    assert rhs_halo(tpde.KPZInterfacePDE(), state) == 1  # the lowering's depth
    assert rhs_halo(tpde.PDE({"c": "laplace(c) + x * c"}), state) == 1  # counted
    assert rhs_halo(tpde.PDE({"c": "-c"}), state) == 0
    hooked = tpde.SwiftHohenbergPDE(bc="periodic", bc_lap={"x": "periodic", "y": "periodic"})
    assert rhs_halo(hooked, state) == 2
