"""Decomposed fixed-dt Euler runs of the port (``decomposition=``,
``solver="explicit_sharded"``) against ``pde_tpu``'s decomposed fused runs on
its virtual 8-device CPU mesh (kernels #12 and #8 in interpret mode) and
against the port's serial run, fp64, at 1e-12 (bit-equal to serial in
practice). The cases mirror ``tests/parallel/test_sharded.py``; then the
solver names, and the configurations a decomposed window does not take,
which run on the plain sharded stepper under the torch engine and raise
under the cuda engine."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers.controller import Controller as JaxController
from pde_tpu.solvers.euler import EulerSolver as JaxEulerSolver
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.parallel import HaloExchange

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
COUPLED = {
    "u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
    "v": "0.05 * laplace(v) + u - u**2 * v",
}
CAHN_HILLIARD = {"c": "laplace(0.5 * c**3 - c - 0.1 * laplace(c))"}


def _state(pkg, grid, n_fields, seed, low=0.0, high=1.0):
    gen = np.random.default_rng(seed)
    fields = [
        pkg.ScalarField(grid, gen.uniform(low, high, grid.shape), label=label,
                        **({"dtype": torch.float64} if pkg is tpde else {}))
        for label in "uv"[:n_fields]
    ]
    return fields[0] if n_fields == 1 else pkg.FieldCollection(fields)


def _leaves(state):
    fields = list(state) if hasattr(state, "fields") else [state]
    return [np.asarray(f.data) for f in fields]


# (pde_tpu test, grid args, grid kwargs, equation(pkg), fields, t_range, dt, decomposition)
CASES = {
    # tests/parallel/test_sharded.py:142
    "diffusion [2, 1]": (([(0, 2), (0, 1)], (16, 16)), {"periodic": True},
                         lambda p: p.DiffusionPDE(0.1), 1, 0.2, 0.01, [2, 1]),
    "diffusion [1, 2]": (([(0, 2), (0, 1)], (16, 16)), {"periodic": True},
                         lambda p: p.DiffusionPDE(0.1), 1, 0.2, 0.01, [1, 2]),
    "diffusion [2, 2]": (([(0, 2), (0, 1)], (16, 16)), {"periodic": True},
                         lambda p: p.DiffusionPDE(0.1), 1, 0.2, 0.01, [2, 2]),
    "diffusion [4, 2]": (([(0, 2), (0, 1)], (16, 16)), {"periodic": True},
                         lambda p: p.DiffusionPDE(0.1), 1, 0.2, 0.01, [4, 2]),
    # :165, three steps: the k = 2 and k = 1 passes of the ladder
    "remainder steps": (([(0, 16), (0, 16)], (16, 16)), {"periodic": True},
                        lambda p: p.DiffusionPDE(0.05), 1, 0.03, 0.01, [2, 2]),
    # :307
    "diffusion bcs": (
        ([(0, 1), (0, 2)], (16, 16)), {"periodic": False},
        lambda p: p.DiffusionPDE(0.05, bc={"x-": {"value": 1}, "x+": {"derivative": 0},
                                           "y": {"type": "mixed", "value": 1.0, "const": 0.5}}),
        1, 0.002, 1e-4, [2, 2]),
    # :387, rows cut
    "coupled rows": (([(0, 16), (0, 16)], (16, 16)), {"periodic": True},
                     lambda p: p.PDE(COUPLED), 2, 0.05, 1e-3, [4, 1]),
    # :437, columns cut
    "coupled columns": (([(0, 16), (0, 16)], (16, 16)), {"periodic": True},
                        lambda p: p.PDE(COUPLED), 2, 0.02, 1e-3, [1, 2]),
    # :473
    "coupled physical bcs": (
        ([(0, 1), (0, 2)], (16, 16)), {"periodic": False},
        lambda p: p.PDE(COUPLED, bc={"x": {"value": 0.2}, "y": {"derivative": 0.1}}),
        2, 0.02, 1e-3, [2, 2]),
    # :508
    "cahn-hilliard no-flux columns": (
        ([(0, 16), (0, 16)], (16, 16)), {"periodic": False},
        lambda p: p.PDE(CAHN_HILLIARD, bc={"derivative": 0}), 1, 0.01, 1e-4, [1, 2]),
}


def _jax_decomposed(case, monkeypatch):
    args, kwargs, make_eq, n_fields, t_range, dt, decomposition = CASES[case]
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    grid = jpde.CartesianGrid(*args, **kwargs)
    low = -0.1 if "cahn" in case else 0.0
    state = _state(jpde, grid, n_fields, seed=5, low=low, high=-low if low else 1.0)
    solver = JaxEulerSolver(make_eq(jpde), decomposition=decomposition)
    result = JaxController(solver, t_range=t_range, tracker=None).run(state, dt=dt)
    assert solver.info.get("fused_step") is True
    assert solver.info["decomposition"] == decomposition
    return _leaves(result)


def _port_run(case, **kwargs):
    args, grid_kwargs, make_eq, n_fields, t_range, dt, _ = CASES[case]
    grid = tpde.CartesianGrid(*args, **grid_kwargs)
    low = -0.1 if "cahn" in case else 0.0
    state = _state(tpde, grid, n_fields, seed=5, low=low, high=-low if low else 1.0)
    result, info = make_eq(tpde).solve(
        state, t_range=t_range, dt=dt, tracker=None, ret_info=True, **kwargs
    )
    return _leaves(result), info["solver"]


@pytest.mark.parametrize("case", CASES)
def test_decomposed_matches_jax_and_serial(case, monkeypatch):
    decomposition = CASES[case][-1]
    launches = (ce.affine_laplace_ext_2d.launches, ce.multi_stencil_ext_2d.launches)
    got, info = _port_run(case, solver="explicit_sharded", decomposition=decomposition)
    assert info["fused_step"] is True
    assert info["decomposition"] == decomposition
    assert (ce.affine_laplace_ext_2d.launches, ce.multi_stencil_ext_2d.launches) == launches
    serial, serial_info = _port_run(case)
    assert serial_info["fused_step"] is True and "decomposition" not in serial_info
    for a, b in zip(got, serial, strict=True):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(got, _jax_decomposed(case, monkeypatch), strict=True):
        np.testing.assert_allclose(a, b, **TOL)


def test_euler_solver_with_decomposition_and_ragged_blocks():
    """EulerSolver(decomposition=) on a ragged 24x20 grid with mixed BCs: blocks
    of 6x10 cut the ladder's top to k = 4 (its halo); equal to serial."""
    grid = tpde.CartesianGrid([(0, 3), (0, 2)], (24, 20))
    state = _state(tpde, grid, 1, seed=2)
    eq = tpde.DiffusionPDE(0.02, bc={"x": {"curvature": 0.5}, "y-": {"value": -1},
                                     "y+": {"type": "mixed", "value": 3.0}})
    solver = tpde.EulerSolver(eq, decomposition=[4, 2])
    copies = HaloExchange.copies
    result = tpde.Controller(solver, t_range=0.037, tracker=None).run(state, dt=1e-3)
    assert solver.info["fused_step"] is True and solver.info["decomposition"] == [4, 2]
    assert solver.info["steps"] == 37 and HaloExchange.copies > copies
    serial = eq.solve(state, t_range=0.037, dt=1e-3, tracker=None)
    np.testing.assert_allclose(result.data.numpy(), serial.data.numpy(), **TOL)


@pytest.mark.parametrize("solver", ["explicit_sharded", "explicit_mpi", tpde.ExplicitMPISolver])
def test_sharded_solver_names(solver):
    grid = tpde.UnitGrid([16, 16], periodic=True)
    state = _state(tpde, grid, 1, seed=3)
    eq = tpde.DiffusionPDE(0.1)
    result, info = eq.solve(state, t_range=0.3, dt=0.1, tracker=None, solver=solver,
                            ret_info=True, gather_mode="main")
    assert info["solver"]["decomposition"] == [4, 2]  # "auto" over eight blocks
    assert info["solver"]["class"] in ("ExplicitShardedSolver", "ExplicitMPISolver")
    serial = eq.solve(state, t_range=0.3, dt=0.1, tracker=None)
    np.testing.assert_allclose(result.data.numpy(), serial.data.numpy(), **TOL)
    result = eq.solve(state, t_range=0.3, dt=0.1, tracker=None, solver=solver,
                      decomposition=[2, 2])
    np.testing.assert_allclose(result.data.numpy(), serial.data.numpy(), **TOL)


def _runs_or_raises(make_eq, state, match, decomposition=(2, 2)):
    """A decomposed configuration no decomposed window takes: the torch engine
    runs the plain sharded stepper, equal to the serial plain loop bit for bit
    (noise from the same seed); the cuda engine raises with the window's reason."""
    def solve(**kwargs):
        return make_eq().solve(state, t_range=0.01, dt=1e-3, tracker=None, ret_info=True,
                               **kwargs)

    got, info = solve(decomposition=list(decomposition))
    assert "fused_step" not in info["solver"] and info["solver"]["sharded_halo"] >= 0
    assert match.replace("\\", "") in info["solver"]["fused_unsupported"]
    serial, _ = solve(backend="numpy")
    for a, b in zip(_leaves(got), _leaves(serial), strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match=match):
        solve(decomposition=list(decomposition), backend="cuda")


def test_unsupported_decomposed_configurations_raise():
    """The configurations the decomposed windows refuse (pde_tpu's gates)
    run through the plain sharded stepper under the torch engine and raise
    under the cuda engine; 2D and 3D array BC values, which they take, fuse."""
    grid = tpde.UnitGrid([16, 16], periodic=True)
    scalar = _state(tpde, grid, 1, seed=4)
    vector = tpde.VectorField(grid, np.random.default_rng(4).random((2, 16, 16)),
                              dtype=torch.float64)

    def seeded(cls, *args, **kwargs):
        return lambda: cls(*args, rng=np.random.default_rng(8), **kwargs)

    _runs_or_raises(lambda: tpde.PDE({"u": "vector_laplace(u)"}), vector,
                    "require scalar fields")
    _runs_or_raises(seeded(tpde.DiffusionPDE, 0.1, noise=0.1), scalar, "support noise")
    _runs_or_raises(seeded(tpde.KPZInterfacePDE, noise=0.1), scalar, "support noise")
    # on a 3D mesh: vector states, noise and array BC values
    cube_grid = tpde.UnitGrid([8, 8, 8], periodic=True)
    cube = tpde.ScalarField(cube_grid, np.random.default_rng(5).random((8, 8, 8)),
                            dtype=torch.float64)
    vector_cube = tpde.VectorField(cube_grid, np.random.default_rng(5).random((3, 8, 8, 8)),
                                   dtype=torch.float64)
    _runs_or_raises(lambda: tpde.PDE({"u": "vector_laplace(u)"}), vector_cube,
                    "require scalar fields", decomposition=(2, 1, 1))
    _runs_or_raises(seeded(tpde.DiffusionPDE, 0.1, noise=0.1), cube, "3D SDE",
                    decomposition=(2, 1, 1))
    _runs_or_raises(seeded(tpde.PDE, {"c": "laplace(c)"}, noise=0.1), cube, "3D SDE",
                    decomposition=(1, 2, 2))
    box = tpde.ScalarField(tpde.UnitGrid([8, 8, 8]), np.random.default_rng(6).random((8, 8, 8)),
                           dtype=torch.float64)
    face_bc = {"x": {"value": np.linspace(0, 1, 64).reshape(8, 8)}, "y": {"derivative": 0},
               "z": {"derivative": 0}}
    wall = tpde.ScalarField(tpde.UnitGrid([16, 16]), np.random.default_rng(7).random((16, 16)),
                            dtype=torch.float64)
    # array BC values fuse on a mesh (the side inputs of #12 and #8 in 2D, of #6
    # in 3D), bit-equal to the serial side-input windows
    array_bc = {"x": {"value": np.linspace(0, 1, 16)}, "y": {"derivative": 0}}
    for make_eq, state, cut in (
            (lambda: tpde.DiffusionPDE(0.1, bc=array_bc), wall, [2, 2]),
            (lambda: tpde.PDE({"c": "laplace(c)"}, bc=array_bc), wall, [2, 2]),
            (lambda: tpde.DiffusionPDE(0.1, bc=face_bc), box, [2, 2, 1]),
            (lambda: tpde.PDE({"c": "laplace(c)"}, bc=face_bc), box, [2, 2, 1])):
        got, info = make_eq().solve(state, t_range=0.01, dt=1e-3, tracker=None,
                                    decomposition=cut, ret_info=True)
        assert info["solver"].get("fused_step") is True
        serial = make_eq().solve(state, t_range=0.01, dt=1e-3, tracker=None)
        np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 1 / 3}):
        _runs_or_raises(lambda: tpde.DiffusionPDE(0.1), scalar, "5856-5867")
    # blocks of one row cannot supply Cahn-Hilliard's two-cell halo to a window;
    # the plain stepper takes it from two blocks a side
    thin = _state(tpde, tpde.UnitGrid([8, 16], periodic=True), 1, seed=4, low=-0.1, high=0.1)
    _runs_or_raises(lambda: tpde.PDE(CAHN_HILLIARD), thin, "Shard too small",
                    decomposition=(8, 1))
    _runs_or_raises(lambda: tpde.PDE({"c": "laplace(c)"}, post_step_hook=lambda d, t: d),
                    scalar, "post-step hook")


def test_decomposed_backends():
    grid = tpde.UnitGrid([16, 16], periodic=True)
    state = _state(tpde, grid, 1, seed=6)
    eq = tpde.DiffusionPDE(0.1)
    with pytest.raises(RuntimeError, match="backend='numpy'"):
        eq.solve(state, t_range=0.3, dt=0.1, tracker=None, backend="numpy",
                 decomposition=[2, 2])
    with pytest.raises(RuntimeError, match="CUDA device"):
        eq.solve(state, t_range=0.3, dt=0.1, tracker=None, backend="cuda",
                 decomposition=[2, 2])
    with tpde.config({"device": "meta"}):
        # the mesh's default devices follow the config key, not the state
        with pytest.raises(ValueError, match="blocks lie on meta"):
            eq.solve(state, t_range=0.3, dt=0.1, tracker=None, decomposition=[1, 1])
