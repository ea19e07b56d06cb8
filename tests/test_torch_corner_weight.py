"""The 9-point corner-weight Laplacian (config key
``operators.cartesian.laplacian_2d_corner_weight``) in kernels #1 and #12 of
the port, against ``pde_tpu`` on the CPU in fp64.

``pde_tpu`` runs its fused windows in interpret mode (``PDE_TPU_PALLAS_INTERPRET=1``);
the port's windows run the kernels' plain versions on CPU tensors, and the
replay of the 9-point march (three registers of the own column and three of
``left + right`` a level, two shared rows a level, two rows of lag a level,
races read as NaN) stands in for the CUDA kernel. Then the gates, each as
``pde_tpu`` draws it: k > 8, bounded sides, the registry's ``laplace``,
column cuts, the cylindrical grid, #2's ``vector_laplace`` and #7."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers.controller import Controller as JaxController
from pde_tpu.solvers.euler import EulerSolver as JaxEulerSolver
from pde_tpu_torch.backends import get_backend
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.ops import cuda_stencil_op_2d as so
from pde_tpu_torch.parallel.fused import make_fused_euler_window_sharded
from pde_tpu_torch.parallel.mesh import GridMesh

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


KEY = "operators.cartesian.laplacian_2d_corner_weight"
WEIGHTS = {"w=1/3": 1 / 3, "w=1/2": 0.5}
# grid args, kwargs, dt of DiffusionPDE(0.1) (stable for the 9-point stencil)
GRIDS = {
    "unit 32x128": (([(0, 32), (0, 128)], [32, 128]), 0.1),
    "anisotropic 32x128": (([(0, 1), (0, 2)], [32, 128]), 5e-4),
}
# 15 steps: one pass of each of the ladder's k = 8, 4, 2 and 1
STEPS = 15


def _rel(got, expected) -> float:
    got, expected = np.asarray(got), np.asarray(expected)
    return float(np.abs(got - expected).max() / np.abs(expected).max())


def _data(shape, seed):
    return np.random.default_rng(seed).random(shape)


def _pair(grid_id, seed, periodic=True):
    (args, dt) = GRIDS[grid_id]
    jgrid = jpde.CartesianGrid(*args, periodic=periodic)
    tgrid = tpde.CartesianGrid(*args, periodic=periodic)
    data = _data(jgrid.shape, seed)
    return (jpde.ScalarField(jgrid, data), tpde.ScalarField(tgrid, torch.tensor(data)), dt)


def _march_window(window):
    """The port's window with every pass through the march replay."""
    return cc.affine_window(window.specs, lambda data, spec, out: cc.affine_laplace_2d_marched(
        data, spec))


# -- the 9-point window against pde_tpu's interpret-mode window --------------------------------
@pytest.mark.parametrize("grid_id", GRIDS)
@pytest.mark.parametrize("label", WEIGHTS)
def test_window_matches_jax(label, grid_id, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jstate, tstate, dt = _pair(grid_id, seed=len(grid_id))
    with jpde.config({KEY: WEIGHTS[label]}), tpde.config({KEY: WEIGHTS[label]}):
        jsolver = JaxEulerSolver(jpde.DiffusionPDE(0.1), adaptive=False)
        jout, _ = jsolver.make_stepper(jstate, dt=dt)(jstate, 0.0, STEPS * dt)
        tsolver = tpde.EulerSolver(tpde.DiffusionPDE(0.1), adaptive=False)
        tout, _ = tsolver.make_stepper(tstate, dt=dt)(tstate, 0.0, STEPS * dt)
        window = tpde.DiffusionPDE(0.1).make_fused_euler_window(tstate, dt)
        marched = _march_window(window)(tstate.data, STEPS)
    assert jsolver.info.get("fused_step") is True
    assert tsolver.info.get("fused_step") is True
    assert [spec.k for spec in window.specs] == [8, 4, 2, 1]
    assert all(spec.corner == WEIGHTS[label] for spec in window.specs)
    assert tsolver.info["steps"] == jsolver.info["steps"] == STEPS
    assert _rel(tout.data.numpy(), jout.data) <= 1e-12
    assert _rel(marched.numpy(), jout.data) <= 1e-12
    assert torch.equal(marched, tout.data)


# -- the plain version against the march replay and the tile emulation --------------------------
@pytest.mark.parametrize("plan", [None, (16, 8), (32, 5)])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("label", WEIGHTS)
def test_plain_matches_march_replay(label, k, plan):
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], [21, 40], periodic=True)
    data = torch.tensor(_data(grid.shape, k))
    with tpde.config({KEY: WEIGHTS[label]}):
        spec = cc.affine_laplace_spec(grid, a=1.0, b=1e-4, k=k, dtype=torch.float64)
    plain = cc.affine_laplace_2d_plain(data, spec)
    assert spec.corner == WEIGHTS[label] and spec.tile == cc.corner_row_plan(k, 8)
    assert torch.equal(cc.affine_laplace_2d_marched(data, spec, plan=plan), plain)
    assert torch.equal(cc.affine_laplace_2d_tiled(data, spec, tile=plan), plain)
    # #12's replay on an extended block of a row cut, against its plain version
    with tpde.config({KEY: WEIGHTS[label]}):
        ext_spec = ce.affine_laplace_ext_spec(grid, (10, 40), a=1.0, b=1e-4, k=k, halo=k,
                                              dtype=torch.float64)
    ext = torch.tensor(_data((10 + 2 * k, 40 + 2 * k), k + 1))
    expected = ce.affine_laplace_ext_2d_plain(ext, ext_spec, (0, 0, 0, 0))
    assert torch.equal(ce.affine_laplace_ext_2d_marched(ext, ext_spec, (0, 0, 0, 0), plan=plan),
                       expected)


def test_march_replay_reads_no_unwritten_cell():
    """A 3x4 grid (the halo wraps many times) and a single-column strip: the
    replay's NaN registers and races would show in the result."""
    grid = tpde.UnitGrid([3, 4], periodic=True)
    data = torch.tensor(_data(grid.shape, 3))
    with tpde.config({KEY: 0.5}):
        for k in (1, 2, 8):
            spec = cc.affine_laplace_spec(grid, a=1.0, b=0.05, k=k, dtype=torch.float64)
            for plan in (None, (1, 1), (4, 2)):
                got = cc.affine_laplace_2d_marched(data, spec, plan=plan)
                assert bool(torch.isfinite(got).all())
                assert torch.equal(got, cc.affine_laplace_2d_plain(data, spec))


def test_kernel_source_of_the_corner_mode():
    """One instantiation per k <= 8 and dtype at the 9-point plan, in libraries
    of their own; the 5-point libraries' sources are what they were."""
    for library, launcher in ((cc.CORNER_LIBRARY, "launch_affine_corner_2d"),
                              (cc.CORNER_EXT_LIBRARY, "launch_affine_corner_ext_2d")):
        source = cc.emit_source(library, (True, True))
        for k in range(1, cc.CORNER_TOP_STEPS + 1):
            for ctype, itemsize in (("float", 4), ("double", 8)):
                plan = ", ".join(map(str, cc.corner_row_plan(k, itemsize)))
                assert f"{launcher}<{ctype}, {k}, {plan}, true, true>" in source
        assert f"case {cc.CORNER_TOP_STEPS + 1}:" not in source
        with pytest.raises(tpde.KernelUnsupportedError, match="fully periodic"):
            cc.emit_source(library, (True, False))
    assert "corner" not in cc.emit_source("affine_laplace_2d", (True, True))
    with tpde.config({KEY: 1 / 3}):
        spec = cc.affine_laplace_spec(tpde.UnitGrid([8, 8], periodic=True), a=1.0, b=0.1,
                                      k=2, dtype=torch.float32)
    assert cc.library_of(spec) == cc.CORNER_LIBRARY
    doubles = list(cc.step_doubles(spec))
    assert len(doubles) == 20 and doubles[16:] == list(cc.corner_factors(spec))
    assert ce.affine_ext_source((True, True), corner=True).library == cc.CORNER_EXT_LIBRARY


# -- decomposed runs: [2, 1] bit-equal to serial --------------------------------------------------
@pytest.mark.parametrize("decomposition", [[2, 1], [4, 1]])
@pytest.mark.parametrize("label", WEIGHTS)
def test_row_cut_equals_serial(label, decomposition, monkeypatch):
    _, tstate, dt = _pair("anisotropic 32x128", seed=7)
    with tpde.config({KEY: WEIGHTS[label]}):
        launches = ce.affine_laplace_ext_2d.launches
        solver = tpde.EulerSolver(tpde.DiffusionPDE(0.1), decomposition=decomposition)
        got, _ = solver.make_stepper(tstate, dt=dt)(tstate, 0.0, STEPS * dt)
        serial, _ = tpde.EulerSolver(tpde.DiffusionPDE(0.1)).make_stepper(tstate, dt=dt)(
            tstate, 0.0, STEPS * dt)
        mesh = GridMesh(tstate.grid, decomposition)
        window = make_fused_euler_window_sharded(mesh, diffusivity=0.1, dt=dt,
                                                 dtype=torch.float64)
    assert solver.info["fused_step"] is True and solver.info["decomposition"] == decomposition
    assert ce.affine_laplace_ext_2d.launches == launches  # CPU buffers: the plain version
    assert [spec.k for spec in window.specs] == [8, 4, 2, 1]
    assert all(spec.corner == WEIGHTS[label] for spec in window.specs)
    assert torch.equal(got.data, serial.data)


# -- the gates ------------------------------------------------------------------------------------
def test_gate_caps_k_at_eight():
    grid = tpde.UnitGrid([16, 16], periodic=True)
    with tpde.config({KEY: 0.5}):
        with pytest.raises(tpde.KernelUnsupportedError, match="pallas_cartesian.py:850-860"):
            cc.affine_laplace_spec(grid, a=1.0, b=0.1, k=12, dtype=torch.float32)
        for k, ladder in ((16, [8, 4, 2, 1]), (12, [6, 3, 1]), (None, [8, 4, 2, 1])):
            window = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=0.1, k=k)
            assert [spec.k for spec in window.specs] == ladder
    # without the key the 5-point ladder keeps its top k
    assert [s.k for s in cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=0.1).specs] \
        == [12, 6, 3, 1]


@pytest.mark.parametrize("bc", [{"derivative": 0}, {"x": "periodic", "y": {"value": 1.0}}])
def test_bounded_sides_refuse_and_run_the_plain_loop(bc, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    periodic = [True, False] if "x" in bc else False
    jstate, tstate, dt = _pair("unit 32x128", seed=11, periodic=periodic)
    with jpde.config({KEY: 1 / 3}), tpde.config({KEY: 1 / 3}):
        bcs = tstate.grid.get_boundary_conditions(bc)
        with pytest.raises(tpde.KernelUnsupportedError, match="pallas_cartesian.py:841-849"):
            cc.make_affine_laplace_2d(tstate.grid, a=1.0, b=0.1, k=1, bcs=bcs)
        jres = jpde.DiffusionPDE(0.1, bc=bc).solve(jstate, t_range=4 * dt, dt=dt, tracker=None)
        teq = tpde.DiffusionPDE(0.1, bc=bc)
        tres = teq.solve(tstate, t_range=4 * dt, dt=dt, tracker=None)
        with pytest.raises(RuntimeError, match="pallas_cartesian.py:841-849"):
            tpde.DiffusionPDE(0.1, bc=bc).solve(tstate, t_range=dt, dt=dt, tracker=None,
                                                backend="cuda")
    assert "fused_step" not in teq.diagnostics["solver"]
    assert "841-849" in teq.diagnostics["solver"]["fused_unsupported"]
    assert _rel(tres.data.numpy(), jres.data) <= 1e-12


def test_registry_laplace_refuses():
    """The registry's ``laplace`` always passes conditions, so it refuses under
    the key, as ``pde_tpu``'s ``make_laplace_pallas`` does; the field method
    (plain torch) takes the 9-point stencil."""
    grid = tpde.UnitGrid([16, 16], periodic=True)
    field = tpde.ScalarField(grid, torch.tensor(_data(grid.shape, 2)))
    with tpde.config({KEY: 0.5}):
        with pytest.raises(tpde.KernelUnsupportedError, match="pallas_cartesian.py:841-849"):
            get_backend("cuda").make_operator(grid, "laplace", "periodic")
        plain = field.laplace("periodic").data
    jgrid = jpde.UnitGrid([16, 16], periodic=True)
    with jpde.config({KEY: 0.5}):
        expected = jpde.ScalarField(jgrid, _data(grid.shape, 2)).laplace("periodic").data
    assert _rel(plain.numpy(), expected) <= 1e-12


def test_column_cuts_refuse_and_run_the_plain_sharded_stepper(monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jstate, tstate, dt = _pair("anisotropic 32x128", seed=5)
    with jpde.config({KEY: 0.5}), tpde.config({KEY: 0.5}):
        with pytest.raises(tpde.KernelUnsupportedError, match="pallas_cartesian.py:5856-5867"):
            make_fused_euler_window_sharded(GridMesh(tstate.grid, [1, 2]), diffusivity=0.1,
                                            dt=dt, dtype=torch.float64)
        jsolver = JaxEulerSolver(jpde.DiffusionPDE(0.1), decomposition=[1, 2])
        jres = JaxController(jsolver, t_range=4 * dt, tracker=None).run(jstate, dt=dt)
        tres, info = tpde.DiffusionPDE(0.1).solve(tstate, t_range=4 * dt, dt=dt, tracker=None,
                                                  decomposition=[1, 2], ret_info=True)
        serial = tpde.DiffusionPDE(0.1).solve(tstate, t_range=4 * dt, dt=dt, tracker=None,
                                              backend="numpy")
        with pytest.raises(RuntimeError, match="row-cut"):
            tpde.DiffusionPDE(0.1).solve(tstate, t_range=dt, dt=dt, tracker=None,
                                         decomposition=[1, 2], backend="cuda")
    assert "fused_step" not in info["solver"] and "5856-5867" in info["solver"][
        "fused_unsupported"]
    assert torch.equal(tres.data, serial.data)
    assert _rel(tres.data.numpy(), jres.data) <= 1e-12


def test_cylindrical_grids_ignore_the_key():
    grid = tpde.CylindricalSymGrid(8, (0, 4), (8, 12), periodic_z=True)
    state = tpde.ScalarField(grid, torch.tensor(_data(grid.shape, 9)))
    eq = tpde.DiffusionPDE(0.1, bc={"r": {"derivative": 0}, "z": "periodic"})
    without = eq.make_fused_euler_window(state, 0.01)(state.data, 11)
    with tpde.config({KEY: 0.5}):
        window = eq.make_fused_euler_window(state, 0.01)
        got = window(state.data, 11)
    assert all(spec.corner == 0.0 and spec.radial is not None for spec in window.specs)
    assert [spec.k for spec in window.specs] == [8, 4, 2, 1]
    assert torch.equal(got, without)


def test_vector_laplace_and_expression_windows_refuse(monkeypatch):
    """#2's ``vector_laplace`` and #7 refuse the key, as ``pde_tpu``'s gates
    do, and the plain loop matches ``pde_tpu``'s (XLA) run."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    grid = tpde.UnitGrid([16, 16], periodic=True)
    with tpde.config({KEY: 0.5}):
        with pytest.raises(tpde.KernelUnsupportedError, match="pallas_cartesian.py:1303-1306"):
            so.stencil_op_2d_spec(grid, "vector_laplace", dtype=torch.float64)
        with pytest.raises(tpde.KernelUnsupportedError, match="models/pde.py:750-762"):
            tpde.PDE({"c": "laplace(c) - c**3"}).make_fused_euler_window(
                tpde.ScalarField(grid, 0.0, dtype=torch.float64), 0.01)
    data = _data(grid.shape, 4)
    with jpde.config({KEY: 0.5}), tpde.config({KEY: 0.5}):
        jres = jpde.PDE({"c": "laplace(c) - c**3"}).solve(
            jpde.ScalarField(jpde.UnitGrid([16, 16], periodic=True), data), t_range=0.05,
            dt=0.01, tracker=None)
        teq = tpde.PDE({"c": "laplace(c) - c**3"})
        tres = teq.solve(tpde.ScalarField(grid, torch.tensor(data)), t_range=0.05, dt=0.01,
                         tracker=None)
    assert "750-762" in teq.diagnostics["solver"]["fused_unsupported"]
    assert _rel(tres.data.numpy(), jres.data) <= 1e-12


@pytest.mark.parametrize("rhs", ["diffusion", "expression"])
def test_3d_windows_ignore_the_key(rhs, monkeypatch):
    """The key alters the 2D Cartesian stencil only: 3D windows (#3, #5) fuse
    under it in both packages, as without it."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    data = _data((8, 8, 8), 13)
    results = []
    with jpde.config({KEY: 0.5}), tpde.config({KEY: 0.5}):
        for pkg in (jpde, tpde):
            eq = pkg.DiffusionPDE(0.1) if rhs == "diffusion" else pkg.PDE(
                {"c": "0.1 * laplace(c) - c**3"})
            state = pkg.ScalarField(pkg.UnitGrid([8, 8, 8], periodic=True),
                                    torch.tensor(data) if pkg is tpde else data)
            results.append(np.asarray(eq.solve(state, t_range=0.05, dt=0.01,
                                               tracker=None).data))
            assert eq.diagnostics["solver"].get("fused_step") is True
    assert _rel(results[1], results[0]) <= 1e-12
