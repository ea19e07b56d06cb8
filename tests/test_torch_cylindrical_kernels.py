"""The cylindrical radial modes of kernels #1 and #7, on the CPU.

- Kernel #1's radial mode (``affine_laplace_2d`` on a ``CylindricalSymGrid``):
  its plain version against the port's cylindrical Laplacian stepped k times,
  and the torch replay of the row march and the block emulation against the
  plain version, at every k of the ladder and more, fp64, under no-flux,
  value, mixed and curvature sides and a periodic z axis; the row table, the
  generated entry points (a library of its own, k up to RADIAL_TOP_STEPS) and
  the 18 doubles.
- Kernel #7's radial helpers: the march replay of the Euler, RK4 and AB2
  programs of Cahn-Hilliard, ``divergence(gradient(u))`` and a mixed rhs
  against their plain versions at every ladder k, fp64; the helpers against
  the plain operators; the emitted stage functions and the row table.
- The cylindrical windows against ``pde_tpu`` run as its own tests run them
  (``PDE_TPU_PALLAS_INTERPRET=1``, ``tests/ops/test_pallas_kernels.py``), on
  32x32 and 16x16 grids, at 1e-12.
- The gates: under ``cuda`` an unsupported operator, a vector state and
  noise raise, under ``torch`` they take the plain loop; on a mesh, what has
  no kernel raises under ``cuda`` and a global reduction in a plain rhs
  under ``torch`` (ROADMAP A9); the registry's cylindrical ``laplace``
  against ``pde_tpu``'s. Decomposed cylindrical runs themselves are
  ``tests/test_torch_radial_ext.py``'s and
  ``tests/test_torch_radial_decomposition.py``'s.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers import EulerSolver as JaxEuler
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.ops import cuda_stencil_2d as cs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64

# id: (grid arguments, conditions)
KERNEL_CASES = {
    "no-flux": (((1.0, 2.0), (0, 2), (30, 37)), {"r": {"derivative": 0}, "z": {"derivative": 0}}),
    "value z": ((2.0, (0, 3), (29, 20)), {"r": {"derivative": 0}, "z": {"value": 0.5}}),
    "mixed r": (((0.5, 2.0), (-1, 1), (24, 33)),
                {"r-": {"type": "mixed", "value": 2.0, "const": 0.5}, "r+": {"value": 1.0},
                 "z": {"curvature": 0.3}}),
    "periodic z": ((1.0, (0, 2), (26, 40), True), {"r": {"derivative": 0}, "z": "periodic"}),
}
LADDER = [8, 4, 2, 1]  # the radial windows' (RADIAL_TOP_STEPS)
KS = list(range(1, 9))  # every k of the radial mode (RADIAL_TOP_STEPS)


def _kernel_case(case):
    args, bc = KERNEL_CASES[case]
    grid = tpde.CylindricalSymGrid(*args)
    data = torch.as_tensor(np.random.default_rng(len(case)).uniform(size=grid.shape))
    return grid, bc, grid.get_boundary_conditions(bc), data


def _spec(grid, bcs, k, a=1.0, b=2e-4):
    return cc.affine_laplace_spec(grid, a=a, b=b, k=k, dtype=F64, bcs=bcs)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_radial_plain_is_the_cylindrical_laplacian_stepped(case, k):
    grid, bc, bcs, data = _kernel_case(case)
    spec = _spec(grid, bcs, k)
    assert spec.radial == (grid.axes_bounds[0][0], grid.discretization[0])
    lap = grid.make_operator("laplace", bc)
    ref = data
    for _ in range(k):
        ref = ref + 2e-4 * lap(ref)
    np.testing.assert_allclose(cc.affine_laplace_2d_plain(data, spec).numpy(), ref.numpy(), **TOL)
    # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(cc.affine_laplace_2d(data, spec).numpy(),
                                  cc.affine_laplace_2d_plain(data, spec).numpy())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_radial_march_replay_matches_plain(case, k):
    grid, _, bcs, data = _kernel_case(case)
    spec = _spec(grid, bcs, k)
    plain = cc.affine_laplace_2d_plain(data, spec).numpy()
    for plan in ((16, 8), (8, 5)):  # several strips and chunks: their borders and the pad rows
        np.testing.assert_allclose(cc.affine_laplace_2d_marched(data, spec, plan).numpy(), plain,
                                   **TOL)
    np.testing.assert_allclose(cc.affine_laplace_2d_tiled(data, spec, (16, 7)).numpy(), plain,
                               **TOL)


def test_radial_march_replay_at_the_kernel_plan():
    grid, _, bcs, data = _kernel_case("no-flux")
    spec = _spec(grid, bcs, cc.RADIAL_TOP_STEPS)
    np.testing.assert_allclose(cc.affine_laplace_2d_marched(data, spec).numpy(),
                               cc.affine_laplace_2d_plain(data, spec).numpy(), **TOL)


def test_radial_rows_table():
    grid, _, bcs, _ = _kernel_case("mixed r")
    for dtype in (torch.float32, F64):
        spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=3, dtype=dtype, bcs=bcs)
        table = cc.radial_rows(spec, "cpu")
        assert table.shape == (grid.shape[0] + 2 * cc.RADIAL_PAD, 2) and table.dtype == dtype
        assert cc.radial_rows(spec, "cpu") is table  # made once
        r_lo, dr = spec.radial
        rows = np.arange(-cc.RADIAL_PAD, grid.shape[0] + cc.RADIAL_PAD)
        fac = (0.01 / (2 * dr)) / ((rows + 0.5) * dr + r_lo)
        np.testing.assert_allclose(table[:, 0].double().numpy(), 0.01 * spec.sx - fac,
                                   rtol=1e-6 if dtype == torch.float32 else 1e-13)
        np.testing.assert_allclose(table[:, 1].double().numpy(), 0.01 * spec.sx + fac,
                                   rtol=1e-6 if dtype == torch.float32 else 1e-13)
        assert bool(torch.isfinite(table).all())
    doubles = list(cc.step_doubles(spec))
    assert len(doubles) == 18
    assert doubles[16:] == [1.0 - 0.02 * spec.sx - 0.02 * spec.sy, 0.01 * spec.sy]
    cartesian = cc.affine_laplace_spec(tpde.UnitGrid([8, 8], periodic=True), a=1.0, b=0.01,
                                       k=3, dtype=F64)
    assert list(cc.step_doubles(cartesian)) == [1.0, 0.01, 1.0, 1.0] + [0.0, 0.0, 0.0] * 4


def test_radial_entry_points_and_gates():
    grid, _, bcs, _ = _kernel_case("periodic z")
    spec = _spec(grid, bcs, 3)
    assert spec.periodic == (False, True)
    assert cc.library_of(spec) == cc.RADIAL_LIBRARY == "affine_laplace_radial_2d"
    unit = cc.kernel_source(spec.periodic, cc.library_of(spec))
    cartesian = cc.kernel_source(spec.periodic)
    assert unit.digest != cartesian.digest and unit.radial and not cartesian.radial
    tx, threads, prefetch, blocks = cc.affine_row_plan(3, 8)
    assert (f"case 3: return pde_tpu_torch::launch_affine_radial_2d<double, 3, {tx}, {threads}, "
            f"{prefetch}, {blocks}, true>(in, out, rows, ints, doubles, stream);"
            in unit.source)
    assert 'extern "C" int affine_laplace_radial_2d_f64(const void* in, void* out, ' \
           "const void* rows, const int* ints," in unit.source
    assert f"case {cc.RADIAL_TOP_STEPS}: " in unit.source
    assert f"case {cc.RADIAL_TOP_STEPS + 1}: " not in unit.source
    # the Cartesian entry points take no row table
    assert "rows" not in cartesian.source and "radial" not in cartesian.source
    # deeper passes take the deep march's radial library, up to 32 steps (C18)
    for k in range(cc.RADIAL_TOP_STEPS + 1, cc.MAX_STEPS + 1):
        deep = _spec(grid, bcs, k)
        assert deep.deep and cc.library_of(deep) == cc.deep_library(cc.RADIAL_LIBRARY)
    with pytest.raises(tpde.KernelUnsupportedError, match="1 <= k <= 32"):
        _spec(grid, bcs, cc.DEEP_MAX_STEPS + 1)
    with pytest.raises(tpde.KernelUnsupportedError, match="explicit boundary conditions"):
        cc.affine_laplace_spec(grid, a=1.0, b=0.1, k=1, dtype=F64)
    # the ext kernel's radial mode: the same gates, the block's table of the grid's rows
    ext_spec = ce.affine_laplace_ext_spec(grid, (13, 20), a=1.0, b=0.1, k=1, halo=1,
                                          dtype=F64, bcs=bcs)
    assert ext_spec.radial == _spec(grid, bcs, 1).radial
    assert ext_spec.table_rows() == grid.shape[0] == _spec(grid, bcs, 1).table_rows()
    # the corner-weight config does not alter the cylindrical stencil (as in pde_tpu)
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 0.5}):
        assert _spec(grid, bcs, 3).radial is not None
    with pytest.raises(tpde.KernelUnsupportedError, match="float32 or float64"):
        cc.affine_laplace_spec(grid, a=1.0, b=0.1, k=1, dtype=torch.float16, bcs=bcs)


def test_diffusion_window_takes_the_radial_mode():
    grid, bc, bcs, data = _kernel_case("value z")
    window = tpde.DiffusionPDE(0.1, bc=bc).make_fused_euler_window(
        tpde.ScalarField(grid, data), 1e-3)
    assert [spec.k for spec in window.specs] == LADDER
    assert all(spec.radial is not None for spec in window.specs)
    # the Cartesian windows keep their top k
    cartesian = tpde.DiffusionPDE(0.1).make_fused_euler_window(
        tpde.ScalarField(tpde.UnitGrid([16, 16], periodic=True), 0.0), 1e-3)
    assert cartesian.specs[0].k == cc.TOP_STEPS == 12
    ref = data
    spec1 = _spec(grid, bcs, 1, b=1e-4)
    for _ in range(37):
        ref = cc.affine_laplace_2d_plain(ref, spec1)
    np.testing.assert_allclose(window(data, 37).numpy(), ref.numpy(), **TOL)


# -- kernel #7's radial helpers --------------------------------------------------------------
BC7 = {"r": {"derivative": 0}, "z": {"value": 0.2}}
PROGRAMS = {
    "cahn-hilliard": ("laplace(c**3 - c - laplace(c))", {"bc_ops": {"c:laplace": BC7}}),
    "divergence of gradient": ("divergence(gradient(c))", {"bc": BC7}),
    "mixed": ("0.1 * laplace(c) - 0.05 * divergence(gradient(c**2)) "
              "+ 0.02 * dot(gradient(c), gradient(c)) - gradient_squared(c)",
              {"bc": {"r": {"derivative": 0.1}, "z": "periodic"}}),
}


def _program_state(name, periodic_z=None):
    rhs, kwargs = PROGRAMS[name]
    periodic = "periodic" in str(kwargs) if periodic_z is None else periodic_z
    grid = tpde.CylindricalSymGrid((0.5, 2.0), (0, 3), (26, 29), periodic_z=periodic)
    state = tpde.ScalarField(grid, np.random.default_rng(3).uniform(0, 1, grid.shape), dtype=F64)
    return tpde.PDE({"c": rhs}, **kwargs), state


@pytest.mark.parametrize("scheme", ["euler", "rk4", "ab2"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_radial_programs_replay_their_plain_versions(name, scheme):
    eq, state = _program_state(name)
    window = getattr(eq, f"make_fused_{scheme}_window")(state, 1e-6)
    program = window.program
    assert program.geometry.radial == (0.5, 1.5 / 26)
    assert "O.rv[0]" in program.source or "divergence" in name
    assert "static constexpr int kRowValues = 2;" in program.source
    rng = np.random.default_rng(4)
    for spec in window.specs:
        datas = [torch.as_tensor(rng.uniform(0, 1, state.grid.shape))
                 for _ in range(program.n_fields)]
        plain = cs.multi_stencil_2d_plain(datas, spec)
        for plan in ((16, 8), (8, 5)):
            for got, ref in zip(cs.multi_stencil_2d_marched(datas, spec, plan), plain,
                                strict=True):
                np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_radial_row_table(dtype):
    """The table a cylindrical program's kernel reads once a row holds the
    plain versions' numbers, bit for bit, and is made once."""
    eq, state = _program_state("mixed")
    window = eq.make_fused_euler_window(state.copy(dtype=dtype), 1e-6)
    program = window.program
    table = cs.row_table(program, dtype, "cpu")
    n, pad = state.grid.shape[0], cs.row_pad(program)
    assert pad == max(spec.k for spec in window.specs) * program.depth  # the deepest halo
    assert table.shape == (n + 2 * pad, 2) and table.dtype == dtype
    assert table.is_contiguous() and cs.row_table(program, dtype, "cpu") is table
    rows = torch.arange(n)
    for i, kind in enumerate(cs.ROW_VALUES):
        values = cs.radial_values(program.geometry, kind, rows, dtype)
        assert torch.equal(table[pad:pad + n, i], values)
        assert torch.equal(table[:pad, i], values[0].expand(pad))  # the pad repeats the edges
        assert torch.equal(table[pad + n:, i], values[-1].expand(pad))
    r = (np.arange(n) + 0.5) * (1.5 / 26) + 0.5
    np.testing.assert_allclose(table[pad:pad + n, 1].double().numpy(), 1 / r,
                               rtol=1e-6 if dtype == torch.float32 else 1e-14)


@pytest.mark.parametrize("periodic_z", [True, False])
def test_radial_helpers_are_the_plain_operators(periodic_z):
    grid = tpde.CylindricalSymGrid((0.5, 2.0), (0, 3), (12, 9), periodic_z=periodic_z)
    bc = {"r": {"derivative": 0.1}, "z": "periodic" if periodic_z else {"value": 0.3}}
    bcs = grid.get_boundary_conditions(bc)
    specs = cc.affine_bc_specs(grid, bcs)
    helpers = cs.PlainHelpers(grid)
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.uniform(size=grid.shape))
    v = torch.as_tensor(rng.uniform(size=(2, *grid.shape)))
    np.testing.assert_allclose(helpers.lap(u, specs).numpy(),
                               grid.make_operator("laplace", bc)(u).numpy(), **TOL)
    full = torch.cat([v, torch.zeros(1, *grid.shape, dtype=F64)])  # v_φ = 0
    np.testing.assert_allclose(helpers.divergence(list(v), specs).numpy(),
                               grid.make_operator("divergence", bc)(full).numpy(), **TOL)
    grad = grid.make_operator("gradient", bc)(u)
    for axis, d in enumerate(helpers.derivatives):
        np.testing.assert_allclose(d(u, specs).numpy(), grad[axis].numpy(), **TOL)
    np.testing.assert_allclose(helpers.gradient_squared(u, specs).numpy(),
                               grid.make_operator("gradient_squared", bc)(u).numpy(), **TOL)


# -- the windows against pde_tpu's -----------------------------------------------------------
def _pair(rng, *grid_args, periodic_z=False):
    jgrid = jpde.CylindricalSymGrid(*grid_args, periodic_z=periodic_z)
    tgrid = tpde.CylindricalSymGrid(*grid_args, periodic_z=periodic_z)
    data = rng.uniform(size=jgrid.shape)
    return jpde.ScalarField(jgrid, data), tpde.ScalarField(tgrid, data, dtype=F64)


def _run_both(jeq, teq, jfield, tfield, dt, t_end, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PDE_TPU_DISABLE_FUSED", raising=False)
    jsolver = JaxEuler(jeq)
    expected, _ = jsolver.make_stepper(jfield, dt)(jfield, 0.0, t_end)
    tsolver = tpde.EulerSolver(teq)
    got, _ = tsolver.make_stepper(tfield, dt)(tfield, 0.0, t_end)
    assert jsolver.info.get("fused_step") is True and tsolver.info.get("fused_step") is True
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)
    return tsolver


@pytest.mark.parametrize("periodic_z", [True, False], ids=["z-periodic", "z-dirichlet"])
def test_diffusion_window_matches_pde_tpu(periodic_z, monkeypatch):
    """pde_tpu's test_fused_euler_window_cylindrical, held against the port."""
    jfield, tfield = _pair(np.random.default_rng(6), 1.0, (0, 2), (32, 32),
                           periodic_z=periodic_z)
    bc = ({"r": {"derivative": 0}, "z": "periodic"} if periodic_z
          else {"r": {"derivative": 0}, "z": {"value": 0}})
    _run_both(jpde.DiffusionPDE(0.1, bc=bc), tpde.DiffusionPDE(0.1, bc=bc), jfield, tfield,
              5e-5, 0.01, monkeypatch)


def test_expression_windows_match_pde_tpu(monkeypatch):
    """pde_tpu's test_fused_expression_cylindrical, held against the port."""
    rng = np.random.default_rng(7)
    bc = {"r": {"derivative": 0}, "z": "periodic"}
    jfield, tfield = _pair(rng, 1.0, (0, 2), (32, 32), periodic_z=True)
    rhs = {"c": "laplace(c**3 - c - 0.01*laplace(c))"}
    _run_both(jpde.PDE(rhs, bc_ops={"c:laplace": bc}), tpde.PDE(rhs, bc_ops={"c:laplace": bc}),
              jfield, tfield, 1e-6, 2e-4, monkeypatch)
    rhs = {"u": "divergence(gradient(u))"}
    _run_both(jpde.PDE(rhs, bc_ops={"u:*": bc}), tpde.PDE(rhs, bc_ops={"u:*": bc}),
              jfield, tfield, 5e-5, 5e-4, monkeypatch)


@pytest.mark.parametrize("rhs, bc", [
    ("0.01 * divergence(gradient(c))", {"derivative": 0}),
    ("0.01 * laplace(c) - 0.05 * divergence(gradient(c**2))", {"derivative": 0}),
    ("0.02 * dot(gradient(c), gradient(c)) + 0.01 * laplace(c)", {"value": 0.1}),
])
def test_divergence_gradient_windows_match_pde_tpu(rhs, bc, monkeypatch):
    """pde_tpu's test_cylindrical_divergence_gradient_fuses, held against the port."""
    jfield, tfield = _pair(np.random.default_rng(8), 1.0, (0, 1), (16, 16))
    _run_both(jpde.PDE({"c": rhs}, bc=bc), tpde.PDE({"c": rhs}, bc=bc), jfield, tfield, 1e-4,
              0.002, monkeypatch)


def test_predefined_models_match_pde_tpu(monkeypatch):
    """pde_tpu's test_predefined_models_fuse_on_cylindrical: Allen-Cahn and
    Cahn-Hilliard through the radial helpers."""
    rng = np.random.default_rng(9)
    bc = {"r": {"derivative": 0}, "z": "periodic"}
    jfield, tfield = _pair(rng, 1.0, (0, 2), (32, 32), periodic_z=True)
    _run_both(jpde.AllenCahnPDE(interface_width=0.01, bc=bc),
              tpde.AllenCahnPDE(interface_width=0.01, bc=bc), jfield, tfield, 1e-5, 1e-3,
              monkeypatch)
    _run_both(jpde.CahnHilliardPDE(bc_c=bc, bc_mu=bc), tpde.CahnHilliardPDE(bc_c=bc, bc_mu=bc),
              jfield, tfield, 1e-7, 2e-5, monkeypatch)


def test_rk4_window_matches_pde_tpu(monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(10)
    bc = {"r": {"derivative": 0}, "z": {"value": 0}}
    jfield, tfield = _pair(rng, 1.0, (0, 2), (32, 32))
    rhs = {"c": "laplace(c**3 - c - 0.01*laplace(c))"}
    expected = jpde.PDE(rhs, bc=bc).solve(jfield, t_range=4e-5, dt=1e-6, solver="runge-kutta",
                                          tracker=None)
    teq = tpde.PDE(rhs, bc=bc)
    got = teq.solve(tfield, t_range=4e-5, dt=1e-6, solver="runge-kutta", tracker=None)
    assert teq.diagnostics["solver"].get("fused_step") is True
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)


# -- the gates ------------------------------------------------------------------------------
GATES = {
    "unsupported operator": (
        lambda: tpde.PDE({"c": "laplace(c) + 0.01 * divergence(vector_laplace(gradient(c)))"},
                         bc={"derivative": 0}),
        "scalar", "take only"),
    "vector state": (lambda: tpde.PDE({"v": "gradient(divergence(v))"}, bc={"derivative": 0}),
                     "vector", "Cartesian grids"),
    "noise": (lambda: tpde.DiffusionPDE(0.1, noise=0.1, bc={"derivative": 0}), "scalar",
              "2D Cartesian grids only"),
}


def _gate_state(kind):
    grid = tpde.CylindricalSymGrid(1.0, (0, 2), (12, 10))
    cls = tpde.ScalarField if kind == "scalar" else tpde.VectorField
    return cls.random_uniform(grid, dtype=F64, rng=np.random.default_rng(1))


@pytest.mark.parametrize("gate", GATES)
def test_gates_raise_under_cuda_and_fall_back_under_torch(gate):
    make_eq, kind, reason = GATES[gate]
    state = _gate_state(kind)
    with pytest.raises(tpde.KernelUnsupportedError, match=reason):
        make_eq().make_fused_euler_window(state, 1e-4)
    with pytest.raises(RuntimeError, match=reason):
        tpde.EulerSolver(make_eq(), backend="cuda").make_stepper(state, dt=1e-4)
    eq = make_eq()
    solver = tpde.EulerSolver(eq, backend="torch")
    result, _ = solver.make_stepper(state, dt=1e-4)(state, 0.0, 5e-4)
    assert "fused_step" not in solver.info and reason in solver.info["fused_unsupported"]
    assert bool(torch.isfinite(result.data).all())


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_meshes_of_cylindrical_grids_raise(backend):
    """What still raises on a mesh of a cylindrical grid: under `cuda` a
    configuration without a decomposed kernel (Cahn-Hilliard: the ext kernel
    #8 has no radial helpers, as in pde_tpu). Under `torch` such a run, and
    a global reduction in the plain rhs, take the plain sharded stepper and
    match the serial run. The mesh itself and the decomposed diffusion
    window run."""
    state = _gate_state("scalar")
    mesh = tpde.GridMesh(state.grid, [2, 1], devices=["cpu"] * 2)
    assert type(mesh.subgrid) is tpde.CylindricalSymGrid
    with tpde.config({"parallel.devices_per_device": 2}):
        _solve_on_a_mesh(state, backend)


def _solve_on_a_mesh(state, backend):
    if backend == "cuda":
        with pytest.raises(RuntimeError, match="do not support cylindrical grids"):
            tpde.PDE({"c": "laplace(c**3 - c - laplace(c))"}, bc={"derivative": 0}).solve(
                state, t_range=1e-3, dt=1e-4, tracker=None, backend=backend,
                decomposition=[2, 1])
    else:
        eq = tpde.PDE({"c": "laplace(c) - integral(c)"}, bc={"derivative": 0})
        got, info = eq.solve(state, t_range=1e-3, dt=1e-4, tracker=None, backend=backend,
                             decomposition=[2, 1], ret_info=True)
        assert info["solver"]["sharded_halo"] == 1
        serial = eq.solve(state, t_range=1e-3, dt=1e-4, tracker=None, backend=backend)
        torch.testing.assert_close(got.data, serial.data, rtol=1e-13, atol=1e-13)


def test_sde_windows_refuse_cylindrical_grids():
    state = _gate_state("scalar")
    with pytest.raises(tpde.KernelUnsupportedError, match="2D Cartesian"):
        cs.WindowProgram(state.grid, lambda helpers: lambda works: works, 1, 1)
    with pytest.raises(tpde.KernelUnsupportedError, match="Cartesian"):
        cs.TileHelpers(state.grid, 4, 0, 0)


@pytest.mark.parametrize("bc", [{"r": {"derivative": 0}, "z": {"value": 0.3}},
                                {"r-": {"derivative": 0}, "r+": {"value": 1.0}, "z": "periodic"}])
def test_registry_laplace_matches_pallas_registry(bc, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    periodic = "periodic" in str(bc)
    jgrid = jpde.CylindricalSymGrid(1.0, (0, 2), (16, 16), periodic_z=periodic)
    tgrid = tpde.CylindricalSymGrid(1.0, (0, 2), (16, 16), periodic_z=periodic)
    data = np.random.default_rng(12).uniform(-1, 1, jgrid.shape)
    data32 = data.astype(np.float32)
    expected = np.asarray(jpde.get_backend("pallas").make_operator(jgrid, "laplace", bc=bc)(data32))
    op = tpde.get_backend("cuda").make_operator(tgrid, "laplace", bc=bc)
    got = op(torch.tensor(data32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-5 * np.abs(expected).max())
    np.testing.assert_allclose(op(torch.tensor(data)).numpy(),
                               tgrid.make_operator("laplace", bc)(torch.tensor(data)).numpy(),
                               rtol=1e-12, atol=1e-12 * np.abs(expected).max())


def test_registry_of_radial_grids():
    backend = tpde.get_backend("cuda")
    cyl = tpde.CylindricalSymGrid(1.0, (0, 2), (8, 8))
    assert backend.registered_operators(cyl) == ["laplace"]
    with pytest.raises(tpde.KernelUnsupportedError, match="no kernel for operator 'gradient'"):
        backend.make_operator(cyl, "gradient", {"derivative": 0})
    for grid in (tpde.PolarSymGrid(1.0, 8), tpde.SphericalSymGrid(1.0, 8)):
        assert backend.registered_operators(grid) == []
        with pytest.raises(tpde.KernelUnsupportedError, match="backend='torch'"):
            backend.make_operator(grid, "laplace", {"derivative": 0})
        # the torch engine serves the plain operators
        op = tpde.get_backend("torch").make_operator(grid, "laplace", {"derivative": 0})
        assert op(torch.zeros(8, dtype=F64)).shape == (8,)
