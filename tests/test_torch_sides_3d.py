"""Boundary values that vary over a face, in time, or in space and time on 3D
grids: the side inputs of the generated 3D window (kernel #5, whose Hopper
kernel also serves #4), serially.

The specs (``collect_bc_side_inputs_3d``, entries and order as ``pde_tpu``'s),
the face tables (each axis padded, wrapped or its edge repeated), the
window's plain version on CPU tensors held against ``pde_tpu``'s fused 3D
window in interpret mode (the cases of ``pde_tpu``'s
``tests/ops/test_pallas_3d.py:492-560, 579-690, 692-770`` on its 8x8x16 grid:
per-face arrays, values in time on a row and a column face, values in space
and time, per-face Robin factors, ``bc_ops`` routing on a coupled
Brusselator; Euler, RK4 and AB2) at rtol 1e-12, atol 1e-13 in fp64; the
replay of the kernel's march with the side inputs against the plain version
bit for bit, at tile seams and on a ragged grid; tracker windows restarting
the tables; what stays refused; and the generated sources the parent
emitted, which keep their digests.
"""

import hashlib

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops import pallas_cartesian as pc
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_cartesian_3d as c3
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.ops import cuda_stencil_3d as s3
from pde_tpu_torch.parallel import GridMesh

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-13)
F64 = torch.float64
SHAPE = (8, 8, 16)
BOUNDS = [(0, 1), (0, 2), (0, 3)]
DT = 2e-4
T0 = 0.3


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _data(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).uniform(0.2, 0.8, size=shape)


def _face(seed, axis, shape=SHAPE, low=-1.0, high=1.0):
    """Values over the face of `axis` (its other two axes)."""
    face = tuple(n for a, n in enumerate(shape) if a != axis)
    return np.random.default_rng(seed).uniform(low, high, face)


def _bc(axis, low, high=None):
    """No-flux faces, but `low` (and `high`) on `axis`."""
    axes = "xyz"
    bc = {axes[a]: {"derivative": 0} for a in range(3) if a != axis}
    bc[f"{axes[axis]}-"] = low
    bc[f"{axes[axis]}+"] = {"derivative": 0} if high is None else high
    return bc


CASES = {
    # per-face value arrays (test_3d_inhomogeneous_bc_parity)
    **{f"array {'xyz'[ax]}": _bc(ax, {"value": _face(1, ax)}) for ax in range(3)},
    # values in time on a column and a row face, with an array
    # (test_3d_time_dependent_bc_parity)
    "t col": {"x": {"derivative": 0}, "y-": {"value_expression": "sin(3 * t)"},
              "y+": {"value": 0}, "z": {"derivative": 0}},
    "t row": {"x-": {"value_expression": "t"}, "x+": {"derivative": 0},
              "y": {"derivative": 0}, "z": {"value": 0}},
    "mixed array and t": {"x-": {"value_expression": "sin(y + z)"}, "x+": {"derivative": 0.5},
                          "y-": {"derivative_expression": "cos(2 * t)"}, "y+": {"value": 0},
                          "z": {"derivative": 0}},
    # values in space and time (test_3d_space_time_bc_parity)
    "xt x": {"x-": {"value_expression": "sin(y + z - t)"}, "x+": {"derivative": 0},
             "y": {"derivative": 0}, "z": {"value": 0}},
    "xt y": {"x": {"derivative": 0}, "y-": {"value_expression": "sin(z - 2 * t)"},
             "y+": {"value": 0}, "z": {"derivative": 0}},
    "xt z": {"x": {"derivative": 0}, "y": {"value": 0},
             "z-": {"value_expression": "cos(x + t)"}, "z+": {"derivative": 0}},
    "xt plus array plus t": {
        "x-": {"value_expression": "sin(y + z - t)"}, "x+": {"derivative": 0},
        "y-": {"value": np.linspace(-1, 1, 8 * 16).reshape(8, 16)},
        "y+": {"value_expression": "sin(3 * t)"}, "z": {"derivative": 0}},
    # Robin faces with per-face gamma arrays (test_3d_array_factor_parity)
    **{f"factor {'xyz'[ax]}": _bc(ax, {"type": "mixed", "value": _face(2, ax, low=0.5, high=2.0),
                                      "const": 0.3}, {"value": 0}) for ax in range(3)},
}


def _grids(shape=SHAPE, periodic=False):
    return (jpde.CartesianGrid(BOUNDS, list(shape), periodic=periodic),
            tpde.CartesianGrid(BOUNDS, list(shape), periodic=periodic))


def _states(seed=0, shape=SHAPE, periodic=False):
    jgrid, tgrid = _grids(shape, periodic)
    return (jpde.ScalarField(jgrid, _data(seed, shape)),
            tpde.ScalarField(tgrid, _data(seed, shape), dtype=F64))


# -- the specs and the tables -------------------------------------------------------------------
@pytest.mark.parametrize("case", ["mixed array and t", "xt plus array plus t", "factor y"])
def test_face_specs_match_jax(case):
    """collect_bc_side_inputs_3d: the same entries in pde_tpu's order."""
    jgrid, tgrid = _grids()
    bc = CASES[case]
    jspecs = pc.affine_bc_specs(jgrid, jgrid.get_boundary_conditions(bc))
    tspecs = cc.affine_bc_specs(tgrid, tgrid.get_boundary_conditions(bc))
    jin = pc.collect_bc_side_inputs_3d({("c", "laplace"): jspecs})
    tin = cc.collect_bc_side_inputs_3d({("c", "laplace"): tspecs})
    assert list(tin) == list(jin) == ["arrays", "t", "xt"]
    assert [(ax, attr) for ax, _, attr in tin["arrays"]] == \
        [(ax, attr) for ax, _, attr in jin["arrays"]]
    for (_, tspec, attr), (_, jspec, _) in zip(tin["arrays"], jin["arrays"], strict=True):
        np.testing.assert_allclose(np.ravel(getattr(tspec, attr)),
                                   np.ravel(getattr(jspec, attr)), **TOL)
    assert [attr for _, attr in tin["t"]] == [attr for _, attr in jin["t"]]
    assert [ax for ax, _ in tin["xt"]] == [ax for ax, _ in jin["xt"]]
    scalar = cc.affine_bc_specs(tgrid, tgrid.get_boundary_conditions({"value": 1.5}))
    assert cc.collect_bc_side_inputs_3d({0: scalar}) is None


def test_face_tables_pad_each_axis():
    """A face's table covers its two axes, each padded by the deepest halo:
    wrapped on a periodic axis, the edge value repeated otherwise, and past
    the grid's end by the march's column tile (FACE_TAIL)."""
    assert cs.FACE_TAIL == (0, c3.MARCH_TY[0], c3.MARCH_TZ)
    grid = tpde.CartesianGrid(BOUNDS, [6, 5, 7], periodic=[False, True, False])
    sides = cs.SideInputs(grid)
    sides.pad = 2
    values = torch.arange(6 * 7, dtype=F64)  # a y face over (x, z)
    table = sides._padded(values, "y").reshape(sides.face_shape("y"))
    assert sides.face_shape("y") == (6 + 4, 7 + 4 + 64)
    grid_face = values.reshape(6, 7)
    x = torch.arange(-2, 6 + 2).clamp(0, 5)
    z = torch.arange(-2, 7 + 2 + 64).clamp(0, 6)
    assert torch.equal(table, grid_face[x[:, None], z[None, :]])
    values = torch.arange(5 * 7, dtype=F64)  # an x face over (y, z): y wraps
    table = sides._padded(values, "x").reshape(sides.face_shape("x"))
    y = torch.arange(-2, 5 + 2 + 32) % 5
    assert torch.equal(table, values.reshape(5, 7)[y[:, None], z[None, :]])
    assert sides.gather(table.reshape(-1), "x", (torch.tensor(-1), torch.tensor(3))) == \
        values.reshape(5, 7)[4, 3]


# -- the windows against pde_tpu ---------------------------------------------------------------
def _solve(pkg, state, eq_of, solver="euler", steps=20, tracker=None, **kwargs):
    eq = eq_of(pkg)
    extra = {} if pkg is jpde else {"backend": "torch"}
    res, info = eq.solve(state, t_range=[T0, T0 + steps * DT], dt=DT, tracker=tracker,
                         solver=solver, ret_info=True, **extra, **kwargs)
    assert info["solver"].get("fused_step"), info["solver"]
    return res


@pytest.mark.parametrize("case", CASES)
def test_windows_match_jax(case, monkeypatch):
    """3D diffusion with the case's faces: the port takes the 3D expression
    window (its plain version on CPU tensors, as pde_tpu reroutes such
    faces from #3 to #5), pde_tpu its fused window in interpret mode."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    bc = CASES[case]
    jstate, tstate = _states(3)
    window = tpde.DiffusionPDE(0.1, bc=bc).make_fused_euler_window(tstate, DT)
    assert window.program.library == "multi_stencil_3d" and window.program.sides is not None
    assert window.needs_t == window.program.sides.needs_t
    out = [_solve(pkg, state, lambda p: p.DiffusionPDE(0.1, bc=bc))
           for pkg, state in ((jpde, jstate), (tpde, tstate))]
    np.testing.assert_allclose(out[1].data.numpy(), np.asarray(out[0].data), **TOL)


ALLEN_CAHN_BC = {"x-": {"type": "mixed", "value": _face(4, 0, low=0.5, high=2.0), "const": 0.3},
                 "x+": {"derivative": 0}, "y-": {"value_expression": "sin(3*t)"},
                 "y+": {"derivative": 0}, "z": {"derivative": 0}}


@pytest.mark.parametrize("solver", ["euler", "runge-kutta", "adams-bashforth"])
def test_schemes_match_jax(solver, monkeypatch):
    """Allen-Cahn with a per-face Robin gamma and a face in time (the card's
    path (b)) through each scheme's 3D window: RK4's stages read their
    tables at t, t + dt/2 and t + dt."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jstate, tstate = _states(5)
    out = [_solve(pkg, state, lambda p: p.PDE({"u": "laplace(u) + u - u**3"}, bc=ALLEN_CAHN_BC),
                  solver=solver, steps=8)
           for pkg, state in ((jpde, jstate), (tpde, tstate))]
    np.testing.assert_allclose(out[1].data.numpy(), np.asarray(out[0].data), **TOL)


def test_coupled_bc_ops_brusselator(monkeypatch):
    """Per-(variable, operator) routing with an array and a value in time on
    two faces through the coupled 3D window
    (test_3d_coupled_routed_bc_side_inputs)."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    vals = np.random.default_rng(6).uniform(0.0, 1.0, (8, 16))
    bc_ops = {"u:laplace": {"x": {"derivative": 0}, "y-": {"value": vals},
                            "y+": {"derivative": 0}, "z": {"value": 0}},
              "v:laplace": {"x": {"derivative": 0}, "y": {"derivative": 0},
                            "z-": {"value_expression": "cos(t)"}, "z+": {"value": 0}}}
    rhs = {"u": "1 + u**2*v - 2.2*u + 0.1*laplace(u)", "v": "1.2*u - u**2*v + 0.05*laplace(v)"}
    out = []
    for pkg, grid in zip((jpde, tpde), _grids(), strict=True):
        kw = {} if pkg is jpde else {"dtype": F64}
        state = pkg.FieldCollection([pkg.ScalarField(grid, _data(7 + i), **kw) for i in range(2)],
                                    labels=["u", "v"])
        out.append(_solve(pkg, state, lambda p: p.PDE(rhs, bc_ops=bc_ops)))
    for j, t in zip(*out, strict=True):
        np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), **TOL)


@pytest.mark.parametrize("solver", ["euler", "runge-kutta", "adams-bashforth"])
def test_tracker_windows_restart_the_tables(solver, monkeypatch):
    """Tracker windows start where the last ended, and a window's tables are
    evaluated a few steps at a time: the fused run is the plain loop's, its
    steps at the same times (test_3d_time_bc_tracker_windows)."""
    monkeypatch.setattr(cs, "SIDE_BLOCK", 3)
    bc = {"x": {"derivative": 0}, "y-": {"value_expression": "sin(5 * t)"},
          "y+": {"value": 0}, "z-": {"value_expression": "cos(x + 20 * t)"},
          "z+": {"derivative": 0}}
    _, state = _states(8)
    eq = tpde.DiffusionPDE(0.2, bc=bc)
    storage = tpde.MemoryStorage()
    fused = _solve(tpde, state, lambda p: eq, solver=solver, steps=23,
                   tracker=storage.tracker(7 * DT))
    assert len(storage) >= 4
    plain = eq.solve(state, t_range=[T0, T0 + 23 * DT], dt=DT, tracker=None, solver=solver,
                     backend="numpy")
    np.testing.assert_allclose(fused.data.numpy(), plain.data.numpy(), **TOL)


# -- the replay of the kernel's march -------------------------------------------------------------
REPLAYS = {
    "array x and xt z": (SHAPE, {"x-": {"value": _face(9, 0)}, "x+": {"derivative": 0},
                                 "y": {"derivative": 0},
                                 "z-": {"value_expression": "cos(x + t)"},
                                 "z+": {"derivative": 0}}),
    "ragged t and factor": ((10, 12, 14), {
        "x": {"derivative": 0}, "y-": {"value_expression": "sin(3*t)"}, "y+": {"value": 0},
        "z-": {"type": "mixed", "value": _face(10, 2, (10, 12, 14), 0.5, 2.0), "const": 0.3},
        "z+": {"derivative": 0}}),
    "ragged xt on x, periodic z": ((10, 12, 14), {
        "x-": {"value_expression": "sin(y + z - t)"}, "x+": {"value": 0},
        "y": {"curvature": 0.5}, "z": "periodic"}),
}


@pytest.mark.parametrize("case", REPLAYS)
@pytest.mark.parametrize("scheme", ["euler", "rk4"])
def test_march_replay_reads_the_faces(case, scheme):
    """The replay of the kernel's march reads each face where the kernel
    does (at a plane's x and the columns' (y, z), from the padded tables):
    equal to the plain version bit for bit at every ladder k, at plans that
    cut the grid into chunks and column tiles with seams on every axis."""
    shape, bc = REPLAYS[case]
    periodic = [False, False, bc.get("z") == "periodic"]
    grid = tpde.CartesianGrid(BOUNDS, list(shape), periodic=periodic)
    state = tpde.ScalarField(grid, _data(11, shape), dtype=F64)
    eq = tpde.PDE({"u": "0.1 * laplace(u) + u - u**3 - 0.05 * gradient_squared(u)"}, bc=bc)
    window = getattr(eq, f"make_fused_{scheme}_window")(state, DT)
    program = window.program
    assert isinstance(program, s3.StencilProgram3D) and program.sides is not None
    for spec in window.specs:
        block = program.sides.block(T0, 0, spec.k + 2, DT, F64, "cpu")
        views = program.sides.for_pass(F64, "cpu", spec.k, block, 2)
        plain = s3.multi_stencil_3d_plain([state.data], spec, views)
        for tile in ((5, 4, 8), (3, 7, 5), None):
            marched = s3.multi_stencil_3d_marched([state.data], spec, tile, views)
            assert torch.equal(marched[0], plain[0]), (spec.k, tile)


def test_two_deep_rk4_with_a_face_in_time_matches_jax(monkeypatch):
    """``laplace(c**3 - c - laplace(c))`` with a face in time, RK4: the window
    of four passes a step (their stages' tables at t, t + dt/2 and t + dt)
    against pde_tpu's fused window in interpret mode."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jstate, tstate = _states(14)
    program = tpde.PDE({"c": "laplace(c**3 - c - laplace(c))"}, bc=CASES["t col"]) \
        .make_fused_rk4_window(tstate, DT).program
    assert len(program.passes) == 4 and program.sides is not None and program.ladder == [1]
    out = [_solve(pkg, state, lambda p: p.PDE({"c": "laplace(c**3 - c - laplace(c))"},
                                              bc=CASES["t col"]), solver="runge-kutta", steps=6)
           for pkg, state in ((jpde, jstate), (tpde, tstate))]
    np.testing.assert_allclose(out[1].data.numpy(), np.asarray(out[0].data), **TOL)


# -- sources, entry points, refusals ------------------------------------------------------------
# sources the parent tree emitted, which side inputs in 3D leave as they were
# (the 2D ones with side inputs, the scalar 3D ones of every scheme and mesh)
SOURCES = {
    "2d sides euler": "8319aa3ff63b923d5f1a6fdce801b4fb716024a48855358851893f5c6aaae7d0",
    "2d sides rk4": "1c126c073b5276861c741010107e658d737b8295fa6fc6630eb51a3b0700359a",
    "2d sides ext": "e4a956e8341c7579ae8913e1aea11ea751db1e767891c1cbaed18faa68d6d825",
    "3d ext allen-cahn": "d22f759fca51c4c6729d9ec9a205f91cddcdfce59c7882dafa2bc1c9eddf6618",
    "3d ext mixed faces": "a336c564c6c8cbdbde5a08e2dd3fed77385d0dbc5819e89a643e4ebbb901f871",
    "3d rk4 mixed faces": "2afe9188c0de455042b76b43b2d7b6680be42d86524d6a8d797dca415b4260e1",
    "3d ab2 mixed faces": "e4bbff901e91345aca6b7265a3211af960f34f2a6fc3ff3e23201e9234df2cb0",
}


def test_sources_keep_their_digests():
    def digest(window):
        return hashlib.sha256(window.program.source.encode()).hexdigest()

    got = {}
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], [12, 14])
    state = tpde.ScalarField(grid, 0.1, dtype=F64)
    bc = {"x-": {"value": np.linspace(-1, 1, 14)}, "x+": {"derivative_expression": "cos(t)"},
          "y-": {"value_expression": "sin(x - 2*t)"}, "y+": {"mixed": "1 + x", "const": 0.3}}
    eq = tpde.PDE({"c": "0.1 * laplace(c) - c**3 + 0.1 * gradient_squared(c)"}, bc=bc)
    got["2d sides euler"] = digest(eq.make_fused_euler_window(state, 1e-3))
    got["2d sides rk4"] = digest(eq.make_fused_rk4_window(state, 1e-3))
    got["2d sides ext"] = digest(eq.make_fused_euler_window(
        state, 1e-3, mesh=GridMesh(grid, [2, 2], devices=["cpu"] * 4)))
    cube = tpde.UnitGrid([16, 16, 16], periodic=True)
    got["3d ext allen-cahn"] = digest(tpde.AllenCahnPDE().make_fused_euler_window(
        tpde.ScalarField(cube, 0.1, dtype=torch.float32), 1e-3,
        mesh=GridMesh(cube, [2, 2, 2], devices=["cpu"] * 8)))
    box = tpde.CartesianGrid(BOUNDS, [16, 16, 16])
    state = tpde.ScalarField(box, 0.1, dtype=torch.float32)
    eq = tpde.PDE({"u": "laplace(u) + u - u**3"},
                  bc={"x": {"value": 0.2}, "y": {"derivative": 0.1}, "z": {"curvature": 0.5}})
    got["3d ext mixed faces"] = digest(eq.make_fused_euler_window(
        state, 1e-3, mesh=GridMesh(box, [2, 2, 2], devices=["cpu"] * 8)))
    got["3d rk4 mixed faces"] = digest(eq.make_fused_rk4_window(state, 1e-3))
    got["3d ab2 mixed faces"] = digest(eq.make_fused_ab2_window(state, 1e-3))
    assert got == SOURCES


def test_side_program_takes_its_own_entry_point():
    """A 3D program with side inputs launches the side-input kernel (tables
    and strides among its arguments); its library depends on the inputs'
    kinds, not on their values."""
    _, state = _states(12)

    def program(bc):
        return tpde.DiffusionPDE(0.1, bc=bc).make_fused_euler_window(state, DT).program

    first = program(CASES["xt plus array plus t"])
    source = first.source
    assert "launch_sides_3d" in source and "kSideInputs = 3" in source
    assert "O.sv[0]" in source and "MarchOperands<T, kVolumes, kSideInputs>" in source
    other = dict(CASES["xt plus array plus t"])
    other["y-"] = {"value": np.linspace(2, 3, 8 * 16).reshape(8, 16)}
    other["y+"] = {"value_expression": "cos(t) + t**2"}
    assert program(other).digest == first.digest
    other["x-"] = {"value": _face(13, 0)}  # another kind: a static face
    assert program(other).digest != first.digest
    strides = cs.side_args(first, first.sides.for_pass(F64, "cpu", 1, first.sides.block(
        T0, 0, 1, DT, F64, "cpu")))[1]
    assert list(strides)[3:] == [first.sides.row_stride(i) for i in range(3)]
    assert [first.sides.kind(i) for i in range(3)] == ["x", "y", "t"]


def test_what_pde_tpu_refuses_stays_refused():
    """Vector states with values that vary over a face and 3D SDE windows
    raise, naming pde_tpu's message; the torch engine runs them on the plain
    loop. (The 3D RK4 step of a two-deep rhs, refused before, now fuses:
    ``test_two_deep_rk4_with_a_face_in_time_matches_jax``.)"""
    grid = tpde.CartesianGrid(BOUNDS, list(SHAPE))
    timed = CASES["t col"]
    vector = tpde.VectorField(grid, 0.1, dtype=F64)
    cases = [
        (tpde.PDE({"v": "vector_laplace(v)"}, bc=CASES["array x"]), vector, "euler",
         "require scalar BC values"),
        (tpde.DiffusionPDE(0.1, bc=timed, noise=0.1), None, "euler", "3D SDE"),
    ]
    for eq, state, kind, match in cases:
        state = tpde.ScalarField(grid, _data(14), dtype=F64) if state is None else state
        with pytest.raises(tpde.KernelUnsupportedError, match=match):
            getattr(eq, f"make_fused_{kind}_window")(state, DT)
        with pytest.raises(RuntimeError, match=match):
            solver = {"euler": "euler", "rk4": "runge-kutta"}[kind]
            eq.solve(state, t_range=[T0, T0 + 2 * DT], dt=DT, tracker=None, solver=solver,
                     backend="cuda")
