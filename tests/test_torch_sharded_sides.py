"""Decomposed 2D windows with boundary values that vary along a side, in time,
or in space and time (the side inputs of the ext kernels #12 and #8): every
block reads the global grid's side tables at its origin.

The kernel layer: each ext kernel's plain version, tile emulation (#12) and
march replay on the blocks of [2, 1], [1, 2] and [2, 2] meshes, put together,
equal the serial side-input pass (kernels #1 and #7's plain versions) bit for
bit at every k of the ladders. The solves: the cases of ``pde_tpu``'s
``tests/parallel/test_sharded.py:809-1147`` through the port's decomposed
windows under the ``torch`` engine (``fused_step``), bit-equal to the port's
serial side-input window and within 1e-12 of ``pde_tpu``'s decomposed run
(its plain ``shard_map`` stepper on its 8 virtual CPU devices). fp64.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.parallel import GridMesh, HaloExchange

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
EXACT = dict(rtol=0, atol=0)
F64 = torch.float64
SHAPE = (16, 16)
BOUNDS = [(0, 1), (0, 2)]
CUTS = [[2, 1], [1, 2], [2, 2]]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _data(seed=0, shape=SHAPE, low=0.2, high=0.8):
    return np.random.default_rng(seed).uniform(low, high, size=shape)


def _grid(pkg, periodic=False, shape=SHAPE, bounds=BOUNDS):
    return pkg.CartesianGrid(bounds, list(shape), periodic=periodic)


def _blocks(mesh, datas, halo):
    """Every block's extended buffers of the global planes `datas` (one
    tensor or a list), filled by the windows' exchange, and its flags with
    its origin."""
    datas = [datas] if isinstance(datas, torch.Tensor) else list(datas)
    exchange = HaloExchange(mesh, halo)
    buffers = exchange.allocate(len(datas), datas[0].dtype)
    exchange.load(buffers, [list(planes) for planes in
                            zip(*(mesh.split_field_data(d) for d in datas))])
    exchange.copy(exchange.strips(buffers))
    flags = [mesh.edge_flags(b) + list(mesh.block_origin(b)) for b in range(len(mesh))]
    return buffers, flags


def _put_together(mesh, parts):
    return mesh.combine_field_data(parts)


# -- #12 with side inputs ----------------------------------------------------------------------
AFFINE_CASES = {
    "arrays on both axes": (False, {
        "x-": {"value": np.linspace(-1.0, 1.0, 16)}, "x+": {"derivative": 0},
        "y-": {"value": "x**2"}, "y+": {"mixed": 2.0, "const": 0.1}}),
    "t on both column sides": (False, {
        "x": {"derivative": 0}, "y-": {"derivative_expression": "0.5 * cos(t)"},
        "y+": {"value_expression": "sin(t)"}}),
    "periodic x, t and an array on y": ([True, False], {
        "x": "periodic", "y-": {"value_expression": "sin(5 * t)"},
        "y+": {"value": np.linspace(0.0, 1.0, 16)}}),
    "periodic y, an array and t on x": ([False, True], {
        "x-": {"value": "sin(y)"}, "x+": {"value_expression": "t"}, "y": "periodic"}),
}


@pytest.mark.parametrize("cut", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("case", AFFINE_CASES)
def test_affine_ext_sides_over_blocks_is_the_serial_pass(case, cut):
    """#12's plain version, tile emulation and march replay on every block,
    their side inputs the global tables at each block's origin (row sides
    padded by SIDE_PAD columns), put together, equal #1's side-input pass on
    the grid bit for bit at k = 6, 3, 1, halo 6."""
    periodic, bc = AFFINE_CASES[case]
    grid = _grid(tpde, periodic)
    bcs = grid.get_boundary_conditions(bc)
    data = torch.tensor(_data(1))
    mesh = GridMesh(grid, cut, devices=["cpu"] * int(np.prod(cut)))
    inputs = cc.AffineSideInputs(grid, bcs)
    buffers, flags = _blocks(mesh, data, cc.SIDES_TOP_STEPS)
    for k in (6, 3, 1):
        times = [0.3 + s * 0.01 for s in range(k)]
        spec = cc.affine_laplace_spec(grid, a=1.0, b=1e-3, k=k, dtype=F64, bcs=bcs)
        serial = cc.affine_laplace_2d_plain(data, spec, inputs.for_pass(F64, "cpu", times))
        ext_spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=1e-3, k=k,
                                              halo=cc.SIDES_TOP_STEPS, dtype=F64, bcs=bcs)
        sides = inputs.for_pass(F64, "cpu", times, row_pad=cc.SIDE_PAD)
        for run in (ce.affine_laplace_ext_2d_plain,
                    lambda e, s, f, sd: ce.affine_laplace_ext_2d_tiled(e, s, f, (5, 3), sd),
                    lambda e, s, f, sd: ce.affine_laplace_ext_2d_marched(e, s, f, (7, 5), sd)):
            parts = [run(ext[0], ext_spec, block_flags, sides)
                     for ext, block_flags in zip(buffers, flags, strict=True)]
            torch.testing.assert_close(_put_together(mesh, parts), serial, **EXACT)


def test_affine_ext_sides_wrapper_and_its_checks():
    """The wrapper on CPU buffers runs the plain version into the interiors
    and counts no launch; it refuses missing or mismatched side inputs and
    flags without an origin."""
    grid = _grid(tpde)
    bcs = grid.get_boundary_conditions(AFFINE_CASES["arrays on both axes"][1])
    mesh = GridMesh(grid, [2, 2], devices=["cpu"] * 4)
    spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=1e-3, k=3, halo=6,
                                      dtype=F64, bcs=bcs)
    assert spec.has_sides and (spec.grid_rows, spec.grid_cols) == (16, 16)
    data = torch.tensor(_data(2))
    buffers, flags = _blocks(mesh, data, 6)
    outs = [[torch.zeros_like(b[0])] for b in buffers]
    inputs = cc.AffineSideInputs(grid, bcs)
    sides = inputs.for_pass(F64, "cpu", row_pad=cc.SIDE_PAD)
    before = ce.affine_laplace_ext_2d.launches
    ce.affine_laplace_ext_2d([b[0] for b in buffers], [o[0] for o in outs], flags, spec,
                             sides=sides)
    assert ce.affine_laplace_ext_2d.launches == before
    got = _put_together(mesh, [o[0][6:-6, 6:-6] for o in outs])
    serial_spec = cc.affine_laplace_spec(grid, a=1.0, b=1e-3, k=3, dtype=F64, bcs=bcs)
    torch.testing.assert_close(
        got, cc.affine_laplace_2d_plain(data, serial_spec, inputs.for_pass(F64, "cpu")), **EXACT)
    ins, outs = [b[0] for b in buffers], [o[0] for o in outs]
    with pytest.raises(ValueError, match="give them"):
        ce.affine_laplace_ext_2d(ins, outs, flags, spec)
    with pytest.raises(ValueError, match="padded"):
        ce.affine_laplace_ext_2d(ins, outs, flags, spec, sides=inputs.for_pass(F64, "cpu"))
    with pytest.raises(ValueError, match="6 ints"):
        ce.affine_laplace_ext_2d(ins, outs, [f[:4] for f in flags], spec, sides=sides)
    with pytest.raises(ValueError, match="first column"):
        ce.affine_laplace_ext_2d(ins, outs, [f[:5] + [12] for f in flags], spec, sides=sides)
    with pytest.raises(tpde.KernelUnsupportedError, match="halo of at most"):
        ce.affine_laplace_ext_spec(tpde.CartesianGrid(BOUNDS, [40, 40]), (20, 20), a=1.0,
                                   b=1e-3, k=3, halo=cc.SIDE_PAD + 1, dtype=F64,
                                   bcs=tpde.CartesianGrid(BOUNDS, [40, 40])
                                   .get_boundary_conditions({"x-": {"value": "y"},
                                                             "x+": {"value": 0},
                                                             "y": {"derivative": 0}}))
    assert ce.affine_ext_source((False, False), sides=True).library == cc.SIDES_EXT_LIBRARY
    assert "launch_affine_sides_ext_2d<float, 6," in cc.emit_source(cc.SIDES_EXT_LIBRARY,
                                                                   (False, False))


# -- #8 with side inputs -----------------------------------------------------------------------
MULTI_CASES = {
    # a time-dependent Dirichlet side, a per-point array side, a side varying in
    # space and time (chip_smoke's main path's sides)
    "cahn-hilliard, t, array and xt": (
        lambda p, bc: p.PDE({"c": "laplace(c**3 - c - laplace(c))"}, bc=bc),
        {"x-": {"value_expression": "0.1*sin(3*t)"}, "x+": {"value": "0.1*sin(y)"},
         "y-": {"value_expression": "cos(x)*sin(t)"}, "y+": {"derivative": 0}},
        [(0, 16), (0, 32)], 1e-3),
    # a per-point ghost factor and a time-dependent one
    "factors": (
        lambda p, bc: p.PDE({"c": "0.1 * laplace(c) - c**3"}, bc=bc),
        {"x-": {"type": "mixed", "value": np.linspace(0.5, 2.0, 16), "const": 0.2},
         "x+": {"derivative": 0}, "y-": {"mixed_expression": "1 + t", "const": "x"},
         "y+": {"value": 0}},
        BOUNDS, 1e-3),
}
SCHEMES = {"euler": "make_fused_euler_window", "rk4": "make_fused_rk4_window",
           "ab2": "make_fused_ab2_window"}


@pytest.mark.parametrize("cut", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", MULTI_CASES)
def test_multi_ext_sides_over_blocks_is_the_serial_pass(case, scheme, cut):
    """#8's plain version and march replay on every block, reading the global
    grid's tables at each block's origin (RK4's stages at their times), put
    together, equal #7's side-input pass bit for bit at every k of the
    decomposed ladder."""
    make_eq, bc, bounds, dt = MULTI_CASES[case]
    grid = _grid(tpde, False, bounds=bounds)
    data = torch.tensor(_data(3, low=-0.3, high=0.3))
    state = tpde.ScalarField(grid, data)
    mesh = GridMesh(grid, cut, devices=["cpu"] * int(np.prod(cut)))
    eq = make_eq(tpde, bc)
    window = getattr(eq, SCHEMES[scheme])(state, dt, mesh=mesh)
    serial = getattr(eq, SCHEMES[scheme])(state, dt)
    assert window.sharded and window.needs_t and serial.needs_t
    assert isinstance(window.program, ce.ExtStencilProgram)
    assert window.program.sides.entries and window.program.sides.pad == serial.program.sides.pad
    n_planes = 2 if scheme == "ab2" else 1
    planes = [data, torch.tensor(_data(4, low=-1, high=1))][:n_planes]
    buffers, flags = _blocks(mesh, planes, window.specs[0].halo)
    serial_specs = {spec.k: spec for spec in serial.specs}
    for spec in window.specs:
        views = window.program.sides.passes(0.25, spec.k, dt, F64, "cpu")(0, spec.k)
        serial_views = serial.program.sides.passes(0.25, spec.k, dt, F64, "cpu")(0, spec.k)
        want = cs.multi_stencil_2d_plain(planes, serial_specs[spec.k], serial_views)
        for replay in (False, True):
            parts = [ce.multi_stencil_ext_2d_marched(ext, spec, f, (7, 5), views) if replay
                     else ce.multi_stencil_ext_2d_plain(ext, spec, f, views)
                     for ext, f in zip(buffers, flags, strict=True)]
            for p, plane in enumerate(want):
                torch.testing.assert_close(_put_together(mesh, [part[p] for part in parts]),
                                           plane, **EXACT)


def test_multi_ext_sides_wrapper_and_its_checks():
    """The wrapper on CPU buffers runs the plain version and counts no launch;
    it refuses missing side inputs and flags without the origin; the
    generated source launches the side-input ext kernel."""
    make_eq, bc, bounds, dt = MULTI_CASES["cahn-hilliard, t, array and xt"]
    grid = _grid(tpde, False, bounds=bounds)
    state = tpde.ScalarField(grid, torch.tensor(_data(5, low=-0.3, high=0.3)))
    mesh = GridMesh(grid, [2, 2], devices=["cpu"] * 4)
    window = make_eq(tpde, bc).make_fused_euler_window(state, dt, mesh=mesh)
    spec = window.specs[-1]
    buffers, flags = _blocks(mesh, state.data, spec.halo)
    outs = [[torch.zeros_like(b[0])] for b in buffers]
    views = window.program.sides.passes(0.0, spec.k, dt, F64, "cpu")(0, spec.k)
    before = ce.multi_stencil_ext_2d.launches
    ce.multi_stencil_ext_2d(buffers, outs, flags, spec, sides=views)
    assert ce.multi_stencil_ext_2d.launches == before
    with pytest.raises(ValueError, match="side inputs"):
        ce.multi_stencil_ext_2d(buffers, outs, flags, spec)
    with pytest.raises(ValueError, match="6 ints"):
        ce.multi_stencil_ext_2d(buffers, outs, [f[:4] for f in flags], spec, sides=views)
    source = window.program.source
    assert "launch_ext_sides_2d<Program" in source and "kSideInputs" in source
    assert "launch_ext_2d<Program" not in source


# -- the windows ---------------------------------------------------------------------------------
def test_side_input_windows_take_the_time_and_the_ladders():
    """#12's decomposed side-input window tops at SIDES_TOP_STEPS with halo
    6 and takes ``(blocks, t0, steps)`` where a value depends on time, its
    passes' t-tables from the window's t0; one with per-point values only
    takes ``(blocks, steps)``; a time-dependent ghost factor, which #12
    refuses as pde_tpu's does, goes to #8."""
    grid = _grid(tpde)
    state = tpde.ScalarField(grid, torch.tensor(_data(6)))
    mesh = GridMesh(grid, [2, 2], devices=["cpu"] * 4)
    timed = tpde.DiffusionPDE(0.05, bc=AFFINE_CASES["t on both column sides"][1])
    window = timed.make_fused_euler_window(state, 1e-3, mesh=mesh)
    assert window.needs_t and [s.k for s in window.specs] == [6, 3, 1]
    assert window.exchange.halo == cc.SIDES_TOP_STEPS
    blocks = [[b] for b in mesh.split_field_data(state.data)]
    late = mesh.combine_field_data([b[0] for b in window(blocks, 0.5, 10)])
    serial = timed.make_fused_euler_window(state, 1e-3)
    torch.testing.assert_close(late, serial(state.data, 0.5, 10), **EXACT)
    assert not torch.equal(late, serial(state.data, 0.0, 10))
    arrays = tpde.DiffusionPDE(0.05, bc=AFFINE_CASES["arrays on both axes"][1])
    assert not arrays.make_fused_euler_window(state, 1e-3, mesh=mesh).needs_t
    factor = tpde.DiffusionPDE(0.05, bc={"x": {"derivative": 0}, "y-": {
        "mixed_expression": "1 + t", "const": 0.1}, "y+": {"value": 0}})
    with pytest.raises(tpde.KernelUnsupportedError, match="kernel #1"):
        cc.affine_laplace_spec(grid, a=1.0, b=1e-3, k=1, dtype=F64,
                               bcs=grid.get_boundary_conditions(factor.bc))
    rerouted = factor.make_fused_euler_window(state, 1e-3, mesh=mesh)
    assert isinstance(rerouted.program, ce.ExtStencilProgram) and rerouted.needs_t


def test_three_dimensional_side_inputs_on_a_mesh_name_their_item():
    """A9.3's 3D half (#6) is ported: the decomposed 3D window takes the side
    inputs (every block reading the global face tables at its origin) and
    equals the serial side-input window bit for bit; the plain sharded
    stepper, which the torch engine runs where no window takes a run, agrees
    with the serial plain loop bit for bit too. What stays refused on a mesh
    names pde_tpu's message: vector states with values that vary over a
    face."""
    cube = tpde.UnitGrid([8, 8, 8])
    bc = {"x-": {"value_expression": "sin(3*t)"}, "x+": {"derivative": 0},
          "y": {"derivative": 0}, "z": {"derivative": 0}}
    state = tpde.ScalarField(cube, torch.tensor(_data(7, (8, 8, 8))))
    mesh = GridMesh(cube, [2, 1, 1], devices=["cpu"] * 2)
    window = tpde.PDE({"c": "laplace(c)"}, bc=bc).make_fused_euler_window(state, 1e-3, mesh=mesh)
    assert window.sharded and window.needs_t and window.program.sides is not None
    got, info = tpde.PDE({"c": "laplace(c)"}, bc=bc).solve(
        state, t_range=0.005, dt=1e-3, tracker=None, decomposition=[2, 1, 1], ret_info=True)
    assert info["solver"]["fused_step"]
    fused = tpde.PDE({"c": "laplace(c)"}, bc=bc).solve(state, t_range=0.005, dt=1e-3,
                                                        tracker=None)
    torch.testing.assert_close(got.data, fused.data, **EXACT)
    vector = tpde.VectorField(cube, torch.tensor(_data(8, (3, 8, 8, 8))))
    eq = tpde.PDE({"v": "vector_laplace(v)"}, bc={"value": np.linspace(0, 1, 64).reshape(8, 8)})
    with pytest.raises(tpde.KernelUnsupportedError, match="require scalar BC values"):
        eq.make_fused_euler_window(vector, 1e-3, mesh=mesh)
    got, info = eq.solve(vector, t_range=0.003, dt=1e-3, tracker=None, decomposition=[2, 1, 1],
                         ret_info=True)
    assert "fused_step" not in info["solver"] and info["solver"]["sharded_halo"] == 1
    serial = eq.solve(vector, t_range=0.003, dt=1e-3, tracker=None, backend="numpy")
    torch.testing.assert_close(got.data, serial.data, **EXACT)


# -- the solves against pde_tpu (tests/parallel/test_sharded.py:809-1147) ----------------------
def _solve_pair(make_eq, bc, periodic, decomposition, *, t_range=0.02, dt=1e-3, seed=0,
                solver="euler", collection=False):
    """The port's decomposed solve (fused, `torch` engine), its serial fused
    solve and pde_tpu's decomposed solve of the same state."""
    def state(pkg):
        grid = _grid(pkg, periodic)
        kw = {"dtype": F64} if pkg is tpde else {}
        if not collection:
            return pkg.ScalarField(grid, _data(seed), **kw)
        return pkg.FieldCollection([pkg.ScalarField(grid, _data(seed + i), **kw)
                                    for i in range(2)], labels=["u", "v"])

    tstate = state(tpde)
    got, info = make_eq(tpde, bc).solve(tstate, t_range=t_range, dt=dt, tracker=None,
                                        solver=solver, decomposition=decomposition,
                                        ret_info=True)
    assert info["solver"].get("fused_step") is True, info["solver"].get("fused_unsupported")
    serial, serial_info = make_eq(tpde, bc).solve(tstate, t_range=t_range, dt=dt, tracker=None,
                                                  solver=solver, ret_info=True)
    assert serial_info["solver"].get("fused_step") is True
    jax_kw = {"solver": "explicit_sharded", "adaptive": False} if solver == "euler" else {
        "solver": solver}
    jax_run = make_eq(jpde, bc).solve(state(jpde), t_range=t_range, dt=dt, tracker=None,
                                      decomposition=decomposition, **jax_kw)
    return got, serial, jax_run


def _assert_pair(got, serial, jax_run):
    fields = (lambda s: list(s) if hasattr(s, "fields") else [s])
    for a, b, c in zip(fields(got), fields(serial), fields(jax_run), strict=True):
        torch.testing.assert_close(a.data, b.data, **EXACT)
        np.testing.assert_allclose(a.data.numpy(), np.asarray(c.data), **TOL)


DIFFUSION_BCS = {
    "array-col": ([True, False], {"x": "periodic", "y-": {"value": np.linspace(0.0, 2.0, 16)},
                                  "y+": {"derivative": 0}}),
    "array-row": (False, {"x-": {"value": np.linspace(-1.0, 1.0, 16)}, "x+": {"derivative": 0},
                          "y": {"derivative": 0}}),
    "expr-row": (False, {"x-": {"value_expression": "y**2"}, "x+": {"derivative": 0.5},
                         "y": {"derivative": 0}}),
    "array-both-axes": (False, {"x-": {"value": np.linspace(-1.0, 1.0, 16)},
                                "x+": {"derivative": 0},
                                "y-": {"value": np.linspace(1.0, 3.0, 16)},
                                "y+": {"value": 0.0}}),
    "t-col": (False, {"x": {"derivative": 0}, "y-": {"value_expression": "sin(3 * t)"},
                      "y+": {"derivative": 0}}),
    "t-row": ([True, False], {"x-": {"value_expression": "t"}, "x+": {"derivative": 0},
                              "y": "periodic"}),
    "t-both-sides": (False, {"x": {"derivative": 0},
                             "y-": {"derivative_expression": "0.5 * cos(t)"},
                             "y+": {"value_expression": "sin(t)"}}),
}


@pytest.mark.parametrize("decomposition", [[2, 1], [2, 2]], ids=["2x1", "2x2"])
@pytest.mark.parametrize("case", DIFFUSION_BCS)
def test_diffusion_through_12_with_side_inputs(case, decomposition):
    """test_sharded_fused_inhomogeneous_bc_parity and
    test_sharded_fused_time_dependent_bc_parity: per-point and
    time-dependent values through #12's side inputs."""
    periodic, bc = DIFFUSION_BCS[case]
    if case == "t-row":  # pde_tpu's grid is periodic along y there, not x
        periodic = [False, True]
    _assert_pair(*_solve_pair(lambda p, b: p.DiffusionPDE(diffusivity=0.05, bc=b), bc,
                              periodic, decomposition))


EXPRESSION_CASES = {
    # test_sharded_expression_inhomogeneous_bc_parity (two fields)
    "two fields, array and t": (
        lambda p, b: p.PDE({"u": "1.0 + u**2 * v - 4.4 * u + 0.05 * laplace(u)",
                            "v": "3.4 * u - u**2 * v + 0.1 * laplace(v)"},
                           bc_ops={"u:laplace": b[0], "v:laplace": b[1]}),
        ({"x-": {"value": np.linspace(0.0, 2.0, 16)}, "x+": {"derivative": 0.5},
          "y": {"derivative": 0}},
         {"x": {"derivative": 0}, "y-": {"value_expression": "cos(2 * t)"},
          "y+": {"value": 1.0}}), True),
    # test_sharded_expression_single_field_bc_parity
    "array-plus-t": (
        lambda p, b: p.PDE({"c": "0.1 * laplace(c) - c**3"}, bc=b),
        {"x-": {"value": np.linspace(-1.0, 1.0, 16)}, "x+": {"derivative": 0},
         "y-": {"value_expression": "sin(3 * t)"}, "y+": {"derivative": 0}}, False),
    "expr-spatial-both": (
        lambda p, b: p.PDE({"c": "0.1 * laplace(c) - c**3"}, bc=b),
        {"x-": {"value_expression": "y**2"}, "x+": {"derivative": 0},
         "y-": {"value": np.linspace(1.0, 3.0, 16)}, "y+": {"value": 0.0}}, False),
    # test_sharded_expression_space_time_bc_parity
    "space-and-time": (
        lambda p, b: p.PDE({"c": "0.1 * laplace(c) - c**3"}, bc=b),
        {"x-": {"value_expression": "sin(3 * y - 2 * t)"}, "x+": {"derivative": 0},
         "y-": {"value_expression": "cos(x) * sin(t)"}, "y+": {"derivative": 0}}, False),
    # test_sharded_fused_array_factor_parity: diffusion rerouted to #8
    "array-factor": (
        lambda p, b: p.DiffusionPDE(0.05, bc=b),
        {"x-": {"type": "mixed", "value": np.linspace(0.5, 2.0, 16),
                "const": np.linspace(-1.0, 1.0, 16)},
         "x+": {"derivative": 0},
         "y-": {"type": "mixed", "value": np.linspace(2.0, 0.5, 16), "const": 0.2},
         "y+": {"value": 0}}, False),
}


@pytest.mark.parametrize("decomposition", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("case", EXPRESSION_CASES)
def test_expression_windows_through_8_with_side_inputs(case, decomposition):
    """Arrays, factors, t and xt values through #8's side inputs, Euler."""
    make_eq, bc, collection = EXPRESSION_CASES[case]
    dt = 5e-4 if case == "array-factor" else 1e-3
    _assert_pair(*_solve_pair(make_eq, bc, False, decomposition, dt=dt,
                              collection=collection))


@pytest.mark.parametrize("solver", ["runge-kutta", "adams-bashforth"])
@pytest.mark.parametrize("case", ["array-plus-t", "space-and-time"])
def test_rk4_and_ab2_windows_through_8_with_side_inputs(case, solver):
    """The RK4 window's stages read the tables at t, t + dt/2 and t + dt;
    AB2's window carries the previous rates; both on [2, 2]."""
    make_eq, bc, _ = EXPRESSION_CASES[case]
    _assert_pair(*_solve_pair(make_eq, bc, False, [2, 2], t_range=0.01, solver=solver))


@pytest.mark.parametrize("make_eq", [
    lambda p, bc: p.DiffusionPDE(diffusivity=0.2, bc=bc),
    lambda p, bc: p.PDE({"c": "0.2 * laplace(c) - c**3"}, bc=bc),
], ids=["diffusion #12", "expression #8"])
def test_time_bc_tracker_windows(make_eq):
    """test_sharded_fused_time_bc_tracker_windows and
    test_sharded_expression_time_bc_tracker_windows: every tracker window
    starts the tables at its own t_start. pde_tpu's plain decomposed
    stepper of a ``DiffusionPDE`` with this condition leaks a tracer between
    tracker windows (``UnexpectedTracerError``), so its reference for the
    diffusion case is the same equation as ``PDE({"c": "0.2 * laplace(c)"})``."""
    bc = {"x": "periodic", "y-": {"value_expression": "sin(5 * t)"}, "y+": {"derivative": 0}}
    data = _data(8)

    def frames(pkg, make=make_eq, **kw):
        state = pkg.ScalarField(pkg.UnitGrid([16, 16], periodic=[True, False]), data,
                                **({"dtype": F64} if pkg is tpde else {}))
        storage = pkg.MemoryStorage()
        info = make(pkg, bc).solve(state, t_range=0.06, dt=1e-3, tracker=storage.tracker(0.02),
                                   ret_info=True, **kw)[1]
        return [np.asarray(f.data) for f in storage], info

    got, info = frames(tpde, decomposition=[2, 2])
    assert info["solver"].get("fused_step") is True
    serial, _ = frames(tpde)
    reference = make_eq
    if isinstance(make_eq(tpde, bc), tpde.DiffusionPDE):
        reference = (lambda p, b: p.PDE({"c": "0.2 * laplace(c)"}, bc=b))
    jax_frames, _ = frames(jpde, reference, decomposition=[2, 2], solver="explicit_sharded",
                           adaptive=False)
    assert len(got) == len(serial) == len(jax_frames) == 4
    for a, b, c in zip(got, serial, jax_frames, strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, **TOL)
