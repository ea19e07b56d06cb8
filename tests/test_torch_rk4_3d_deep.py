"""3D fixed-dt RK4 of a two-deep rhs through kernels #5 (``multi_stencil_3d``)
and #6 (``multi_stencil_ext_3d``): Cahn-Hilliard, Swift-Hohenberg,
Kuramoto-Sivashinsky and ``laplace(c**3 - c - laplace(c))``, fp64.

A step takes eight halo planes and 11-15 volumes, whose rings fit no plan
while the stages that add ``dt/2 k`` to the fields (and the last combine)
read the fields from their rings at lags 2 to 8. The programs' layout reads
those values from the pass's input instead (``input_points``), so a field's
ring keeps three planes, and keeps each volume in a compact plane: the
window plane less the volume's writer's lag on every side. Their one-step
passes try z tiles of 64, 32 and 16 cells within one block's 227 KiB.

- The layouts and plans: the slots and margins per volume, the stages that
  read the fields from the input, the bytes per dtype against the budgets;
  the programs that built before keep their sources, slots and plans.
- The replays of both kernels' marches in the new layout against their
  plain versions at rtol = atol = 0 (slots start as NaN and a compact
  volume's cells past its margin read NaN, so a race, a short ring or a
  read outside the plane shows), under several plans, on periodic,
  no-flux, mixed and side-input faces, and the ext march under every
  edge-flag pattern.
- The windows against ``pde_tpu``'s fused RK4 windows in interpret mode
  over two tracker windows at 1e-12, serially and decomposed (the
  decomposed windows also bit-equal to the serial ones).
- A three-deep rhs (48 planes a step), whose fp64 planes fit no plan:
  refused by name with its bytes; its fp32 window fuses.
"""

import hashlib

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers.runge_kutta import RungeKuttaSolver as JaxRK
from pde_tpu_torch.ops import cuda_cartesian_3d as c3
from pde_tpu_torch.ops import cuda_ext_3d as e3
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.ops import cuda_stencil_3d as s3
from pde_tpu_torch.parallel import GridMesh, HaloExchange

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-13)
F32, F64 = torch.float32, torch.float64
DT = 1e-3
NOFLUX = {"derivative": 0}
MIXED = {"x": "periodic", "y-": {"value": 0.3}, "y+": {"derivative": 0.1},
         "z": {"curvature": 0.5}}
TIMED = {"x": {"derivative": 0}, "y-": {"value_expression": "sin(3 * t)"},
         "y+": {"value": 0}, "z": {"derivative": 0}}
CH_EXPR = "laplace(c**3 - c - laplace(c))"
FLAGS_3D = [[0, 0, 0, 0, 0, 0], [1, 0, 0, 1, 1, 0], [0, 1, 1, 0, 0, 1], [1, 1, 1, 1, 1, 1]]


@pytest.fixture(autouse=True)
def device():
    """The port's entry points default to the card; these tests ask for the
    CPU, with eight blocks per device as pde_tpu's tests have eight CPU
    devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield "cpu"


def _data(shape, seed, low=-0.5, high=0.5):
    return np.random.default_rng(seed).uniform(low, high, shape)


def _state(pkg, shape, seed=0, periodic=True, dtype=F64):
    grid = pkg.UnitGrid(list(shape), periodic=periodic)
    kwargs = {"dtype": dtype} if pkg is tpde else {}
    return pkg.ScalarField(grid, _data(shape, seed), **kwargs)


MODELS = {
    "cahn-hilliard": lambda p, bc="auto_periodic_neumann": p.CahnHilliardPDE(
        bc_c=bc, bc_mu=bc),
    "swift-hohenberg": lambda p, bc="auto_periodic_neumann": p.SwiftHohenbergPDE(bc=bc),
    "kuramoto-sivashinsky": lambda p, bc="auto_periodic_neumann": p.KuramotoSivashinskyPDE(
        bc=bc),
    "expression": lambda p, bc="auto_periodic_neumann": p.PDE({"c": CH_EXPR}, bc=bc),
}


# -- layouts and plans --------------------------------------------------------------------------
CH_LAGS = (0, 1, 2, 2, 3, 4, 4, 5, 6, 6, 7)
# model: (slots per volume, margins per volume, fp32 plan and bytes, fp64 plan and bytes)
LAYOUTS = {
    "cahn-hilliard": ((3,) * 11, CH_LAGS, ((32, 32, 32), 221376), ((32, 16, 16), 166272)),
    "swift-hohenberg": ((3,) * 11, CH_LAGS, ((32, 32, 32), 221376), ((32, 16, 16), 166272)),
    "kuramoto-sivashinsky": ((3, 3, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3, 2),
                             (0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7),
                             ((32, 16, 32), 166720), ((32, 16, 16), 204416)),
    "expression": ((3,) * 11, CH_LAGS, ((32, 32, 32), 221376), ((32, 16, 16), 166272)),
}


def _loads(plan, halo=16):
    """Window cells a block loads per cell it writes, at a plan's column tile."""
    return (plan[1] + halo) * (plan[2] + halo) / (plan[1] * plan[2])


@pytest.mark.parametrize("model", LAYOUTS)
def test_layout_reads_the_fields_from_the_input(model):
    """Eight halo planes a step: the stages at lags 2, 4, 6 and 8 (y + dt/2 k,
    y + dt k and the last combine) read the field from the pass's input, so
    its ring keeps three planes (nine from its ring); each volume's plane
    drops its writer's lag on every side; the one-step plan is the column
    tile whose compact planes fit one block and load the fewest window cells
    a cell written, fp32 and fp64 each."""
    slots, margins, (plan32, bytes32), (plan64, bytes64) = LAYOUTS[model]
    window = MODELS[model](tpde).make_fused_rk4_window(_state(tpde, [16] * 3, dtype=F32), DT)
    program = window.program
    layout = program.march
    assert program.depth == 8 and program.ladder == [1] and [s.k for s in window.specs] == [1]
    assert program.input_points and layout.input_points and program.carry
    assert layout.slots == slots and layout.step_slots == sum(slots)
    assert layout.margins == margins == layout.lags
    assert [st.lag for st in layout.stages] == list(range(1, 9))
    assert [sorted(st.points) for st in layout.stages] == [[], [0]] * 4
    assert all(0 not in st.reads for st in layout.stages if st.lag > 1)
    assert program.tiles == {F32: {1: plan32}, F64: {1: plan64}}
    for dtype, plan, need in ((F32, plan32, bytes32), (F64, plan64, bytes64)):
        assert program.smem_bytes(1, plan, dtype.itemsize) == need
        assert need == dtype.itemsize * sum(n * (plan[1] + 16 - 2 * m) * (plan[2] + 16 - 2 * m)
                                            for n, m in zip(slots, margins))
        assert cs.SMEM_BUDGET < need <= s3.SMEM_MAX
        # every plan that loads fewer cells a cell written takes more than a block
        for ty in c3.MARCH_TY:
            for tz in (c3.MARCH_TZ, *c3.MARCH_TZ_NARROW):
                if _loads((32, ty, tz)) < _loads(plan):
                    assert program.smem_bytes(1, (32, ty, tz), dtype.itemsize) > s3.SMEM_MAX
    source = program.source
    assert "static constexpr bool kInputPoints = true;" in source
    assert "stage_points(int j) { return j == 0 ? 0u : j == 1 ? 1u" in source
    assert f"volume_margin(int v) {{ return v == 0 ? 0 : v == 1 ? 1 : v == 2 ? {margins[2]}" \
        in source
    assert "MarchOperands<T, kVolumes, 0, kFields>" in source and "O.x[0]" in source
    assert "O.c[1][-(WZ - 2)]" in source and "O.c[1][q" not in source
    assert "case 1: return pde_tpu_torch::launch_3d<Program, double" in source
    # read from the rings, with whole window planes, the fields keep nine
    # planes a step, which no fp64 plan takes
    ring = s3.march_layout(program, s3._AXES)
    assert ring.slots[0] == 9 and not any(st.points for st in ring.stages) and not ring.margins
    assert ring.step_slots * (8 + 16) * (16 + 16) * 8 > s3.SMEM_MAX


def test_a_three_deep_rhs_fits_fp32_only():
    """``laplace(laplace(laplace(c)))`` takes twelve halo planes a step: its
    48 compact planes fit one block in fp32, not in fp64, whose window (and
    the cuda engine) raise naming the bytes; the torch engine runs the plain
    loop and says why."""
    eq = tpde.PDE({"c": "laplace(laplace(laplace(c)))"})
    window = eq.make_fused_rk4_window(_state(tpde, [24] * 3, dtype=F32), 1e-5)
    program = window.program
    assert program.depth == 12 and program.input_points and program.march.step_slots == 48
    assert program.tiles == {F32: {1: (32, 16, 16)}, F64: {1: None}}
    source = program.source
    assert "launch_3d<Program, float, 1, 32, 16, 16>" in source
    assert "launch_3d<Program, double" not in source
    message = r"48 planes a step need 245184 bytes at the narrowest plan \(32, 8, 16\), past " \
        r"the 232448 bytes"
    with pytest.raises(tpde.KernelUnsupportedError, match=message):
        cs.multi_stencil_spec(program, 1, F64)
    state = _state(tpde, [24] * 3)
    with pytest.raises(tpde.KernelUnsupportedError, match=message):
        eq.make_fused_rk4_window(state, 1e-5)
    with pytest.raises(RuntimeError, match="245184 bytes"):
        tpde.RungeKuttaSolver(eq, backend="cuda").make_stepper(state, dt=1e-5)
    solver = tpde.RungeKuttaSolver(eq, adaptive=False)
    solver.make_stepper(state, dt=1e-5)
    assert "245184 bytes" in solver.info["fused_unsupported"] and "fused_step" not in solver.info
    # the fp32 pass's march (margins up to 11 cells) replays its plain version
    small = eq.make_fused_rk4_window(_state(tpde, (13, 14, 15), 4, dtype=F32), 1e-5)
    (spec,) = small.specs
    data = torch.as_tensor(_data((13, 14, 15), 5), dtype=F32)
    plain = s3.multi_stencil_3d_plain([data], spec)
    assert torch.equal(s3.multi_stencil_3d_marched([data], spec, (4, 5, 6))[0], plain[0])


# the generated sources, slots and plans of 3D programs that built before the
# layout that reads the fields from the input, which they keep
PARENT = {
    "allen-cahn rk4": ("7c71ddecc919d42454e3c043dbeafb67502dabeabf59820b1c5a1151d129020b",
                       (5, 3, 2, 3, 2, 3, 2), [1], (32, 8, 64), (32, 8, 64)),
    "allen-cahn rk4 no-flux": (
        "1ff95a2c7bb02bb62b3cce23834b5af7cf6bd59ef94231e71d939204cd3816b6",
        (5, 3, 2, 3, 2, 3, 2), [1], (32, 8, 64), (32, 8, 64)),
    "cahn-hilliard euler": ("131dc95e24278306188f00e3c661009f4885f1207623132c7213ba29a5b37010",
                            (3, 3), [1], (32, 32, 64), (32, 16, 64)),
    "cahn-hilliard ab2": ("f17624299bbc7453edccf4672e7b958d3cc0b94ea253943540decaf18f535708",
                          (3, 3, 3), [1], (32, 32, 64), (32, 16, 64)),
    "swift-hohenberg euler": (
        "8f0aaace2cebce78fd7ddaeda12c74bbdbd68efe64e0dca2377f9801572143a1",
        (3, 3), [1], (32, 32, 64), (32, 16, 64)),
    "kuramoto-sivashinsky ab2": (
        "d2d5d42d6d2fc4e552039fc9a56c66afa617b49f0e97b5f2647c3374f4d57097",
        (4, 3, 3), [1], (32, 32, 64), (32, 16, 64)),
    "allen-cahn rk4 [2, 2, 2]": (
        "071b3f061ad62c5d9603708bc4f87f64312116443f777c751f61458eb7cb9328",
        (5, 3, 2, 3, 2, 3, 2), [1], (32, 8, 64), (32, 8, 64)),
    "cahn-hilliard euler [2, 2, 2]": (
        "d255a86f4113a4302dec47608cc95fd3212ae4e1683470cab6f0b3ba096727a6",
        (3, 3), [1], (32, 32, 64), (32, 16, 64)),
}


@pytest.mark.parametrize("case", PARENT)
def test_programs_that_fit_keep_their_layout(case):
    """A program whose rings fit a plan keeps the layout, the plan and the
    generated source it had (the template's new mode is not emitted)."""
    cube = tpde.UnitGrid([16] * 3, periodic="no-flux" not in case)
    state = tpde.ScalarField(cube, 0.1, dtype=F32)
    name, scheme = case.split()[:2]
    eq = {"allen-cahn": tpde.AllenCahnPDE(bc=NOFLUX) if "no-flux" in case
          else tpde.AllenCahnPDE(),
          "cahn-hilliard": tpde.CahnHilliardPDE(), "swift-hohenberg": tpde.SwiftHohenbergPDE(),
          "kuramoto-sivashinsky": tpde.KuramotoSivashinskyPDE()}[name]
    mesh = GridMesh(cube, [2, 2, 2], devices=["cpu"] * 8) if "[2, 2, 2]" in case else None
    program = getattr(eq, f"make_fused_{scheme}_window")(state, DT, mesh=mesh).program
    digest, slots, ladder, plan32, plan64 = PARENT[case]
    assert hashlib.sha256(program.source.encode()).hexdigest() == digest
    assert not program.input_points and "kInputPoints" not in program.source
    assert program.march.slots == slots and program.ladder == ladder
    assert program.tiles == {F32: {1: plan32}, F64: {1: plan64}}


# -- the replays of the marches ---------------------------------------------------------------
# id: (PDE, grid shape, periodic)
REPLAYS = {
    "cahn-hilliard periodic": (lambda: tpde.CahnHilliardPDE(), (10, 9, 12), True),
    "cahn-hilliard no-flux": (lambda: tpde.CahnHilliardPDE(bc_c=NOFLUX, bc_mu=NOFLUX),
                              (9, 11, 10), False),
    "swift-hohenberg mixed": (lambda: tpde.SwiftHohenbergPDE(bc=MIXED), (10, 10, 9),
                              [True, False, False]),
    "kuramoto-sivashinsky no-flux": (lambda: tpde.KuramotoSivashinskyPDE(bc=NOFLUX),
                                     (9, 10, 11), False),
    "expression, a face in time": (lambda: tpde.PDE({"c": CH_EXPR}, bc=TIMED), (10, 9, 11),
                                   False),
}
TILES = ((5, 4, 8), (3, 7, 5), (32, 3, 4), None)


@pytest.mark.parametrize("case", REPLAYS)
def test_march_replays_plain_version(case):
    """The replay of #5's march in the new layout (fields read at their cells
    from the input, three-plane rings) equals its plain version bit for bit
    under plans that cut the grid into chunks and column tiles with seams on
    every axis; with side inputs from inner step 2 of a window."""
    make_eq, shape, periodic = REPLAYS[case]
    (spec,) = make_eq().make_fused_rk4_window(_state(tpde, shape, 11, periodic), DT).specs
    program = spec.program
    assert program.input_points and program.march.margins
    data = torch.as_tensor(_data(shape, 12))
    views = None
    if program.sides is not None:
        block = program.sides.block(0.3, 0, 3, DT, F64, "cpu")
        views = program.sides.for_pass(F64, "cpu", 1, block, 2)
    plain = s3.multi_stencil_3d_plain([data], spec, views)
    for tile in TILES:
        marched = s3.multi_stencil_3d_marched([data], spec, tile, views)
        assert torch.equal(marched[0], plain[0]), tile


@pytest.mark.parametrize("flag_set", range(4))
@pytest.mark.parametrize("model", ["cahn-hilliard", "kuramoto-sivashinsky"])
def test_ext_march_replays_plain_version(model, flag_set):
    """The ext kernel's march in the new layout on one block's extended
    buffer (halo 8), under each edge-flag pattern, equals its plain version
    bit for bit; the ext program is the serial one cut to the blocks."""
    state = _state(tpde, [16, 16, 16], 3, False, F32)
    mesh = GridMesh.from_grid(state.grid, [2, 2, 2])
    window = MODELS[model](tpde, NOFLUX).make_fused_rk4_window(state, DT, mesh=mesh)
    serial = MODELS[model](tpde, NOFLUX).make_fused_rk4_window(state, DT)
    program = window.program
    assert isinstance(program, e3.ExtStencilProgram3D) and program.input_points
    def struct(text):
        return text[text.index("namespace {"):text.index("}  // namespace")]

    assert program.march.slots == serial.program.march.slots
    assert struct(program.source) == struct(serial.program.source)
    assert program.tiles == serial.program.tiles
    assert [s.k for s in window.specs] == [1] and window.specs[0].halo == 8
    ext = torch.as_tensor(_data((24, 24, 24), flag_set))
    spec = e3.multi_stencil_ext_3d_spec(program, 1, F64, (8, 8, 8), 8)
    flags = FLAGS_3D[flag_set]
    plain = e3.multi_stencil_ext_3d_plain([ext], spec, flags)
    for tile in ((3, 5, 4), (32, 8, 16), None):
        marched = e3.multi_stencil_ext_3d_marched([ext], spec, flags, tile=tile)
        torch.testing.assert_close(marched[0], plain[0], rtol=0, atol=0)


def test_ext_pass_with_side_inputs_is_the_serial_pass():
    """A face in time on a [2, 2, 1] mesh of 8-cell blocks: every block's ext
    plain version and ext march replay, reading the global tables at its
    origin, put together equal the serial pass bit for bit."""
    grid = tpde.UnitGrid([16, 16, 8], periodic=False)
    data = torch.as_tensor(_data(grid.shape, 6))
    eq = tpde.PDE({"c": CH_EXPR}, bc=TIMED)
    state = tpde.ScalarField(grid, data)
    mesh = GridMesh(grid, [2, 2, 1], devices=["cpu"] * 4)
    ext_window = eq.make_fused_rk4_window(state, DT, mesh=mesh)
    serial = eq.make_fused_rk4_window(state, DT)
    assert ext_window.program.input_points and ext_window.program.sides is not None
    (spec,), (ext_spec,) = serial.specs, ext_window.specs
    exchange = HaloExchange(mesh, ext_spec.halo)
    buffers = exchange.allocate(1, F64)
    exchange.load(buffers, [[block] for block in mesh.split_field_data(data)])
    exchange.copy(exchange.strips(buffers))
    flags = [mesh.edge_flags(b) + list(mesh.block_origin(b)) for b in range(len(mesh))]
    block = serial.program.sides.block(0.3, 0, 3, DT, F64, "cpu")
    views = serial.program.sides.for_pass(F64, "cpu", 1, block, 2)
    want = s3.multi_stencil_3d_plain([data], spec, views)[0]
    outs = exchange.allocate(1, F64)
    e3.multi_stencil_ext_3d(buffers, outs, flags, ext_spec, sides=views)
    plain = mesh.combine_field_data(exchange.interiors(outs)[b][0] for b in range(len(mesh)))
    marched = mesh.combine_field_data(
        e3.multi_stencil_ext_3d_marched(buffers[b], ext_spec, flags[b], (4, 3, 5), views)[0]
        for b in range(len(mesh)))
    torch.testing.assert_close(plain, want, rtol=0, atol=0)
    torch.testing.assert_close(marched, want, rtol=0, atol=0)


# -- the windows against pde_tpu ----------------------------------------------------------------
def _run(solver, state, bounds=(0.0, 0.004, 0.008)):
    """Two tracker windows of a fixed-dt stepper."""
    stepper = solver.make_stepper(state, dt=DT)
    for t0, t1 in zip(bounds[:-1], bounds[1:]):
        state, t = stepper(state, t0, t1)
        assert t == pytest.approx(t1)
    return state


def _jax_fused(make_eq, shape, periodic, monkeypatch, decomposition=None):
    """pde_tpu's fused RK4 windows in interpret mode (its sharded windows on
    its virtual CPU devices with a decomposition)."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PDE_TPU_DISABLE_FUSED", raising=False)
    kwargs = {} if decomposition is None else {"decomposition": decomposition}
    solver = JaxRK(make_eq(jpde), adaptive=False, **kwargs)
    result = _run(solver, _state(jpde, shape, 7, periodic))
    assert solver.info.get("fused_step") is True
    return np.asarray(result.data)


# id: (model, bc, grid shape, periodic)
WINDOWS = {
    "cahn-hilliard periodic": ("cahn-hilliard", "auto_periodic_neumann", (8, 8, 8), True),
    "kuramoto-sivashinsky periodic": ("kuramoto-sivashinsky", "auto_periodic_neumann",
                                      (8, 8, 8), True),
    "swift-hohenberg no-flux": ("swift-hohenberg", NOFLUX, (8, 10, 8), False),
    "expression mixed": ("expression", MIXED, (8, 9, 10), [True, False, False]),
}


@pytest.mark.parametrize("case", WINDOWS)
def test_windows_match_pde_tpu(case, monkeypatch):
    """The port's fused RK4 window (its plain version on CPU tensors) against
    pde_tpu's in interpret mode, over two tracker windows."""
    model, bc, shape, periodic = WINDOWS[case]

    def make_eq(p):
        return MODELS[model](p, bc)

    solver = tpde.RungeKuttaSolver(make_eq(tpde), backend="torch", adaptive=False)
    got = _run(solver, _state(tpde, shape, 7, periodic))
    assert solver.info["fused_step"] is True and "fused_unsupported" not in solver.info
    assert solver.info["steps"] == 8
    np.testing.assert_allclose(got.data.numpy(), _jax_fused(make_eq, shape, periodic,
                                                            monkeypatch), **TOL)


def test_time_dependent_face_on_the_kernel_route(monkeypatch):
    """``laplace(c**3 - c - laplace(c))`` with a face in time: RK4's stages
    read the tables at t, t + dt/2 and t + dt, through #5's side-input
    kernel (its plain version here), as pde_tpu's fused window does."""
    grid_args = ([(0, 1), (0, 2), (0, 3)], [8, 8, 16])
    out = []
    for pkg in (jpde, tpde):
        if pkg is jpde:
            monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
        state = pkg.ScalarField(pkg.CartesianGrid(*grid_args), _data((8, 8, 16), 14, 0.2, 0.8),
                                **({} if pkg is jpde else {"dtype": F64}))
        eq = pkg.PDE({"c": CH_EXPR}, bc=TIMED)
        extra = {} if pkg is jpde else {"backend": "torch"}
        res, info = eq.solve(state, t_range=[0.3, 0.3 + 6 * 2e-4], dt=2e-4, tracker=None,
                             solver="runge-kutta", ret_info=True, **extra)
        assert info["solver"].get("fused_step") is True
        out.append(np.asarray(res.data))
    window = tpde.PDE({"c": CH_EXPR}, bc=TIMED).make_fused_rk4_window(
        tpde.ScalarField(tpde.CartesianGrid(*grid_args), 0.5, dtype=F64), 2e-4)
    assert window.needs_t and window.program.input_points
    assert "launch_sides_3d" in window.program.source
    np.testing.assert_allclose(out[1], out[0], **TOL)


# -- decomposed windows -------------------------------------------------------------------------
# id: (model, bc, grid shape, periodic, decomposition)
MESHES = {
    "cahn-hilliard [2, 1, 1]": ("cahn-hilliard", "auto_periodic_neumann", (16, 8, 8), True,
                                [2, 1, 1]),
    "swift-hohenberg no-flux [1, 2, 1]": ("swift-hohenberg", NOFLUX, (8, 16, 8), False,
                                          [1, 2, 1]),
    "expression mixed [1, 1, 2]": ("expression", MIXED, (8, 9, 16), [True, False, False],
                                   [1, 1, 2]),
}


@pytest.mark.parametrize("case", MESHES)
def test_decomposed_windows_match_serial_and_pde_tpu(case, monkeypatch):
    """The decomposed window (#6's plain version over the blocks) equals the
    serial window bit for bit and matches pde_tpu's sharded fused window."""
    model, bc, shape, periodic, decomposition = MESHES[case]

    def make_eq(p):
        return MODELS[model](p, bc)

    solver = tpde.RungeKuttaSolver(make_eq(tpde), backend="torch", adaptive=False,
                                   decomposition=decomposition)
    got = _run(solver, _state(tpde, shape, 7, periodic))
    assert solver.info["fused_step"] is True and solver.info["decomposition"] == decomposition
    serial = _run(tpde.RungeKuttaSolver(make_eq(tpde), backend="torch", adaptive=False),
                  _state(tpde, shape, 7, periodic))
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
    want = _jax_fused(make_eq, shape, periodic, monkeypatch, decomposition)
    np.testing.assert_allclose(got.data.numpy(), want, **TOL)


def test_blocks_need_eight_cells_of_halo():
    """A two-deep step takes eight halo cells, which 4-cell blocks cannot
    supply: pde_tpu's "Shard too small" gate; the torch engine then runs the
    plain sharded stepper, bit-equal to the serial plain loop."""
    state = _state(tpde, (8, 8, 8), 5)
    mesh = GridMesh.from_grid(state.grid, [2, 1, 1])
    with pytest.raises(tpde.KernelUnsupportedError, match="Shard too small"):
        tpde.CahnHilliardPDE().make_fused_rk4_window(state, DT, mesh=mesh)
    got, info = tpde.CahnHilliardPDE().solve(state, t_range=0.004, dt=DT, tracker=None,
                                             solver="runge-kutta", decomposition=[2, 1, 1],
                                             ret_info=True)
    assert "Shard too small" in info["solver"]["fused_unsupported"]
    serial = tpde.CahnHilliardPDE().solve(state, t_range=0.004, dt=DT, tracker=None,
                                          solver="runge-kutta", backend="numpy")
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())


def test_cuda_engine_takes_the_kernel():
    """Under backend='cuda' the stepper builds the fused window (no plan
    error) and then asks for a CUDA state, serially and on a mesh."""
    state = _state(tpde, (16, 8, 8), 0)
    for kwargs in ({}, {"decomposition": [2, 1, 1]}):
        for eq in (tpde.CahnHilliardPDE(), tpde.SwiftHohenbergPDE()):
            with pytest.raises(RuntimeError, match="CUDA device"):
                tpde.RungeKuttaSolver(eq, backend="cuda", **kwargs).make_stepper(state, dt=DT)
