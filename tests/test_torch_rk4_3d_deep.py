"""3D fixed-dt RK4 of a two-deep rhs through kernels #5 (``multi_stencil_3d``)
and #6 (``multi_stencil_ext_3d``): Cahn-Hilliard, Swift-Hohenberg,
Kuramoto-Sivashinsky and ``laplace(c**3 - c - laplace(c))``, fp64.

A step takes eight halo planes and 11-15 volumes, whose rings fit no plan.
The step is cut at its RK stages into four passes (``cut_step``), each a
one-step march of the rhs's depth (two planes of halo) whose inputs (the
fields and the values of earlier passes it reads) differ from its outputs;
their rings fit two blocks an SM. On a mesh the step keeps one exchange of
eight cells, and the ext kernel's passes compute their blocks and the cells
around them that the later passes read: two passes of two RK stages where
they have plans (4, 0 cells), else four (6, 4, 2, 0).

- The cut: each pass's reads, writes, slots and plans, the bytes against
  the two-block budget, the generated source; the passes composed equal
  the plain RK4 step bit for bit; the programs that built before keep
  their sources, slots and plans.
- Each pass's replay of its march against its plain version at rtol =
  atol = 0 (slots start as NaN, so a race or a short ring shows), at two
  plans, on periodic, no-flux, mixed and side-input faces; the ext passes'
  replays on their regions under every edge-flag pattern.
- The windows against ``pde_tpu``'s fused RK4 windows in interpret mode
  over two tracker windows at 1e-12, serially and decomposed (the
  decomposed windows also bit-equal to the serial ones).
- A three-deep rhs: its fp32 window fuses, fp64 is refused by name.
"""

import hashlib

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers.runge_kutta import RungeKuttaSolver as JaxRK
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


# -- the cut ----------------------------------------------------------------------------------
P32, P16, P8 = (32, 32, 64), (32, 16, 64), (32, 8, 64)
CH_CUT = (((0, 1, (3, 3)), P32, P16), ((1, 2, (1, 3, 3, 3)), P32, P16),
          ((2, 2, (1, 1, 3, 3, 3)), P32, P8), ((2, 1, (3, 1, 3, 3, 3)), P16, P8))
# model: per pass, ((values read, values written, slots per volume), fp32 plan, fp64 plan)
CUTS = {
    "cahn-hilliard": CH_CUT,
    "swift-hohenberg": (((0, 1, (3, 3)), P32, P16), ((1, 2, (3, 3, 3, 3)), P16, P8),
                        ((2, 2, (1, 1, 3, 3, 3)), P32, P8), ((2, 1, (3, 1, 3, 3, 3)), P16, P8)),
    "kuramoto-sivashinsky": (((0, 1, (3, 3, 2)), P32, P16), ((1, 2, (1, 3, 3, 3, 2)), P16, P8),
                             ((2, 2, (1, 1, 3, 3, 3, 2)), P16, P8),
                             ((2, 1, (3, 1, 3, 3, 3, 2)), P16, P8)),
    "expression": CH_CUT,
}


@pytest.mark.parametrize("model", CUTS)
def test_the_step_is_cut_into_four_passes(model):
    """Eight halo planes a step, which no plan takes whole: four passes of
    two planes of halo, each reading the fields and the values of the pass
    before (k1; k2 and k1 + 2 k2, or their counterparts), whose stages of
    lag 0 recompute ``y + dt/2 k`` from them; every pass's rings fit two
    blocks' shared memory an SM in fp32 and fp64, at the widest column tile
    that fits; the source holds one program struct a pass."""
    window = MODELS[model](tpde).make_fused_rk4_window(_state(tpde, [16] * 3, dtype=F32), DT)
    program = window.program
    assert program.depth == 8 and program.stage_depth == 2 and program.ladder == [1]
    assert [s.k for s in window.specs] == [1] and len(program.passes) == 4
    assert program.tiles == {F32: {1: tuple(c[1] for c in CUTS[model])},
                             F64: {1: tuple(c[2] for c in CUTS[model])}}
    source = program.source
    for p, ((reads, writes, slots), plan32, plan64) in zip(program.passes, CUTS[model],
                                                           strict=True):
        assert (len(p.reads), len(p.writes), p.march.slots) == (reads, writes, slots)
        assert p.depth == 2 and p.n_fields == 1 + reads and p.extent == 0
        assert [st.lag for st in p.march.stages] == ([1, 2] if p.index == 0 else [0, 1, 2])
        assert p.tiles == {F32: {1: plan32}, F64: {1: plan64}} and p.min_blocks == 2
        for dtype, plan in ((F32, plan32), (F64, plan64)):
            need = p.smem_bytes(1, plan, dtype.itemsize)
            assert need == dtype.itemsize * sum(slots) * (plan[1] + 4) * (plan[2] + 4)
            assert need <= cs.SMEM_BUDGET
            wider = (32, 2 * plan[1], 64)
            assert plan[1] == 32 or p.smem_bytes(1, wider, dtype.itemsize) > cs.SMEM_BUDGET
        assert f"static constexpr int kInputs = {1 + reads};" in source
        assert f"multi_stencil_3d_p{p.index}_f64(" in source
        assert (f"launch_3d<pass{p.index}::Program, double, 1, {plan64[0]}, {plan64[1]}, "
                f"{plan64[2]}>") in source
    assert "kOutputs = 1;\n  static constexpr int kExtent = 0;" in source
    # the values handed on: each pass's writes are what the passes after it read
    handed = {i for p in program.passes[1:] for i in p.reads}
    assert handed == {i for p in program.passes[:-1] for i in p.writes}
    assert list(program.passes[-1].writes) == [n.index for n in program.outputs]


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("model", CUTS)
def test_the_passes_compose_the_step(model, periodic):
    """The passes' plain versions in turn equal the plain RK4 step (the
    traced step's plain version, which is the step's plain version in the
    wrapper) bit for bit in fp64, and so do their replays' (each at the
    kernel's plan)."""
    bc = "auto_periodic_neumann" if periodic else NOFLUX
    shape = (10, 9, 11)
    (spec,) = MODELS[model](tpde, bc).make_fused_rk4_window(
        _state(tpde, shape, 1, periodic), DT).specs
    data = torch.as_tensor(_data(shape, 2))
    step = cs.multi_stencil_2d_plain([data], spec)[0]
    assert torch.equal(s3.multi_stencil_3d_plain([data], spec)[0], step)
    passes = spec.program.cut(F64)
    assert torch.equal(s3.run_cut(passes, [data], s3.pass_plain)[0], step)
    assert torch.equal(s3.multi_stencil_3d_marched([data], spec, (4, 5, 6))[0], step)


def test_a_three_deep_rhs_fits_fp32_only():
    """``laplace(laplace(laplace(c)))`` takes twelve halo planes a step: four
    passes of three, which take the kernel in fp32; fp64 is refused by
    name, as pde_tpu refuses the program (the cuda engine raises, the torch
    engine runs the plain loop and says why)."""
    eq = tpde.PDE({"c": "laplace(laplace(laplace(c)))"})
    window = eq.make_fused_rk4_window(_state(tpde, [24] * 3, dtype=F32), 1e-5)
    program = window.program
    assert program.depth == 12 and program.stage_depth == 3 and program.fp32_only
    assert [p.depth for p in program.passes] == [3] * 4
    assert program.tiles == {F32: {1: ((32, 32, 64), (32, 16, 64), (32, 16, 64), (32, 16, 64))},
                             F64: {1: None}}
    source = program.source
    assert "launch_3d<pass3::Program, float, 1, 32, 16, 64>" in source
    assert "launch_3d<pass0::Program, double" not in source
    message = r"rhs 3 stencils deep takes the kernel in float32 only: pde_tpu's fused 3D RK4"
    with pytest.raises(tpde.KernelUnsupportedError, match=message):
        cs.multi_stencil_spec(program, 1, F64)
    state = _state(tpde, [24] * 3)
    with pytest.raises(tpde.KernelUnsupportedError, match=message):
        eq.make_fused_rk4_window(state, 1e-5)
    with pytest.raises(RuntimeError, match="float32 only"):
        tpde.RungeKuttaSolver(eq, backend="cuda").make_stepper(state, dt=1e-5)
    solver = tpde.RungeKuttaSolver(eq, adaptive=False)
    solver.make_stepper(state, dt=1e-5)
    assert "float32 only" in solver.info["fused_unsupported"] and "fused_step" not in solver.info
    # the fp32 passes' marches replay their plain versions
    small = eq.make_fused_rk4_window(_state(tpde, (13, 14, 15), 4, dtype=F32), 1e-5)
    (spec,) = small.specs
    data = torch.as_tensor(_data((13, 14, 15), 5), dtype=F32)
    plain = s3.multi_stencil_3d_plain([data], spec)
    assert torch.equal(s3.multi_stencil_3d_marched([data], spec, (4, 5, 6))[0], plain[0])


# the generated sources, slots and plans of 3D programs that built before the
# cut steps, which they keep
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
    generated source it had (it is not cut)."""
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
    assert program.passes is None and "kInputs" not in program.source
    assert program.march.slots == slots and program.ladder == ladder
    assert program.tiles == {F32: {1: plan32}, F64: {1: plan64}}


# -- the replays of the passes' marches ---------------------------------------------------------
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
TILES = ((5, 4, 8), (3, 7, 5))


def _pass_inputs(program, data, views):
    """Each pass's inputs, from the passes' plain versions in turn."""
    held, inputs = {}, []
    for p in program.cut(data.dtype):
        ins = [data] + [held[i] for i in p.reads]
        inputs.append(ins)
        held.update(zip(p.writes, s3.pass_plain(p, ins, views)))
    return inputs


@pytest.mark.parametrize("index", range(4))
@pytest.mark.parametrize("case", REPLAYS)
def test_march_replays_plain_version(case, index):
    """The replay of pass `index`'s march (its inputs in three-plane rings or
    one, its lag-0 stage, its outputs) equals the pass's plain version bit
    for bit on the inputs the passes before it give, under plans that cut
    the grid into chunks and column tiles with seams on every axis; with
    side inputs from inner step 2 of a window."""
    make_eq, shape, periodic = REPLAYS[case]
    (spec,) = make_eq().make_fused_rk4_window(_state(tpde, shape, 11, periodic), DT).specs
    program = spec.program
    data = torch.as_tensor(_data(shape, 12))
    views = None
    if program.sides is not None:
        block = program.sides.block(0.3, 0, 3, DT, F64, "cpu")
        views = program.sides.for_pass(F64, "cpu", 1, block, 2)
    p = program.cut(F64)[index]
    ins = _pass_inputs(program, data, views)[index]
    plain = s3.pass_plain(p, ins, views)
    assert len(plain) == len(p.writes) and p.n_fields == len(ins)
    for tile in TILES:
        marched = s3.pass_marched(p, ins, tile, views)
        for got, want in zip(marched, plain, strict=True):
            assert torch.equal(got, want), tile


# model: the ext passes' (depth, extent, slots per volume) in fp32, in fp64
CH_TWO = ((4, 4, (3, 3, 3, 3, 3)), (4, 0, (5, 1, 3, 3, 3, 3, 3, 3)))
EXT_CUTS = {
    "cahn-hilliard": (CH_TWO, CH_TWO),
    "kuramoto-sivashinsky": (((4, 4, (3, 3, 2, 3, 3, 3, 2)),
                              (4, 0, (5, 1, 3, 3, 3, 2, 3, 3, 3, 2))),
                             ((2, 6, (3, 3, 2)), (2, 4, (1, 3, 3, 3, 2)),
                              (2, 2, (1, 1, 3, 3, 3, 2)), (2, 0, (3, 1, 3, 3, 3, 2)))),
}


@pytest.mark.parametrize("flag_set", range(4))
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("model", EXT_CUTS)
def test_ext_march_replays_plain_version(model, dtype, flag_set):
    """The ext kernel's cut step on one block's extended buffer (halo 8),
    under each edge-flag pattern, equals the plain ext step (the traced
    step's, independent of the cut) bit for bit. Each dtype takes two RK
    stages a pass where its passes have plans in it (Cahn-Hilliard, and
    Kuramoto-Sivashinsky in fp32: two passes of four planes of halo,
    computing 4 and 0 cells past the block), else one (Kuramoto-Sivashinsky
    in fp64, whose second pass of two stages has no fp64 plan: the serial
    cut, its passes computing 6, 4, 2 and 0 cells past the block)."""
    state = _state(tpde, [16, 16, 16], 3, False, F32)
    mesh = GridMesh.from_grid(state.grid, [2, 2, 2])
    window = MODELS[model](tpde, NOFLUX).make_fused_rk4_window(state, DT, mesh=mesh)
    serial = MODELS[model](tpde, NOFLUX).make_fused_rk4_window(state, DT)
    program = window.program
    assert isinstance(program, e3.ExtStencilProgram3D)
    for cut, want in zip((program.cut(F32), program.cut(F64)), EXT_CUTS[model], strict=True):
        assert [(p.depth, p.extent, p.march.slots) for p in cut] == list(want)
    assert program.passes is program.cut(F32)
    passes = program.cut(dtype)
    if len(passes) == 4:
        for p, q in zip(passes, serial.program.cut(dtype), strict=True):
            assert (p.reads, p.writes, p.march.slots) == (q.reads, q.writes, q.march.slots)
        assert program.tiles[dtype] == serial.program.tiles[dtype]
        two = type("TwoStages", (e3.ExtStencilProgram3D,), {"pass_stages": (2,)})
        assert two(state.grid, program.make_step, 8, 1, carry=True).tiles[F64][1] is None
    assert [s.k for s in window.specs] == [1] and window.specs[0].halo == 8
    ext = torch.as_tensor(_data((24, 24, 24), flag_set), dtype=dtype)
    spec = e3.multi_stencil_ext_3d_spec(program, 1, dtype, (8, 8, 8), 8)
    assert len(spec.tile) == len(passes)
    flags = FLAGS_3D[flag_set]
    plain = e3.multi_stencil_ext_3d_plain([ext], spec, flags)
    for tile in ((3, 5, 4), (32, 8, 16), None):
        marched = e3.multi_stencil_ext_3d_marched([ext], spec, flags, tile=tile)
        torch.testing.assert_close(marched[0], plain[0], rtol=0, atol=0)


@pytest.mark.parametrize("flag_set", range(4))
@pytest.mark.parametrize("stages", [1, 2])
def test_ext_passes_shrink_their_regions(stages, flag_set):
    """Each ext pass of Cahn-Hilliard on one block, cut one or two RK stages
    a pass, computes the block and the cells past it that the passes after
    it read (6, 4, 2, 0, or 4, 0; zero beyond a flagged face): its replay
    equals its plain version bit for bit on that region, no cell of it NaN,
    on the inputs the passes before it wrote; with no flag the last equals the serial step on the
    buffer's periodic grid."""
    grid = tpde.UnitGrid([16, 16, 16], periodic=False)
    state = tpde.ScalarField(grid, _data(grid.shape, 9), dtype=F64)
    base = tpde.CahnHilliardPDE(bc_c=NOFLUX, bc_mu=NOFLUX).make_fused_rk4_window(state, DT)
    cut = type("Cut", (e3.ExtStencilProgram3D,), {"pass_stages": (stages,)})
    program = cut(grid, base.program.make_step, 8, 1, carry=True)
    assert [p.extent for p in program.cut(F64)] == ([6, 4, 2, 0] if stages == 1 else [4, 0])
    spec = e3.multi_stencil_ext_3d_spec(program, 1, F64, (8, 8, 8), 8)
    ext = torch.as_tensor(_data((24, 24, 24), 20 + flag_set))
    flags = FLAGS_3D[flag_set]
    edges = tuple(bool(f) for f in flags)
    held = {}
    for p in program.cut(F64):
        ins = [ext] + [held[i] for i in p.reads]
        plain = e3.ext_pass_plain(p, ins, spec, edges, (0, 0, 0))
        marched = e3.ext_pass_marched(p, ins, spec, edges, (0, 0, 0), (3, 5, 4))
        region = e3._region(spec, p.extent)
        assert all(tuple(v.shape) == (8 + 2 * p.extent,) * 3 for v in plain)
        for got, want in zip(marched, plain, strict=True):
            assert not torch.isnan(got).any()
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        outs = [torch.full_like(ext, float("nan")) for _ in plain]
        for out, value in zip(outs, plain, strict=True):
            out[region] = value
        held.update(zip(p.writes, outs))
    # with no flags the block sees its buffer's cells as a periodic grid's
    # (every pass's reach stays inside the buffer): the last pass equals the
    # serial step on the periodic 24³ grid of the buffer there
    if not any(flags):
        periodic = tpde.CahnHilliardPDE().make_fused_rk4_window(
            tpde.ScalarField(tpde.UnitGrid([24] * 3, periodic=True), 0.0, dtype=F64), DT)
        want = s3.multi_stencil_3d_plain([ext], periodic.specs[0])[0][(slice(8, 16),) * 3]
        torch.testing.assert_close(outs[0][(slice(8, 16),) * 3], want, rtol=0, atol=0)


def test_ext_pass_with_side_inputs_is_the_serial_pass():
    """A face in time on a [2, 2, 1] mesh of 8-cell blocks: every block's ext
    plain version and ext march replay, reading the global tables at its
    origin, put together equal the serial cut step bit for bit."""
    grid = tpde.UnitGrid([16, 16, 8], periodic=False)
    data = torch.as_tensor(_data(grid.shape, 6))
    eq = tpde.PDE({"c": CH_EXPR}, bc=TIMED)
    state = tpde.ScalarField(grid, data)
    mesh = GridMesh(grid, [2, 2, 1], devices=["cpu"] * 4)
    ext_window = eq.make_fused_rk4_window(state, DT, mesh=mesh)
    serial = eq.make_fused_rk4_window(state, DT)
    # with side inputs the ext step keeps one RK stage a pass (kernel B's
    # two-stage passes take more registers)
    assert ext_window.program.sides is not None
    assert [p.extent for p in ext_window.program.passes] == [6, 4, 2, 0]
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
    """The port's fused RK4 window (its passes' plain versions on CPU
    tensors) against pde_tpu's in interpret mode, over two tracker
    windows."""
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
    """``laplace(c**3 - c - laplace(c))`` with a face in time: RK4's passes
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
    assert window.needs_t and len(window.program.passes) == 4
    assert "launch_sides_3d<pass3::Program" in window.program.source
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
    "kuramoto-sivashinsky no-flux [2, 2, 1]": ("kuramoto-sivashinsky", NOFLUX, (16, 16, 8),
                                               False, [2, 2, 1]),
}


@pytest.mark.parametrize("case", MESHES)
def test_decomposed_windows_match_serial_and_pde_tpu(case, monkeypatch):
    """The decomposed window (#6's passes' plain versions over the blocks,
    one exchange a step) equals the serial window bit for bit and matches
    pde_tpu's sharded fused window."""
    model, bc, shape, periodic, decomposition = MESHES[case]

    def make_eq(p):
        return MODELS[model](p, bc)

    mesh = GridMesh(tpde.UnitGrid(list(shape), periodic=periodic), decomposition,
                    devices=["cpu"] * int(np.prod(decomposition)))
    exchange = HaloExchange(mesh, 8)
    strips = len(exchange.strips(exchange.allocate(1, F64)))
    copies = HaloExchange.copies
    solver = tpde.RungeKuttaSolver(make_eq(tpde), backend="torch", adaptive=False,
                                   decomposition=decomposition)
    got = _run(solver, _state(tpde, shape, 7, periodic))
    assert solver.info["fused_step"] is True and solver.info["decomposition"] == decomposition
    assert HaloExchange.copies - copies == 8 * strips  # one exchange a step, eight steps
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
