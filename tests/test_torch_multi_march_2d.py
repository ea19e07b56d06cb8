"""The row-marching schedule of the generated 2D multi-field kernels (TPU kernels
#7 and #8; ``march_program_2d`` of ``csrc/march_2d.cuh``).

The pure-torch replays of the kernels' march (``multi_stencil_2d_marched``,
``multi_stencil_ext_2d_marched``) follow the kernel's own schedule: the
stages of a step and the rows each lags, each volume's ring of shared-memory
rows reused modulo its length, chunk borders, and what a thread may read
between two barriers. Their slots start as NaN, and a read of another
thread's cell from a row that is stored to in the same iteration reads NaN,
so a schedule that reads a row before it exists, after it is overwritten or
while it is being written poisons the result. They are held against the
plain versions at every k of each program's ladder at rtol = atol = 0, at
plans cut small enough that strips, chunks and ragged edges all occur; the
ext replay over the blocks of a decomposed grid equals the serial replay bit
for bit. Also: the stages and slots the emitter reckons, the ladder, the
plan and the chunk length a launch picks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.parallel import GridMesh

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


EXACT = dict(rtol=0, atol=0)
# plans (strip columns, chunk rows) that cut a grid of 11-24 cells into several
# strips and chunks, ragged along both axes; None: the kernel's strip and the
# chunk its launch picks
PLANS = ((5, 7), (8, 3), None)
MIXED = {"x-": {"value": 1}, "x+": {"derivative": 0},
         "y-": {"derivative": 0.2}, "y+": {"type": "mixed", "value": 1.0, "const": 0.3}}


def _pde(equation, **kwargs):
    def build(state, dt):
        eq = (tpde.PDE(equation, **kwargs) if isinstance(equation, dict)
              else getattr(tpde, equation)(**kwargs))
        window = eq.make_fused_euler_window(state, dt)
        return window.program, window.specs

    return build


# id: (grid, window maker, state kind: scalar fields or a vector field, fields)
CASES = {
    "cahn-hilliard periodic": (lambda: tpde.UnitGrid([16, 20], periodic=True),
                               _pde("CahnHilliardPDE"), "scalar", 1),
    "cahn-hilliard dirichlet/neumann": (
        lambda: tpde.CartesianGrid([(0, 16), (0, 22)], [16, 22]),
        _pde("CahnHilliardPDE", bc_c={"derivative": 0}, bc_mu={"value": 0.3}), "scalar", 1),
    "allen-cahn robin": (
        lambda: tpde.CartesianGrid([(0, 13), (0, 18)], [13, 18]),
        _pde({"u": "laplace(u) + u - u**3"}, bc={"type": "mixed", "value": 2.0, "const": 0.5}),
        "scalar", 1),
    "mixed sides": (
        lambda: tpde.CartesianGrid([(0, 12), (0, 17)], [12, 17]),
        _pde({"c": "0.5 * laplace(c) - 0.05 * gradient_squared(c) - 0.1 * c"}, bc=MIXED),
        "scalar", 1),
    "ginzburg-landau": (lambda: tpde.UnitGrid([12, 15], periodic=True),
                        _pde({"u": "0.2 * vector_laplace(u) + u - dot(u, u) * u"}), "vector", 1),
    "brusselator no-flux": (
        lambda: tpde.UnitGrid([11, 14]),
        _pde({"u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
              "v": "0.05 * laplace(v) + u - u**2 * v"}), "scalar", 2),
    "divergence-gradient periodic rows": (
        lambda: tpde.CartesianGrid([(0, 14), (0, 15)], [14, 15], periodic=[True, False]),
        _pde({"c": "0.2 * divergence(gradient(c))"},
             bc={"x": "periodic", "y": {"derivative": 0.1}}), "scalar", 1),
    # an operand of depth 0 (a stage with no lag) beside a field read at lag 2
    "depth-0 operand": (lambda: tpde.UnitGrid([13, 12], periodic=True),
                        _pde({"u": "0.1 * laplace(u**3 - u - laplace(u)) + 0.2 * laplace(u**3)"}),
                        "scalar", 1),
}


def _window(case_id, dt=1e-3):
    grid_fn, build, kind, n_fields = CASES[case_id]
    grid = grid_fn()
    rng = np.random.default_rng(sorted(CASES).index(case_id))
    if kind == "vector":
        state = tpde.VectorField(grid, rng.uniform(-0.5, 0.5, (2, *grid.shape)),
                                 dtype=torch.float64)
        datas = [state.data[0], state.data[1]]
    else:
        datas = [torch.tensor(rng.uniform(-0.5, 0.5, grid.shape) + i) for i in range(n_fields)]
        fields = [tpde.ScalarField(grid, d) for d in datas]
        state = fields[0] if n_fields == 1 else tpde.FieldCollection(fields)
    program, specs = build(state, dt)
    return program, specs, datas


def _assert_exact(got, expected):
    for g, e in zip(got, expected, strict=True):
        torch.testing.assert_close(g, e, **EXACT)


@pytest.mark.parametrize("case_id", CASES)
def test_marched_matches_plain_at_every_k(case_id):
    program, specs, datas = _window(case_id)
    assert [spec.k for spec in specs] == program.ladder
    for spec in specs:
        expected = cs.multi_stencil_2d_plain(datas, spec)
        for plan in PLANS:
            _assert_exact(cs.multi_stencil_2d_marched(datas, spec, plan=plan), expected)


@pytest.mark.parametrize("case_id", ["cahn-hilliard dirichlet/neumann", "ginzburg-landau",
                                     "depth-0 operand"])
def test_a_short_ring_poisons_the_replay(case_id, monkeypatch):
    """Each volume keeps as many rows as its readers need, not one fewer: with
    any volume's ring a row short, the replay reads a row that is no longer
    (or not yet) there."""
    program, specs, datas = _window(case_id)
    spec = specs[0]
    expected = cs.multi_stencil_2d_plain(datas, spec)
    layout = program.march
    for v, n in enumerate(layout.slots):
        short = dataclasses.replace(layout, slots=layout.slots[:v] + (n - 1,) + layout.slots[v + 1:])
        monkeypatch.setitem(program.__dict__, "march", short)
        got = cs.multi_stencil_2d_marched(datas, spec, plan=PLANS[0])
        assert not all(torch.allclose(g, e) for g, e in zip(got, expected))
    monkeypatch.setitem(program.__dict__, "march", layout)
    _assert_exact(cs.multi_stencil_2d_marched(datas, spec, plan=PLANS[0]), expected)


@pytest.mark.parametrize("case_id, j", [("cahn-hilliard periodic", 0), ("depth-0 operand", 1)])
def test_a_stage_one_row_early_races(case_id, j, monkeypatch):
    """A stage must lag the rows it reads through a stencil by one more row
    than their writer: one row earlier, it reads its column neighbours from
    the row the other threads are writing in the same iteration (NaN)."""
    program, specs, datas = _window(case_id)
    spec = specs[0]
    layout = program.march
    stages = list(layout.stages)
    stages[j] = dataclasses.replace(stages[j], lag=stages[j].lag - 1)
    monkeypatch.setitem(program.__dict__, "march",
                        dataclasses.replace(layout, stages=tuple(stages)))
    got = cs.multi_stencil_2d_marched(datas, spec, plan=PLANS[0])
    assert any(bool(torch.isnan(g).any()) for g in got)


def test_chunks_shorter_than_the_halo():
    """At the top k of Cahn-Hilliard (halo 8) chunks of one and two rows march
    through 17 and 18: the wavefront's warm-up and drain overlap."""
    program, specs, datas = _window("cahn-hilliard dirichlet/neumann")
    spec = specs[0]
    assert spec.k * program.depth == 8
    for plan in ((22, 1), (7, 2), (3, 16)):
        _assert_exact(cs.multi_stencil_2d_marched(datas, spec, plan=plan),
                      cs.multi_stencil_2d_plain(datas, spec))


# -- the ext kernel's march over a decomposed grid -----------------------------------------------
EXT_GRIDS = {
    "no-flux": (False, {"derivative": 0}, {"value": 0.3}),
    "rows periodic": ([True, False], {"x": "periodic", "y": {"derivative": 0.1}},
                      {"x": "periodic", "y": {"curvature": 0.1}}),
    "periodic": (True, "periodic", "periodic"),
}
CUTS = ([2, 2], [1, 4], [4, 1])


def _decomposed(grid, data, program, spec_k: int, halo: int, cut):
    """The ext replay over every block of `cut`: each block's buffer sliced
    from the grid padded by the halo (wrapped; beyond a non-periodic side the
    halo holds the wrap too, which a flagged side ignores), flags set on the
    blocks' sides that lie on the grid's non-periodic sides."""
    local = tuple(n // c for n, c in zip(grid.shape, cut))
    padded = np.pad(data.numpy(), halo, mode="wrap")
    out = torch.full(grid.shape, float("nan"), dtype=data.dtype)
    spec = ce.multi_stencil_ext_spec(program, spec_k, data.dtype, local, halo)
    for block in np.ndindex(*cut):
        start = [b * n for b, n in zip(block, local)]
        ext = torch.tensor(padded[tuple(slice(s, s + n + 2 * halo) for s, n in zip(start, local))])
        flags = [0 if grid.periodic[a] else int(block[a] == (0, c - 1)[side])
                 for a, c in enumerate(cut) for side in (0, 1)]
        (got,) = ce.multi_stencil_ext_2d_marched([ext], spec, flags, plan=(7, 5))
        out[tuple(slice(s, s + n) for s, n in zip(start, local))] = got
    return out


@pytest.mark.parametrize("cut", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("grid_id", EXT_GRIDS)
def test_ext_marched_over_blocks_is_the_serial_march(grid_id, cut):
    """Cahn-Hilliard on a 32x24 grid cut into blocks (each side flag set on
    some blocks and clear on others): the blocks' ext replays put together
    equal the serial replay bit for bit, at every k of the ladder."""
    periodic, bc_c, bc_mu = EXT_GRIDS[grid_id]
    grid = tpde.CartesianGrid([(0, 32), (0, 48)], (32, 24), periodic=periodic)
    eq = tpde.CahnHilliardPDE(bc_c=bc_c, bc_mu=bc_mu)
    data = torch.tensor(np.random.default_rng(4).uniform(-0.5, 0.5, grid.shape))
    state = tpde.ScalarField(grid, data)
    mesh = GridMesh(grid, cut, devices=["cpu"] * int(np.prod(cut)))
    ext_window = eq.make_fused_euler_window(state, 1e-3, mesh=mesh)
    serial = eq.make_fused_euler_window(state, 1e-3)
    halo = ext_window.specs[0].halo
    ks = [s.k for s in ext_window.specs]
    assert ks == [k for k in serial.program.ladder if k * 2 <= min(mesh.local_shape)]
    for spec in serial.specs:
        if spec.k not in ks:
            continue
        want = cs.multi_stencil_2d_marched([data], spec, plan=(7, 5))[0]
        got = _decomposed(grid, data, ext_window.program, spec.k, halo, cut)
        torch.testing.assert_close(got, want, **EXACT)
        torch.testing.assert_close(got, cs.multi_stencil_2d_plain([data], spec)[0], **EXACT)


@pytest.mark.parametrize("flags", [[0, 0, 0, 0], [1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0]],
                         ids=lambda f: "".join(map(str, f)))
def test_ext_marched_matches_plain_per_flag(flags):
    """One block with each side flag set or clear, at a halo wider than the
    pass needs and a ragged strip: the replay equals the ext plain version."""
    grid = tpde.CartesianGrid([(0, 20), (0, 18)], (20, 18))
    eq = tpde.PDE({"c": "0.1 * laplace(c) - 0.05 * gradient_squared(c) - c**3"}, bc=MIXED)
    state = tpde.ScalarField(grid, 0.0)
    mesh = GridMesh(grid, [2, 2], devices=["cpu"] * 4)
    program = eq.make_fused_euler_window(state, 1e-3, mesh=mesh).program
    ext = torch.tensor(np.random.default_rng(9).uniform(-0.5, 0.5, (10 + 18, 9 + 18)))
    for k in program.ladder:
        spec = ce.multi_stencil_ext_spec(program, k, torch.float64, (10, 9), 9)
        (want,) = ce.multi_stencil_ext_2d_plain([ext], spec, flags)
        for plan in (None, (4, 3)):
            (got,) = ce.multi_stencil_ext_2d_marched([ext], spec, flags, plan=plan)
            torch.testing.assert_close(got, want, **EXACT)


# -- the stages, slots, ladder and plan --------------------------------------------------------
def test_stages_and_slots():
    ac, _, _ = _window("allen-cahn robin")
    assert [(st.lag, st.first, len(st.nodes)) for st in ac.march.stages] == [(1, 0, 1)]
    assert ac.march.slots == (3,)  # rows w - 1, w, w + 1 of the one stencil read
    ch, _, _ = _window("cahn-hilliard periodic")
    assert [(st.lag, st.first) for st in ch.march.stages] == [(1, 1), (2, 0)]
    # c: a stencil read at lag 1, a pointwise read at lag 2; mu: a stencil read at lag 2
    assert ch.march.lags == (0, 1) and ch.march.slots == (3, 3)
    gl, _, _ = _window("ginzburg-landau")
    assert gl.n_fields == 2 and gl.march.slots == (3, 3) and len(gl.march.stages) == 1
    deep, _, _ = _window("depth-0 operand")
    # u**3 (depth 0, lag 0), the chemical potential (depth 1), then the field
    assert [st.lag for st in deep.march.stages] == [0, 1, 2]
    assert deep.march.lags == (0, 0, 1) and deep.march.slots == (3, 4, 3)
    source = deep.source
    assert '#include "march_2d.cuh"' in source
    assert "static constexpr int kStages = 3;" in source
    assert "static constexpr int kStepSlots = 10;" in source
    assert "volume_slots(int v) { return v == 0 ? 3 : v == 1 ? 4 : 3; }" in source


def test_emitted_stage_functions():
    program, _, _ = _window("mixed sides")
    source = program.source
    assert "kRowsPeriodic = false" in source and "kColsPeriodic = false" in source
    # rows from the rows before and after (row flags), columns from the centre row
    for read in ("O.lo[0][q]", "O.hi[0][q]", "O.c[0][q - 1]", "O.c[0][q + 1]"):
        assert read in source
    for side in ("if (rf & pde_tpu_torch::kLowEdge)", "else if (rf & pde_tpu_torch::kHighEdge)",
                 "if (cf & pde_tpu_torch::kLowEdge)", "else if (cf & pde_tpu_torch::kHighEdge)"):
        assert side in source
    for dtype, ctype in ((torch.float32, "float"), (torch.float64, "double")):
        for k, (tx, threads) in program.tiles[dtype].items():
            assert (f"case {k}: return pde_tpu_torch::launch_2d<Program, {ctype}, {k}, {tx}, "
                    f"{threads}>(ins, outs, n_rows, n_cols, chunk, stream);") in source
    periodic, _, _ = _window("cahn-hilliard periodic")
    assert "kLowEdge" not in periodic.source
    rows, _, _ = _window("divergence-gradient periodic rows")
    assert "cf & pde_tpu_torch::kLowEdge" in rows.source and "rf & pde_tpu_torch" not in rows.source


def test_ext_program_shares_the_stage_functions():
    """The ext program's struct is the serial one: the same stage functions,
    whose ghosts follow the flags the geometry sets."""
    grid = tpde.CartesianGrid([(0, 16), (0, 22)], [16, 22])
    state = tpde.ScalarField(grid, 0.0, dtype=torch.float64)
    eq = tpde.CahnHilliardPDE(bc_c={"derivative": 0}, bc_mu={"value": 0.3})
    mesh = GridMesh(grid, [2, 2], devices=["cpu"] * 4)
    ext = eq.make_fused_euler_window(state, 1e-3, mesh=mesh).program
    serial = eq.make_fused_euler_window(state, 1e-3).program

    def struct(source):
        return source[source.index("namespace {"):source.index("}  // namespace")]

    assert struct(ext.source) == struct(serial.source)
    assert ext.library == "multi_stencil_ext_2d" and ext.ladder == serial.ladder
    for k, (tx, threads) in ext.tiles[torch.float64].items():
        assert (f"launch_ext_2d<Program, double, {k}, {tx}, {threads}>(ins, outs, edges, "
                "n_blocks, n_rows, n_cols, halo, ld, chunk, stream);") in ext.source


def test_ladder_top_and_its_cut():
    """The top k is ``TOP_HALO // depth``, lowered one step at a time until an
    fp64 plan fits the budget."""
    assert cs.TOP_HALO == 8
    ch, _, _ = _window("cahn-hilliard periodic")
    assert ch.ladder == [4, 2, 1]
    gl, _, _ = _window("ginzburg-landau")
    assert gl.ladder == [8, 4, 2, 1]
    # a budget too small for k = 8 in fp64 (8 levels of 6 rows), but not for k = 7
    budget = 8 * 6 * (64 + 16) * 8 - 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "SMEM_BUDGET", budget)
        mp.setattr(cs, "ROW_TX", (64,))
        assert cs.row_plan(8, 6, 8, 8) is None and cs.row_plan(7, 6, 7, 8) is not None
        assert cs.StencilProgram(gl.grid, gl.make_step, gl.depth, 2).ladder == [7, 3, 1]


@pytest.mark.parametrize("case_id", CASES)
def test_plans_fit_the_budget(case_id):
    program, _, _ = _window(case_id)
    for dtype, (_, _, itemsize) in cs._DTYPES.items():
        for k, (tx, threads) in program.tiles[dtype].items():
            width = tx + 2 * k * program.depth
            smem = k * program.march.step_slots * width * itemsize  # RowShape::kSmem
            assert tx in cs.ROW_TX and smem <= cs.SMEM_BUDGET
            assert threads % 32 == 0 and width <= threads < width + 32  # a column each
            if tx != cs.ROW_TX[0]:  # the widest strip that fits
                wider = cs.ROW_TX[cs.ROW_TX.index(tx) - 1] + 2 * k * program.depth
                assert k * program.march.step_slots * wider * itemsize > cs.SMEM_BUDGET


def test_chunk_length_fills_the_card():
    """The chunk the wrappers pass to a launch: the longest that still gives
    two blocks per SM of the H100's 132, at the main paths' shapes."""
    assert cs.chunk_rows(4096, 16) == 128  # Cahn-Hilliard and Ginzburg-Landau 4096²: 512 blocks
    assert cs.chunk_rows(2048, 8, 4) == 128  # four 2048² blocks of a [2, 2] mesh: 512 blocks
    assert cs.chunk_rows(1024, 4) == 16  # 1024²: 256 blocks, the floor
    assert cs.chunk_rows(8192, 32) == 512
    for n_rows, strips, blocks in ((4096, 16, 1), (2048, 8, 4), (8192, 32, 1), (300, 2, 8)):
        chunk = cs.chunk_rows(n_rows, strips, blocks)
        assert chunk in cs.CHUNK_ROWS
        count = -(-n_rows // chunk) * strips * blocks
        assert count >= cs.FILL_BLOCKS or chunk == cs.CHUNK_ROWS[-1]
        if chunk != cs.CHUNK_ROWS[0]:
            longer = cs.CHUNK_ROWS[cs.CHUNK_ROWS.index(chunk) - 1]
            assert -(-n_rows // longer) * strips * blocks < cs.FILL_BLOCKS
    # the serial wrapper passes the same rule's chunk to the kernel
    program, _, _ = _window("cahn-hilliard periodic")
    for dtype in (torch.float32, torch.float64):
        for k in program.ladder:
            spec = cs.multi_stencil_spec(program, k, dtype)
            n_rows, n_cols = spec.shape
            assert program.launch_args(spec) == (
                n_rows, n_cols, k, cs.chunk_rows(n_rows, -(-n_cols // spec.tile[0])))
