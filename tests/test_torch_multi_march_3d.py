"""The x-marching schedule of the generated 3D multi-field kernels (TPU kernels
#5/#4 and #6; ``march_program_3d`` of ``csrc/multi_stencil_3d.cuh``).

The pure-torch replays of the kernels' march (``multi_stencil_3d_marched``,
``multi_stencil_ext_3d_marched``) follow the kernel's own schedule: the
stages of a step and the planes each lags, each volume's ring of
shared-memory slots reused modulo its count, and what a thread may read
between two barriers. Their slots start as NaN, and a read of another
thread's cell from a slot that is stored to in the same iteration reads NaN,
so a schedule that reads a plane before it exists, after it is overwritten
or while it is being written poisons the result. They are held against the
plain versions at every k of each program's ladder, fp64 to 1e-12, at plans
cut small enough that blocks, chunks and ragged edges all occur; the ext
replay over the blocks of a decomposed grid equals the serial replay bit for
bit. Also: the stages and slots the emitter reckons, the ladder and the plan.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_cartesian_3d as c3
from pde_tpu_torch.ops import cuda_ext_3d as e3
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.ops import cuda_stencil_3d as s3
from pde_tpu_torch.parallel import GridMesh

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
RAGGED = ([(0, 1), (0, 2), (0, 3)], (10, 12, 14))
# plans that cut a grid of 10-16 cells into several chunks and column tiles,
# ragged along every axis
PLANS = ((5, 4, 8), (3, 7, 5))


def _pde(equation: str | dict, **kwargs):
    """A case's window maker for an expression PDE (``PDE`` or a model)."""

    def build(state, dt):
        eq = (tpde.PDE(equation, **kwargs) if isinstance(equation, dict)
              else getattr(tpde, equation)(**kwargs))
        window = eq.make_fused_euler_window(state, dt)
        return window.program, window.specs

    return build


def _x_faces(state, dt):
    """An rhs with derivatives along each axis and ghosts on the x faces."""
    grid = state.grid
    specs = cc.affine_bc_specs(grid, grid.get_boundary_conditions(
        {"x-": {"value": 0.5}, "x+": {"derivative": -1.0}, "y": {"derivative": 0.0},
         "z": {"curvature": 0.2}}))

    def make_step(h):
        def step(works):
            (w,) = works
            c = h.trim(w, 1)
            rate = (0.1 * h.d_row(w, bc=specs) + 0.05 * h.lap(w, bc=specs)
                    + 0.02 * h.d_col(w, bc=specs) * h.d_depth(w, bc=specs))
            return [c + dt * rate]

        return step

    program = s3.StencilProgram3D(grid, make_step, 1, 1)
    return program, [cs.multi_stencil_spec(program, k, torch.float64) for k in program.ladder]


# id: (grid, window maker, fields)
CASES = {
    "allen-cahn periodic": (lambda: tpde.UnitGrid([12] * 3, periodic=True),
                            _pde({"u": "laplace(u) + u - u**3"}), 1),
    "cahn-hilliard periodic": (lambda: tpde.UnitGrid([12] * 3, periodic=True),
                               _pde("CahnHilliardPDE"), 1),
    "cahn-hilliard no-flux ragged": (
        lambda: tpde.CartesianGrid(*RAGGED),
        _pde("CahnHilliardPDE", bc_c={"derivative": 0}, bc_mu={"derivative": 0}), 1),
    "brusselator": (lambda: tpde.UnitGrid([10] * 3, periodic=True),
                    _pde({"u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
                          "v": "0.05 * laplace(v) + u - u**2 * v"}), 2),
    "dot-grad no-flux": (
        lambda: tpde.CartesianGrid(*RAGGED),
        _pde({"c": "0.1 * laplace(c) + 0.05 * dot(gradient(c), gradient(c))"},
             bc={"derivative": 0}), 1),
    "x faces": (lambda: tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)], (11, 9, 10)), _x_faces, 1),
    # SOURCE_3D's mixed faces: value on x, derivative on y, curvature on z
    "mixed faces": (
        lambda: tpde.CartesianGrid(*RAGGED),
        _pde({"c": "0.1 * laplace(c) - 0.05 * gradient_squared(c)"},
             bc={"x": {"value": 0.2}, "y": {"derivative": 0.1}, "z": {"curvature": 0.5}}), 1),
    # an operand of depth 0 (a stage with no lag) beside a field read at lag 2
    "depth-0 operand": (lambda: tpde.UnitGrid([11] * 3, periodic=True),
                        _pde({"u": "0.1 * laplace(u**3 - u - laplace(u)) + 0.2 * laplace(u**3)"}),
                        1),
}


def _window(case_id, dt=1e-4):
    grid_fn, build, n_fields = CASES[case_id]
    grid = grid_fn()
    rng = np.random.default_rng(sorted(CASES).index(case_id))
    datas = [torch.tensor(rng.uniform(-0.5, 0.5, grid.shape) + i) for i in range(n_fields)]
    fields = [tpde.ScalarField(grid, d) for d in datas]
    state = fields[0] if n_fields == 1 else tpde.FieldCollection(fields)
    program, specs = build(state, dt)
    return program, specs, datas


@pytest.mark.parametrize("case_id", CASES)
def test_marched_matches_plain_at_every_k(case_id):
    program, specs, datas = _window(case_id)
    for spec in specs:
        expected = s3.multi_stencil_3d_plain(datas, spec)
        for tile in PLANS + (None,):
            got = s3.multi_stencil_3d_marched(datas, spec, tile=tile)
            for g, e in zip(got, expected, strict=True):
                torch.testing.assert_close(g, e, **TOL)


@pytest.mark.parametrize("case_id", ["allen-cahn periodic", "cahn-hilliard no-flux ragged",
                                     "depth-0 operand"])
def test_a_short_ring_poisons_the_replay(case_id, monkeypatch):
    """Each volume keeps as many planes as its readers need, not one fewer:
    with any volume's ring a slot short, the replay reads a plane that is no
    longer (or not yet) there."""
    program, specs, datas = _window(case_id)
    spec = specs[0]
    expected = s3.multi_stencil_3d_plain(datas, spec)
    layout = program.march
    for v, n in enumerate(layout.slots):
        if n == 1:
            continue
        short = dataclasses.replace(layout, slots=layout.slots[:v] + (n - 1,) + layout.slots[v + 1:])
        monkeypatch.setitem(program.__dict__, "march", short)
        got = s3.multi_stencil_3d_marched(datas, spec, tile=PLANS[0])
        assert not all(torch.allclose(g, e, **TOL) for g, e in zip(got, expected))
    monkeypatch.setitem(program.__dict__, "march", layout)
    got = s3.multi_stencil_3d_marched(datas, spec, tile=PLANS[0])
    for g, e in zip(got, expected, strict=True):
        torch.testing.assert_close(g, e, **TOL)


def test_chunks_shorter_than_the_halo():
    """At k = 3 a chunk of one plane marches through seven; the wavefront's
    warm-up and drain overlap."""
    program, specs, datas = _window("dot-grad no-flux")
    spec = specs[0]
    assert spec.k == 3
    for tile in ((1, 5, 6), (2, 12, 14)):
        (got,) = s3.multi_stencil_3d_marched(datas, spec, tile=tile)
        torch.testing.assert_close(got, s3.multi_stencil_3d_plain(datas, spec)[0], **TOL)


# -- the ext kernel's march over a decomposed grid -----------------------------------------------
EXT_GRIDS = {
    "x periodic": ([True, False, False],
                   {"x": "periodic", "y": {"derivative": 0}, "z": {"value": 0.3}},
                   {"x": "periodic", "y": {"value": 0.2}, "z": {"curvature": 0.1}}),
    "no-flux": (False, {"derivative": 0}, {"derivative": 0}),
}
CUTS = ([2, 2, 2], [2, 1, 1])


def _decomposed(grid, data, program, spec_k: int, halo: int, cut):
    """The ext replay over every block of `cut`: each block's buffer sliced
    from the grid padded by the halo (wrapped; beyond a non-periodic face the
    halo holds the wrap too, which a flagged face ignores), flags set on the
    blocks' faces that lie on the grid's non-periodic faces."""
    local = tuple(n // c for n, c in zip(grid.shape, cut))
    padded = np.pad(data.numpy(), halo, mode="wrap")
    out = torch.full(grid.shape, float("nan"), dtype=data.dtype)
    spec = e3.multi_stencil_ext_3d_spec(program, spec_k, data.dtype, local, halo)
    for block in np.ndindex(*cut):
        start = [b * n for b, n in zip(block, local)]
        ext = torch.tensor(padded[tuple(slice(s, s + n + 2 * halo) for s, n in zip(start, local))])
        flags = [0 if grid.periodic[a] else int(block[a] == (0, c - 1)[side])
                 for a, c in enumerate(cut) for side in (0, 1)]
        (got,) = e3.multi_stencil_ext_3d_marched([ext], spec, flags, tile=(4, 3, 5))
        out[tuple(slice(s, s + n) for s, n in zip(start, local))] = got
    return out


@pytest.mark.parametrize("cut", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("grid_id", EXT_GRIDS)
def test_ext_marched_over_blocks_is_the_serial_march(grid_id, cut):
    """Cahn-Hilliard on a 12x10x14 grid cut into blocks (each face flag set on
    some blocks and clear on others, the x-cut of row 4's ``ext_x`` among
    them): the blocks' ext replays put together equal the serial replay bit
    for bit, at every k of the ladder."""
    periodic, bc_c, bc_mu = EXT_GRIDS[grid_id]
    grid = tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)], (12, 10, 14), periodic=periodic)
    eq = tpde.CahnHilliardPDE(bc_c=bc_c, bc_mu=bc_mu)
    data = torch.tensor(np.random.default_rng(4).uniform(-0.5, 0.5, grid.shape))
    state = tpde.ScalarField(grid, data)
    mesh = GridMesh(grid, cut, devices=["cpu"] * int(np.prod(cut)))
    ext_window = eq.make_fused_euler_window(state, 1e-6, mesh=mesh)
    serial = eq.make_fused_euler_window(state, 1e-6)
    assert [s.k for s in ext_window.specs] == serial.program.ladder
    halo = ext_window.specs[0].halo
    for spec in serial.specs:
        want = s3.multi_stencil_3d_marched([data], spec, tile=(4, 3, 5))[0]
        got = _decomposed(grid, data, ext_window.program, spec.k, halo, cut)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(got, s3.multi_stencil_3d_plain([data], spec)[0], **TOL)


@pytest.mark.parametrize("flags", [[0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1], [1, 0, 0, 1, 1, 0]],
                         ids=lambda f: "".join(map(str, f)))
def test_ext_marched_matches_plain_per_flag(flags):
    """One block with each face flag set or clear, at a halo wider than the
    pass needs: the replay equals the ext plain version."""
    grid = tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)], (12, 10, 14))
    eq = tpde.PDE({"c": "0.1 * laplace(c) - 0.05 * gradient_squared(c) - c**3"},
                  bc={"x": {"value": 0.2}, "y": {"derivative": 0.1}, "z": {"curvature": 0.5}})
    state = tpde.ScalarField(grid, 0.0)
    mesh = GridMesh(grid, [2, 2, 2], devices=["cpu"] * 8)
    program = eq.make_fused_euler_window(state, 1e-4, mesh=mesh).program
    ext = torch.tensor(np.random.default_rng(9).uniform(-0.5, 0.5, (6 + 8, 5 + 8, 7 + 8)))
    for k in program.ladder:
        spec = e3.multi_stencil_ext_3d_spec(program, k, torch.float64, (6, 5, 7), 4)
        (want,) = e3.multi_stencil_ext_3d_plain([ext], spec, flags)
        for tile in (None, (2, 3, 4)):
            (got,) = e3.multi_stencil_ext_3d_marched([ext], spec, flags, tile=tile)
            torch.testing.assert_close(got, want, **TOL)


# -- the stages, slots, ladder and plan --------------------------------------------------------
def test_stages_and_slots():
    ac, _, _ = _window("allen-cahn periodic")
    assert [(st.lag, st.first, len(st.nodes)) for st in ac.march.stages] == [(1, 0, 1)]
    assert ac.march.slots == (3,)  # planes w - 1, w, w + 1 of the one stencil read
    ch, _, _ = _window("cahn-hilliard periodic")
    assert [(st.lag, st.first) for st in ch.march.stages] == [(1, 1), (2, 0)]
    # c: a stencil read at lag 1, a pointwise read at lag 2; mu: a stencil read at lag 2
    assert ch.march.lags == (0, 1) and ch.march.slots == (3, 3)
    deep, _, _ = _window("depth-0 operand")
    # u**3 (depth 0, lag 0), the chemical potential (depth 1), then the field;
    # u is read through a stencil at lag 1 (mu) and pointwise at lag 2 (the
    # field's update), u**3 through a stencil at lags 1 and 2
    assert [st.lag for st in deep.march.stages] == [0, 1, 2]
    assert deep.march.lags == (0, 0, 1)
    assert deep.march.slots == (3, 4, 3)
    source = deep.source
    assert "static constexpr int kStages = 3;" in source
    assert "static constexpr int kStepSlots = 10;" in source
    assert "volume_slots(int v) { return v == 0 ? 3 : v == 1 ? 4 : 3; }" in source


def test_ladder_top_and_its_cut():
    """The top k is ``TOP_HALO // depth``, lowered one step at a time until an
    fp64 plan fits the budget."""
    assert s3.TOP_HALO == 3
    ac, _, _ = _window("allen-cahn periodic")
    assert ac.ladder == [3, 1]
    ch, _, _ = _window("cahn-hilliard periodic")
    assert ch.ladder == [1]
    # two fields, three planes each: k = 3 does not fit in fp64, k = 2 does
    bru, _, _ = _window("brusselator")
    assert bru.march.step_slots == 6 and bru.ladder == [2, 1]
    assert c3.march_plan(3, 6, 3, 8) is None and c3.march_plan(2, 6, 2, 8) is not None


@pytest.mark.parametrize("case_id", CASES)
def test_plans_fit_the_budget(case_id):
    program, _, _ = _window(case_id)
    for dtype, (_, _, itemsize) in cs._DTYPES.items():
        for k, (cx, ty, tz) in program.tiles[dtype].items():
            halo = k * program.depth
            assert (cx, tz) == (c3.MARCH_CX, c3.MARCH_TZ)
            smem = k * program.march.step_slots * (ty + 2 * halo) * (tz + 2 * halo) * itemsize
            assert smem <= c3.SMEM_BUDGET  # ProgramShape::kSmem of the template
            assert f"{k}, {cx}, {ty}, {tz}>(ins, outs" in program.source


def test_plan_fills_the_card():
    """Allen-Cahn's top pass at 256³ and its ext pass over eight 128³ blocks
    launch at least one block per SM of the H100's 132."""
    state = tpde.ScalarField(tpde.UnitGrid([256] * 3, periodic=True), 0.0, dtype=torch.float32)
    window = tpde.AllenCahnPDE().make_fused_euler_window(state, 1e-3)
    for spec in window.specs:
        cx, ty, tz = spec.tile
        assert (256 // cx) * (256 // ty) * (256 // tz) >= 132
        assert 8 * (128 // cx) * (128 // ty) * (128 // tz) >= 132
