"""The row-marching schedule of the two 2D affine Laplacian kernels (TPU kernels
#1 and #12; ``AffineRowMarch`` of ``csrc/affine_march_2d.cuh``).

The pure-torch replays of the kernels' march (``affine_laplace_2d_marched``,
``affine_laplace_ext_2d_marched``) follow the kernel's own schedule: the two
shared-memory rows of each level and the iteration each is written and read
in, each thread's three registers a level, where each ghost is formed, the
chunk and strip borders. Registers and shared rows start as NaN, and a read
of other threads' cells from a row that is stored to in the same iteration
reads NaN, so a schedule that reads a value before it exists, after it is
overwritten or while it is being written poisons the result. They are held
against the plain versions in fp64 at rtol = atol = 0: every BC form, both
mixed periodicities, grids smaller than the halo, ragged strips and chunks,
every edge-flag set; the ext replay over the blocks of a decomposed grid
equals the serial replay bit for bit; and the whole slice against
``pde_tpu``'s Pallas kernels in interpret mode. Also: the plan, the top k and
the ladders of the serial and decomposed windows.
"""

import math

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import affine_bc_specs as jax_affine_bc_specs
from pde_tpu.ops.pallas_cartesian import make_affine_laplace_2d as jax_affine_laplace_2d
from pde_tpu.ops.pallas_cartesian import make_affine_laplace_ext_2d as jax_affine_laplace_ext_2d
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.parallel import GridMesh, make_fused_euler_window_sharded

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


EXACT = dict(rtol=0, atol=0)
# the BC forms of tests/test_torch_affine_laplace.py
BC_CASES = [
    {"value": 0},
    {"value": 1.5},
    {"derivative": 0},
    {"derivative": 0.3},
    {"type": "mixed", "value": 2.0, "const": 0.5},
    {"curvature": 0.0},
    {"curvature": 1.0},
]
# plans (strip columns, chunk rows): ragged against the grids below along both
# axes, chunks shorter than the halo; None: the kernel's strip and the chunk its
# launch picks
PLANS = ((5, 7), (8, 3), None)
FLAG_SETS = [[0, 0, 0, 0], [1, 0, 0, 0], [0, 1, 0, 1], [1, 1, 1, 1]]
MIXED_BC = {"x-": {"value": 1.0}, "x+": {"derivative": 0.3},
            "y-": {"type": "mixed", "value": 2.0, "const": 0.5}, "y+": {"curvature": 1.0}}


def _spec(shape, periodic, bc, k, bounds=((0, 1), (0, 2))):
    grid = tpde.CartesianGrid(list(bounds), shape, periodic=periodic)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    return cc.affine_laplace_spec(grid, a=1.0, b=1e-3, k=k, dtype=torch.float64, bcs=bcs)


def _data(shape, seed=80):
    return torch.tensor(np.random.default_rng(seed).random(shape))


def _assert_marched(data, spec, plans=PLANS):
    expected = cc.affine_laplace_2d_plain(data, spec)
    for plan in plans:
        torch.testing.assert_close(cc.affine_laplace_2d_marched(data, spec, plan=plan), expected,
                                   **EXACT)


# -- the serial replay ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 6, 16])
@pytest.mark.parametrize("bc", BC_CASES, ids=str)
def test_marched_matches_plain_for_every_bc(bc, k):
    _assert_marched(_data((13, 17)), _spec((13, 17), False, bc, k))


@pytest.mark.parametrize("k", [1, 2, 5, 16])
@pytest.mark.parametrize("bounds", [((0, 1), (0, 1)), ((0, 1), (0, 3))],
                         ids=["isotropic", "anisotropic"])
def test_marched_matches_plain_periodic(bounds, k):
    _assert_marched(_data((12, 19)), _spec((12, 19), True, None, k, bounds))


@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize(
    "bc,periodic",
    [({"x": "periodic", "y": {"derivative": 0.3}}, [True, False]),
     ({"x": {"value": 1}, "y": "periodic"}, [False, True])],
    ids=["periodic-x", "periodic-y"],
)
def test_marched_matches_plain_mixed_periodicity(bc, periodic, k):
    _assert_marched(_data((14, 11)), _spec((14, 11), periodic, bc, k))


@pytest.mark.parametrize("shape,periodic,bc", [
    ((2, 5), False, {"curvature": 1.0}),
    ((3, 4), True, None),
    ((2, 3), [False, True], {"x": {"derivative": 0.2}, "y": "periodic"}),
], ids=["two rows bounded", "periodic wraps many times", "two rows, periodic columns"])
def test_grids_smaller_than_the_halo(shape, periodic, bc):
    """At k = 16 the window is 32 cells wider than these grids: a periodic axis
    wraps several times, a bounded one leaves most of the window outside."""
    _assert_marched(_data(shape), _spec(shape, periodic, bc, 16), plans=((3, 1), (1, 2), None))


def test_one_shared_row_a_level_races():
    """A level's column neighbours come from the row the level below stored in
    the iteration before: with one shared row a level instead of two, every
    read meets the row being stored in the same iteration, and the replay
    reads NaN."""
    data, spec = _data((13, 17)), _spec((13, 17), True, None, 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cc, "ROW_SLOTS", 1)
        assert bool(torch.isnan(cc.affine_laplace_2d_marched(data, spec, plan=(8, 3))).all())
    _assert_marched(data, spec, plans=((8, 3),))


def test_marched_and_tiled_blocks_agree_with_the_plain_version_in_fp32():
    """fp32: the replay, the block emulation and the plain version run the same
    operations on the same values, so they agree bit for bit there too."""
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], (13, 17))
    bcs = grid.get_boundary_conditions({"type": "mixed", "value": 2.0, "const": 0.5})
    spec = cc.affine_laplace_spec(grid, a=1.0, b=1e-3, k=9, dtype=torch.float32, bcs=bcs)
    data = _data((13, 17)).float()
    expected = cc.affine_laplace_2d_plain(data, spec)
    torch.testing.assert_close(cc.affine_laplace_2d_marched(data, spec, plan=(5, 7)), expected,
                               **EXACT)
    torch.testing.assert_close(cc.affine_laplace_2d_tiled(data, spec, tile=(5, 7)), expected,
                               **EXACT)


# -- the ext replay -----------------------------------------------------------------------------
def _ext_spec(k, halo, periodic=False, bc=MIXED_BC, local=(8, 12)):
    grid = tpde.CartesianGrid([(0, 1), (0, 3)], [16, 24], periodic=periodic)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    return ce.affine_laplace_ext_spec(grid, local, a=1.0, b=1e-3, k=k, halo=halo,
                                      dtype=torch.float64, bcs=bcs)


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("k, halo", [(1, 1), (3, 5), (8, 8)])
def test_ext_marched_matches_plain(k, halo, flags):
    """A halo wider than k reads the window at offset halo - k; a ragged strip
    and chunk; flags on any set of sides."""
    spec = _ext_spec(k, halo)
    ext = torch.tensor(np.random.default_rng(k + halo).random((8 + 2 * halo, 12 + 2 * halo)))
    expected = ce.affine_laplace_ext_2d_plain(ext, spec, flags)
    for plan in ((5, 3), None):
        torch.testing.assert_close(ce.affine_laplace_ext_2d_marched(ext, spec, flags, plan=plan),
                                   expected, **EXACT)


def _decomposed(data, spec_k, grid, bcs, cut, halo):
    """The ext replay over every block of `cut`: each block's buffer sliced
    from the grid padded by the halo (wrapped; beyond a non-periodic side the
    halo holds the wrap too, which a flagged side ignores), flags set on the
    blocks' sides that lie on the grid's non-periodic sides."""
    local = tuple(n // c for n, c in zip(grid.shape, cut))
    spec = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=1e-3, k=spec_k, halo=halo,
                                      dtype=torch.float64, bcs=bcs)
    padded = np.pad(data.numpy(), halo, mode="wrap")
    out = torch.full(grid.shape, float("nan"), dtype=data.dtype)
    for block in np.ndindex(*cut):
        start = [b * n for b, n in zip(block, local)]
        ext = torch.tensor(padded[tuple(slice(s, s + n + 2 * halo) for s, n in zip(start, local))])
        flags = [0 if grid.periodic[a] else int(block[a] == (0, c - 1)[side])
                 for a, c in enumerate(cut) for side in (0, 1)]
        out[tuple(slice(s, s + n) for s, n in zip(start, local))] = (
            ce.affine_laplace_ext_2d_marched(ext, spec, flags, plan=(7, 5)))
    return out


@pytest.mark.parametrize("cut", [[2, 2], [1, 4]], ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("periodic, bc", [
    (True, None), (False, MIXED_BC), ([True, False], {"x": "periodic", "y": {"derivative": 0.1}}),
], ids=["periodic", "mixed sides", "rows periodic"])
def test_ext_marched_over_blocks_is_the_serial_march(periodic, bc, cut):
    """A 16x40 grid cut into blocks (each side flag set on some blocks and
    clear on others): the blocks' ext replays put together equal the serial
    replay bit for bit, at each k of a halo-8 ladder."""
    grid = tpde.CartesianGrid([(0, 1), (0, 3)], (16, 40), periodic=periodic)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    data = _data(grid.shape, seed=81)
    for k in (8, 4, 1):
        spec = cc.affine_laplace_spec(grid, a=1.0, b=1e-3, k=k, dtype=torch.float64, bcs=bcs)
        serial = cc.affine_laplace_2d_marched(data, spec, plan=(7, 5))
        torch.testing.assert_close(_decomposed(data, k, grid, bcs, cut, 8), serial, **EXACT)
        torch.testing.assert_close(serial, cc.affine_laplace_2d_plain(data, spec), **EXACT)


# -- the slice against pde_tpu's Pallas kernels (interpret mode) -------------------------------
@pytest.mark.parametrize("case", [
    ("periodic", ([32, 40],), {"periodic": True}, None, 16, "UnitGrid"),
    ("no-flux", ([(0, 1), (0, 2)], (24, 20)), {}, {"derivative": 0}, 5, "CartesianGrid"),
    ("mixed", ([(0, 1), (0, 3)], (16, 24)), {}, MIXED_BC, 3, "CartesianGrid"),
], ids=lambda c: c[0])
def test_marched_matches_jax(case):
    """The replay of the kernel's march against ``make_affine_laplace_2d`` of
    ``pde_tpu`` in interpret mode, fp64, at 1e-12."""
    _, args, kwargs, bc, k, cls = case
    jgrid, tgrid = getattr(jpde, cls)(*args, **kwargs), getattr(tpde, cls)(*args, **kwargs)
    data = np.random.default_rng(82).random(jgrid.shape)
    jbcs = None if bc is None else jgrid.get_boundary_conditions(bc)
    tbcs = None if bc is None else tgrid.get_boundary_conditions(bc)
    expected = jax_affine_laplace_2d(jgrid, a=1.0, b=1e-3, k=k, dtype=np.float64, bcs=jbcs,
                                     interpret=True)(data)
    spec = cc.affine_laplace_spec(tgrid, a=1.0, b=1e-3, k=k, dtype=torch.float64, bcs=tbcs)
    got = cc.affine_laplace_2d_marched(torch.tensor(data), spec, plan=(9, 7))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("flags", [[1, 0, 0, 1], [0, 1, 1, 0]], ids=lambda f: "".join(map(str, f)))
def test_ext_marched_matches_jax(flags):
    """The ext replay against ``make_affine_laplace_ext_2d`` of ``pde_tpu`` in
    interpret mode on the same extended block and flags, fp64, at 1e-12."""
    k = 4
    jgrid = jpde.CartesianGrid([(0, 1), (0, 3)], [16, 24])
    jbcs = jgrid.get_boundary_conditions(MIXED_BC)
    ext = np.random.default_rng(83).random((8 + 2 * k, 12 + 2 * k))
    expected = jax_affine_laplace_ext_2d(
        (8, 12), a=1.0, b=1e-3, k=k, discretization=jgrid.discretization, ext_cols=True,
        dtype=np.float64, bc_specs=jax_affine_bc_specs(jgrid, jbcs), interpret=True,
    )(ext, np.asarray(flags + [0], dtype=np.int32))
    got = ce.affine_laplace_ext_2d_marched(torch.tensor(ext), _ext_spec(k, k), flags, plan=(5, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-12, atol=1e-12)


# -- the plan, the top k and the ladders -----------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_plan_per_k_and_dtype(dtype):
    """One thread per window column in whole warps, two shared rows a level
    within the budget (a level of a 256-column strip at k = 16: 37120 B in
    fp32, 74240 B in fp64), the unroll period a multiple of the slots, the
    three registers and the prefetch ring; the spec carries the plan and the
    generated entry points instantiate it."""
    itemsize = cc._DTYPES[dtype][2]
    assert cc.ROW_PERIOD == math.lcm(cc.ROW_SLOTS, 3) == 6
    assert cc.ROW_PERIOD % cc.ROW_PREFETCH == 0 and cc.ROW_MIN_BLOCKS == {4: 4, 8: 2}
    grid = tpde.UnitGrid([64, 64], periodic=True)
    sources = {library: cc.kernel_source((True, True), library).source
               for library in ("affine_laplace_2d", "affine_laplace_ext_2d")}
    ctype = cc._DTYPES[dtype][0]
    for k in range(1, cc.MAX_STEPS + 1):
        tx, threads, prefetch, min_blocks = plan = cc.affine_row_plan(k, itemsize)
        assert tx == cs.ROW_TX[0] == 256
        assert threads % 32 == 0 and tx + 2 * k <= threads < tx + 2 * k + 32
        smem = cc.affine_row_smem(k, tx, threads, itemsize)
        assert smem == k * 2 * (threads + 2) * itemsize <= cs.SMEM_BUDGET
        assert (prefetch, min_blocks) == (cc.ROW_PREFETCH, cc.ROW_MIN_BLOCKS[itemsize])
        assert cc.affine_laplace_spec(grid, a=1.0, b=0.1, k=k, dtype=dtype).tile == plan
        args = f"{ctype}, {k}, {tx}, {threads}, {prefetch}, {min_blocks}, true, true>"
        assert f"case {k}: return pde_tpu_torch::launch_affine_2d<{args}(in, out," in (
            sources["affine_laplace_2d"])
        assert f"case {k}: return pde_tpu_torch::launch_affine_ext_2d<{args}(ins, outs," in (
            sources["affine_laplace_ext_2d"])
    assert cc.affine_row_smem(16, 256, 288, itemsize) == 37120 * itemsize // 4


def test_plan_rejects_what_does_not_fit(monkeypatch):
    monkeypatch.setattr(cs, "SMEM_BUDGET", cc.affine_row_smem(16, 64, 96, 8) - 1)
    with pytest.raises(tpde.KernelUnsupportedError, match="No row-march plan"):
        cc.affine_row_plan(16, 8)
    assert cc.affine_row_plan(15, 8)[0] == 64


def test_sources_differ_by_periodicity_and_library():
    digests = {cc.kernel_source(p, library).digest
               for p in ((True, True), (True, False), (False, True), (False, False))
               for library in ("affine_laplace_2d", "affine_laplace_ext_2d")}
    assert len(digests) == 8
    assert ce.affine_ext_source((False, True)) is cc.kernel_source((False, True),
                                                                    "affine_laplace_ext_2d")
    assert "false, true>" in ce.affine_ext_source((False, True)).source


def test_chunk_and_strip_of_the_main_paths():
    """The block a launch marches: 256-column strips, and the chunk of
    ``chunk_rows`` (4096²: 128 rows, 512 blocks; four 2048² blocks of a
    [2, 2] mesh in one launch: 128 rows)."""
    spec = cc.affine_laplace_spec(tpde.UnitGrid([4096, 4096], periodic=True), a=1.0, b=0.01,
                                  k=cc.TOP_STEPS, dtype=torch.float32)
    assert cc.block_plan(spec) == (256, 128)
    ext = ce.affine_laplace_ext_spec(tpde.UnitGrid([4096, 4096], periodic=True), (2048, 2048),
                                     a=1.0, b=0.01, k=cc.TOP_STEPS, halo=cc.TOP_STEPS,
                                     dtype=torch.float32)
    assert ext.tile[0] == 256 and cs.chunk_rows(2048, 2048 // 256, 4) == 128
    assert cc.block_plan(spec, 8) == (8, 8) and cc.block_plan(spec, (5, 7)) == (5, 7)


def test_top_steps_and_the_ladders():
    """Both diffusion windows climb the same ladder from ``TOP_STEPS`` (the
    TPU kernel's cap stays the gate), so a decomposed run makes the same
    passes as the serial one; the decomposed halo is the top k and shrinks
    with it where blocks are small."""
    assert cc.TOP_STEPS == 12 and cc.MAX_STEPS == 16
    ladder = [cc.TOP_STEPS >> i for i in range(cc.TOP_STEPS.bit_length())]
    grid = tpde.UnitGrid([64, 48], periodic=True)
    serial = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=0.1, dtype=torch.float64)
    assert [s.k for s in serial.specs] == ladder
    sharded = make_fused_euler_window_sharded(
        GridMesh(grid, [2, 2], devices=["cpu"] * 4), diffusivity=0.1, dt=0.1,
        dtype=torch.float64)
    assert [s.k for s in sharded.specs] == ladder and sharded.exchange.halo == cc.TOP_STEPS
    small = make_fused_euler_window_sharded(
        GridMesh(tpde.UnitGrid([24, 20], periodic=True), [2, 2], devices=["cpu"] * 4),
        diffusivity=0.1, dt=0.1, dtype=torch.float64)
    assert [s.k for s in small.specs] == [6, 3, 1] and small.exchange.halo == 6
    data = _data((64, 48))
    steps = 37
    expected = data
    one = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=1, dtype=torch.float64)
    for _ in range(steps):
        expected = cc.affine_laplace_2d_plain(expected, one)
    torch.testing.assert_close(serial(data, steps), expected, rtol=1e-12, atol=1e-12)
