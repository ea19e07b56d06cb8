"""Decomposed 3D windows with boundary values that vary over a face, in time,
or in space and time (the side inputs of the ext kernel #6): every block
reads the serial window's face tables of the global grid at its origin.

The kernel layer: the ext kernel's plain version and the replay of its march
on the blocks of [2, 1, 1], [1, 2, 1], [1, 1, 2] and [2, 2, 2] meshes, put
together, equal the serial side-input pass (#5's plain version) bit for bit
at every k of the ladder. The solves: the cases of ``pde_tpu``'s
``test_3d_sharded_bc_side_input_parity`` and ``test_3d_array_factor_parity``
(``tests/ops/test_pallas_3d.py:692-770``) through the port's decomposed
windows under the ``torch`` engine (``fused_step``), bit-equal to the port's
serial side-input window; a subset also within rtol 1e-12, atol 1e-13 of
``pde_tpu``'s decomposed fused run in interpret mode. fp64.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_ext_3d as e3
from pde_tpu_torch.ops import cuda_stencil_3d as s3
from pde_tpu_torch.parallel import GridMesh, HaloExchange

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-13)
F64 = torch.float64
SHAPE = (8, 8, 16)
BOUNDS = [(0, 1), (0, 2), (0, 3)]
DT = 2e-4
T0 = 0.3
CUTS = [[2, 1, 1], [1, 2, 1], [1, 1, 2], [2, 2, 2]]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _data(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).uniform(0.2, 0.8, size=shape)


def _face(seed, shape, low=-1.0, high=1.0):
    return np.random.default_rng(seed).uniform(low, high, shape)


# pde_tpu's test_3d_sharded_bc_side_input_parity
SIDES = {
    "x-plane": {"x-": {"value": _face(1, (8, 16))}, "x+": {"derivative": 0},
                "y": {"derivative": 0}, "z": {"value": 0}},
    "y-side": {"x": {"derivative": 0}, "y-": {"value": _face(2, (8, 16))},
               "y+": {"derivative": 0}, "z": {"value": 0}},
    "z-side": {"x": {"derivative": 0}, "y": {"value": 0},
               "z-": {"value": _face(3, (8, 8))}, "z+": {"derivative": 0}},
    "t-arr": {"x-": {"value": _face(1, (8, 16))}, "x+": {"derivative": 0},
              "y-": {"value_expression": "sin(3 * t)"}, "y+": {"value": 0},
              "z": {"derivative": 0}},
    "xt": {"x": {"derivative": 0}, "y-": {"value_expression": "sin(z - 2 * t)"},
           "y+": {"value": 0}, "z-": {"value_expression": "cos(x + t)"},
           "z+": {"derivative": 0}},
}


def _solve(pkg, bc, decomposition=None, *, eq=None, solver="euler", steps=10, seed=0,
           tracker=None):
    grid = pkg.CartesianGrid(BOUNDS, list(SHAPE))
    kw = {} if pkg is jpde else {"dtype": F64}
    state = pkg.ScalarField(grid, _data(seed), **kw)
    eq = pkg.DiffusionPDE(0.1, bc=bc) if eq is None else eq
    extra = {} if pkg is jpde else {"backend": "torch"}
    if decomposition is not None:
        extra["decomposition"] = decomposition
    res, info = eq.solve(state, t_range=[T0, T0 + steps * DT], dt=DT, tracker=tracker,
                         solver=solver, ret_info=True, **extra)
    assert info["solver"].get("fused_step"), info["solver"]
    return res


# -- the kernel layer ------------------------------------------------------------------------------
EXT_CASES = {
    "array x, xt z": ([False, False, False], {
        "x-": {"value": _face(4, (10, 14))}, "x+": {"value": 0}, "y": {"derivative": 0},
        "z-": {"value_expression": "cos(x + t)"}, "z+": {"derivative": 0}}),
    "periodic x, t on y, factor on z": ([True, False, False], {
        "x": "periodic", "y-": {"value_expression": "sin(3*t)"}, "y+": {"derivative": 0},
        "z-": {"type": "mixed", "value": _face(5, (12, 10), 0.5, 2.0), "const": 0.3},
        "z+": {"value": 0}}),
}


@pytest.mark.parametrize("cut", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("case", EXT_CASES)
def test_ext_pass_over_blocks_is_the_serial_pass(case, cut):
    """A 12x10x14 grid cut into blocks (each face flag set on some blocks and
    clear on others): every block's ext plain version and ext march replay,
    reading the global tables at its origin, put together equal the serial
    side-input pass bit for bit at every k, from inner step 2 of a window."""
    periodic, bc = EXT_CASES[case]
    grid = tpde.CartesianGrid(BOUNDS, [12, 10, 14], periodic=periodic)
    data = torch.tensor(_data(6, grid.shape))
    state = tpde.ScalarField(grid, data)
    eq = tpde.PDE({"u": "0.1 * laplace(u) + u - u**3 - 0.05 * gradient_squared(u)"}, bc=bc)
    mesh = GridMesh(grid, cut, devices=["cpu"] * int(np.prod(cut)))
    ext_window = eq.make_fused_euler_window(state, DT, mesh=mesh)
    serial = eq.make_fused_euler_window(state, DT)
    program = ext_window.program
    assert isinstance(program, e3.ExtStencilProgram3D) and program.sides is not None
    assert ext_window.needs_t and [s.k for s in ext_window.specs] == serial.program.ladder
    halo = ext_window.specs[0].halo
    exchange = HaloExchange(mesh, halo)
    buffers = exchange.allocate(1, F64)
    exchange.load(buffers, [[block] for block in mesh.split_field_data(data)])
    exchange.copy(exchange.strips(buffers))
    flags = [mesh.edge_flags(b) + list(mesh.block_origin(b)) for b in range(len(mesh))]
    for spec, ext_spec in zip(serial.specs, ext_window.specs, strict=True):
        block = serial.program.sides.block(T0, 0, spec.k + 2, DT, F64, "cpu")
        views = serial.program.sides.for_pass(F64, "cpu", spec.k, block, 2)
        want = s3.multi_stencil_3d_plain([data], spec, views)[0]
        outs = exchange.allocate(1, F64)
        e3.multi_stencil_ext_3d(buffers, outs, flags, ext_spec, sides=views)
        plain = mesh.combine_field_data(exchange.interiors(outs)[b][0] for b in range(len(mesh)))
        marched = mesh.combine_field_data(
            e3.multi_stencil_ext_3d_marched(buffers[b], ext_spec, flags[b], (4, 3, 5), views)[0]
            for b in range(len(mesh)))
        torch.testing.assert_close(plain, want, rtol=0, atol=0)
        torch.testing.assert_close(marched, want, rtol=0, atol=0)


def test_ext_pass_checks_its_origins():
    """A pass with side inputs takes nine ints a block (six face flags, its
    first cell in the grid) and the pass's tables."""
    grid = tpde.CartesianGrid(BOUNDS, [12, 10, 14])
    state = tpde.ScalarField(grid, 0.0, dtype=F64)
    mesh = GridMesh(grid, [2, 1, 1], devices=["cpu"] * 2)
    window = tpde.DiffusionPDE(0.1, bc=EXT_CASES["array x, xt z"][1]).make_fused_euler_window(
        state, DT, mesh=mesh)
    spec = window.specs[-1]
    bufs = [[torch.zeros(tuple(n + 2 * spec.halo for n in spec.shape), dtype=F64)]]
    with pytest.raises(ValueError, match="9 ints per block"):
        e3.multi_stencil_ext_3d(bufs, bufs, [mesh.edge_flags(0)], spec)
    with pytest.raises(ValueError, match="does not lie in the grid"):
        e3.multi_stencil_ext_3d(bufs, bufs, [mesh.edge_flags(0) + [7, 0, 0]], spec)
    with pytest.raises(ValueError, match="side inputs"):
        e3.multi_stencil_ext_3d(bufs, bufs, [mesh.edge_flags(0) + [0, 0, 0]], spec)


# -- the solves ------------------------------------------------------------------------------------
@pytest.mark.parametrize("decomposition", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("side", SIDES)
def test_decomposed_runs_equal_the_serial_window(side, decomposition):
    """Bit-equal to the serial side-input window, as pde_tpu's test holds its
    decomposed kernel to its serial one."""
    bc = SIDES[side]
    serial = _solve(tpde, bc)
    sharded = _solve(tpde, bc, decomposition)
    np.testing.assert_array_equal(sharded.data.numpy(), serial.data.numpy())


@pytest.mark.parametrize("side, decomposition", [("t-arr", [2, 1, 1]), ("xt", [2, 2, 2]),
                                                 ("z-side", [1, 1, 2])])
def test_decomposed_runs_match_jax(side, decomposition, monkeypatch):
    """Against pde_tpu's decomposed fused run (its ext kernel #6 in
    interpret mode on its virtual CPU devices)."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    bc = SIDES[side]
    want = _solve(jpde, bc, decomposition)
    got = _solve(tpde, bc, decomposition)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), **TOL)


@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x-side", "y-side", "z-side"])
def test_factor_faces_on_a_mesh(axis):
    """Robin faces with per-face gamma arrays on [2, 2, 1], bit-equal to the
    serial window (test_3d_array_factor_parity)."""
    axes = "xyz"
    face = tuple(n for a, n in enumerate(SHAPE) if a != axis)
    bc = {axes[a]: {"derivative": 0} for a in range(3) if a != axis}
    bc[f"{axes[axis]}-"] = {"type": "mixed", "value": _face(7, face, 0.5, 2.0), "const": 0.3}
    bc[f"{axes[axis]}+"] = {"value": 0}
    serial = _solve(tpde, bc)
    np.testing.assert_array_equal(_solve(tpde, bc, [2, 2, 1]).data.numpy(), serial.data.numpy())


@pytest.mark.parametrize("solver", ["runge-kutta", "adams-bashforth"])
def test_rk4_and_ab2_on_a_mesh(solver):
    """Allen-Cahn with a per-face Robin gamma and a face in time (the card's
    path (b)) on [2, 2, 2], in two tracker windows: bit-equal to the serial
    window, RK4's stages at their times."""
    bc = {"x-": {"type": "mixed", "value": _face(8, (8, 16), 0.5, 2.0), "const": 0.3},
          "x+": {"derivative": 0}, "y-": {"value_expression": "sin(3*t)"},
          "y+": {"derivative": 0}, "z": {"derivative": 0}}
    eq = tpde.PDE({"u": "laplace(u) + u - u**3"}, bc=bc)
    kwargs = dict(eq=eq, solver=solver, steps=6, tracker=tpde.trackers.ConsistencyTracker(3 * DT))
    serial = _solve(tpde, bc, **kwargs)
    sharded = _solve(tpde, bc, [2, 2, 2], **kwargs)
    np.testing.assert_array_equal(sharded.data.numpy(), serial.data.numpy())
