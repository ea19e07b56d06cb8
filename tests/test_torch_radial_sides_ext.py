"""Boundary values that vary along a side and in time on decomposed
cylindrical grids: the side inputs of kernel #12's radial mode (the kernel
``affine_laplace_radial_sides_ext_2d_kernel``, library
``RADIAL_SIDES_EXT_LIBRARY``), on the CPU, fp64.

- The plain version against ``pde_tpu``'s ``make_affine_laplace_ext_2d(
  radial=..., bc_specs=...)`` in interpret mode on the same extended blocks,
  its five flags (the fifth the block's first row) and its side arrays
  sliced per block from the global ones padded by the halo, as
  ``pde_tpu/parallel/fused.py:197-240`` slices them; the port's six flags
  (its first row and column) and the global tables; at 1e-12 of max|f|.
- The plain version, the tile emulation and the march replay over every
  block of [2, 1], [1, 2] and [2, 2] meshes, put together, against the
  serial radial side-input pass bit for bit (blocks whose first row is 0,
  inner ones and the last).
- The decomposed window, ``window(blocks, t0, steps)`` over 37 steps,
  against the port's serial window bit for bit; the decomposed solve under
  the ``torch`` engine fused (``fused_step``), bit-equal to the port's serial
  solve and within 1e-12 of ``pde_tpu``'s fused sharded run in interpret
  mode on its virtual CPU devices.
- On 12-row blocks, where ``pde_tpu``'s fused sharded run differs from its
  own serial run, the decomposed solve against ``pde_tpu``'s serial run.
- The ladder, the six flags a block, the wrapper's checks, the entry points,
  and what stays refused on a mesh (a time-dependent ghost factor, as in
  ``pde_tpu``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import affine_bc_specs as jax_affine_bc_specs
from pde_tpu.ops.pallas_cartesian import make_affine_laplace_ext_2d as jax_affine_laplace_ext_2d
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.parallel import GridMesh, HaloExchange
from pde_tpu_torch.parallel.fused import make_fused_euler_window_sharded

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
EXACT = dict(rtol=0, atol=0)
F64 = torch.float64
T0 = 0.3
DT = 0.01
CUTS = [[2, 1], [1, 2], [2, 2]]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the
    CPU, with eight blocks per device as pde_tpu's tests have eight CPU
    devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


# id -> (grid arguments, periodic z, conditions)
CASES = {
    "hole, periodic z, t on r-, an array on r+": (
        ((0.5, 2.0), (0, 3), (16, 24)), True, lambda: {
            "r-": {"value_expression": "0.1*sin(3*t)"},
            "r+": {"value": np.sin(np.linspace(0.0, 6.0, 24))}, "z": "periodic"}),
    # 32 rows: pde_tpu's fused sharded run on two 12-row blocks of a 24-row
    # cylinder differs from its own serial run, scalar sides too (PERF.md §7)
    "r = 0, bounded z, an array on z-, t on z+": (
        (2.0, (0, 3), (32, 16)), False, lambda: {
            "r": {"derivative": 0}, "z-": {"value": np.linspace(0.0, 1.0, 32)},
            "z+": {"derivative_expression": "cos(t)"}}),
    "hole, an array on r-, arrays and t on z": (
        ((1.0, 3.0), (0, 2), (16, 24)), False, lambda: {
            "r-": {"value": 0.5 + 0.25 * np.cos(np.linspace(0.0, 4.0, 24))},
            "r+": {"derivative_expression": "0.5*sin(t)"}, "z-": {"value": "r**2"},
            "z+": {"value_expression": "t"}}),
}


def _grid(pkg, case):
    args, periodic_z, _ = CASES[case]
    return pkg.CylindricalSymGrid(*args, periodic_z=periodic_z)


def _data(shape, seed=0):
    return np.random.default_rng(seed).uniform(0.2, 0.8, size=shape)


def _times(k, t0=T0):
    return [t0 + s * DT for s in range(k)]


def _blocks(mesh, data, halo):
    """Each block's extended buffer, filled by the windows' exchange, and its
    six flags (edge flags, first row and column)."""
    exchange = HaloExchange(mesh, halo)
    buffers = exchange.allocate(1, data.dtype)
    exchange.load(buffers, [[block] for block in mesh.split_field_data(data)])
    exchange.copy(exchange.strips(buffers))
    flags = [mesh.edge_flags(b) + list(mesh.block_origin(b)) for b in range(len(mesh))]
    return [bufs[0] for bufs in buffers], flags


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("cut", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(case, cut, k):
    tgrid, jgrid = _grid(tpde, case), _grid(jpde, case)
    bc = CASES[case][2]()
    tbcs, jbcs = tgrid.get_boundary_conditions(bc), jgrid.get_boundary_conditions(bc)
    mesh = GridMesh(tgrid, cut)
    local = mesh.local_shape
    spec = ce.affine_laplace_ext_spec(tgrid, local, a=1.0, b=2e-3, k=k, halo=k, dtype=F64,
                                      bcs=tbcs)
    assert spec.radial is not None and spec.has_sides and spec.grid_rows == tgrid.shape[0]
    jspecs = jax_affine_bc_specs(jgrid, jbcs)
    kernel = jax_affine_laplace_ext_2d(
        local, a=1.0, b=2e-3, k=k, discretization=jgrid.discretization, ext_cols=True,
        dtype=np.float64, bc_specs=jspecs, interpret=True,
        radial=(float(jgrid.axes_bounds[0][0]), float(jgrid.discretization[0])))
    times = _times(k)
    tab = None
    if kernel.has_t:
        ts = jnp.asarray(times)
        tab = jnp.stack([jnp.zeros_like(ts) if f is None else jax.vmap(f)(ts)
                         for f in kernel.t_slots], axis=1)
    sides = cc.AffineSideInputs(tgrid, tbcs).for_pass(F64, "cpu", times, row_pad=cc.SIDE_PAD)
    gen = np.random.default_rng(k + sum(cut))
    for b in range(len(mesh)):
        row0, col0 = mesh.block_origin(b)
        ext = gen.uniform(0.2, 0.8, (local[0] + 2 * k, local[1] + 2 * k))
        extra = []  # pde_tpu's per-block slices of the global side arrays padded by the halo
        for slot in kernel.array_slots:
            arr = np.asarray(jspecs[slot // 2][slot % 2].const_static, dtype=float).reshape(-1)
            padded = np.concatenate([arr[-k:], arr, arr[:k]])
            if slot < 2:
                extra.append(padded[col0:col0 + local[1] + 2 * k].reshape(1, -1))
            else:
                extra.append(padded[row0:row0 + local[0] + 2 * k])
        if tab is not None:
            extra.append(tab)
        expected = np.asarray(kernel(ext, np.asarray(mesh.edge_flags(b) + [row0], np.int32),
                                     *extra))
        got = ce.affine_laplace_ext_2d_plain(torch.tensor(ext), spec,
                                             mesh.edge_flags(b) + [row0, col0], sides)
        np.testing.assert_allclose(got.numpy(), expected, rtol=0,
                                   atol=1e-12 * np.abs(expected).max())


@pytest.mark.parametrize("cut", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("case", CASES)
def test_blocks_replay_the_serial_pass(case, cut):
    """#12's plain version, tile emulation and march replay on every block,
    reading the global radial table and side tables at each block's origin,
    put together, equal #1's radial side-input pass bit for bit at k = 1, 3
    and RADIAL_SIDES_TOP_STEPS under a halo of RADIAL_SIDES_TOP_STEPS."""
    grid = _grid(tpde, case)
    bcs = grid.get_boundary_conditions(CASES[case][2]())
    data = torch.tensor(_data(grid.shape, 1))
    mesh = GridMesh(grid, cut)
    inputs = cc.AffineSideInputs(grid, bcs)
    halo = cc.RADIAL_SIDES_TOP_STEPS
    exts, flags = _blocks(mesh, data, halo)
    for k in sorted({1, 3, halo}, reverse=True):
        times = _times(k)
        serial = cc.affine_laplace_2d_plain(
            data, cc.affine_laplace_spec(grid, a=1.0, b=2e-3, k=k, dtype=F64, bcs=bcs),
            inputs.for_pass(F64, "cpu", times))
        spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=2e-3, k=k, halo=halo,
                                          dtype=F64, bcs=bcs)
        sides = inputs.for_pass(F64, "cpu", times, row_pad=cc.SIDE_PAD)
        for run in (ce.affine_laplace_ext_2d_plain,
                    lambda e, s, f, sd: ce.affine_laplace_ext_2d_tiled(e, s, f, (5, 3), sd),
                    lambda e, s, f, sd: ce.affine_laplace_ext_2d_marched(e, s, f, (7, 5), sd)):
            parts = [run(ext, spec, f, sides) for ext, f in zip(exts, flags, strict=True)]
            torch.testing.assert_close(mesh.combine_field_data(parts), serial, **EXACT)


@pytest.mark.parametrize("cut", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("case", CASES)
def test_decomposed_window_is_the_serial_window(case, cut):
    """37 steps from t0 on the blocks, bit-equal to the serial radial
    side-input window; the ladder tops at RADIAL_SIDES_TOP_STEPS."""
    grid = _grid(tpde, case)
    bcs = grid.get_boundary_conditions(CASES[case][2]())
    mesh = GridMesh(grid, cut)
    window = make_fused_euler_window_sharded(mesh, diffusivity=0.1, dt=DT, dtype=F64, bcs=bcs)
    serial = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=DT, dtype=F64, bcs=bcs)
    top = cc.RADIAL_SIDES_TOP_STEPS
    assert window.sharded and window.needs_t == serial.needs_t
    assert [s.k for s in window.specs] == [s.k for s in serial.specs] == [
        top >> i for i in range(top.bit_length())]
    assert window.exchange.halo == top
    assert all(s.radial is not None and s.has_sides for s in window.specs)
    data = torch.tensor(_data(grid.shape, 2))
    args = (T0, 37) if window.needs_t else (37,)
    got = window([[b] for b in mesh.split_field_data(data)], *args)
    torch.testing.assert_close(mesh.combine_field_data([b[0] for b in got]),
                               serial(data, *args), **EXACT)


@pytest.mark.parametrize("cut", CUTS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("case", CASES)
def test_decomposed_solve_matches_jax_and_serial(case, cut, monkeypatch):
    """DiffusionPDE.solve with decomposition=: fused under the torch engine,
    bit-equal to the port's serial solve, within 1e-12 of pde_tpu's fused
    sharded run in interpret mode."""
    from pde_tpu.solvers import Controller, EulerSolver

    bc = CASES[case][2]()
    data = _data(_grid(tpde, case).shape, 3)
    state = tpde.ScalarField(_grid(tpde, case), data, dtype=F64)
    eq = tpde.DiffusionPDE(0.1, bc=bc)
    t_range = [T0, T0 + 13 * DT]
    got, info = eq.solve(state, t_range=t_range, dt=DT, tracker=None, decomposition=cut,
                         ret_info=True)
    assert info["solver"].get("fused_step") is True
    assert "fused_unsupported" not in info["solver"] and "sharded_halo" not in info["solver"]
    serial = eq.solve(state, t_range=t_range, dt=DT, tracker=None)
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PDE_TPU_DISABLE_FUSED", raising=False)
    jsolver = EulerSolver(jpde.DiffusionPDE(0.1, bc=bc), decomposition=cut)
    expected = Controller(jsolver, t_range=t_range, tracker=None).run(
        jpde.ScalarField(_grid(jpde, case), data), DT)
    assert jsolver.info.get("fused_step")
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)


@pytest.mark.parametrize("cut", [[2, 1], [2, 2]], ids=["2x1", "2x2"])
def test_twelve_row_blocks_match_jax_serial(cut, monkeypatch):
    """On a 24-row cylinder cut into 12-row blocks, where pde_tpu's fused
    sharded run differs from its own serial run (by 3.9e-4 in a probe, scalar
    sides too), the port's decomposed run equals its serial run bit for bit and
    pde_tpu's serial fused run within 1e-12."""
    bc = {"r": {"derivative": 0}, "z-": {"value": np.linspace(0.0, 1.0, 24)},
          "z+": {"derivative_expression": "cos(t)"}}
    data = _data((24, 16), 6)
    state = tpde.ScalarField(tpde.CylindricalSymGrid(2.0, (0, 3), (24, 16)), data, dtype=F64)
    t_range = [T0, T0 + 13 * DT]
    eq = tpde.DiffusionPDE(0.1, bc=bc)
    got, info = eq.solve(state, t_range=t_range, dt=DT, tracker=None, decomposition=cut,
                         ret_info=True)
    assert info["solver"].get("fused_step") is True
    np.testing.assert_array_equal(
        got.data.numpy(), eq.solve(state, t_range=t_range, dt=DT, tracker=None).data.numpy())
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PDE_TPU_DISABLE_FUSED", raising=False)
    from pde_tpu.solvers import EulerSolver

    jfield = jpde.ScalarField(jpde.CylindricalSymGrid(2.0, (0, 3), (24, 16)), data)
    jsolver = EulerSolver(jpde.DiffusionPDE(0.1, bc=bc))
    expected, _ = jsolver.make_stepper(jfield, DT)(jfield, *t_range)
    assert jsolver.info.get("fused_step") is True
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)


def test_window_flags_and_what_stays_refused():
    """Every pass launches once a device with six flags a block, its first
    row serving both tables; a window of per-point consts only takes
    (blocks, steps); a time-dependent ghost factor stays refused on a mesh,
    as in pde_tpu (pde_tpu/parallel/fused.py:127-146), and the run takes
    the plain sharded stepper, bit-equal to the serial plain run."""
    import pde_tpu_torch.parallel.fused as fused

    case = "hole, an array on r-, arrays and t on z"
    grid = _grid(tpde, case)
    bcs = grid.get_boundary_conditions(CASES[case][2]())
    mesh = GridMesh(grid, [2, 2])
    seen = []
    original = ce.affine_laplace_ext_2d

    def spy(ins, outs, flags, spec, **kwargs):
        seen.append(([tuple(f) for f in flags], spec.k, kwargs["sides"].t))
        return original(ins, outs, flags, spec, **kwargs)

    try:
        fused.affine_laplace_ext_2d = spy
        window = make_fused_euler_window_sharded(mesh, diffusivity=0.1, dt=DT, dtype=F64,
                                                 bcs=bcs)
        window([[b] for b in mesh.split_field_data(torch.zeros(grid.shape, dtype=F64))], T0, 13)
    finally:
        fused.affine_laplace_ext_2d = original
    top = cc.RADIAL_SIDES_TOP_STEPS
    ladder = [top >> i for i in range(top.bit_length())]
    ks, rest = [], 13
    for k in ladder:
        ks += [k] * (rest // k)
        rest %= k
    assert [k for _, k, _ in seen] == ks
    assert seen[0][0] == [(int(r == 0), int(r == 1), int(c == 0), int(c == 1), 8 * r, 12 * c)
                          for r in range(2) for c in range(2)]
    # z+ is value t: its ghost const is 2t, the last pass at step 12
    assert [row[3] for row in seen[-1][2]] == [pytest.approx(2 * (T0 + 12 * DT))]
    arrays = {"r-": {"value": np.linspace(0.0, 1.0, 24)}, "r+": {"derivative": 0},
              "z": {"value": "r"}}
    window = make_fused_euler_window_sharded(mesh, diffusivity=0.1, dt=DT, dtype=F64,
                                             bcs=grid.get_boundary_conditions(arrays))
    assert not window.needs_t and window.specs[0].has_sides
    factor = {"r-": {"derivative": 0}, "r+": {"mixed_expression": "1 + t", "const": 0.1},
              "z": {"value": 0}}
    with pytest.raises(tpde.KernelUnsupportedError, match="kernel #7"):
        make_fused_euler_window_sharded(mesh, diffusivity=0.1, dt=DT, dtype=F64,
                                        bcs=grid.get_boundary_conditions(factor))
    state = tpde.ScalarField(grid, _data(grid.shape, 4), dtype=F64)
    got, info = tpde.DiffusionPDE(0.1, bc=factor).solve(
        state, t_range=[T0, T0 + 5 * DT], dt=DT, tracker=None, decomposition=[2, 2],
        ret_info=True)
    assert "fused_step" not in info["solver"] and info["solver"]["sharded_halo"]
    assert "cylindrical" in info["solver"]["fused_unsupported"]
    serial = tpde.DiffusionPDE(0.1, bc=factor).solve(state, t_range=[T0, T0 + 5 * DT], dt=DT,
                                                     tracker=None, backend="numpy")
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())


def test_wrapper_checks_and_entry_points():
    """The wrapper on CPU buffers writes the plain version into the interiors
    and counts no launch; it refuses five flags, missing side inputs and
    tables the row sides' padding does not match; the library's entry
    points take the radial table, then the side tables."""
    case = "r = 0, bounded z, an array on z-, t on z+"
    grid = _grid(tpde, case)
    bcs = grid.get_boundary_conditions(CASES[case][2]())
    mesh = GridMesh(grid, [2, 2])
    spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=2e-3, k=3, halo=4,
                                      dtype=F64, bcs=bcs)
    exts, flags = _blocks(mesh, torch.tensor(_data(grid.shape, 5)), 4)
    outs = [torch.full_like(x, 7.0) for x in exts]
    inputs = cc.AffineSideInputs(grid, bcs)
    sides = inputs.for_pass(F64, "cpu", _times(3), row_pad=cc.SIDE_PAD)
    launches = (ce.affine_laplace_ext_2d.launches, ce.affine_laplace_ext_2d.radial_sides_launches)
    ce.affine_laplace_ext_2d(exts, outs, flags, spec, sides=sides)
    assert (ce.affine_laplace_ext_2d.launches,
            ce.affine_laplace_ext_2d.radial_sides_launches) == launches
    for ext, out, f in zip(exts, outs, flags, strict=True):
        torch.testing.assert_close(out[4:-4, 4:-4],
                                   ce.affine_laplace_ext_2d_plain(ext, spec, f, sides), **EXACT)
    with pytest.raises(ValueError, match="6 ints"):
        ce.affine_laplace_ext_2d(exts, outs, [f[:5] for f in flags], spec, sides=sides)
    with pytest.raises(ValueError, match="give them"):
        ce.affine_laplace_ext_2d(exts, outs, flags, spec)
    with pytest.raises(ValueError, match="padded"):
        ce.affine_laplace_ext_2d(exts, outs, flags, spec,
                                 sides=inputs.for_pass(F64, "cpu", _times(3)))
    deep = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=2e-3,
                                      k=cc.RADIAL_SIDES_TOP_STEPS + 1, halo=8, dtype=F64,
                                      bcs=bcs)  # the deep march's library (C18)
    assert deep.deep and ce.affine_ext_source(deep.periodic, radial=True, sides=True,
                                              deep=True).library == "affine_laplace_deep_" \
        "radial_sides_ext_2d"
    unit = ce.affine_ext_source(spec.periodic, radial=True, sides=True)
    assert unit.library == cc.RADIAL_SIDES_EXT_LIBRARY and unit.radial
    top = cc.RADIAL_SIDES_TOP_STEPS
    plan = ", ".join(map(str, cc.affine_row_plan(top, 4)))
    assert (f"case {top}: return pde_tpu_torch::launch_affine_radial_sides_ext_2d<float, {top}, "
            f"{plan}, false>(ins, outs, edges, n_blocks, rows, arrays, ints, doubles, stream);"
            in unit.source)
    assert f"case {top + 1}: " not in unit.source
    assert unit.digest not in {ce.affine_ext_source(spec.periodic, radial=True).digest,
                               ce.affine_ext_source(spec.periodic, sides=True).digest}
