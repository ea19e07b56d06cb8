"""Kernel #12's radial mode (the affine ext kernel on the blocks of a
decomposed ``CylindricalSymGrid``) and the decomposed cylindrical diffusion
window, on the CPU, fp64.

- The plain version against ``pde_tpu``'s ``make_affine_laplace_ext_2d(
  radial=...)`` in interpret mode on the same extended blocks and flags, the
  fifth flag the block's first row in the grid, on the meshes of
  ``tests/ops/test_pallas_kernels.py``'s ``test_fused_cylindrical_sharded``
  (z cut, r cut, r and z with Dirichlet z, four r blocks), at 1e-12.
- The tile emulation and the march replay over every block of [2, 2], [4, 1]
  and [1, 4] against the serial radial pass, bit for bit (the replay's
  registers and shared rows start as NaN, so a race poisons the result).
- The gates (k above the radial ladder, other grid classes, five flags, the
  cylindrical multi-field window refused with ``pde_tpu``'s message), the
  entry points of the radial ext library, and the engines: under ``cuda`` a
  decomposed configuration without a kernel raises, under ``torch`` it takes
  the plain sharded stepper.
- The decomposed cylindrical diffusion solve under ``torch`` against
  ``pde_tpu``'s fused sharded run in interpret mode at 1e-12, and against the
  port's serial window bit for bit.
"""

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

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
EXACT = dict(rtol=0, atol=0)
F64 = torch.float64
# pde_tpu's meshes (tests/ops/test_pallas_kernels.py:618-650) on a smaller grid:
# id -> (decomposition, periodic z)
MESHES = {
    "z-cut": ([1, 2], True),
    "r-cut": ([2, 1], True),
    "r+z-dirichlet": ([2, 2], False),
    "r4": ([4, 1], False),
}
BC_PERIODIC = {"r": {"derivative": 0}, "z": "periodic"}
BC_BOUNDED = {"r-": {"derivative": 0}, "r+": {"type": "mixed", "value": 2.0, "const": 0.5},
              "z": {"value": 0.5}}


def _grid(pkg, periodic_z, shape=(16, 24), radius=1.0):
    return pkg.CylindricalSymGrid(radius, (0, 2), shape, periodic_z=periodic_z)


def _flags(mesh, b):
    return mesh.edge_flags(b) + [mesh.block_origin(b)[0]]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mesh_id", MESHES)
def test_plain_matches_jax(mesh_id, k):
    decomposition, periodic_z = MESHES[mesh_id]
    bc = BC_PERIODIC if periodic_z else BC_BOUNDED
    tgrid, jgrid = _grid(tpde, periodic_z), _grid(jpde, periodic_z)
    tbcs, jbcs = tgrid.get_boundary_conditions(bc), jgrid.get_boundary_conditions(bc)
    mesh = GridMesh(tgrid, decomposition)
    local = mesh.local_shape
    spec = ce.affine_laplace_ext_spec(tgrid, local, a=1.0, b=2e-4, k=k, halo=k, dtype=F64,
                                      bcs=tbcs)
    assert spec.radial == (0.0, tgrid.discretization[0]) and spec.grid_rows == 16
    kernel = jax_affine_laplace_ext_2d(
        local, a=1.0, b=2e-4, k=k, discretization=jgrid.discretization, ext_cols=True,
        dtype=np.float64, bc_specs=jax_affine_bc_specs(jgrid, jbcs), interpret=True,
        radial=(float(jgrid.axes_bounds[0][0]), float(jgrid.discretization[0])))
    gen = np.random.default_rng(k + len(mesh_id))
    for b in range(len(mesh)):
        flags = _flags(mesh, b)
        ext = gen.random((local[0] + 2 * k, local[1] + 2 * k))
        expected = kernel(ext, np.asarray(flags, dtype=np.int32))
        got = ce.affine_laplace_ext_2d_plain(torch.tensor(ext), spec, flags)
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def _blocks(data, mesh, halo):
    """Each block's extended buffer, filled by the ext windows' exchange."""
    exchange = HaloExchange(mesh, halo)
    buffers = exchange.allocate(1, data.dtype)
    exchange.load(buffers, [[block] for block in mesh.split_field_data(data)])
    exchange.copy(exchange.strips(buffers))
    return [bufs[0] for bufs in buffers]


@pytest.mark.parametrize("periodic_z", [True, False], ids=["z-periodic", "z-bounded"])
@pytest.mark.parametrize("cut", [[2, 2], [4, 1], [1, 4]], ids=lambda c: "x".join(map(str, c)))
def test_blocks_replay_the_serial_radial_pass(cut, periodic_z):
    """The blocks' march replays and tile emulations put together equal the
    serial radial pass bit for bit at each k (each side flag set on some
    blocks and clear on others; a halo deeper than k read at offset halo - k)."""
    grid = _grid(tpde, periodic_z, shape=(24, 20), radius=(0.5, 2.0))
    bcs = grid.get_boundary_conditions(BC_PERIODIC if periodic_z else BC_BOUNDED)
    mesh = GridMesh(grid, cut)
    data = torch.as_tensor(np.random.default_rng(sum(cut)).uniform(size=grid.shape))
    halo = min(5, *mesh.local_shape)
    exts = _blocks(data, mesh, halo)
    for k in sorted({1, 2, halo}):
        spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=2e-4, k=k, halo=halo,
                                          dtype=F64, bcs=bcs)
        serial = cc.affine_laplace_2d_plain(
            data, cc.affine_laplace_spec(grid, a=1.0, b=2e-4, k=k, dtype=F64, bcs=bcs))
        for method in ("marched", "tiled", "plain"):
            parts = []
            for b, ext in enumerate(exts):
                if method == "marched":
                    parts.append(ce.affine_laplace_ext_2d_marched(ext, spec, _flags(mesh, b),
                                                                  plan=(7, 4)))
                elif method == "tiled":
                    parts.append(ce.affine_laplace_ext_2d_tiled(ext, spec, _flags(mesh, b),
                                                                tile=(7, 4)))
                else:
                    parts.append(ce.affine_laplace_ext_2d_plain(ext, spec, _flags(mesh, b)))
            torch.testing.assert_close(mesh.combine_field_data(parts), serial, **EXACT)


def test_wrapper_writes_interiors_on_the_cpu():
    grid = _grid(tpde, False)
    mesh = GridMesh(grid, [2, 2])
    spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=2e-4, k=3, halo=4,
                                      dtype=F64, bcs=grid.get_boundary_conditions(BC_BOUNDED))
    exts = _blocks(torch.as_tensor(np.random.default_rng(2).uniform(size=grid.shape)), mesh, 4)
    outs = [torch.full_like(x, 7.0) for x in exts]
    flags = [_flags(mesh, b) for b in range(4)]
    launches = ce.affine_laplace_ext_2d.launches
    ce.affine_laplace_ext_2d(exts, outs, flags, spec)
    assert ce.affine_laplace_ext_2d.launches == launches
    for ext, out, f in zip(exts, outs, flags):
        torch.testing.assert_close(out[4:12, 4:16], ce.affine_laplace_ext_2d_plain(ext, spec, f),
                                   **EXACT)
        out[4:12, 4:16] = 7.0
        assert bool((out == 7.0).all())  # the halo ring is left as it was


def test_entry_points_and_gates():
    grid = _grid(tpde, False)
    bcs = grid.get_boundary_conditions(BC_BOUNDED)
    unit = ce.affine_ext_source((False, False), radial=True)
    assert unit.library == cc.RADIAL_EXT_LIBRARY and unit.radial
    for k in range(1, cc.RADIAL_TOP_STEPS + 1):
        plan = ", ".join(map(str, cc.affine_row_plan(k, 8)))
        assert (f"case {k}: return pde_tpu_torch::launch_affine_radial_ext_2d<double, {k}, "
                f"{plan}, false>(ins, outs, edges, n_blocks, rows, ints, doubles, stream);"
                in unit.source)
    assert f"case {cc.RADIAL_TOP_STEPS + 1}: " not in unit.source
    assert "switch (ints[5])" in unit.source
    cartesian = ce.affine_ext_source((False, False))
    assert "radial" not in cartesian.source and "rows" not in cartesian.source
    assert unit.digest != cartesian.digest
    spec = ce.affine_laplace_ext_spec(grid, (8, 12), a=1.0, b=0.1, k=2, halo=2, dtype=F64,
                                      bcs=bcs)
    assert len(cc.step_doubles(spec)) == 18
    ext = torch.zeros((12, 16), dtype=F64)
    with pytest.raises(ValueError, match="5 ints"):
        ce.affine_laplace_ext_2d_plain(ext, spec, [1, 0, 1, 0])
    with pytest.raises(ValueError, match="does not lie in the grid"):
        ce.affine_laplace_ext_2d_plain(ext, spec, [1, 0, 1, 0, 9])
    # deeper passes take the deep march's radial ext library (C18)
    assert ce.affine_laplace_ext_spec(grid, (16, 12), a=1.0, b=0.1, k=cc.RADIAL_TOP_STEPS + 1,
                                      halo=cc.RADIAL_TOP_STEPS + 1, dtype=F64, bcs=bcs).deep
    with pytest.raises(tpde.KernelUnsupportedError, match="1 <= k <= 16"):
        ce.affine_laplace_ext_spec(grid, (8, 12), a=1.0, b=0.1, k=cc.EXT_MAX_STEPS + 1,
                                   halo=10, dtype=F64, bcs=bcs)
    polar = tpde.PolarSymGrid(1.0, 16)
    with pytest.raises(tpde.KernelUnsupportedError, match="CylindricalSymGrid"):
        ce.affine_laplace_ext_spec(polar, (8,), a=1.0, b=0.1, k=1, halo=1, dtype=F64,
                                   bcs=polar.get_boundary_conditions("auto_periodic_neumann"))


def _window_case(pkg, mesh_id, seed=0, shape=None):
    decomposition, periodic_z = MESHES[mesh_id]
    shape = shape or ((16, 64) if mesh_id == "z-cut" else (32, 32))
    grid = _grid(pkg, periodic_z, shape=shape)
    data = np.random.default_rng(seed).uniform(size=grid.shape)
    field = pkg.ScalarField(grid, data, **({"dtype": F64} if pkg is tpde else {}))
    bc = {"r": {"derivative": 0}, "z": "periodic" if periodic_z else {"value": 0}}
    return field, pkg.DiffusionPDE(0.1, bc=bc), decomposition


@pytest.mark.parametrize("mesh_id", MESHES)
def test_decomposed_window_matches_jax_and_serial(mesh_id, monkeypatch):
    """pde_tpu's test_fused_cylindrical_sharded against the port: the
    decomposed window (plain versions of #12's radial mode on the CPU) equals
    the serial window bit for bit and pde_tpu's fused sharded run at 1e-12."""
    from pde_tpu.solvers import Controller, EulerSolver

    state, eq, decomposition = _window_case(tpde, mesh_id)
    got, info = eq.solve(state, t_range=2e-3, dt=5e-5, tracker=None,
                         decomposition=decomposition, ret_info=True)
    assert info["solver"]["fused_step"] is True and "sharded_halo" not in info["solver"]
    assert info["solver"]["decomposition"] == decomposition
    serial, serial_info = eq.solve(state, t_range=2e-3, dt=5e-5, tracker=None, ret_info=True)
    assert serial_info["solver"]["fused_step"] is True
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jfield, jeq, _ = _window_case(jpde, mesh_id)
    jsolver = EulerSolver(jeq, decomposition=decomposition)
    expected = Controller(jsolver, t_range=2e-3, tracker=None).run(jfield, 5e-5)
    assert jsolver.info.get("fused_step")
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)


def test_window_ladder_and_flags():
    """The window's passes: the radial ladder [8, 4, 2, 1] at halo 8, cut
    where the blocks are smaller; one launch per pass a device; each block's
    flags carry its first row."""
    from pde_tpu_torch.parallel.fused import make_fused_euler_window_sharded

    grid = _grid(tpde, False, shape=(32, 40))
    bcs = grid.get_boundary_conditions(BC_BOUNDED)
    window = make_fused_euler_window_sharded(GridMesh(grid, [2, 2]), diffusivity=0.1, dt=1e-4,
                                             dtype=F64, bcs=bcs)
    assert [s.k for s in window.specs] == [8, 4, 2, 1] and window.specs[0].halo == 8
    assert all(s.radial is not None and s.grid_rows == 32 for s in window.specs)
    small = make_fused_euler_window_sharded(GridMesh(grid, [8, 1]), diffusivity=0.1, dt=1e-4,
                                            dtype=F64, bcs=bcs)
    assert [s.k for s in small.specs] == [4, 2, 1]
    seen = []
    original = ce.affine_laplace_ext_2d

    def spy(ins, outs, flags, spec):
        seen.append([tuple(f) for f in flags])
        return original(ins, outs, flags, spec)

    mesh = GridMesh(grid, [4, 2])
    import pde_tpu_torch.parallel.fused as fused

    try:
        fused.affine_laplace_ext_2d = spy
        window = make_fused_euler_window_sharded(mesh, diffusivity=0.1, dt=1e-4, dtype=F64,
                                                 bcs=bcs)
        blocks = [[b] for b in mesh.split_field_data(torch.zeros(grid.shape, dtype=F64))]
        window(blocks, 13)
    finally:
        fused.affine_laplace_ext_2d = original
    assert len(seen) == 3  # 13 = 8 + 4 + 1, one launch a pass on one device
    assert seen[0] == [(int(r == 0), int(r == 3), int(c == 0), int(c == 1), 8 * r)
                       for r in range(4) for c in range(2)]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_configurations_without_a_kernel(backend):
    """On a mesh, as in pde_tpu: cylindrical Cahn-Hilliard (#8 has no radial
    helpers) and polar and spherical diffusion have no window; under `torch`
    they take the plain sharded stepper, under `cuda` they raise."""
    cyl = tpde.ScalarField(_grid(tpde, False),
                           np.random.default_rng(1).uniform(-0.1, 0.1, (16, 24)), dtype=F64)
    cases = [
        (tpde.CahnHilliardPDE(bc_c={"derivative": 0}, bc_mu={"derivative": 0}), cyl, [2, 2],
         "do not support cylindrical grids"),
        (tpde.PDE({"c": "laplace(c) - c**3"}, bc={"derivative": 0}), cyl, [2, 2],
         "do not support cylindrical grids"),
        (tpde.DiffusionPDE(0.1), tpde.ScalarField(tpde.PolarSymGrid(1.0, 16), 1.0, dtype=F64), [4],
         "polar and spherical"),
        (tpde.DiffusionPDE(0.1), tpde.ScalarField(tpde.SphericalSymGrid(1.0, 16), 1.0, dtype=F64),
         [2], "polar and spherical"),
    ]
    for eq, state, decomposition, reason in cases:
        if backend == "cuda":
            with pytest.raises(RuntimeError, match=reason):
                eq.solve(state, t_range=1e-4, dt=1e-5, tracker=None, backend="cuda",
                         decomposition=decomposition)
            continue
        got, info = eq.solve(state, t_range=1e-4, dt=1e-5, tracker=None,
                             decomposition=decomposition, ret_info=True)
        assert reason in info["solver"]["fused_unsupported"] and info["solver"]["sharded_halo"]
        serial = eq.solve(state, t_range=1e-4, dt=1e-5, tracker=None, backend="numpy")
        np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
