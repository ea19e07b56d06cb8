"""The module holding the 3D affine ext kernel (TPU kernel #11): its plain
version against ``pde_tpu``'s ``make_affine_laplace_ext_3d`` (every axis
extended) in interpret mode on the same extended block and edge flags, fp64,
at 1e-12; the tile emulation against the plain version at tiles that cut the
block several times; the generated entry points; the wrapper on the CPU; and
the gate."""

import functools

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import affine_bc_params as jax_affine_bc_params
from pde_tpu.ops.pallas_cartesian import make_affine_laplace_ext_3d as jax_affine_laplace_ext_3d
from pde_tpu_torch.ops import cuda_cartesian_3d as c3
from pde_tpu_torch.ops import cuda_ext_3d as e3

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
LOCAL = (6, 5, 7)
FLAG_SETS = [
    [0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0], [0, 1, 0, 1, 0, 1], [1, 0, 1, 0, 1, 0],
    [1, 1, 1, 1, 1, 1], [0, 0, 1, 1, 0, 0],
]
# Dirichlet, Neumann, Robin and curvature faces on an anisotropic grid
MIXED_BC = {
    "x-": {"value": 1.0}, "x+": {"derivative": 0.3},
    "y-": {"type": "mixed", "value": 2.0, "const": 0.5}, "y+": {"curvature": 1.0},
    "z": {"value": -0.5},
}
GRIDS = {
    "mixed anisotropic": (([(0, 1), (0, 2), (0, 3)], [12, 10, 14]), {}, MIXED_BC),
    "neumann isotropic": (([(0, 2), (0, 2), (0, 2)], [12, 10, 14]), {}, {"derivative": 0.2}),
    "periodic y": (([(0, 1), (0, 2), (0, 3)], [12, 10, 14]), {"periodic": [False, True, False]},
                   {"x": {"value": 0.5}, "y": "periodic", "z": {"derivative": -1.0}}),
    "periodic": (([(0, 1), (0, 2), (0, 3)], [12, 10, 14]), {"periodic": True}, None),
}
B = 1e-3


def _grids(case):
    args, kwargs, bc = GRIDS[case]
    jgrid, tgrid = jpde.CartesianGrid(*args, **kwargs), tpde.CartesianGrid(*args, **kwargs)
    jbcs = None if bc is None else jgrid.get_boundary_conditions(bc)
    tbcs = None if bc is None else tgrid.get_boundary_conditions(bc)
    return jgrid, jbcs, tgrid, tbcs


def _spec(case, k, halo=None, local=LOCAL):
    _, _, tgrid, tbcs = _grids(case)
    return e3.affine_laplace_ext_3d_spec(
        tgrid, local, a=1.0, b=B, k=k, halo=k if halo is None else halo, dtype=torch.float64,
        bcs=tbcs,
    )


@functools.cache
def _jax_kernel(case, k):
    jgrid, jbcs, _, _ = _grids(case)
    return jax_affine_laplace_ext_3d(
        LOCAL, a=1.0, b=B, k=k, discretization=jgrid.discretization, ext_axes=(True,) * 3,
        dtype=np.float64, bc_params=None if jbcs is None else jax_affine_bc_params(jgrid, jbcs),
        interpret=True,
    )


def _ext_block(halo, seed, local=LOCAL):
    return np.random.default_rng(seed).random(tuple(n + 2 * halo for n in local))


def _masked(flags, periodic):
    """The flags of a block of that grid: none on a periodic axis."""
    return [int(f and not periodic[i // 2]) for i, f in enumerate(flags)]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_matches_jax_mixed_faces(k, flags):
    spec = _spec("mixed anisotropic", k)
    ext = _ext_block(k, seed=10 * k + sum(flags))
    expected = _jax_kernel("mixed anisotropic", k)(ext, np.asarray(flags, dtype=np.int32))
    launches = e3.affine_laplace_ext_3d.launches
    got = e3.affine_laplace_ext_3d_plain(torch.tensor(ext), spec, flags)
    assert e3.affine_laplace_ext_3d.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("flags", [[1, 1, 0, 1, 1, 0], [0, 1, 1, 0, 0, 1]],
                         ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("case", ["neumann isotropic", "periodic y", "periodic"])
@pytest.mark.parametrize("k", [1, 2])
def test_plain_matches_jax_other_grids(k, case, flags):
    spec = _spec(case, k)
    flags = _masked(flags, spec.periodic)
    ext = _ext_block(k, seed=7 + k)
    expected = _jax_kernel(case, k)(ext, np.asarray(flags, dtype=np.int32))
    got = e3.affine_laplace_ext_3d_plain(torch.tensor(ext), spec, flags)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_self_wrapped_block_matches_the_serial_kernel():
    """One periodic block whose halo is its own wrap is the serial kernel's
    pass on that block, bit for bit (the same arithmetic)."""
    _, _, tgrid, _ = _grids("periodic")
    data = torch.tensor(np.random.default_rng(3).random((12, 10, 14)))
    for k in range(1, c3.MAX_STEPS + 1):
        serial = c3.affine_laplace_3d_spec(tgrid, a=1.0, b=B, k=k, dtype=torch.float64)
        spec = _spec("periodic", k, halo=c3.MAX_STEPS, local=(12, 10, 14))
        ext = torch.tensor(np.pad(data.numpy(), c3.MAX_STEPS, mode="wrap"))
        got = e3.affine_laplace_ext_3d_plain(ext, spec, [0] * 6)
        torch.testing.assert_close(got, c3.affine_laplace_3d_plain(data, serial), rtol=0, atol=0)


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("k, halo, tile", [
    (1, 1, (2, 2, 3)), (2, 3, (4, 2, 3)), (3, 3, (3, 4, 2)), (2, 4, (6, 5, 7)), (4, 4, (5, 3, 4)),
])
def test_tile_emulation_matches_plain(k, halo, tile, flags):
    """Tiles that cut the block several times, ragged against it and equal to
    it; a halo wider than k reads the window at offset halo - k; cells past
    the buffer load as zero."""
    spec = _spec("mixed anisotropic", k, halo)
    ext = torch.tensor(_ext_block(halo, seed=k + halo))
    plain = e3.affine_laplace_ext_3d_plain(ext, spec, flags)
    tiled = e3.affine_laplace_ext_3d_tiled(ext, spec, flags, tile=tile)
    torch.testing.assert_close(tiled, plain, rtol=0, atol=0)


def test_tile_emulation_at_the_kernels_tile():
    """The kernel's plan cuts the block along every axis (ragged)."""
    spec = _spec("mixed anisotropic", 2, local=(40, 36, 70))
    assert spec.tile == (32, 32, 64)  # fp64 at k = 2: the serial kernel's plan
    ext = torch.tensor(_ext_block(2, seed=4, local=(40, 36, 70)))
    flags = [1, 0, 0, 1, 1, 1]
    torch.testing.assert_close(
        e3.affine_laplace_ext_3d_tiled(ext, spec, flags),
        e3.affine_laplace_ext_3d_plain(ext, spec, flags), rtol=0, atol=0)


def test_wrapper_writes_interiors_on_the_cpu():
    spec = _spec("mixed anisotropic", 2, 3)
    exts = [torch.tensor(_ext_block(3, seed=s)) for s in range(3)]
    outs = [torch.full_like(x, 7.0) for x in exts]
    flags = [[1, 0, 1, 0, 1, 0], [0, 1, 0, 1, 0, 1], [0, 0, 0, 0, 0, 0]]
    launches = e3.affine_laplace_ext_3d.launches
    assert e3.affine_laplace_ext_3d(exts, outs, flags, spec) == outs
    assert e3.affine_laplace_ext_3d.launches == launches
    interior = (slice(3, 9), slice(3, 8), slice(3, 10))
    for ext, out, f in zip(exts, outs, flags):
        torch.testing.assert_close(out[interior], e3.affine_laplace_ext_3d_plain(ext, spec, f))
        out[interior] = 7.0
        assert bool((out == 7.0).all())  # the halo shell is left as it was
    with pytest.raises(ValueError, match="six edge flags|6 edge flags"):
        e3.affine_laplace_ext_3d(exts, outs, [[0] * 4] * 3, spec)
    with pytest.raises(ValueError, match="buffers"):
        e3.affine_laplace_ext_3d([x.float() for x in exts], outs, flags, spec)
    meta = [torch.zeros_like(x, device="meta") for x in exts]
    with pytest.raises(RuntimeError, match="No 3D affine ext kernel"):
        e3.affine_laplace_ext_3d(meta, [torch.zeros_like(x) for x in meta], flags, spec)


def test_generated_entry_points():
    source = e3.affine_ext_source((True, False, True)).source
    assert '#include "affine_laplace_ext_3d.cuh"' in source
    for k in range(1, c3.MAX_STEPS + 1):
        cx, ty, tz = c3.march_plan_3d(k, 4)
        assert (f"case {k}: return pde_tpu_torch::launch_affine_ext_3d<float, {k}, {cx}, {ty}, "
                f"{tz}, true, false, true>") in source
    assert e3.affine_ext_source((True,) * 3).digest != e3.affine_ext_source((False,) * 3).digest


def test_gate():
    _, _, grid, bcs = _grids("mixed anisotropic")
    with pytest.raises(tpde.KernelUnsupportedError, match="Shard too small"):
        e3.affine_laplace_ext_3d_spec(grid, (2, 5, 7), a=1, b=1, k=3, halo=3,
                                      dtype=torch.float64, bcs=bcs)
    with pytest.raises(tpde.KernelUnsupportedError, match="halo"):
        e3.affine_laplace_ext_3d_spec(grid, LOCAL, a=1, b=1, k=3, halo=2,
                                      dtype=torch.float64, bcs=bcs)
    with pytest.raises(tpde.KernelUnsupportedError, match="1 <= k <= 4"):
        e3.affine_laplace_ext_3d_spec(grid, LOCAL, a=1, b=1, k=5, halo=5,
                                      dtype=torch.float64, bcs=bcs)
    with pytest.raises(tpde.KernelUnsupportedError, match="float32 or float64"):
        e3.affine_laplace_ext_3d_spec(grid, LOCAL, a=1, b=1, k=1, halo=1,
                                      dtype=torch.bfloat16, bcs=bcs)
    with pytest.raises(tpde.KernelUnsupportedError, match="3D CartesianGrid"):
        e3.affine_laplace_ext_3d_spec(tpde.UnitGrid([8, 8], periodic=True), (4, 4), a=1, b=1,
                                      k=1, halo=1, dtype=torch.float64)
    # more (block, x chunk) pairs than a CUDA grid's z extent holds
    assert -(-300000 // c3.march_plan_3d(1, 8)[0]) * e3.MAX_BLOCKS > 65535
    with pytest.raises(tpde.KernelUnsupportedError, match="tiles"):
        e3.affine_laplace_ext_3d_spec(tpde.UnitGrid([600000, 4, 4], periodic=True),
                                      (300000, 4, 4), a=1, b=1, k=1, halo=1, dtype=torch.float64)
    array_bcs = grid.get_boundary_conditions(
        {"x": {"value": np.linspace(0, 1, 140).reshape(10, 14)}, "y": {"derivative": 0},
         "z": {"derivative": 0}})
    with pytest.raises(tpde.KernelUnsupportedError, match="B1\\(c\\)"):
        e3.affine_laplace_ext_3d_spec(grid, LOCAL, a=1, b=1, k=1, halo=1,
                                      dtype=torch.float64, bcs=array_bcs)
    # a periodic axis has no global face: a flag there is refused
    spec = _spec("periodic y", 1)
    with pytest.raises(ValueError, match="periodic axis 1"):
        e3.affine_laplace_ext_3d_plain(torch.tensor(_ext_block(1, 0)), spec, [0, 0, 1, 0, 0, 0])
