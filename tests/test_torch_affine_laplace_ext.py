"""The module holding the affine ext kernel (TPU kernel #12): its plain
version against ``pde_tpu``'s ``make_affine_laplace_ext_2d`` in interpret
mode on the same extended block and edge flags, fp64, at 1e-12; the tile
emulation against the plain version; and the gate."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import affine_bc_specs as jax_affine_bc_specs
from pde_tpu.ops.pallas_cartesian import make_affine_laplace_ext_2d as jax_affine_laplace_ext_2d
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_ext_2d as ce

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
LOCAL = (8, 12)
FLAG_SETS = [[0, 0, 0, 0], [1, 0, 0, 0], [0, 1, 0, 1], [1, 1, 1, 1]]
# Dirichlet, Neumann, Robin and curvature sides on an anisotropic grid
MIXED_BC = {
    "x-": {"value": 1.0}, "x+": {"derivative": 0.3},
    "y-": {"type": "mixed", "value": 2.0, "const": 0.5}, "y+": {"curvature": 1.0},
}
GRIDS = {
    "mixed anisotropic": (([(0, 1), (0, 3)], [16, 24]), {}, MIXED_BC),
    "dirichlet isotropic": (([(0, 2), (0, 3)], [16, 24]), {}, {"value": -0.5}),
    "periodic": (([(0, 2), (0, 3)], [16, 24]), {"periodic": True}, None),
}


def _specs(case, k, halo=None):
    args, kwargs, bc = GRIDS[case]
    jgrid, tgrid = jpde.CartesianGrid(*args, **kwargs), tpde.CartesianGrid(*args, **kwargs)
    jbcs = None if bc is None else jgrid.get_boundary_conditions(bc)
    tbcs = None if bc is None else tgrid.get_boundary_conditions(bc)
    spec = ce.affine_laplace_ext_spec(
        tgrid, LOCAL, a=1.0, b=1e-3, k=k, halo=k if halo is None else halo,
        dtype=torch.float64, bcs=tbcs,
    )
    return jgrid, jbcs, spec


def _ext_block(k, seed):
    n, m = LOCAL
    return np.random.default_rng(seed).random((n + 2 * k, m + 2 * k))


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_plain_matches_jax_mixed_bcs(k, flags):
    jgrid, jbcs, spec = _specs("mixed anisotropic", k)
    ext = _ext_block(k, seed=10 * k + sum(flags))
    kernel = jax_affine_laplace_ext_2d(
        LOCAL, a=1.0, b=1e-3, k=k, discretization=jgrid.discretization, ext_cols=True,
        dtype=np.float64, bc_specs=jax_affine_bc_specs(jgrid, jbcs), interpret=True,
    )
    expected = kernel(ext, np.asarray(flags + [0], dtype=np.int32))
    launches = ce.affine_laplace_ext_2d.launches
    got = ce.affine_laplace_ext_2d_plain(torch.tensor(ext), spec, flags)
    assert ce.affine_laplace_ext_2d.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("case, flags", [
    ("dirichlet isotropic", [1, 1, 0, 1]), ("periodic", [0, 0, 0, 0]),
])
def test_plain_matches_jax_other_grids(case, flags):
    k = 3
    jgrid, jbcs, spec = _specs(case, k)
    ext = _ext_block(k, seed=7)
    kernel = jax_affine_laplace_ext_2d(
        LOCAL, a=1.0, b=1e-3, k=k, discretization=jgrid.discretization, ext_cols=True,
        dtype=np.float64, bc_specs=None if jbcs is None else jax_affine_bc_specs(jgrid, jbcs),
        interpret=True,
    )
    expected = kernel(ext, np.asarray(flags + [0], dtype=np.int32))
    got = ce.affine_laplace_ext_2d_plain(torch.tensor(ext), spec, flags)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("k, halo, tile", [(1, 1, 4), (3, 5, 4), (5, 8, 8), (4, 4, 5)])
def test_tile_emulation_matches_plain(k, halo, tile, flags):
    """Tiles smaller than, equal to and ragged against the block; a halo wider
    than k reads the window at offset halo - k; cells past the buffer load as
    zero."""
    _, _, spec = _specs("mixed anisotropic", k, halo)
    ext = torch.tensor(_ext_block(halo, seed=k + halo))
    plain = ce.affine_laplace_ext_2d_plain(ext, spec, flags)
    tiled = ce.affine_laplace_ext_2d_tiled(ext, spec, flags, tile=tile)
    torch.testing.assert_close(tiled, plain, rtol=0, atol=0)


def test_wrapper_writes_interiors_on_the_cpu():
    _, _, spec = _specs("mixed anisotropic", 2, 4)
    exts = [torch.tensor(_ext_block(4, seed=s)) for s in range(3)]
    outs = [torch.full_like(x, 7.0) for x in exts]
    flags = [[1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 0, 0]]
    launches = ce.affine_laplace_ext_2d.launches
    ce.affine_laplace_ext_2d(exts, outs, flags, spec)
    assert ce.affine_laplace_ext_2d.launches == launches
    for ext, out, f in zip(exts, outs, flags):
        interior = out[4:12, 4:16]
        torch.testing.assert_close(interior, ce.affine_laplace_ext_2d_plain(ext, spec, f))
        out[4:12, 4:16] = 7.0
        assert bool((out == 7.0).all())  # the halo ring is left as it was


def test_gate():
    args, kwargs, bc = GRIDS["mixed anisotropic"]
    grid = tpde.CartesianGrid(*args, **kwargs)
    bcs = grid.get_boundary_conditions(bc)
    with pytest.raises(tpde.KernelUnsupportedError, match="Shard too small"):
        ce.affine_laplace_ext_spec(grid, (4, 12), a=1, b=1, k=5, halo=5,
                                   dtype=torch.float64, bcs=bcs)
    with pytest.raises(tpde.KernelUnsupportedError, match="halo"):
        ce.affine_laplace_ext_spec(grid, LOCAL, a=1, b=1, k=4, halo=2,
                                   dtype=torch.float64, bcs=bcs)
    # bf16 (B1(f)) where the blocks cut the columns, bounded or not, at the
    # float32 plan; refused on a rows-only cut, as pde_tpu's gate
    # (pde_tpu/ops/pallas_cartesian.py:5764-5767, pde_tpu/parallel/fused.py:152-158)
    with pytest.raises(tpde.KernelUnsupportedError, match="B1\\(f\\).*5764-5767"):
        ce.affine_laplace_ext_spec(grid, (8, 24), a=1, b=1, k=1, halo=1,
                                   dtype=torch.bfloat16, bcs=bcs)
    spec = ce.affine_laplace_ext_spec(grid, LOCAL, a=1, b=1, k=1, halo=1, dtype=torch.bfloat16,
                                      bcs=bcs)
    assert spec.compute_dtype == torch.float32 and spec.tile == cc.affine_row_plan(1, 4)
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 0.5}):
        # the 9-point mode (B1(e)) takes fully periodic grids only, as pde_tpu's
        # gate (:5847-5855); a periodic grid's blocks take it
        with pytest.raises(tpde.KernelUnsupportedError, match="841-849"):
            ce.affine_laplace_ext_spec(grid, LOCAL, a=1, b=1, k=1, halo=1,
                                       dtype=torch.float64, bcs=bcs)
        periodic = tpde.CartesianGrid(*args, periodic=True)
        assert ce.affine_laplace_ext_spec(periodic, LOCAL, a=1, b=1, k=1, halo=1,
                                          dtype=torch.float64).corner == 0.5
    # per-point values take the side inputs' mode (k <= SIDES_TOP_STEPS)
    array_bcs = grid.get_boundary_conditions(
        {"x": {"value": np.linspace(0, 1, 24)}, "y": {"derivative": 0}})
    assert ce.affine_laplace_ext_spec(grid, LOCAL, a=1, b=1, k=1, halo=1,
                                      dtype=torch.float64, bcs=array_bcs).has_sides
    # deeper ones the deep march's (C18), up to the ext kernel's 16 steps
    assert ce.affine_laplace_ext_spec(grid, LOCAL, a=1, b=1, k=cc.SIDES_TOP_STEPS + 1,
                                      halo=cc.SIDES_TOP_STEPS + 1, dtype=torch.float64,
                                      bcs=array_bcs).deep
    with pytest.raises(tpde.KernelUnsupportedError, match="1 <= k <= 16"):
        ce.affine_laplace_ext_spec(grid, LOCAL, a=1, b=1, k=cc.EXT_MAX_STEPS + 1,
                                   halo=cc.EXT_MAX_STEPS + 1, dtype=torch.float64,
                                   bcs=array_bcs)
