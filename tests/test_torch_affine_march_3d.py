"""The x-marching schedule of the two 3D affine Laplacian kernels (TPU kernels
#3 and #11; ``march_3d`` of ``csrc/affine_laplace_3d.cuh``).

The pure-torch replays of the kernels' march (``affine_laplace_3d_marched``,
``affine_laplace_ext_3d_marched``) follow the kernel's own schedule: the
shared-memory slot each level writes, when a plane enters and retires, where
each ghost is formed, the x-chunk borders. Their slots start as NaN, so a
read of a cell the schedule has not written yet poisons the result. They are
held against the plain versions at rtol = atol = 0, at every k, in fp64 and
fp32, at the kernel's plan and at plans that cut the grid finely (chunks
shorter than 2k included); and the plan's budget and block counts.
"""

import numpy as np
import pytest
import torch

import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_cartesian_3d as c3
from pde_tpu_torch.ops import cuda_ext_3d as e3
from pde_tpu_torch.ops.cuda_stencil_2d import SMEM_BUDGET

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


# the edge grids of tests/test_torch_affine_laplace_3d.py
EDGE_CASES = {
    # the triple seam: halos deeper than the grid on every axis
    "8^3 periodic": ([(0, 1)] * 3, (8, 8, 8), True, None),
    "8^3 no-flux": ([(0, 1)] * 3, (8, 8, 8), False, {"derivative": 0}),
    # ragged tiles along every axis, anisotropic, faces that meet
    "ragged no-flux": ([(0, 1), (0, 2), (0, 3)], (18, 21, 34), False, {"derivative": 0}),
    "ragged mixed": ([(0, 1), (0, 2), (0, 3)], (18, 21, 34), [False, True, False],
                     {"x-": {"value": 1}, "x+": {"curvature": 0.5}, "y": "periodic",
                      "z": {"type": "mixed", "value": 1.0, "const": 0.2}}),
    "two cells": ([(0, 1)] * 3, (2, 3, 2), False, {"value": 1.5}),
}
# the kernel's plan, a plan that cuts every axis, chunks shorter than 2k
TILES = (None, (5, 8, 16), (2, 16, 32))


def _case(case_id, dtype, seed=70):
    bounds, shape, periodic, bc = EDGE_CASES[case_id]
    grid = tpde.CartesianGrid(bounds, shape, periodic=periodic)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    data = torch.tensor(np.random.default_rng(seed).random(shape), dtype=dtype)
    return grid, bcs, data


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case_id", EDGE_CASES)
def test_marched_matches_plain_at_every_k(case_id, dtype):
    grid, bcs, data = _case(case_id, dtype)
    for k in range(1, c3.MAX_STEPS + 1):
        spec = c3.affine_laplace_3d_spec(grid, a=1.0, b=2e-3, k=k, dtype=dtype, bcs=bcs)
        expected = c3.affine_laplace_3d_plain(data, spec)
        for tile in TILES:
            got = c3.affine_laplace_3d_marched(data, spec, tile=tile)
            torch.testing.assert_close(got, expected, rtol=0, atol=0)


@pytest.mark.parametrize("cx", [1, 2, 3])
def test_chunks_shorter_than_two_k(cx):
    """At k = 4 a chunk of cx planes marches through cx + 8 planes; the
    wavefront's warm-up and drain overlap."""
    grid, bcs, data = _case("ragged no-flux", torch.float64)
    spec = c3.affine_laplace_3d_spec(grid, a=1.0, b=2e-3, k=4, dtype=torch.float64, bcs=bcs)
    got = c3.affine_laplace_3d_marched(data, spec, tile=(cx, 7, 12))
    torch.testing.assert_close(got, c3.affine_laplace_3d_plain(data, spec), rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 3])
def test_a_short_ring_poisons_the_replay(k, monkeypatch):
    """The replay reads what the schedule wrote, so a ring one slot too short
    to keep a plane until its last read shows."""
    grid, bcs, data = _case("ragged no-flux", torch.float64)
    spec = c3.affine_laplace_3d_spec(grid, a=1.0, b=2e-3, k=k, dtype=torch.float64, bcs=bcs)
    monkeypatch.setattr(c3, "MARCH_SLOTS", c3.MARCH_SLOTS - 1)
    got = c3.affine_laplace_3d_marched(data, spec, tile=(5, 8, 16))
    assert not torch.equal(got, c3.affine_laplace_3d_plain(data, spec))


# -- the ext kernel's march ---------------------------------------------------------------------
FLAG_SETS = [
    [0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0], [0, 1, 0, 1, 0, 1], [1, 0, 1, 0, 1, 0],
    [1, 1, 1, 1, 1, 1], [0, 0, 1, 1, 0, 0],
]
MIXED_BC = {
    "x-": {"value": 1.0}, "x+": {"derivative": 0.3},
    "y-": {"type": "mixed", "value": 2.0, "const": 0.5}, "y+": {"curvature": 1.0},
    "z": {"value": -0.5},
}
GRIDS = {
    "mixed anisotropic": ({}, MIXED_BC),
    "periodic y": ({"periodic": [False, True, False]},
                   {"x": {"value": 0.5}, "y": "periodic", "z": {"derivative": -1.0}}),
    "periodic": ({"periodic": True}, None),
}


def _ext_spec(case, k, halo, dtype, local=(6, 5, 7)):
    kwargs, bc = GRIDS[case]
    grid = tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)], [12, 10, 14], **kwargs)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    return e3.affine_laplace_ext_3d_spec(grid, local, a=1.0, b=1e-3, k=k, halo=halo, dtype=dtype,
                                         bcs=bcs)


def _ext(halo, seed, dtype, local=(6, 5, 7)):
    shape = tuple(n + 2 * halo for n in local)
    return torch.tensor(np.random.default_rng(seed).random(shape), dtype=dtype)


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("k, halo", [(1, 1), (2, 3), (3, 3), (4, 4)])
def test_ext_marched_matches_plain(k, halo, flags):
    """Every flag pattern of the ext tests; a halo wider than k reads the
    window at offset halo - k; cells past the buffer load as zero."""
    for dtype in (torch.float64, torch.float32):
        spec = _ext_spec("mixed anisotropic", k, halo, dtype)
        ext = _ext(halo, seed=k + halo + sum(flags), dtype=dtype)
        expected = e3.affine_laplace_ext_3d_plain(ext, spec, flags)
        for tile in (None, (2, 2, 3), (1, 3, 4)):
            got = e3.affine_laplace_ext_3d_marched(ext, spec, flags, tile=tile)
            torch.testing.assert_close(got, expected, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["periodic y", "periodic"])
def test_ext_marched_on_other_grids(case):
    for k in range(1, c3.MAX_STEPS + 1):
        spec = _ext_spec(case, k, 4, torch.float64)
        ext = _ext(4, seed=k, dtype=torch.float64)
        flags = [int(f and not spec.periodic[i // 2]) for i, f in enumerate([1, 1, 0, 1, 1, 0])]
        for tile in (None, (2, 3, 4)):
            got = e3.affine_laplace_ext_3d_marched(ext, spec, flags, tile=tile)
            torch.testing.assert_close(got, e3.affine_laplace_ext_3d_plain(ext, spec, flags),
                                       rtol=0, atol=0)


def test_ext_march_of_a_self_wrapped_block_is_the_serial_march():
    """One periodic block whose halo is its own wrap: the two kernels'
    replays agree bit for bit (one update, one schedule)."""
    grid = tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)], [12, 10, 14], periodic=True)
    data = torch.tensor(np.random.default_rng(3).random((12, 10, 14)))
    for k in range(1, c3.MAX_STEPS + 1):
        serial = c3.affine_laplace_3d_spec(grid, a=1.0, b=1e-3, k=k, dtype=torch.float64)
        spec = e3.affine_laplace_ext_3d_spec(grid, (12, 10, 14), a=1.0, b=1e-3, k=k, halo=4,
                                             dtype=torch.float64)
        ext = torch.tensor(np.pad(data.numpy(), 4, mode="wrap"))
        torch.testing.assert_close(
            e3.affine_laplace_ext_3d_marched(ext, spec, [0] * 6, tile=(5, 4, 8)),
            c3.affine_laplace_3d_marched(data, serial, tile=(5, 4, 8)), rtol=0, atol=0)


# -- the plan ----------------------------------------------------------------------------------
@pytest.mark.parametrize("itemsize", [4, 8])
def test_march_plan_fits_the_budget(itemsize):
    for k in range(1, c3.MAX_STEPS + 1):
        cx, ty, tz = c3.march_plan_3d(k, itemsize)
        assert 256 % tz == 0 and 256 % cx == 0  # no ragged tile or chunk at 256 cells
        assert c3.MARCH_SLOTS == 2  # MarchShape::kSlots of the template
        smem = k * c3.MARCH_SLOTS * (ty + 2 * k) * (tz + 2 * k) * itemsize  # MarchShape::kSmem
        assert smem <= SMEM_BUDGET
        if ty != c3.MARCH_TY[0]:  # the largest tile that fits
            wider = c3.MARCH_TY[c3.MARCH_TY.index(ty) - 1]
            assert k * c3.MARCH_SLOTS * (wider + 2 * k) * (tz + 2 * k) * itemsize > SMEM_BUDGET
        dtype = torch.float32 if itemsize == 4 else torch.float64
        spec = c3.affine_laplace_3d_spec(tpde.UnitGrid([16] * 3, periodic=True), a=1.0, b=0.1,
                                         k=k, dtype=dtype)
        assert spec.tile == (cx, ty, tz)


def _blocks(shape, plan):
    return int(np.prod([-(-n // t) for n, t in zip(shape, plan)]))


def test_march_plan_fills_the_card():
    """The main pass at 256³ and the decomposed pass over eight 128³ blocks
    launch at least one block per SM of the H100's 132."""
    for k in range(1, c3.MAX_STEPS + 1):
        plan = c3.march_plan_3d(k, 4)
        assert _blocks((256,) * 3, plan) >= 132
        assert 8 * _blocks((128,) * 3, plan) >= 132
    assert _blocks((256,) * 3, c3.march_plan_3d(c3.TOP_STEPS, 4)) == 256 ** 3 // int(
        np.prod(c3.march_plan_3d(c3.TOP_STEPS, 4)))


def test_march_plan_rejects_what_does_not_fit():
    with pytest.raises(tpde.KernelUnsupportedError, match="No march plan"):
        c3.march_plan_3d(4, 64)
