"""The deep march's replay (``cc.affine_deep_block``: the kernel
``AffineDeepMarch`` of ``csrc/affine_deep_2d.cuh`` as it schedules a block)
against the plain version, on the CPU, fp64 unless stated: kernel #1's deep
passes past the register march's top in each 5-point mode.

- Each deep mode at k = top + 1, 12, 16 and 32 (those past its register
  top) on grids of 64 rows: the replay (strips, chunks, k a number, three
  shared rows a level, NaN where the schedule has not written, the block's
  copy of the radial factors, the side tables indexed as the kernel indexes
  them) at the kernel's plan and at a plan whose strips and chunks meet the
  edges and wrap, bit for bit.
- A side table cut short raises where the kernel would read past it.
- bf16 deep passes (periodic columns, as ``pde_tpu`` takes bf16): the replay
  against the plain version bit for bit, a deep pass against the ladder of
  shallower ones.
"""

import numpy as np
import pytest
import torch

import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_cartesian as cc

torch.set_num_threads(1)

F64 = torch.float64
BF16 = torch.bfloat16
DT = 0.01
T0 = 0.3
B = 2e-3


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


def _wave(n):
    return 0.5 + 0.25 * np.sin(np.linspace(0.0, 6.0, n))


# id -> (grid, conditions, register top), as in tests/test_torch_deep_passes.py
CASES = {
    "periodic": (lambda: tpde.UnitGrid([64, 16], periodic=True), None, cc.MAX_STEPS),
    "bounded": (lambda: tpde.UnitGrid([64, 16]),
                {"x": {"value": 1}, "y": {"derivative": 0.5}}, cc.MAX_STEPS),
    "side inputs": (lambda: tpde.UnitGrid([64, 16]), {
        "x-": {"value": _wave(16)}, "x+": {"value_expression": "0.1*sin(3*t)"},
        "y-": {"value": _wave(64)}, "y+": {"derivative": 0}}, cc.SIDES_TOP_STEPS),
    "radial": (lambda: tpde.CylindricalSymGrid((0.5, 3.0), (0, 2), (64, 16), periodic_z=True),
               {"r": {"value": 0}, "z": "periodic"}, cc.RADIAL_TOP_STEPS),
    "radial, bounded z": (lambda: tpde.CylindricalSymGrid(2.0, (0, 3), (64, 16)),
                          {"r": {"derivative": 0}, "z": {"value": 1}}, cc.RADIAL_TOP_STEPS),
    "radial side inputs": (lambda: tpde.CylindricalSymGrid((0.5, 2.0), (0, 3), (64, 16)), {
        "r-": {"value_expression": "0.1*sin(3*t)"}, "r+": {"value": _wave(16)},
        "z-": {"value": _wave(64)}, "z+": {"derivative_expression": "cos(t)"}},
        cc.RADIAL_SIDES_TOP_STEPS),
}


def _deep_ks(case):
    top = CASES[case][2]
    return sorted({top + 1, 12, 16, 32} - set(range(1, top + 1)))


def _times(k, t0=T0):
    return [t0 + s * DT for s in range(k)]


def _pass(case, k, dtype=F64):
    """(grid, spec, the pass's side inputs from T0 or None)."""
    make, bc, _ = CASES[case]
    grid = make()
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    spec = cc.affine_laplace_spec(grid, a=1.0, b=B, k=k, dtype=dtype, bcs=bcs)
    sides = None
    if spec.has_sides:
        sides = cc.AffineSideInputs(grid, bcs).for_pass(dtype, "cpu", _times(k))
    return grid, spec, sides


def _data(shape, seed):
    return np.random.default_rng(seed).uniform(0.2, 0.8, size=shape)


REPLAY = [(case, k) for case in CASES for k in _deep_ks(case)]


@pytest.mark.parametrize("case,k", REPLAY, ids=[f"{c}-k{k}" for c, k in REPLAY])
def test_deep_replay_is_the_plain_pass(case, k):
    """The deep march's replay (NaN where the schedule has not written, the
    tables indexed as the kernel indexes them) at the kernel's plan and at
    a plan of two strips and three chunks (the last one short), equals the
    plain version bit for bit."""
    grid, spec, sides = _pass(case, k)
    data = torch.tensor(_data(grid.shape, 100 + k))
    plain = cc.affine_laplace_2d_plain(data, spec, sides)
    for plan in (None, (8, 29)):
        assert torch.equal(cc.affine_laplace_2d_marched(data, spec, plan, sides), plain)


def test_replay_reads_no_entry_past_the_tables():
    """The replay reads a column side's table at the entries the kernel
    reads, up to k rows past the grid: a table cut short raises."""
    _, spec, sides = _pass("radial side inputs", 32)
    data = torch.tensor(_data(spec.shape, 7))
    short = cc.AffineSides(tuple(a if a is None or i < 2 else a[:-16]
                                 for i, a in enumerate(sides.arrays)), sides.t)
    with pytest.raises(IndexError):
        cc.affine_laplace_2d_marched(data, spec, (16, 8), short)


#: bf16 cases: the columns periodic, as pde_tpu takes bf16
BF16_CASES = ["periodic", "radial"]


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_deep_replay_and_ladder(case):
    """bf16 deep passes (every level rounded to bf16): the replay equals the
    plain version bit for bit; a k = 32 pass equals two k = 16 passes, as
    every level is rounded, and stays within one bf16 ulp a step of the fp64
    pass."""
    grid, spec, _ = _pass(case, 32, BF16)
    assert spec.deep and spec.compute_dtype == torch.float32
    assert spec.tile == cc.affine_deep_plan(32, 4, spec.radial is not None)
    data = torch.tensor(_data(grid.shape, 5)).to(BF16)
    plain = cc.affine_laplace_2d_plain(data, spec)
    assert plain.dtype == BF16
    assert torch.equal(cc.affine_laplace_2d_marched(data, spec, (24, 20)), plain)
    half = _pass(case, 16, BF16)[1]
    ladder = cc.affine_laplace_2d_plain(cc.affine_laplace_2d_plain(data, half), half)
    assert torch.equal(ladder, plain)
    exact = cc.affine_laplace_2d_plain(data.to(F64), _pass(case, 32)[1])
    ulp = 2.0 ** (np.floor(np.log2(float(exact.abs().max()))) - 7)
    assert float((plain.double() - exact).abs().max()) <= 32 * ulp


def test_bf16_side_inputs_deep_replay():
    """Side inputs on rows bounded, columns periodic, in bf16 (rounded tables)."""
    grid = tpde.UnitGrid([64, 16], periodic=[False, True])
    bcs = grid.get_boundary_conditions({"x-": {"value": _wave(16)},
                                        "x+": {"value_expression": "0.1*sin(3*t)"},
                                        "y": "periodic"})
    spec = cc.affine_laplace_spec(grid, a=1.0, b=B, k=20, dtype=BF16, bcs=bcs)
    assert spec.deep and cc.library_of(spec) == "affine_laplace_deep_sides_2d"
    sides = cc.AffineSideInputs(grid, bcs).for_pass(BF16, "cpu", _times(20))
    data = torch.tensor(_data(grid.shape, 6)).to(BF16)
    assert torch.equal(cc.affine_laplace_2d_marched(data, spec, (16, 11), sides),
                       cc.affine_laplace_2d_plain(data, spec, sides))
