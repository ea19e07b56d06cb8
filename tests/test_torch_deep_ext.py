"""Every depth that kernel #12 takes in the port, and the diffusion windows at
``pde_tpu``'s depth: the deep march on the blocks of a decomposed grid
(``csrc/affine_deep_2d.cuh``'s ext kernel, the ``affine_laplace_deep_*_ext_2d``
libraries) past the register march's top in the radial, side-input and
radial side-input modes, up to ``cc.EXT_MAX_STEPS`` = 16, on the CPU, fp64
unless stated.

- #12's deep modes at k = top + 1 and 16 over every block of [2, 2] and
  [2, 1] meshes: the plain version and the deep march's replay on each
  block, put together, against kernel #1's deep pass bit for bit (each
  block reading the global radial table and side tables at its origin); bf16
  on column cuts likewise.
- The gate: k = 17 refused, naming ``pde_tpu``'s ext gate; the deep ext
  libraries and their entry points; the Cartesian ext passes stay in the
  register library up to 16.
- The decomposed window with k = 16 (its 16-step passes and, with side
  inputs, its 8-step ones deep) bit-equal to the serial window over 25 steps,
  and an explicit k past 16 halved.
- ``make_fused_euler_window_cyl`` and ``make_fused_euler_window_2d(k=16)``
  against ``pde_tpu``'s windows in interpret mode at 1e-12 of max|f|.
- ``test_c18_*``: the entry points of kernel #12 that refused depths the
  port's kernel #1 and ``pde_tpu``'s #12 take (fault C18).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops import pallas_cartesian as pc
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.parallel import GridMesh, HaloExchange
from pde_tpu_torch.parallel.fused import make_fused_euler_window_sharded

torch.set_num_threads(1)

F64 = torch.float64
BF16 = torch.bfloat16
DT = 0.01
T0 = 0.3
B = 2e-3
EXACT = dict(rtol=0, atol=0)
CUTS = [[2, 2], [2, 1]]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the
    CPU, with the blocks of a mesh on one device."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _wave(n):
    return 0.5 + 0.25 * np.sin(np.linspace(0.0, 6.0, n))


# id -> (grid class name, grid arguments, keywords, conditions, register top)
CASES = {
    "radial": ("CylindricalSymGrid", ((0.5, 3.0), (0, 2), (64, 32)), {"periodic_z": True},
               lambda: {"r": {"value": 0}, "z": "periodic"}, cc.RADIAL_TOP_STEPS),
    "radial, bounded z": ("CylindricalSymGrid", (2.0, (0, 3), (64, 32)), {},
                          lambda: {"r": {"derivative": 0}, "z": {"value": 1}},
                          cc.RADIAL_TOP_STEPS),
    "side inputs": ("UnitGrid", ([64, 32],), {}, lambda: {
        "x-": {"value": _wave(32)}, "x+": {"value_expression": "0.1*sin(3*t)"},
        "y-": {"value": _wave(64)}, "y+": {"derivative": 0}}, cc.SIDES_TOP_STEPS),
    "radial side inputs": ("CylindricalSymGrid", ((0.5, 2.0), (0, 3), (64, 32)), {}, lambda: {
        "r-": {"value_expression": "0.1*sin(3*t)"}, "r+": {"value": _wave(32)},
        "z-": {"value": _wave(64)}, "z+": {"derivative_expression": "cos(t)"}},
        cc.RADIAL_SIDES_TOP_STEPS),
}


def _grid(pkg, case):
    name, args, kwargs, _, _ = CASES[case]
    return getattr(pkg, name)(*args, **kwargs)


def _bcs(grid, case):
    return grid.get_boundary_conditions(CASES[case][3]())


def _times(k, t0=T0):
    return [t0 + s * DT for s in range(k)]


def _data(shape, seed):
    return np.random.default_rng(seed).uniform(0.2, 0.8, size=shape)


def _flags(mesh, spec):
    """Each block's ints: its edge flags, then its first row (radial mode)
    or its first row and column (side inputs)."""
    width = 6 if spec.has_sides else 5 if spec.radial is not None else 4
    return [(mesh.edge_flags(b) + list(mesh.block_origin(b)))[:width] for b in range(len(mesh))]


def _blocks(mesh, data, halo):
    """Each block's extended buffer, filled by the windows' exchange."""
    exchange = HaloExchange(mesh, halo)
    buffers = exchange.allocate(1, data.dtype)
    exchange.load(buffers, [[block] for block in mesh.split_field_data(data)])
    exchange.copy(exchange.strips(buffers))
    return [bufs[0] for bufs in buffers]


BLOCKS = [(case, cut, k) for case in CASES for cut in CUTS
          for k in sorted({CASES[case][4] + 1, 16})]


@pytest.mark.parametrize("case,cut,k", BLOCKS,
                         ids=[f"{c}-{'x'.join(map(str, m))}-k{k}" for c, m, k in BLOCKS])
def test_deep_blocks_equal_the_serial_deep_pass(case, cut, k):
    """#12's deep pass on every block (its plain version, and the deep
    march's replay at a plan of narrow strips and short chunks), put
    together, equals #1's deep pass bit for bit, under a halo of 16."""
    grid = _grid(tpde, case)
    bcs = _bcs(grid, case)
    data = torch.tensor(_data(grid.shape, k))
    serial_spec = cc.affine_laplace_spec(grid, a=1.0, b=B, k=k, dtype=F64, bcs=bcs)
    assert serial_spec.deep
    inputs = cc.AffineSideInputs(grid, bcs) if serial_spec.has_sides else None
    serial = cc.affine_laplace_2d_plain(
        data, serial_spec, None if inputs is None else inputs.for_pass(F64, "cpu", _times(k)))
    mesh = GridMesh(grid, cut)
    spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=B, k=k, halo=16,
                                      dtype=F64, bcs=bcs)
    assert spec.deep and ce.affine_ext_source(
        spec.periodic, spec.radial is not None, sides=spec.has_sides, deep=True).deep
    sides = None if inputs is None else inputs.for_pass(F64, "cpu", _times(k),
                                                        row_pad=cc.SIDE_PAD)
    exts, flags = _blocks(mesh, data, 16), _flags(mesh, spec)
    for run in (ce.affine_laplace_ext_2d_plain,
                lambda e, s, f, sd: ce.affine_laplace_ext_2d_marched(e, s, f, (8, 13), sd)):
        parts = [run(ext, spec, f, sides) for ext, f in zip(exts, flags, strict=True)]
        torch.testing.assert_close(mesh.combine_field_data(parts), serial, **EXACT)
    # the wrapper's CPU path writes the plain blocks into the buffers' interiors
    outs = [torch.zeros_like(e) for e in exts]
    launches = ce.affine_laplace_ext_2d.deep_launches
    ce.affine_laplace_ext_2d(exts, outs, flags, spec, sides=sides)
    assert ce.affine_laplace_ext_2d.deep_launches == launches
    torch.testing.assert_close(mesh.combine_field_data([o[16:-16, 16:-16] for o in outs]),
                               serial, **EXACT)


@pytest.mark.parametrize("cut", [[2, 2], [1, 2]], ids=["2x2", "1x2"])
def test_bf16_deep_blocks_on_column_cuts(cut):
    """bf16 where the mesh cuts the columns, as pde_tpu's ext kernel takes it:
    the radial mode's deep pass (k = 12) on the blocks, plain and replayed,
    equals the serial bf16 deep pass bit for bit (every level rounded)."""
    grid = _grid(tpde, "radial")
    bcs = _bcs(grid, "radial")
    data = torch.tensor(_data(grid.shape, 3)).to(BF16)
    serial = cc.affine_laplace_2d_plain(
        data, cc.affine_laplace_spec(grid, a=1.0, b=B, k=12, dtype=BF16, bcs=bcs))
    mesh = GridMesh(grid, cut)
    spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=B, k=12, halo=12,
                                      dtype=BF16, bcs=bcs)
    assert spec.deep and spec.tile == cc.affine_deep_plan(12, 4, True)
    exts, flags = _blocks(mesh, data, 12), _flags(mesh, spec)
    for run in (ce.affine_laplace_ext_2d_plain,
                lambda e, s, f: ce.affine_laplace_ext_2d_marched(e, s, f, (8, 11))):
        parts = [run(ext, spec, f) for ext, f in zip(exts, flags, strict=True)]
        assert torch.equal(mesh.combine_field_data(parts), serial)


@pytest.mark.parametrize("case", CASES)
def test_gate_and_libraries(case):
    """k = 17 is refused on the blocks, naming pde_tpu's ext gate; past its
    register top a mode goes to its deep ext library, whose entry points
    take the register library's parameters."""
    grid = _grid(tpde, case)
    bcs = _bcs(grid, case)
    local = GridMesh(grid, [2, 1]).local_shape
    with pytest.raises(tpde.KernelUnsupportedError, match=r"1 <= k <= 16.*5746-5770"):
        ce.affine_laplace_ext_spec(grid, local, a=1.0, b=B, k=17, halo=17, dtype=F64, bcs=bcs)
    top = CASES[case][4]
    spec = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=B, k=top + 1, halo=top + 1,
                                      dtype=F64, bcs=bcs)
    unit = ce.affine_ext_source(spec.periodic, spec.radial is not None, sides=spec.has_sides,
                                deep=True)
    register = ce.affine_ext_source(spec.periodic, spec.radial is not None,
                                    sides=spec.has_sides)
    assert unit.library == cc.deep_library(register.library) and unit.deep
    assert unit.library in cc.DEEP_LIBRARIES and unit.radial == register.radial
    assert (f"pde_tpu_torch::launch_affine_deep_ext_2d<double, "
            f"{str(spec.radial is not None).lower()}, {str(spec.has_sides).lower()}, "
            in unit.source)
    assert cc._ENTRY[unit.library][0] == cc._ENTRY[register.library][0]
    assert f"case {top + 1}: " not in register.source


def test_cartesian_ext_passes_stay_in_the_register_library():
    """The Cartesian ext kernel takes k up to 16 in its register library,
    which has no deep counterpart."""
    grid = tpde.UnitGrid([64, 32], periodic=True)
    spec = ce.affine_laplace_ext_spec(grid, (32, 16), a=1.0, b=B, k=16, halo=16, dtype=F64)
    assert not spec.deep and "affine_laplace_deep_ext_2d" not in cc.DEEP_LIBRARIES


@pytest.mark.parametrize("case", CASES)
def test_decomposed_window_at_sixteen(case):
    """make_fused_euler_window_sharded(k=16): the ladder 16, 8, 4, 2, 1 under
    a halo of 16, its deep passes where k passes the register top, bit-equal
    to the serial window(k=16) over 25 steps on [2, 2]."""
    grid = _grid(tpde, case)
    bcs = _bcs(grid, case)
    mesh = GridMesh(grid, [2, 2])
    window = make_fused_euler_window_sharded(mesh, diffusivity=0.1, dt=DT, dtype=F64, bcs=bcs,
                                             k=16)
    serial = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=DT, dtype=F64, k=16,
                                           bcs=bcs)
    top = CASES[case][4]
    assert [s.k for s in window.specs] == [s.k for s in serial.specs] == [16, 8, 4, 2, 1]
    assert [s.deep for s in window.specs] == [s.k > top for s in window.specs]
    assert window.exchange.halo == 16 and window.needs_t == serial.needs_t
    data = torch.tensor(_data(grid.shape, 4))
    args = (T0, 25) if window.needs_t else (25,)
    got = window([[b] for b in mesh.split_field_data(data)], *args)
    torch.testing.assert_close(mesh.combine_field_data([b[0] for b in got]),
                               serial(data, *args), **EXACT)


def test_decomposed_window_halves_past_sixteen():
    """An explicit k past the ext kernel's 16 halves, as pde_tpu's windows
    halve a k their gate refuses."""
    grid = _grid(tpde, "radial")
    window = make_fused_euler_window_sharded(GridMesh(grid, [2, 2]), diffusivity=0.1, dt=DT,
                                             dtype=F64, bcs=_bcs(grid, "radial"), k=32)
    assert [s.k for s in window.specs] == [16, 8, 4, 2, 1]


# -- the serial windows at pde_tpu's depth ------------------------------------------------------
def _jax_window(case, data, steps):
    """pde_tpu's window in interpret mode: make_fused_euler_window_cyl on a
    cylinder, make_fused_euler_window_2d(k=16) elsewhere."""
    grid = _grid(jpde, case)
    bcs = grid.get_boundary_conditions(CASES[case][3]())
    if isinstance(grid, jpde.CylindricalSymGrid):
        window = pc.make_fused_euler_window_cyl(grid, diffusivity=0.1, dt=DT, bcs=bcs,
                                                dtype=np.float64, interpret=True)
    else:
        window = pc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=DT, dtype=np.float64,
                                               k=16, bcs=bcs, interpret=True)
    args = (T0, steps) if getattr(window, "needs_t", False) else (steps,)
    return np.asarray(window(jnp.asarray(data), *args))


WINDOWS = ["radial", "radial side inputs", "side inputs"]


@pytest.mark.parametrize("case", WINDOWS)
def test_windows_at_pde_tpus_depth(case, monkeypatch):
    """make_fused_euler_window_cyl (k = 16 by default) on the cylinders and
    make_fused_euler_window_2d(k=16) on the side-input grid: the ladder 16,
    8, 4, 2, 1, 25 steps (16 + 8 + 1) against pde_tpu's window in interpret
    mode at 1e-12 of max|f|."""
    grid = _grid(tpde, case)
    bcs = _bcs(grid, case)
    if isinstance(grid, tpde.CylindricalSymGrid):
        window = cc.make_fused_euler_window_cyl(grid, diffusivity=0.1, dt=DT, bcs=bcs, dtype=F64)
    else:
        window = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=DT, dtype=F64, k=16,
                                               bcs=bcs)
    assert [s.k for s in window.specs] == [16, 8, 4, 2, 1] and window.specs[0].deep
    data = _data(grid.shape, 9)
    got = window(torch.tensor(data), *((T0, 25) if window.needs_t else (25,)))
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    expected = _jax_window(case, data, 25)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-12 * np.abs(expected).max())


# -- C18: the entry points of kernel #12 that refused depths ------------------------------------
#: (case, k) that the port's ext gate refused before: the radial mode past 8,
#: side inputs past 6, both past 5
C18_EXT = [("radial", 12), ("radial", 16), ("side inputs", 7), ("side inputs", 8),
           ("radial side inputs", 6), ("radial side inputs", 8)]


@pytest.mark.parametrize("case,k", C18_EXT, ids=[f"{c}-k{k}" for c, k in C18_EXT])
def test_c18_affine_laplace_ext_spec(case, k):
    """affine_laplace_ext_spec takes the depth (pde_tpu's hardware path
    takes k <= 8 on every mode, its interpret mode any k)."""
    grid = _grid(tpde, case)
    spec = ce.affine_laplace_ext_spec(grid, GridMesh(grid, [2, 2]).local_shape, a=1.0, b=B,
                                      k=k, halo=k, dtype=F64, bcs=_bcs(grid, case))
    assert spec.k == k and spec.deep


def test_c18_make_fused_euler_window_sharded():
    """The decomposed window on a cylinder takes an explicit k = 16 (the
    serial window's and pde_tpu's depth) where it refused past 8."""
    grid = _grid(tpde, "radial side inputs")
    window = make_fused_euler_window_sharded(GridMesh(grid, [2, 1]), diffusivity=0.1, dt=DT,
                                             dtype=F64, bcs=_bcs(grid, "radial side inputs"),
                                             k=16)
    assert window.specs[0].k == 16 and window.specs[0].deep and window.specs[0].has_sides
