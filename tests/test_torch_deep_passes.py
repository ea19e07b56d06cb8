"""Every depth that kernel #1 takes in ``pde_tpu``: the deep march
(``csrc/affine_deep_2d.cuh``, the libraries of ``cc.DEEP_LIBRARIES``) past
the register march's top in each 5-point mode, up to ``cc.DEEP_MAX_STEPS``
(``pde_tpu``'s geometry gate, ``4 * _HALO``), on the CPU, fp64.

- Each deep mode at k = top + 1, 12, 16 and 32 (those past its register top)
  on grids of 64 rows, where ``pde_tpu``'s k = 32 geometry holds: the pass
  (the wrapper's CPU path, the plain version) against ``pde_tpu``'s
  ``make_affine_laplace_2d(..., interpret=True)`` (``radial=`` on the
  cylinders, the t-table with side inputs) at 1e-12 of max|f|.
- The gate: the deep libraries, their entry points and plans; the refusals
  at k = 33 and of the 9-point mode at k = 9; the windows' explicit k.
- ``test_c18_*``: each entry point of kernel #1 that refused a depth
  ``pde_tpu`` takes (fault C18).

The deep march's replay is held to the plain version in
``tests/test_torch_deep_replay.py``; kernel #12's deep passes and the
windows at ``pde_tpu``'s depth are in ``tests/test_torch_deep_ext.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops import pallas_cartesian as pc
from pde_tpu_torch.ops import cuda_cartesian as cc

torch.set_num_threads(1)

F64 = torch.float64
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


# id -> (grid class name, grid arguments, keywords, conditions, register top)
CASES = {
    "periodic": ("UnitGrid", ([64, 16],), {"periodic": True}, None, cc.MAX_STEPS),
    "bounded": ("UnitGrid", ([64, 16],), {},
                lambda: {"x": {"value": 1}, "y": {"derivative": 0.5}}, cc.MAX_STEPS),
    "side inputs": ("UnitGrid", ([64, 16],), {}, lambda: {
        "x-": {"value": _wave(16)}, "x+": {"value_expression": "0.1*sin(3*t)"},
        "y-": {"value": _wave(64)}, "y+": {"derivative": 0}}, cc.SIDES_TOP_STEPS),
    "radial": ("CylindricalSymGrid", ((0.5, 3.0), (0, 2), (64, 16)), {"periodic_z": True},
               lambda: {"r": {"value": 0}, "z": "periodic"}, cc.RADIAL_TOP_STEPS),
    "radial, bounded z": ("CylindricalSymGrid", (2.0, (0, 3), (64, 16)), {},
                          lambda: {"r": {"derivative": 0}, "z": {"value": 1}},
                          cc.RADIAL_TOP_STEPS),
    "radial side inputs": ("CylindricalSymGrid", ((0.5, 2.0), (0, 3), (64, 16)), {}, lambda: {
        "r-": {"value_expression": "0.1*sin(3*t)"}, "r+": {"value": _wave(16)},
        "z-": {"value": _wave(64)}, "z+": {"derivative_expression": "cos(t)"}},
        cc.RADIAL_SIDES_TOP_STEPS),
}


def _deep_ks(case):
    top = CASES[case][4]
    return sorted({top + 1, 12, 16, 32} - set(range(1, top + 1)))


#: (case, k) of the comparisons with pde_tpu: every deep k of each mode
#: (the bounded-z cylinder, the radial mode's other periodicity, at its ends)
JAX_PASSES = [(case, k) for case in CASES for k in _deep_ks(case)
              if case != "radial, bounded z" or k in (9, 32)]


def _grid(pkg, case):
    name, args, kwargs, _, _ = CASES[case]
    return getattr(pkg, name)(*args, **kwargs)


def _bc(case):
    make = CASES[case][3]
    return None if make is None else make()


def _times(k, t0=T0):
    return [t0 + s * DT for s in range(k)]


def _pass(case, k, dtype=F64):
    """(port grid, spec, the pass's side inputs from T0 or None)."""
    grid = _grid(tpde, case)
    bc = _bc(case)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    spec = cc.affine_laplace_spec(grid, a=1.0, b=B, k=k, dtype=dtype, bcs=bcs)
    sides = None
    if spec.has_sides:
        sides = cc.AffineSideInputs(grid, bcs).for_pass(dtype, "cpu", _times(k))
    return grid, spec, sides


def _data(shape, seed):
    return np.random.default_rng(seed).uniform(0.2, 0.8, size=shape)


def _jax_pass(case, k, data):
    """pde_tpu's pass in interpret mode (radial= on a cylinder, its t-table from T0)."""
    grid = _grid(jpde, case)
    bc = _bc(case)
    radial = None
    if isinstance(grid, jpde.CylindricalSymGrid):
        radial = (float(grid.axes_bounds[0][0]), float(grid.discretization[0]))
    op = pc.make_affine_laplace_2d(
        grid, a=1.0, b=B, k=k, dtype=np.float64,
        bcs=None if bc is None else grid.get_boundary_conditions(bc), interpret=True,
        radial=radial)
    if op.t_slots is None:
        return np.asarray(op(data))
    ts = jnp.asarray(_times(k))
    tab = jnp.stack([jnp.zeros_like(ts) if f is None else jax.vmap(f)(ts) for f in op.t_slots],
                    axis=1)
    return np.asarray(op(data, tab))


@pytest.mark.parametrize("case,k", JAX_PASSES, ids=[f"{c}-k{k}" for c, k in JAX_PASSES])
def test_deep_pass_matches_jax(case, k):
    """The deep pass (the plain version, which the wrapper runs on the CPU)
    against pde_tpu's kernel in interpret mode, 1e-12 of max|f|."""
    grid, spec, sides = _pass(case, k)
    assert spec.deep and cc.library_of(spec).startswith("affine_laplace_deep_")
    data = _data(grid.shape, k)
    expected = _jax_pass(case, k, data)
    launches = cc.affine_laplace_2d.deep_launches
    got = cc.affine_laplace_2d(torch.tensor(data), spec, sides=sides)
    assert cc.affine_laplace_2d.deep_launches == launches  # the CPU path launches nothing
    np.testing.assert_allclose(got.numpy(), expected, rtol=0,
                               atol=1e-12 * np.abs(expected).max())


@pytest.mark.parametrize("case", CASES)
def test_gate_libraries_and_entry_points(case):
    """Past its register top a mode goes to its deep library (one entry point
    per dtype, k at run time, the register library's parameters); at the top
    it stays in the register library, whose entry points end there."""
    top = CASES[case][4]
    _, at_top, _ = _pass(case, top)
    _, deep, _ = _pass(case, top + 1)
    assert not at_top.deep and deep.deep
    assert cc.register_top(deep.radial is not None, deep.has_sides) == top
    library = cc.library_of(deep)
    assert library == cc.deep_library(cc.library_of(at_top)) and library in cc.DEEP_LIBRARIES
    assert deep.tile == cc.affine_deep_plan(top + 1, 8, deep.radial is not None, deep.has_sides)
    unit = cc.kernel_source(deep.periodic, library)
    assert unit.deep and unit.radial == (deep.radial is not None)
    register = cc.kernel_source(at_top.periodic, cc.library_of(at_top))
    assert f"case {top}: " in register.source and f"case {top + 1}: " not in register.source
    flags = ", ".join(str(bool(v)).lower() for v in (
        deep.radial is not None, deep.has_sides, *deep.periodic))
    assert (f"pde_tpu_torch::launch_affine_deep_2d<double, {flags}, double>(in, out, "
            in unit.source)
    assert f'extern "C" int {library}_f32(' in unit.source and "case " not in unit.source
    assert unit.digest != register.digest
    assert len(cc.step_doubles(deep, _pass(case, top + 1)[2])) == (
        16 + 2 * (deep.radial is not None) + 4 * (top + 1) * deep.has_sides)


def test_deep_plan():
    """The widest strip whose window row 256 threads cover at two columns
    each and whose rings (and, radial, the longest chunk's factors; with side
    inputs, the t-table) fit the 227 KB of a block; a tighter budget narrows
    it."""
    for k, itemsize, radial, sides in ((17, 4, False, False), (32, 4, True, True),
                                       (32, 8, True, True), (20, 8, False, True)):
        tx, threads, prefetch, blocks = cc.affine_deep_plan(k, itemsize, radial, sides)
        assert (threads, prefetch, blocks) == (cc.DEEP_THREADS, 1, 1)
        assert tx + 2 * k <= cc.DEEP_THREADS * cc.DEEP_COLS
        rows = 512 + 2 * k if radial else 0
        assert cc.affine_deep_smem(k, tx, itemsize, rows, sides) <= cc.DEEP_SMEM
        wider = [t for t in cc.DEEP_TX if t > tx]
        assert all(t + 2 * k > 512
                   or cc.affine_deep_smem(k, t, itemsize, rows, sides) > cc.DEEP_SMEM
                   for t in wider)
    assert cc.affine_deep_plan(32, 8, True)[0] == 224
    # the plan's constants are the kernel's
    template = cc._DEEP_TEMPLATE.read_text()
    for name, value in (("kDeepThreads", cc.DEEP_THREADS), ("kDeepCols", cc.DEEP_COLS),
                        ("kDeepSlots", cc.DEEP_SLOTS), ("kDeepMaxSteps", cc.DEEP_MAX_STEPS),
                        ("kDeepPad", cc.SIDE_PAD), ("kDeepPad", cc.RADIAL_PAD)):
        assert f"constexpr int {name} = {value};" in template
    # the register march reads the same tables from their 16th entry on
    register = cc._TEMPLATE.read_text()
    assert f"constexpr int kAffineMaxSteps = {cc.REGISTER_SIDE_PAD};" in register
    assert "constexpr int kSidePad = kAffineMaxSteps;" in register
    assert "constexpr int kRadialPad = 2 * kAffineMaxSteps;" in register
    assert cc.RADIAL_PAD == 2 * cc.REGISTER_SIDE_PAD
    assert cc.affine_deep_plan(32, 4, budget=cc.DEEP_SMEM // 2)[0] < 448
    with pytest.raises(tpde.KernelUnsupportedError, match="No deep-march plan"):
        cc.affine_deep_plan(32, 8, budget=1024)


def test_side_pointers():
    """The deep march reads the side tables as they are; the register march,
    compiled with a pad of 16, from their 16th entry on, where the table is
    padded (a column side's, an ext row side's), so both read grid row g of
    a column side at the same element."""
    grid, register, _ = _pass("side inputs", cc.SIDES_TOP_STEPS)
    deep = _pass("side inputs", cc.SIDES_TOP_STEPS + 1)[1]
    inputs = cc.AffineSideInputs(grid, grid.get_boundary_conditions(_bc("side inputs")))
    skip = cc.SIDE_PAD - cc.REGISTER_SIDE_PAD
    for row_pad in (0, cc.SIDE_PAD):
        sides = inputs.for_pass(F64, "cpu", _times(3), row_pad=row_pad)
        for spec, offset in ((register, skip), (deep, 0)):
            pointers = list(cc.side_pointers(spec, sides))
            for i, arr in enumerate(sides.arrays):
                if arr is None:
                    assert pointers[i] is None
                    continue
                padded = i >= 2 or row_pad
                assert pointers[i] == arr.data_ptr() + (offset if padded else 0) * 8
    assert cc.SIDE_PAD >= cc.DEEP_MAX_STEPS and cc.REGISTER_SIDE_PAD >= cc.MAX_STEPS


@pytest.mark.parametrize("case", CASES)
def test_refusal_past_32_steps(case):
    """k = 33 is refused in every mode, naming pde_tpu's geometry gate."""
    with pytest.raises(tpde.KernelUnsupportedError, match=r"1 <= k <= 32.*pallas_cartesian.py:190"):
        _pass(case, 33)


def test_nine_point_mode_stays_at_eight():
    """The 9-point corner-weight mode takes k <= 8 (pde_tpu's cap); its
    window halves an explicit k = 16 to 8."""
    grid = tpde.UnitGrid([64, 16], periodic=True)
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 1 / 3}):
        assert cc.affine_laplace_spec(grid, a=1.0, b=B, k=8, dtype=F64).corner
        with pytest.raises(tpde.KernelUnsupportedError, match="k=8.*850-860"):
            cc.affine_laplace_spec(grid, a=1.0, b=B, k=9, dtype=F64)
        window = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=DT, dtype=F64, k=16)
        assert [s.k for s in window.specs] == [8, 4, 2, 1]


def test_window_cyl_refuses_cartesian_grids():
    grid = tpde.UnitGrid([64, 16], periodic=True)
    with pytest.raises(tpde.KernelUnsupportedError, match="CylindricalSymGrid required"):
        cc.make_fused_euler_window_cyl(grid, diffusivity=0.1, dt=DT, bcs=None)


def test_window_halves_past_32():
    """An explicit k past 32 halves until the mode takes it, as pde_tpu's window."""
    grid = tpde.UnitGrid([64, 16], periodic=True)
    window = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=DT, dtype=F64, k=40)
    assert [s.k for s in window.specs] == [20, 10, 5, 2, 1]
    assert [s.deep for s in window.specs] == [True, False, False, False, False]


#: the windows' cases whose 16-step passes take the deep march
WINDOWS = ["radial", "radial side inputs", "side inputs"]


# -- C18: the entry points that refused depths pde_tpu takes -------------------------------------
#: (case, k) that the port's gates refused before: the radial mode past 8, side
#: inputs past 6, both past 5, every 5-point mode past 16
C18_PASSES = [("radial", 12), ("radial side inputs", 6), ("side inputs", 8), ("periodic", 20),
              ("bounded", 32)]


@pytest.mark.parametrize("case,k", C18_PASSES, ids=[f"{c}-k{k}" for c, k in C18_PASSES])
def test_c18_make_affine_laplace_2d(case, k):
    """make_affine_laplace_2d takes the depth and computes the plain pass."""
    grid = _grid(tpde, case)
    bc = _bc(case)
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    op = cc.make_affine_laplace_2d(grid, a=1.0, b=B, k=k, dtype=F64, bcs=bcs)
    assert op.k == k
    data = torch.tensor(_data(grid.shape, 11))
    times = _times(k) if op.t_slots is not None else None
    _, spec, sides = _pass(case, k)
    assert torch.equal(op(data, times=times), cc.affine_laplace_2d_plain(data, spec, sides))


@pytest.mark.parametrize("case", WINDOWS)
def test_c18_make_fused_euler_window_2d(case):
    """make_fused_euler_window_2d(k=16) builds on the cylinder, with side
    inputs and with radial side inputs, and its 16-step pass is the plain
    pass."""
    grid = _grid(tpde, case)
    bcs = grid.get_boundary_conditions(_bc(case))
    window = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=DT, dtype=F64, k=16,
                                           bcs=bcs)
    spec = window.specs[0]
    assert spec.k == 16 and spec.deep
    data = torch.tensor(_data(grid.shape, 12))
    inputs = cc.AffineSideInputs(grid, bcs) if spec.has_sides else None
    sides = None if inputs is None else inputs.for_pass(F64, "cpu", _times(16))
    got = window(data, *((T0, 16) if window.needs_t else (16,)))
    assert torch.equal(got, cc.affine_laplace_2d_plain(data, spec, sides))


def test_c18_make_fused_euler_window_cyl():
    """make_fused_euler_window_cyl exists, with pde_tpu's default k = 16."""
    grid = _grid(tpde, "radial")
    window = cc.make_fused_euler_window_cyl(
        grid, diffusivity=0.1, dt=DT, bcs=grid.get_boundary_conditions(_bc("radial")))
    assert [s.k for s in window.specs] == [16, 8, 4, 2, 1]
    assert window.specs[0].dtype == torch.float32 and window.specs[0].deep
