"""bf16 storage in kernel #1 (ROADMAP B1(f)), serially, on the CPU: a bf16
pass loads bf16, steps in float32 with the float32 kernel's coefficients,
rounds every level to bf16 and stores bf16 (``round_level``).

- Each mode ``pde_tpu`` takes bf16 in (periodic; bounded rows with periodic
  columns, scalar sides and side inputs; the radial mode with z periodic,
  with and without side inputs): the same seeded bf16 input through
  ``pde_tpu``'s kernel in interpret mode and the port's plain version, within
  2**-6 of max|f| of each other, and within k * 2**-8 of max|f| of an fp64
  run; every level of the plain version is bf16 (a k-step pass equals k
  one-step passes); the march replay and the tile emulation equal the plain
  version bit for bit.
- The generated bf16 libraries and the side tables the passes read.
- The routes of ``DiffusionPDE`` solves: fused where ``pde_tpu`` fuses, the
  plain loop under the ``torch`` engine where it does not, and a refusal
  naming ``pde_tpu``'s gate under the ``cuda`` engine; and every gate that
  keeps refusing bf16, each with the line of ``pde_tpu``'s gate.
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

BF16 = torch.bfloat16
T0 = 0.3
DT = 0.1
B = 0.01  # dt * D of the passes: a = 1, b = 0.01


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


# id -> (grid class, arguments, keyword arguments, conditions or None, ks); 32x128
# grids of unit spacing, the columns (z) periodic
MODES = {
    "periodic": ("UnitGrid", ([32, 128],), {"periodic": True}, None, (1, 4, 12, 16)),
    "bounded rows": ("CartesianGrid", ([(0, 32), (0, 128)], [32, 128]), {"periodic": [False, True]},
                     lambda: {"x-": {"value": 0.3}, "x+": {"derivative": 0.1}, "y": "periodic"},
                     (1, 4, 12)),
    "bounded rows, side inputs": (
        "CartesianGrid", ([(0, 32), (0, 128)], [32, 128]), {"periodic": [False, True]},
        lambda: {"x-": {"value": 0.5 * np.sin(np.linspace(0.0, 6.0, 128))},
                 "x+": {"value_expression": "0.2*sin(3*t)"}, "y": "periodic"},
        (1, 3, cc.SIDES_TOP_STEPS)),
    "radial": ("CylindricalSymGrid", ((16, 48), (0, 128), (32, 128)), {"periodic_z": True},
               lambda: {"r-": {"value": 0.2}, "r+": {"derivative": 0}, "z": "periodic"},
               (1, 4, cc.RADIAL_TOP_STEPS)),
    "radial, side inputs": (
        "CylindricalSymGrid", ((16, 48), (0, 128), (32, 128)), {"periodic_z": True},
        lambda: {"r-": {"value_expression": "0.1*sin(3*t)"},
                 "r+": {"value": 0.5 * np.cos(np.linspace(0.0, 4.0, 128))}, "z": "periodic"},
        (1, 3, cc.RADIAL_SIDES_TOP_STEPS)),
}
CASES = [(mode, k) for mode, (*_, ks) in MODES.items() for k in ks]


def _grids(mode):
    cls, args, kwargs, make_bc, _ = MODES[mode]
    bc = None if make_bc is None else make_bc()
    return getattr(jpde, cls)(*args, **kwargs), getattr(tpde, cls)(*args, **kwargs), bc


def _data(shape, seed):
    """A seeded bf16 state in [-1, 1): the ml_dtypes array pde_tpu takes, and
    the same values as a torch bf16 tensor."""
    values = np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(jnp.bfloat16)
    return values, torch.tensor(values.astype(np.float32)).to(BF16)


def _times(k):
    return [T0 + s * DT for s in range(k)]


def _pass(mode, k, dtype=BF16):
    """The port's spec of a k-step pass on `dtype` data and its side inputs from T0."""
    _, tgrid, bc = _grids(mode)
    bcs = None if bc is None else tgrid.get_boundary_conditions(bc)
    spec = cc.affine_laplace_spec(tgrid, a=1.0, b=B, k=k, dtype=dtype, bcs=bcs)
    sides = None
    if spec.has_sides:
        sides = cc.AffineSideInputs(tgrid, bcs).for_pass(dtype, "cpu", _times(k))
    return spec, sides


def _jax_pass(mode, k, values):
    """pde_tpu's kernel #1 on bf16 data, in interpret mode (the radial mode on a
    cylinder; its side inputs' t-table from T0)."""
    jgrid, _, bc = _grids(mode)
    radial = None
    if MODES[mode][0] == "CylindricalSymGrid":
        radial = (float(jgrid.axes_bounds[0][0]), float(jgrid.discretization[0]))
    op = pc.make_affine_laplace_2d(
        jgrid, a=1.0, b=B, k=k, dtype=jnp.bfloat16,
        bcs=None if bc is None else jgrid.get_boundary_conditions(bc), interpret=True,
        radial=radial)
    if op.t_slots is None:
        return np.asarray(op(jnp.asarray(values)), dtype=np.float64)
    ts = jnp.asarray(_times(k))
    tab = jnp.stack([jnp.zeros_like(ts) if f is None else jax.vmap(f)(ts) for f in op.t_slots],
                    axis=1)
    return np.asarray(op(jnp.asarray(values), tab), dtype=np.float64)


@pytest.mark.parametrize("mode, k", CASES)
def test_plain_matches_jax_and_fp64(mode, k):
    values, data = _data((32, 128), seed=k)
    spec, sides = _pass(mode, k)
    got = cc.affine_laplace_2d_plain(data, spec, sides)
    assert got.dtype == BF16
    got = got.double().numpy()
    top = float(np.abs(values.astype(np.float64)).max())
    expected = _jax_pass(mode, k, values)
    spec64, sides64 = _pass(mode, k, torch.float64)
    exact = cc.affine_laplace_2d_plain(data.double(), spec64, sides64).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=k * 2**-8 * top)
    # pde_tpu's radial mode forms its row factors in bf16 (the row index and
    # the radius cast to the data's dtype, pde_tpu/ops/pallas_cartesian.py:
    # 215-219) and rounds each product to bf16, so at its deepest passes it
    # strays further from the fp64 run than the port (0.0214 against 0.0123 of
    # max|f| at k = 8): the two are held within 2**-6 of max|f| up to k = 2,
    # and beyond within k * 2**-7, what two results each within k * 2**-8 of
    # fp64 keep; the port is held no further from fp64 than pde_tpu
    radial = MODES[mode][0] == "CylindricalSymGrid"
    atol = max(2**-6, k * 2**-7) if radial else 2**-6
    np.testing.assert_allclose(got, expected, rtol=0, atol=atol * top)
    if radial:
        assert np.abs(got - exact).max() <= np.abs(expected - exact).max()


@pytest.mark.parametrize("mode", MODES)
def test_every_level_is_bf16(mode):
    """A pass of k steps equals k one-step passes: each level is rounded to
    bf16, so a result does not depend on the ladder."""
    k = MODES[mode][4][-1]
    _, data = _data((32, 128), seed=1)
    spec, sides = _pass(mode, k)
    deep = cc.affine_laplace_2d_plain(data, spec, sides)
    stepped = data
    _, tgrid, bc = _grids(mode)
    bcs = None if bc is None else tgrid.get_boundary_conditions(bc)
    inputs = None if sides is None else cc.AffineSideInputs(tgrid, bcs)
    for s in range(k):
        one = cc.affine_laplace_spec(tgrid, a=1.0, b=B, k=1, dtype=BF16, bcs=bcs)
        step_sides = None if inputs is None else inputs.for_pass(BF16, "cpu", [T0 + s * DT])
        stepped = cc.affine_laplace_2d_plain(stepped, one, step_sides)
        assert stepped.dtype == BF16
    torch.testing.assert_close(deep, stepped, rtol=0, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_replay_and_emulation_equal_plain(mode):
    """The march replay (the kernel's plan, and strips and chunks of 16 rows
    and columns whose windows hold NaN where the schedule leaves them) and
    the tile emulation hold the levels in float32, rounded to bf16, as the
    plain version does: bit for bit."""
    k = MODES[mode][4][1]
    _, data = _data((32, 128), seed=2)
    spec, sides = _pass(mode, k)
    plain = cc.affine_laplace_2d_plain(data, spec, sides)
    for plan in (None, (16, 16)):
        torch.testing.assert_close(cc.affine_laplace_2d_marched(data, spec, plan, sides), plain,
                                   rtol=0, atol=0)
    torch.testing.assert_close(cc.affine_laplace_2d_tiled(data, spec, (16, 8), sides), plain,
                               rtol=0, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_library_and_plan(mode):
    """A bf16 pass goes to a library of its own that holds the bf16 entry
    points alone (the float32 march at its plan, loading and storing
    __nv_bfloat16), and the float32 and float64 libraries stay as they were."""
    spec, _ = _pass(mode, 1)
    assert spec.compute_dtype == torch.float32 and spec.tile == cc.affine_row_plan(1, 4)
    library = cc.library_of(spec)
    unit = cc.kernel_source(spec.periodic, library, True)
    plain = cc.kernel_source(spec.periodic, library)
    assert unit is not plain and unit.digest != plain.digest and unit.suffixes == ("bf16",)
    assert f'extern "C" int {library}_bf16(' in unit.source
    assert "_f32(" not in unit.source and "_f64(" not in unit.source
    assert "__nv_bfloat16" not in plain.source
    tx, threads, prefetch, blocks = cc.affine_row_plan(1, 4)
    assert f"<float, 1, {tx}, {threads}, {prefetch}, {blocks}, " in unit.source
    assert unit.source.count("__nv_bfloat16>(") == unit.source.count("    case ")


def test_side_tables_hold_bf16_values():
    """The side tables and the t-table of a bf16 pass hold bf16-rounded values
    (pde_tpu casts them to the data's dtype, pde_tpu/ops/pallas_cartesian.py:
    932, 1221), in float32, the kernels' working type."""
    spec, sides = _pass("bounded rows, side inputs", 2)
    array = next(a for a in sides.arrays if a is not None)
    assert array.dtype == torch.float32
    torch.testing.assert_close(array, array.to(BF16).float(), rtol=0, atol=0)
    t = torch.tensor(sides.t, dtype=torch.float64)
    torch.testing.assert_close(t, t.to(BF16).double(), rtol=0, atol=0)
    exact = [0.2 * np.sin(3 * t) for t in _times(2)]
    assert [row[1] for row in sides.t] != exact
    with pytest.raises(ValueError, match="do not match"):  # float64 tables on bf16 data
        cc.affine_laplace_2d(torch.zeros(spec.shape, dtype=BF16), spec, sides=cc.AffineSides(
            tuple(None if a is None else a.double() for a in sides.arrays), sides.t))


# -- the routes of a solve ------------------------------------------------------------------
ROUTES = {
    # id -> (grid, conditions, whether pde_tpu fuses bf16 there)
    "periodic": (lambda p: p.UnitGrid([32, 128], periodic=True), "periodic", True),
    "bounded rows": (lambda p: p.UnitGrid([32, 128], periodic=[False, True]),
                     {"x": {"value": 0.1}, "y": "periodic"}, True),
    "cylinder, z periodic": (lambda p: p.CylindricalSymGrid((16, 48), (0, 128), (32, 128),
                                                            periodic_z=True),
                             {"r": {"derivative": 0}, "z": "periodic"}, True),
    "bounded columns": (lambda p: p.UnitGrid([32, 128], periodic=[True, False]),
                        {"x": "periodic", "y": {"value": 0.1}}, False),
    "cylinder, z bounded": (lambda p: p.CylindricalSymGrid((16, 48), (0, 128), (32, 128)),
                            {"r": {"derivative": 0}, "z": {"value": 0.1}}, False),
}


@pytest.mark.parametrize("route", ROUTES)
def test_solver_routes(route):
    """Under the torch engine a bf16 solve fuses where pde_tpu's gate takes
    bf16 (its window equal to the ladder of plain passes), and takes the plain
    loop elsewhere; the cuda engine refuses the rest, naming the gate."""
    make_grid, bc, fused = ROUTES[route]
    grid = make_grid(tpde)
    values, data = _data(grid.shape, seed=5)
    state = tpde.ScalarField(grid, values)
    assert state.dtype == BF16
    eq = tpde.DiffusionPDE(0.1, bc=bc)
    solver = tpde.ExplicitSolver(eq, backend="torch")
    stepper = solver.make_stepper(state, dt=DT)
    result, t = stepper(state, 0.0, 2.5)
    assert result.dtype == BF16 and t == pytest.approx(2.5)
    assert solver.info.get("fused_step", False) is fused
    if fused:
        window = eq.make_fused_euler_window(state, DT)
        torch.testing.assert_close(result.data, window(data, 25), rtol=0, atol=0)
    else:
        assert "B1(f)" in solver.info["fused_unsupported"]
        with pytest.raises(RuntimeError, match="B1\\(f\\)"):
            tpde.ExplicitSolver(eq, backend="cuda").make_stepper(state, dt=DT)


# -- what stays refused, as in pde_tpu --------------------------------------------------------
def _refusals():
    from pde_tpu_torch.ops import cuda_cartesian_3d as c3
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.ops import cuda_stencil_op_2d as so

    periodic = tpde.UnitGrid([16, 128], periodic=True)
    bounded = tpde.UnitGrid([16, 128], periodic=[True, False])
    cylinder = tpde.CylindricalSymGrid(1.0, (0, 2), (16, 128))
    cube = tpde.UnitGrid([8, 8, 8], periodic=True)

    def laplace(grid):
        return lambda h: (lambda works: [w + 0.01 * h.lap(w) for w in works])

    def corner():
        with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 1 / 3}):
            cc.affine_laplace_spec(periodic, a=1.0, b=B, k=1, dtype=BF16)

    return {
        "9-point #1 (:841-849)": (corner, "841-849"),
        "bounded columns #1 (:775-790, :889-899)": (
            lambda: cc.affine_laplace_spec(bounded, a=1.0, b=B, k=1, dtype=BF16,
                                           bcs=bounded.get_boundary_conditions(
                                               {"x": "periodic", "y": {"value": 0}})),
            "775-790, 889-899"),
        "cylinder, z bounded (:5455-5467)": (
            lambda: cc.affine_laplace_spec(cylinder, a=1.0, b=B, k=1, dtype=BF16,
                                           bcs=cylinder.get_boundary_conditions(
                                               {"r": {"derivative": 0}, "z": {"value": 0}})),
            "5455-5467"),
        "#2 (:1372)": (lambda: so.stencil_op_2d_spec(periodic, "gradient", dtype=BF16), "1372"),
        "#7 (:3815)": (lambda: cs.make_chunked_multi_window_2d(periodic, laplace(periodic), 1, 1,
                                                                dtype=BF16), "3815"),
        "#3 (:1495)": (lambda: c3.affine_laplace_3d_spec(cube, a=1.0, b=B, k=1, dtype=BF16),
                       "1495"),
        "#5 (:3044)": (lambda: s3.make_chunked_multi_window_3d(cube, laplace(cube), 1, 1,
                                                               dtype=BF16), "3044"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_refusals_name_pde_tpu_gates(case):
    call, line = _refusals()[case]
    with pytest.raises(tpde.KernelUnsupportedError, match=f"B1\\(f\\).*{line}"):
        call()
