"""Boundary values that vary along a side and in time on cylindrical grids,
serially: the side inputs of kernel #1's radial mode (the kernel
``affine_laplace_radial_sides_2d_kernel``, library
``RADIAL_SIDES_LIBRARY``), on the CPU, fp64.

- One pass at every k of the mode's ladder: the plain version against
  ``pde_tpu``'s ``make_affine_laplace_2d(radial=..., bcs=...)`` in interpret
  mode at 1e-12 of max|f|; the march replay at the kernel's plan and at small
  plans, and the tile emulation, against the plain version bit for bit (the
  radial table padded by RADIAL_PAD rows, the column sides' tables by
  SIDE_PAD rows: blocks whose first row is 0, inner blocks and the last).
- The serial window over 37 steps from t0 (``window(data, t0, steps)``: the
  ladder's remainders) against ``pde_tpu``'s window in interpret mode and
  against the plain loop; ``DiffusionPDE.solve`` under the ``torch`` engine
  fusing where ``pde_tpu`` fuses.
- The gate, the entry points, the doubles' order, the wrapper's checks, and
  the refusals that stay (consts varying in space and time, per-point and
  time-dependent ghost factors: the expression window's, as ``pde_tpu``
  routes them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops import pallas_cartesian as pc
from pde_tpu.solvers import EulerSolver as JaxEuler
from pde_tpu_torch.ops import cuda_cartesian as cc

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64
T0 = 0.3
DT = 0.01
KS = list(range(1, cc.RADIAL_SIDES_TOP_STEPS + 1))


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


# id -> (grid arguments, periodic z, conditions): a hole or r = 0, z periodic or
# bounded, per-point consts along r and along z, time-dependent consts
CASES = {
    "hole, periodic z, t on r-, an array on r+": (
        ((0.5, 2.0), (0, 3), (16, 32)), True, lambda: {
            "r-": {"value_expression": "0.1*sin(3*t)"},
            "r+": {"value": np.sin(np.linspace(0.0, 6.0, 32))}, "z": "periodic"}),
    "r = 0, bounded z, an array on z-, t on z+": (
        (2.0, (0, 3), (24, 16)), False, lambda: {
            "r": {"derivative": 0}, "z-": {"value": np.linspace(0.0, 1.0, 24)},
            "z+": {"derivative_expression": "cos(t)"}}),
    "hole, an array on r-, an expression array on z-": (
        ((1.0, 3.0), (0, 2), (16, 32)), False, lambda: {
            "r-": {"value": 0.5 + 0.25 * np.cos(np.linspace(0.0, 4.0, 32))},
            "r+": {"derivative": 0}, "z-": {"value": "r**2"},
            "z+": {"value_expression": "t"}}),
    "r = 0, periodic z, t on r+": (
        (1.0, (0, 2), (16, 16)), True, lambda: {
            "r-": {"derivative": 0}, "r+": {"value_expression": "sin(t)"}, "z": "periodic"}),
}


def _grids(case):
    args, periodic_z, make_bc = CASES[case]
    return (jpde.CylindricalSymGrid(*args, periodic_z=periodic_z),
            tpde.CylindricalSymGrid(*args, periodic_z=periodic_z), make_bc())


def _data(grid, seed=0):
    return np.random.default_rng(seed).uniform(0.2, 0.8, size=grid.shape)


def _times(k, t0=T0):
    return [t0 + s * DT for s in range(k)]


def _pass(case, k, b=0.005):
    """(pde_tpu grid, port grid, conditions, spec, the pass's side inputs from T0)."""
    jgrid, tgrid, bc = _grids(case)
    bcs = tgrid.get_boundary_conditions(bc)
    spec = cc.affine_laplace_spec(tgrid, a=1.0, b=b, k=k, dtype=F64, bcs=bcs)
    sides = cc.AffineSideInputs(tgrid, bcs).for_pass(F64, "cpu", _times(k))
    return jgrid, tgrid, bc, spec, sides


def _jax_pass(jgrid, bc, k, data, b=0.005):
    """pde_tpu's radial pass with its side inputs, in interpret mode."""
    op = pc.make_affine_laplace_2d(
        jgrid, a=1.0, b=b, k=k, dtype=np.float64, bcs=jgrid.get_boundary_conditions(bc),
        interpret=True, radial=(float(jgrid.axes_bounds[0][0]), float(jgrid.discretization[0])))
    if op.t_slots is None:
        return np.asarray(op(data))
    ts = jnp.asarray(_times(k))
    tab = jnp.stack([jnp.zeros_like(ts) if f is None else jax.vmap(f)(ts) for f in op.t_slots],
                    axis=1)
    return np.asarray(op(data, tab))


@pytest.mark.parametrize("case", CASES)
def test_spec_library_and_doubles(case):
    """The gate takes the sides in the radial mode; the pass goes to a
    library of its own whose entry points go up to RADIAL_SIDES_TOP_STEPS,
    and its doubles are the 16, the radial constants, then the t-table."""
    _, tgrid, _, spec, sides = _pass(case, 3)
    assert spec.radial == (float(tgrid.axes_bounds[0][0]), float(tgrid.discretization[0]))
    assert spec.has_sides and spec.periodic == (False, CASES[case][1])
    assert cc.library_of(spec) == cc.RADIAL_SIDES_LIBRARY == "affine_laplace_radial_sides_2d"
    unit = cc.kernel_source(spec.periodic, cc.library_of(spec))
    assert unit.radial and unit.digest != cc.kernel_source(spec.periodic, cc.RADIAL_LIBRARY).digest
    top = cc.RADIAL_SIDES_TOP_STEPS
    assert top <= min(cc.RADIAL_TOP_STEPS, cc.SIDES_TOP_STEPS)
    tx, threads, prefetch, blocks = cc.affine_row_plan(top, 8)
    assert (f"case {top}: return pde_tpu_torch::launch_affine_radial_sides_2d<double, {top}, "
            f"{tx}, {threads}, {prefetch}, {blocks}, {str(CASES[case][1]).lower()}>(in, out, "
            "rows, arrays, ints, doubles, stream);" in unit.source)
    assert f"case {top + 1}: " not in unit.source
    doubles = list(cc.step_doubles(spec, sides))
    assert len(doubles) == 18 + 4 * spec.k
    assert doubles[16:18] == list(cc.radial_constants(spec))
    assert sides.t is not None and doubles[18:] == [v for row in sides.t for v in row]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(case, k):
    jgrid, _, bc, spec, sides = _pass(case, k)
    data = _data(jgrid, k)
    expected = _jax_pass(jgrid, bc, k, data)
    got = cc.affine_laplace_2d_plain(torch.tensor(data), spec, sides)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-12 * np.abs(expected).max())
    # the wrapper's CPU path is the plain version, and counts no launch
    launches = cc.affine_laplace_2d.radial_sides_launches
    torch.testing.assert_close(cc.affine_laplace_2d(torch.tensor(data), spec, sides=sides), got,
                               rtol=0, atol=0)
    assert cc.affine_laplace_2d.radial_sides_launches == launches


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
def test_march_replay_is_the_plain_pass(case, k):
    """The march replay (the kernel's schedule, NaN where it has not written)
    at the kernel's plan and at plans whose chunks start at row 0, inside
    and at the last rows, and the tile emulation, equal the plain version
    bit for bit."""
    _, tgrid, _, spec, sides = _pass(case, k)
    data = torch.tensor(_data(tgrid, 10 + k))
    plain = cc.affine_laplace_2d_plain(data, spec, sides)
    for plan in (None, (8, 5), (16, 7)):
        assert torch.equal(cc.affine_laplace_2d_marched(data, spec, plan, sides), plain)
    assert torch.equal(cc.affine_laplace_2d_tiled(data, spec, (8, 5), sides), plain)


@pytest.mark.parametrize("case", CASES)
def test_window_from_t0_matches_jax_and_the_plain_loop(case, monkeypatch):
    """37 steps (the ladder's passes and its remainders) from t0: the port's window
    against pde_tpu's fused window in interpret mode and against k = 1
    plain passes at the steps' times."""
    jgrid, tgrid, bc = _grids(case)
    bcs = tgrid.get_boundary_conditions(bc)
    window = cc.make_fused_euler_window_2d(tgrid, diffusivity=0.1, dt=DT, dtype=F64, bcs=bcs)
    top = cc.RADIAL_SIDES_TOP_STEPS
    assert [s.k for s in window.specs] == [top >> i for i in range(top.bit_length())]
    assert all(s.radial is not None and s.has_sides for s in window.specs)
    data = _data(tgrid, 3)
    args = (T0, 37) if window.needs_t else (37,)
    got = window(torch.tensor(data), *args)
    inputs = cc.AffineSideInputs(tgrid, bcs)
    step = cc.affine_laplace_spec(tgrid, a=1.0, b=DT * 0.1, k=1, dtype=F64, bcs=bcs)
    ref = torch.tensor(data)
    for i in range(37):
        ref = cc.affine_laplace_2d_plain(ref, step, inputs.for_pass(F64, "cpu", [T0 + i * DT]))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jwindow = pc.make_fused_euler_window_2d(jgrid, diffusivity=0.1, dt=DT, dtype=np.float64,
                                            bcs=jgrid.get_boundary_conditions(bc),
                                            interpret=True)
    assert bool(getattr(jwindow, "needs_t", False)) == window.needs_t
    expected = np.asarray(jwindow(jnp.asarray(data), *args))
    np.testing.assert_allclose(got.numpy(), expected, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_solve_fuses_where_pde_tpu_fuses(case, monkeypatch):
    """DiffusionPDE.solve on the cylinder: fused under the torch engine with
    no fused_unsupported, as pde_tpu's solve in interpret mode, at 1e-12."""
    jgrid, tgrid, bc = _grids(case)
    data = _data(tgrid, 4)
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PDE_TPU_DISABLE_FUSED", raising=False)
    jfield = jpde.ScalarField(jgrid, data)
    jsolver = JaxEuler(jpde.DiffusionPDE(0.1, bc=bc))
    expected, _ = jsolver.make_stepper(jfield, DT)(jfield, T0, T0 + 13 * DT)
    assert jsolver.info.get("fused_step") is True
    state = tpde.ScalarField(tgrid, data, dtype=F64)
    got, info = tpde.DiffusionPDE(0.1, bc=bc).solve(state, t_range=[T0, T0 + 13 * DT], dt=DT,
                                                    tracker=None, backend="torch",
                                                    ret_info=True)
    assert info["solver"].get("fused_step") is True
    assert "fused_unsupported" not in info["solver"]
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)


# the refusals that stay: kernel #1 takes no consts varying in space and time and
# no per-point or time-dependent ghost factors; the expression window (#7's
# radial helpers) takes them, as pde_tpu routes them
REFUSED = {
    "space and time": {"r": {"derivative": 0}, "z-": {"value_expression": "sin(r - t)"},
                       "z+": {"value": 0}},
    "time-dependent robin factor": {"r-": {"derivative": 0},
                                    "r+": {"mixed_expression": "1 + t", "const": 0.2},
                                    "z": {"derivative": 0}},
    "per-point robin factor": {"r-": {"derivative": 0},
                               "r+": {"mixed": "1 + z", "const": 0.1}, "z": {"derivative": 0}},
}


@pytest.mark.parametrize("refused", REFUSED)
def test_what_stays_refused_goes_to_the_expression_window(refused, monkeypatch):
    bc = REFUSED[refused]
    jgrid = jpde.CylindricalSymGrid(1.0, (0, 2), (16, 16))
    tgrid = tpde.CylindricalSymGrid(1.0, (0, 2), (16, 16))
    bcs = tgrid.get_boundary_conditions(bc)
    with pytest.raises(tpde.KernelUnsupportedError, match="kernel #7"):
        cc.affine_laplace_spec(tgrid, a=1.0, b=1e-3, k=2, dtype=F64, bcs=bcs)
    assert not pc.supports_affine_laplace_cyl(jgrid, jgrid.get_boundary_conditions(bc),
                                              np.float64)
    state = tpde.ScalarField(tgrid, _data(tgrid, 5), dtype=F64)
    window = tpde.DiffusionPDE(0.1, bc=bc).make_fused_euler_window(state, 1e-3)
    assert window.program.sides is not None  # #7's radial helpers with its side inputs
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    jfield = jpde.ScalarField(jgrid, _data(tgrid, 5))
    jsolver = JaxEuler(jpde.DiffusionPDE(0.1, bc=bc))
    expected, _ = jsolver.make_stepper(jfield, 1e-3)(jfield, 0.1, 0.105)
    got, info = tpde.DiffusionPDE(0.1, bc=bc).solve(state, t_range=[0.1, 0.105], dt=1e-3,
                                                    tracker=None, backend="torch",
                                                    ret_info=True)
    assert info["solver"].get("fused_step") is True and jsolver.info.get("fused_step") is True
    np.testing.assert_allclose(got.data.numpy(), np.asarray(expected.data), **TOL)


def test_gate_checks_and_wrapper_checks():
    """Passes deeper than RADIAL_SIDES_TOP_STEPS take the deep march's
    library of the mode (C18); a cylinder with scalar sides keeps the scalar radial library and its
    RADIAL_TOP_STEPS; the wrapper refuses missing or mismatched inputs."""
    case = "r = 0, bounded z, an array on z-, t on z+"
    _, tgrid, bc = _grids(case)
    bcs = tgrid.get_boundary_conditions(bc)
    deep = cc.affine_laplace_spec(tgrid, a=1.0, b=1e-3, k=cc.RADIAL_SIDES_TOP_STEPS + 1,
                                  dtype=F64, bcs=bcs)
    assert deep.deep and cc.library_of(deep) == cc.deep_library(cc.RADIAL_SIDES_LIBRARY)
    scalar = cc.affine_laplace_spec(
        tgrid, a=1.0, b=1e-3, k=cc.RADIAL_TOP_STEPS, dtype=F64,
        bcs=tgrid.get_boundary_conditions({"r": {"derivative": 0}, "z": {"value": 0}}))
    assert not scalar.has_sides and cc.library_of(scalar) == cc.RADIAL_LIBRARY
    assert len(cc.step_doubles(scalar)) == 18
    _, _, _, spec, sides = _pass(case, 3)
    data = torch.tensor(_data(tgrid))
    with pytest.raises(ValueError, match="give them"):
        cc.affine_laplace_2d(data, spec)
    with pytest.raises(ValueError, match="t-table of 3 steps"):
        cc.affine_laplace_2d(data, spec, sides=cc.AffineSides(sides.arrays, sides.t[:2]))
    with pytest.raises(ValueError, match="do not match"):
        cc.affine_laplace_2d(data, spec, sides=cc.AffineSides((None,) * 4, sides.t))
    op = cc.make_affine_laplace_2d(tgrid, a=1.0, b=0.005, k=3, dtype=F64, bcs=bcs)
    assert op.k == 3 and op.t_slots is not None
    with pytest.raises(ValueError, match="give its 3 times"):
        op(data)
    torch.testing.assert_close(op(data, times=_times(3)),
                               cc.affine_laplace_2d_plain(data, spec, sides), rtol=0, atol=0)
