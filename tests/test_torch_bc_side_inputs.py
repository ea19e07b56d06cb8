"""Boundary values that vary in time and space, the kernel layer: the side
specs (``affine_bc_specs`` with expression, array and time-dependent parts,
``collect_bc_side_inputs``), kernel #1's side inputs (B1(c): per-point consts
and a per-pass t-table) and kernel #7's (B2(b): per-point consts and
factors, time-dependent consts and factors per step and RK4 stage, consts
varying in space and time), each through its plain version and the replays
of its march and tiles, the windows that take the time (``needs_t``), the
routing and refusals, and the library's hash. Held against ``pde_tpu``'s
kernels in interpret mode and its solves on the CPU in fp64 at 1e-12, the
replays against the plain versions at rtol = atol = 0.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops import pallas_cartesian as pc
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_stencil_2d as cs

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64
SHAPE = (12, 14)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _grids(periodic=(False, False)):
    args = ([(0, 1), (0, 2)], SHAPE)
    return (jpde.CartesianGrid(*args, periodic=list(periodic)),
            tpde.CartesianGrid(*args, periodic=list(periodic)))


def _data(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).uniform(0.2, 0.8, size=shape)


# -- the specs --------------------------------------------------------------------------------
SPEC_BCS = {
    "t consts": {"x-": {"value_expression": "sin(3*t)"}, "x+": {"derivative_expression": "cos(t)"},
                 "y": {"derivative": 0}},
    "arrays": {"x-": {"value": np.linspace(-1, 1, SHAPE[1])}, "x+": {"curvature": "sin(y)"},
               "y-": {"value": "x**2"}, "y+": {"mixed": "1 + x", "const": 0.3}},
    "xt and t factor": {"x": {"derivative": 0}, "y-": {"value_expression": "sin(x - 2*t)"},
                        "y+": {"mixed_expression": "1 + t", "const": "x"}},
    "space expressions": {"x-": {"value_expression": "y**2"}, "x+": {"virtual_point": "value + y"},
                          "y-": {"mixed_expression": "2 + x", "const": "x"},
                          "y+": {"derivative_expression": "3"}},
}


@pytest.mark.parametrize("case", SPEC_BCS)
def test_side_specs_match_jax(case):
    jgrid, tgrid = _grids()
    bc = SPEC_BCS[case]
    jspecs = pc.affine_bc_specs(jgrid, jgrid.get_boundary_conditions(bc))
    tspecs = cc.affine_bc_specs(tgrid, tgrid.get_boundary_conditions(bc))
    times = torch.tensor([0.0, 0.3, 1.7], dtype=F64)
    for jpair, tpair in zip(jspecs, tspecs, strict=True):
        for j, t in zip(jpair, tpair, strict=True):
            for attr in ("f1", "f2", "const_static"):
                np.testing.assert_allclose(np.asarray(getattr(t, attr), dtype=float).reshape(-1),
                                           np.asarray(getattr(j, attr), dtype=float).reshape(-1),
                                           **TOL)
            for attr in ("const_t", "f1_t"):
                assert (getattr(t, attr) is None) == (getattr(j, attr) is None)
                if getattr(j, attr) is None:
                    continue
                for s in times.tolist():
                    assert getattr(t, attr)(s) == pytest.approx(float(getattr(j, attr)(s)),
                                                                rel=1e-13, abs=1e-15)
                np.testing.assert_allclose(getattr(t, attr)(times).numpy(),
                                           [float(getattr(j, attr)(s)) for s in times.tolist()],
                                           **TOL)
            assert (t.const_xt is None) == (j.const_xt is None)
            if j.const_xt is not None:
                got = t.const_xt(times, "cpu").numpy()
                for row, s in zip(got, times.tolist(), strict=True):
                    np.testing.assert_allclose(row, np.asarray(j.const_xt(s)), **TOL)
    jin = pc.collect_bc_side_inputs({("c", "laplace"): jspecs})
    tin = cc.collect_bc_side_inputs({("c", "laplace"): tspecs})
    assert {k: len(v) for k, v in tin.items()} == {k: len(v) for k, v in jin.items()}
    for key in ("arrays", "xt", "factors"):
        assert [entry[0] for entry in tin[key]] == [entry[0] for entry in jin[key]]
    assert [attr for _, attr in tin["t"]] == [attr for _, attr in jin["t"]]


def test_side_specs_refuse_what_pde_tpu_refuses():
    _, grid = _grids()
    for bc, match in (({"x-": {"virtual_point": "value**2"}}, "coefficient varies"),
                      ({"x-": {"mixed_expression": "y*t"}}, "time and space"),
                      ({"x-": {"value_expression": "y", "value_cell": 2}}, "value_cell"),
                      ({"x-": {"value": lambda adj, dx, x, y, t: t}}, "Callable")):
        bcs = grid.get_boundary_conditions({**bc, "x+": {"derivative": 0}, "y": "auto_periodic_neumann"})
        with pytest.raises(tpde.KernelUnsupportedError, match=match):
            cc.affine_bc_specs(grid, bcs)
    assert cc.collect_bc_side_inputs({0: cc.affine_bc_specs(
        grid, grid.get_boundary_conditions({"value": 1.5}))}) is None


# -- kernel #1 (B1(c)) --------------------------------------------------------------------------
AFFINE_BCS = {
    "hardware": ((False, False), lambda: {
        "x-": {"value": np.sin(np.linspace(0, 2 * np.pi, SHAPE[1]))}, "x+": {"derivative": 0},
        "y-": {"value_expression": "sin(3*t)"}, "y+": {"derivative": 0}}),
    "periodic rows": ((True, False), lambda: {
        "x": "periodic", "y-": {"value": "sin(2*pi*x)"}, "y+": {"derivative_expression": "t"}}),
    "periodic columns": ((False, True), lambda: {
        "x-": {"value_expression": "cos(t) + 1"}, "x+": {"value": "y/2"}, "y": "periodic"}),
}


def _affine(case, k, dtype=F64):
    periodic, make_bc = AFFINE_BCS[case]
    jgrid, tgrid = _grids(periodic)
    bc = make_bc()
    spec = cc.affine_laplace_spec(tgrid, a=1.0, b=0.005, k=k, dtype=dtype,
                                  bcs=tgrid.get_boundary_conditions(bc))
    inputs = cc.AffineSideInputs(tgrid, tgrid.get_boundary_conditions(bc))
    times = [0.3 + 0.01 * s for s in range(k)]
    return jgrid, tgrid, bc, spec, inputs.for_pass(dtype, "cpu", times), times


@pytest.mark.parametrize("case", AFFINE_BCS)
def test_affine_plain_with_side_inputs_matches_jax(case):
    import jax
    import jax.numpy as jnp

    k = 4
    jgrid, _, bc, spec, sides, times = _affine(case, k)
    assert spec.has_sides
    jop = pc.make_affine_laplace_2d(jgrid, a=1.0, b=0.005, k=k, dtype=np.float64,
                                    bcs=jgrid.get_boundary_conditions(bc), interpret=True)
    data = _data(1)
    if jop.t_slots is None:
        expected = np.asarray(jop(data))
    else:
        ts = jnp.asarray(times)
        tab = jnp.stack([jnp.zeros_like(ts) if f is None else jax.vmap(f)(ts)
                         for f in jop.t_slots], axis=1)
        expected = np.asarray(jop(data, tab))
    got = cc.affine_laplace_2d_plain(torch.tensor(data), spec, sides).numpy()
    np.testing.assert_allclose(got, expected, **TOL)


@pytest.mark.parametrize("case", AFFINE_BCS)
@pytest.mark.parametrize("k", [3, cc.SIDES_TOP_STEPS])
def test_affine_replays_with_side_inputs(case, k):
    """The tiles' emulation and the march's replay read the side inputs
    where the kernel reads them: equal to the plain version, bit for bit."""
    _, _, _, spec, sides, _ = _affine(case, k)
    data = torch.tensor(_data(2))
    plain = cc.affine_laplace_2d_plain(data, spec, sides)
    for tile in (8, (8, 5)):
        assert torch.equal(cc.affine_laplace_2d_tiled(data, spec, tile, sides), plain)
    for plan in ((8, 8), (8, 3), None):
        assert torch.equal(cc.affine_laplace_2d_marched(data, spec, plan, sides), plain)


def test_affine_window_from_t0_is_the_plain_loop():
    """The t-table of each pass of a ladder window from t0 != 0 holds the
    times t0 + i*dt of its steps: the window equals the plain loop."""
    _, tgrid = _grids()
    bc = AFFINE_BCS["hardware"][1]()
    eq = tpde.DiffusionPDE(0.1, bc=bc)
    state = tpde.ScalarField(tgrid, _data(3), dtype=F64)
    window = eq.make_fused_euler_window(state, 1e-3)
    assert window.needs_t and window.specs[0].has_sides
    fused, info = eq.solve(state, t_range=[0.37, 0.37 + 31e-3], dt=1e-3, tracker=None,
                           backend="torch", ret_info=True)
    assert info["solver"]["fused_step"]
    plain = eq.solve(state, t_range=[0.37, 0.37 + 31e-3], dt=1e-3, tracker=None,
                     backend="numpy")
    np.testing.assert_allclose(fused.data.numpy(), plain.data.numpy(), **TOL)


def test_affine_gates():
    """What kernel #1 leaves to others: the expression window takes consts
    varying in space and time and per-point or time-dependent factors (as
    pde_tpu routes them); the radial mode takes the side inputs in a library
    of its own, up to RADIAL_SIDES_TOP_STEPS steps a pass, and the deep
    march's library past that; the window's ladder tops where it did."""
    _, tgrid = _grids()
    for bc in ({"y-": {"value_expression": "sin(x - t)"}, "y+": {"derivative": 0},
                "x": {"derivative": 0}},
               {"x-": {"mixed": "1 + y"}, "x+": {"derivative": 0}, "y": {"derivative": 0}},
               {"x-": {"mixed_expression": "t"}, "x+": {"derivative": 0}, "y": {"derivative": 0}}):
        bcs = tgrid.get_boundary_conditions(bc)
        with pytest.raises(tpde.KernelUnsupportedError, match="kernel #7"):
            cc.affine_laplace_spec(tgrid, a=1.0, b=0.1, k=2, dtype=F64, bcs=bcs)
        state = tpde.ScalarField(tgrid, _data(4), dtype=F64)
        window = tpde.DiffusionPDE(0.1, bc=bc).make_fused_euler_window(state, 1e-3)
        assert window.program.sides is not None  # rerouted to kernel #7
    cylinder = tpde.CylindricalSymGrid(2.0, (0, 3), (12, 10))
    timed = {"r": {"value_expression": "sin(t)"}, "z": {"derivative": 0}}
    spec = cc.affine_laplace_spec(cylinder, a=1.0, b=0.1, k=2, dtype=F64,
                                  bcs=cylinder.get_boundary_conditions(timed))
    assert spec.radial is not None and spec.side_t == (True, True, False, False)
    assert cc.library_of(spec) == cc.RADIAL_SIDES_LIBRARY
    # deeper passes take the deep march's radial side-input library (C18)
    deep = cc.affine_laplace_spec(cylinder, a=1.0, b=0.1, k=cc.RADIAL_SIDES_TOP_STEPS + 1,
                                  dtype=F64, bcs=cylinder.get_boundary_conditions(timed))
    assert deep.deep and cc.library_of(deep) == cc.deep_library(cc.RADIAL_SIDES_LIBRARY)
    with pytest.raises(ValueError, match="side inputs"):
        spec = _affine("hardware", 2)[3]
        cc.affine_laplace_2d(torch.tensor(_data(5)), spec)
    deep = _affine("hardware", cc.SIDES_TOP_STEPS + 1)[3]
    assert deep.deep and cc.library_of(deep) == cc.deep_library(cc.SIDES_LIBRARY)
    window = tpde.DiffusionPDE(0.1, bc=AFFINE_BCS["hardware"][1]()).make_fused_euler_window(
        tpde.ScalarField(_grids()[1], _data(5), dtype=F64), 1e-3)
    assert [spec.k for spec in window.specs] == [6, 3, 1]


# -- kernel #7 (B2(b)) ---------------------------------------------------------------------------
MULTI_BCS = {
    "t sides": ((False, False), {"x": {"derivative": 0}, "y-": {"value_expression": "sin(3*t)"},
                                 "y+": {"derivative_expression": "0.5*cos(t)"}}),
    "xt and arrays": ((False, False), {
        "x-": {"value": np.linspace(-1, 1, SHAPE[1])}, "x+": {"derivative_expression": "cos(t)"},
        "y-": {"value_expression": "sin(x - 2*t)"}, "y+": {"mixed": "1 + x", "const": 0.3}}),
    "periodic rows, t factor": ((True, False), {
        "x": "periodic", "y-": {"value_expression": "sin(x - 2*t)"},
        "y+": {"mixed_expression": "1 + t", "const": "x"}}),
    "periodic columns": ((False, True), {
        "x-": {"value_expression": "cos(y + t)"}, "x+": {"value": "sin(y)"}, "y": "periodic"}),
}
RHS = "0.1 * laplace(c) - c**3 + 0.1 * gradient_squared(c)"


def _window(case, kind="euler", rhs=RHS, dt=1e-3):
    periodic, bc = MULTI_BCS[case]
    _, tgrid = _grids(periodic)
    state = tpde.ScalarField(tgrid, _data(6), dtype=F64)
    eq = tpde.PDE({"c": rhs}, bc=bc)
    return getattr(eq, f"make_fused_{kind}_window")(state, dt), state


@pytest.mark.parametrize("case, kind", [(case, "euler") for case in MULTI_BCS]
                         + [("xt and arrays", "rk4")])
def test_multi_replays_with_side_inputs(case, kind):
    """The march's replay and the square window's tiles read the program's
    side inputs where the kernel does (every ladder k, several plans):
    equal to the plain version, bit for bit."""
    window, state = _window(case, kind)
    program = window.program
    assert program.sides is not None and window.needs_t == program.sides.needs_t
    for spec in window.specs:
        block = program.sides.block(0.2, 0, spec.k + 2, 1e-3, F64, "cpu")
        views = program.sides.for_pass(F64, "cpu", spec.k, block, 2)
        plain = cs.multi_stencil_2d_plain([state.data], spec, views)
        for plan in ((8, 5), (256, None)):
            assert torch.equal(cs.multi_stencil_2d_marched([state.data], spec, plan, views)[0],
                               plain[0])
        assert torch.equal(cs.tiled_pass([state.data], spec, 8, sides=views)[0], plain[0])


@pytest.mark.parametrize("case, solver", [("t sides", "runge-kutta"), ("xt and arrays", "euler"),
                                          ("periodic rows, t factor", "adams-bashforth")])
def test_multi_windows_match_jax(case, solver, monkeypatch):
    """The windows' plain versions against pde_tpu's windows in interpret mode
    (its kernel #7 with the same side inputs), from t = 0.3."""
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    periodic, bc = MULTI_BCS[case]
    out = []
    for pkg, grid in zip((jpde, tpde), _grids(periodic), strict=True):
        state = pkg.ScalarField(grid, _data(7)) if pkg is jpde else \
            pkg.ScalarField(grid, _data(7), dtype=F64)
        res, info = pkg.PDE({"c": RHS}, bc=bc).solve(
            state, t_range=[0.3, 0.3 + 4e-3], dt=1e-3, tracker=None, solver=solver,
            ret_info=True, **({} if pkg is jpde else {"backend": "torch"}))
        assert info["solver"].get("fused_step")
        out.append(np.asarray(res.data) if pkg is jpde else res.data.numpy())
    np.testing.assert_allclose(out[1], out[0], **TOL)


@pytest.mark.parametrize("scheme", [("euler", "euler"), ("rk4", "runge-kutta"),
                                    ("ab2", "adams-bashforth")])
def test_windows_over_chunks_and_tracker_windows(scheme, monkeypatch):
    """A window's tables evaluated a block of steps at a time, over several
    blocks, and tracker windows starting where the last ended: the plain
    loop's result, its steps at the same times (RK4: its stages at t, t +
    dt/2, t + dt)."""
    monkeypatch.setattr(cs, "SIDE_BLOCK", 3)
    kind, solver = scheme
    periodic, bc = MULTI_BCS["xt and arrays"]
    _, tgrid = _grids(periodic)
    state = tpde.ScalarField(tgrid, _data(8), dtype=F64)
    eq = tpde.PDE({"c": RHS}, bc=bc)
    tracker = tpde.trackers.ConsistencyTracker(interrupts=0.004)
    fused, info = eq.solve(state, t_range=[0.3, 0.3 + 13e-3], dt=1e-3, tracker=tracker,
                           solver=solver, backend="torch", ret_info=True)
    assert info["solver"]["fused_step"]
    plain = eq.solve(state, t_range=[0.3, 0.3 + 13e-3], dt=1e-3, tracker=tracker,
                     solver=solver, backend="numpy")
    np.testing.assert_allclose(fused.data.numpy(), plain.data.numpy(), **TOL)


def test_cahn_hilliard_model_window_takes_side_inputs():
    periodic, bc = MULTI_BCS["t sides"]
    out = []
    for pkg, grid in zip((jpde, tpde), _grids(periodic), strict=True):
        state = pkg.ScalarField(grid, _data(9)) if pkg is jpde else \
            pkg.ScalarField(grid, _data(9), dtype=F64)
        eq = pkg.CahnHilliardPDE(0.01, bc_c=bc, bc_mu=bc)
        kwargs = {} if pkg is jpde else {"backend": "torch"}
        res, info = eq.solve(state, t_range=[0.3, 0.3 + 4e-5], dt=1e-5, tracker=None,
                             ret_info=True, **kwargs)
        out.append(np.asarray(res.data) if pkg is jpde else res.data.numpy())
    assert info["solver"]["fused_step"]
    np.testing.assert_allclose(out[1], out[0], **TOL)


def test_library_hash_depends_on_the_kinds_only():
    """The generated source names the side inputs' kinds, never their values:
    solves of the same form with other expressions or arrays share one
    library (no rebuild), and a scalar-BC program's source is the one it had
    without side inputs."""
    _, tgrid = _grids()
    state = tpde.ScalarField(tgrid, _data(10), dtype=F64)

    def digest(y_minus, x_minus):
        bc = {"x-": {"value": x_minus}, "x+": {"derivative": 0},
              "y-": {"value_expression": y_minus}, "y+": {"derivative_expression": "0.5"}}
        return tpde.PDE({"c": RHS}, bc=bc).make_fused_euler_window(state, 1e-3).program.digest

    first = digest("sin(3*t)", np.linspace(0, 1, SHAPE[1]))
    assert digest("2*cos(t) + t**2", np.linspace(-3, 1, SHAPE[1])) == first
    assert digest("sin(x - t)", np.linspace(0, 1, SHAPE[1])) != first  # another kind (xt)
    units = {cc.kernel_source(spec.periodic, cc.library_of(spec)).digest
             for case in ("hardware",) for k in (1, 2)
             for spec in [_affine(case, k)[3]]}
    assert units == {cc.kernel_source((False, False), cc.SIDES_LIBRARY).digest}


# -- refusals under cuda, the plain loop under torch -----------------------------------------------
def test_unported_side_inputs_raise_under_cuda_and_fall_back_under_torch():
    """Every window of the port takes side inputs now: decomposed 2D windows
    (#12 and #8, A9.3), SDE windows (#9/#10) and the 3D windows (#5/#4,
    serially and on a mesh #6): the torch engine fuses them, the cuda engine
    asks for the card. What pde_tpu refuses still raises under cuda and runs
    the plain loop under torch: a 3D SDE window, here with a face in time."""
    timed = {"x-": {"value_expression": "sin(3*t)"}, "x+": {"derivative": 0},
             "y": {"derivative": 0}}
    timed_3d = {**timed, "z": {"derivative": 0}}
    _, tgrid = _grids()
    cube = tpde.UnitGrid([8, 8, 8])
    cases = [
        (lambda p: p.PDE({"c": RHS}, bc=timed), tgrid, {"decomposition": [2, 2]}, None),
        (lambda p: p.DiffusionPDE(0.1, bc=timed), tgrid, {"decomposition": [2, 2]}, None),
        (lambda p: p.PDE({"c": "laplace(c)"}, bc=timed_3d), cube, {}, None),
        (lambda p: p.DiffusionPDE(0.1, bc=timed_3d), cube, {"decomposition": [2, 1, 1]}, None),
        (lambda p: p.DiffusionPDE(0.1, bc=timed_3d, noise=0.1, rng=np.random.default_rng(2)),
         cube, {}, "3D SDE"),
    ]
    for make_eq, grid, kwargs, match in cases:
        state = tpde.ScalarField(grid, _data(11, grid.shape), dtype=F64)
        with pytest.raises(RuntimeError, match=match or "CUDA device"):
            tpde.EulerSolver(make_eq(tpde), backend="cuda", **kwargs).make_stepper(state, dt=1e-3)
        solver = tpde.EulerSolver(make_eq(tpde), backend="torch", **kwargs)
        solver.make_stepper(state, dt=1e-3)
        assert ("fused_step" in solver.info) == (match is None)
    sde_eq = tpde.DiffusionPDE(0.1, bc=timed, noise=0.1, rng=np.random.default_rng(1))
    state = tpde.ScalarField(tgrid, _data(11, tgrid.shape), dtype=F64)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tpde.EulerSolver(sde_eq, backend="cuda").make_stepper(state, dt=1e-3)
    solver = tpde.EulerSolver(sde_eq, backend="torch")
    solver.make_stepper(state, dt=1e-3)
    assert solver.info["fused_step"] and "fused_unsupported" not in solver.info
    # the torch engine's plain loop on a mesh against pde_tpu's decomposed run
    out = []
    for pkg, grid in zip((jpde, tpde), _grids(), strict=True):
        state = pkg.ScalarField(grid, _data(12)) if pkg is jpde else \
            pkg.ScalarField(grid, _data(12), dtype=F64)
        res = pkg.PDE({"c": RHS}, bc=timed).solve(
            state, t_range=[0.3, 0.305], dt=1e-3, tracker=None, decomposition=[2, 2],
            **({} if pkg is jpde else {"backend": "torch"}))
        out.append(np.asarray(res.data) if pkg is jpde else res.data.numpy())
    np.testing.assert_allclose(out[1], out[0], **TOL)


def test_registry_laplace_takes_side_inputs():
    """The cuda registry's ``laplace`` (kernel #1 at k = 1, as pde_tpu's
    ``make_laplace_pallas``) at the call's time."""
    _, tgrid = _grids()
    bc = AFFINE_BCS["hardware"][1]()
    op = tpde.get_backend("cuda").make_operator(tgrid, "laplace", bc)
    plain = tgrid.make_operator("laplace", bc)
    data = torch.tensor(_data(13))
    for t in (0.0, 0.4):
        np.testing.assert_allclose(op(data, t).numpy(), plain(data, t).numpy(), **TOL)
        np.testing.assert_allclose(op(data, args={"t": t}).numpy(), plain(data, t).numpy(),
                                   **TOL)
