"""Boundary values that vary in time and space in the Euler-Maruyama windows
(B2(b) of kernels #9 and #10).

One k-step pass of kernel #10's plain version, with the side inputs of a
model's ghosts (per-point consts and factors, consts and factors varying in
time, consts varying in space and time), is held against ``pde_tpu``'s
``make_fused_sde_stencil_window_2d`` in interpret mode, fed the same numpy
increments and its per-step t-table and space-and-time tables from the same
start time, at every k of the port's ladder (fp64, <= 1e-12). The square
window's tile emulation reads the tables where the kernel does, equal to the
plain version at rtol = atol = 0, for both noise modes; kernel #9 adds the
Philox stream its staged twin is fed, whatever the sides. The windows with
sides are the plain loop (Euler-Maruyama and Milstein, over tracker windows
and table blocks), and what ``pde_tpu`` refuses still raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_sde_2d as sde
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.ops import philox

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64
DT = 1e-3
T0 = 0.3
RHS = "0.1 * laplace(c) + 0.1 * gradient_squared(c) - c**3"


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tpde.config({"device": "cpu"}):
        yield


# id: (shape, periodic, bc); every kind of side input on grids of 16² to 64²
CASES = {
    "t sides 16x16": ((16, 16), (False, False), {
        "x": {"derivative": 0}, "y-": {"value_expression": "sin(3*t)"},
        "y+": {"derivative_expression": "0.5*cos(t)"}}),
    "xt and arrays 24x40": ((24, 40), (False, False), {
        "x-": {"value": "sin(y)"}, "x+": {"derivative_expression": "cos(t)"},
        "y-": {"value_expression": "sin(x - 2*t)"}, "y+": {"mixed": "1 + x", "const": 0.3}}),
    "periodic rows, t factor 32x20": ((32, 20), (True, False), {
        "x": "periodic", "y-": {"value_expression": "sin(x - 2*t)"},
        "y+": {"mixed_expression": "1 + t", "const": "x"}}),
    "periodic columns 64x64": ((64, 64), (False, True), {
        "x-": {"value_expression": "cos(y + t)"}, "x+": {"value": "sin(y)"}, "y": "periodic"}),
}
K_CASES = [(case, k) for case in CASES for k in (8, 4, 2, 1)]


def _grid(pkg, case):
    shape, periodic, _ = CASES[case]
    return pkg.CartesianGrid([(0, 1), (0, 2)], list(shape), periodic=list(periodic))


def _data(case):
    shape = CASES[case][0]
    return np.random.default_rng(sorted(CASES).index(case)).uniform(-0.5, 0.5, shape)


def _increments(case, k):
    shape = CASES[case][0]
    return np.random.default_rng(50 + sorted(CASES).index(case)).normal(0.0, 0.05, (k, *shape))


@functools.cache
def _window(case, kernel_noise=False):
    """The port's Euler-Maruyama window of the case (staged, or Philox)."""
    state = tpde.ScalarField(_grid(tpde, case), _data(case), dtype=F64)
    mode = {"sde.kernel_noise": "on", "sde.increment_dist": "irwin4"} if kernel_noise else {}
    with tpde.config(mode):
        eq = tpde.PDE({"c": RHS}, bc=CASES[case][2], noise=0.2)
        window = eq.make_fused_euler_window(state, DT)
    assert window.needs_key and window.program.stencil.sides is not None
    assert window.program.noise == ("irwin4" if kernel_noise else "staged")
    return window, state.data


def _views(window, spec):
    """The pass's views of the side inputs: the window's steps from T0."""
    return window.program.stencil.sides.passes(T0, spec.k, DT, F64, "cpu")(0, spec.k)


@functools.cache
def _jax_pass(case, k):
    """One k-step pass of ``pde_tpu``'s kernel #10 in interpret mode, its
    side inputs staged by ``_BCSideStager2D`` for the steps from T0."""
    from pde_tpu.ops.pallas_cartesian import (
        _t_slot_funcs,
        make_fused_sde_stencil_window_2d,
    )

    jstate = jpde.ScalarField(_grid(jpde, case), _data(case))
    jeq = jpde.PDE({"c": RHS}, bc=CASES[case][2])
    _, grid, exprs, var_map, _, bc_inputs, depth, _, make_get_bc = (
        jeq._fused_stencil_lowering(jstate, None))
    assert bc_inputs is not None

    def make_step(ops):
        rhs_fn, d = jeq._lower_stencil_expr(exprs[0], var_map, ops, make_get_bc("c"))

        def step(work):
            center = ops.trim(work, d)
            return center + DT * jnp.broadcast_to(jnp.asarray(rhs_fn([work])), center.shape)

        return step

    window_k, got_k = make_fused_sde_stencil_window_2d(
        grid, make_step, depth, dtype=np.float64, k=k, interpret=True, bc_inputs=bc_inputs)
    assert got_k == k
    ts = T0 + jnp.arange(k) * DT
    t_funcs = _t_slot_funcs(bc_inputs["t"])
    t_tab = jnp.stack([jax.vmap(f)(ts) for f in t_funcs], axis=1) if t_funcs else None
    xt_ops = [jax.vmap(spec.const_xt)(ts) for _, spec in bc_inputs["xt"]]
    noise = _increments(case, k)
    if t_funcs or xt_ops:
        return np.asarray(window_k(jstate.data, noise, xt_ops, t_tab))
    return np.asarray(window_k(jstate.data, noise))


@pytest.mark.parametrize("case, k", K_CASES)
def test_staged_pass_with_sides_matches_jax_kernel(case, k, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    window, data = _window(case)
    spec = next(s for s in window.specs if s.k == k)
    launches = (sde.sde_stencil_2d.launches, sde.sde_stencil_2d.sides_launches)
    got = sde.sde_stencil_2d(data, torch.tensor(_increments(case, k)), spec,
                             sides=_views(window, spec))
    assert (sde.sde_stencil_2d.launches, sde.sde_stencil_2d.sides_launches) == launches
    np.testing.assert_allclose(got.numpy(), _jax_pass(case, k), **TOL)


@pytest.mark.parametrize("case, k", K_CASES)
def test_tile_emulation_reads_sides_as_the_kernel(case, k):
    """The square window's tiles (two tile shapes, one ragged) read each
    table at the global cells along their sides: the plain version, bit for
    bit, with staged increments and with the Philox stream."""
    window, data = _window(case)
    spec = next(s for s in window.specs if s.k == k)
    views = _views(window, spec)
    noise = torch.tensor(_increments(case, k))
    plain = sde.sde_stencil_2d_plain(data, noise, spec, views)
    for tile in (8, (16, 5)):
        assert torch.equal(sde.sde_stencil_2d_tiled(data, noise, spec, tile, views), plain)
    kn_window, _ = _window(case, kernel_noise=True)
    kn_spec = next(s for s in kn_window.specs if s.k == k)
    ctl = (*philox.seed_words(7 + k), 3)
    kn_views = _views(kn_window, kn_spec)
    kn_plain = sde.sde_kernel_noise_2d_plain(data, ctl, kn_spec, kn_views)
    assert torch.equal(sde.sde_kernel_noise_2d_tiled(data, ctl, kn_spec, 8, kn_views), kn_plain)


@pytest.mark.parametrize("case", CASES)
def test_kernel_noise_stream_is_unchanged_by_sides(case):
    """Kernel #9 with side inputs adds the Philox increments of (seed, global
    step, global cell): its plain version equals kernel #10's fed those
    increments, at every k."""
    kn_window, data = _window(case, kernel_noise=True)
    st_window, _ = _window(case)
    for kn_spec, st_spec in zip(kn_window.specs, st_window.specs, strict=True):
        ctl = (*philox.seed_words(11), 5)
        rows, cols = (torch.arange(n) for n in kn_spec.shape)
        staged = torch.stack([
            philox.cell_increments("irwin4", ctl[:2], ctl[2] + s, rows, cols, F64, kn_spec.scale)
            for s in range(kn_spec.k)])
        got = sde.sde_kernel_noise_2d(data, ctl, kn_spec, sides=_views(kn_window, kn_spec))
        expected = sde.sde_stencil_2d(data, staged, st_spec, sides=_views(st_window, st_spec))
        np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=0, atol=0)


def test_sides_are_required_and_checked():
    window, data = _window("t sides 16x16")
    spec = window.specs[-1]
    noise = torch.zeros((spec.k, *spec.shape), dtype=F64)
    with pytest.raises(ValueError, match="side inputs"):
        sde.sde_stencil_2d(data, noise, spec)
    views = _views(window, spec)
    with pytest.raises(ValueError, match="dtype and device"):
        sde.sde_stencil_2d(data, noise, spec, sides=[v.float() for v in views])


@pytest.mark.parametrize("solver, config", [
    ("euler", {}), ("milstein", {}),
    ("euler", {"sde.increment_dist": "rademacher", "sde.kernel_noise": "off"})])
def test_windows_with_sides_are_the_plain_loop(solver, config, monkeypatch):
    """KPZ with a time-dependent Dirichlet side: the staged window from t0,
    its tables over several blocks and tracker windows, equals the plain
    loop on the same stream (Euler-Maruyama, and Milstein, whose fused path
    is the Euler window; Milstein's loop draws normal increments whatever
    the law, as pde_tpu's, so it is compared under the default law)."""
    monkeypatch.setattr(cs, "SIDE_BLOCK", 3)
    grid = tpde.CartesianGrid([(0, 1), (0, 1)], [16, 24], periodic=[False, True])
    state = tpde.ScalarField(grid, np.random.default_rng(3).uniform(-0.1, 0.1, (16, 24)),
                             dtype=F64)
    bc = {"x": {"value_expression": "0.1*sin(3*t)"}, "y": "periodic"}
    dt = 1e-4  # stable on this grid
    tracker = tpde.trackers.ConsistencyTracker(interrupts=4 * dt)
    out = []
    with tpde.config(config):
        for backend in ("torch", "numpy"):
            eq = tpde.KPZInterfacePDE(nu=1, lmbda=1, noise=0.01, bc=bc,
                                      rng=np.random.default_rng(4))
            res, info = eq.solve(state, t_range=[T0, T0 + 13 * dt], dt=dt, tracker=tracker,
                                 solver=solver, backend=backend, ret_info=True)
            out.append(res.data)
            assert info["solver"].get("fused_step") is (True if backend == "torch" else None)
    assert out[0].abs().max() < 1
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), **TOL)


def test_irwin4_window_with_sides_takes_kernel_9():
    """Under ``irwin4`` the window with sides draws in the kernel (#9), from
    the window's start time."""
    grid = tpde.CartesianGrid([(0, 1), (0, 1)], [16, 16], periodic=[False, True])
    state = tpde.ScalarField(grid, 0.0, dtype=F64)
    bc = {"x": {"value_expression": "0.1*sin(3*t)"}, "y": "periodic"}
    with tpde.config({"sde.increment_dist": "irwin4"}):
        eq = tpde.KPZInterfacePDE(nu=1, lmbda=1, noise=0.1, bc=bc, rng=np.random.default_rng(5))
        window = eq.make_fused_euler_window(state, DT)
        res, info = eq.solve(state, t_range=[T0, T0 + 9 * DT], dt=DT, tracker=None,
                             solver="milstein", ret_info=True)
    assert window.needs_t and window.program.noise == "irwin4"
    assert info["solver"]["fused_step"] and torch.isfinite(res.data).all()
    # the in-kernel stream is not the plain loop's: the edge rows still follow the sides
    assert res.data.abs().max() > 0


def test_cuda_engine_takes_sde_sides_and_refuses_what_pde_tpu_refuses():
    """Under ``cuda`` an SDE window with side inputs no longer raises naming
    B2(b) (here it asks for the card); what pde_tpu refuses still raises:
    3D SDE windows, noise on a mesh, multiplicative noise."""
    timed = {"x-": {"value_expression": "sin(3*t)"}, "x+": {"derivative": 0},
             "y": {"derivative": 0}}
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], [12, 14])
    state = tpde.ScalarField(grid, 0.1, dtype=F64)
    eq = tpde.DiffusionPDE(0.1, bc=timed, noise=0.1, rng=np.random.default_rng(1))
    with pytest.raises(RuntimeError, match="CUDA device"):
        tpde.EulerSolver(eq, backend="cuda").make_stepper(state, dt=1e-3)

    class Multiplicative(tpde.DiffusionPDE):
        def make_noise_variance(self, state, *, ret_diff=False):
            return lambda leaves, t: [y * y for y in leaves]

    cube = tpde.ScalarField(tpde.UnitGrid([8, 8, 8]), 0.1, dtype=F64)
    cases = [
        (tpde.DiffusionPDE(0.1, bc={**timed, "z": {"derivative": 0}}, noise=0.1), cube, {},
         "3D SDE"),
        (tpde.DiffusionPDE(0.1, bc=timed, noise=0.1), state, {"decomposition": [2, 1]},
         "A9.3|noise"),
        (Multiplicative(0.1, bc=timed, noise=0.1), state, {}, "additive scalar noise"),
    ]
    with tpde.config({"parallel.devices_per_device": 8}):
        for eq, field, kwargs, match in cases:
            with pytest.raises(RuntimeError, match=match):
                tpde.EulerSolver(eq, backend="cuda", **kwargs).make_stepper(field, dt=1e-3)


def test_side_program_sources():
    """A program with side inputs takes its own entry point (the tables'
    pointers and strides among the arguments); one without keeps the source
    it had, its level struct without side rows."""
    window, _ = _window("xt and arrays 24x40")
    source = window.program.source
    assert "launch_sides<Program" in source and "L.sp[" in source
    assert "const void* const* sides, const long long* steps" in source
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], [16, 16], periodic=[True, True])
    plain = tpde.PDE({"c": RHS}, noise=0.2).make_fused_euler_window(
        tpde.ScalarField(grid, 0.0, dtype=F64), DT)
    assert plain.program.stencil.sides is None and not plain.needs_t
    assert "launch<Program" in plain.program.source and "sides" not in plain.program.source
    assert "Level<T, kFields, kBuffers>&" in plain.program.source
