"""The module holding the generated multi-field kernel (``ops/cuda_stencil_2d``).

One k-step pass of the port's fused Euler window, through the kernel's plain
version and through the replay of its row march (strips and chunks of 8
cells), is held against ``pde_tpu``'s kernel
``make_fused_multi_stencil_window_2d`` in interpret mode on the same numpy
inputs, fp64, at the tolerances of ``pde_tpu``'s own fused-window tests. Also:
the ladder window against single steps, the emitter's determinism, and the
gates. (``tests/test_torch_multi_march_2d.py`` holds the march's schedule.)
"""

import functools

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_stencil_2d as cs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


BRUSSELATOR = {
    "u": "1 + u**2 * v - 2.2 * u + 0.1 * laplace(u)",
    "v": "1.2 * u - u**2 * v + 0.02 * laplace(v)",
}
MIXED_BC = {"x-": {"value": 1}, "x+": {"derivative": 0},
            "y-": {"derivative": 0.2}, "y+": {"type": "mixed", "value": 1.0, "const": 0.3}}

# id: (grid class, grid args, periodic, n_fields, make the PDE in one package, dt, rtol)
CASES = {
    "cahn-hilliard-expression": (
        "UnitGrid", ([16, 16],), True, 1,
        lambda p: p.PDE({"c": "laplace(c**3 - c - laplace(c))"}), 1e-3, 1e-11),
    "cahn-hilliard-noflux": (
        "CartesianGrid", ([(0, 8), (0, 8)], (16, 16)), False, 1,
        lambda p: p.CahnHilliardPDE(bc_c={"derivative": 0}, bc_mu={"derivative": 0}),
        1e-3, 1e-11),
    "cahn-hilliard-two-bcs": (
        "CartesianGrid", ([(0, 4), (0, 16)], (16, 32)), False, 1,
        lambda p: p.CahnHilliardPDE(0.5, bc_c={"value": 0.1}, bc_mu={"derivative": 0}),
        1e-3, 1e-11),
    "brusselator-periodic": ("UnitGrid", ([16, 16],), True, 2,
                             lambda p: p.PDE(BRUSSELATOR), 0.01, 1e-12),
    "brusselator-neumann": ("UnitGrid", ([16, 32],), False, 2,
                            lambda p: p.PDE(BRUSSELATOR), 0.01, 1e-12),
    "wave-system": ("UnitGrid", ([16, 32],), True, 2,
                    lambda p: p.PDE({"u": "v", "v": "0.5 * laplace(u)"}), 0.01, 1e-12),
    "divergence-gradient": (
        "CartesianGrid", ([(0, 1), (0, 2)], (16, 32)), False, 1,
        lambda p: p.PDE({"c": "0.001 * divergence(gradient(c))"}, bc={"derivative": 0.1}),
        0.01, 1e-12),
    "dot-gradients": (
        "UnitGrid", ([16, 16],), True, 2,
        lambda p: p.PDE({"u": "0.1 * laplace(u) + 0.05 * dot(gradient(u), gradient(v))",
                         "v": "0.1 * laplace(v)"}), 0.01, 1e-12),
    "mixed-bcs-pointwise": (
        "CartesianGrid", ([(0, 1), (0, 1)], (16, 16)), False, 1,
        lambda p: p.PDE({"c": "0.001 * laplace(c) - 0.1 * c + 0.01 * tanh(c) "
                              "- 1e-4 * exp(c) * gradient_squared(c)"}, bc=MIXED_BC),
        1e-3, 1e-11),
}


def _data(case_id):
    cls, args, periodic, n_fields, _, _, _ = CASES[case_id]
    shape = getattr(jpde, cls)(*args, periodic=periodic).shape
    rng = np.random.default_rng(sorted(CASES).index(case_id))
    return [rng.uniform(-0.5, 0.5, shape) + (1.0 if i else 0.0) for i in range(n_fields)]


def _states(case_id):
    cls, args, periodic, n_fields, _, _, _ = CASES[case_id]
    jgrid = getattr(jpde, cls)(*args, periodic=periodic)
    fields = [jpde.ScalarField(jgrid, d, label="uv"[i]) for i, d in enumerate(_data(case_id))]
    jstate = fields[0] if n_fields == 1 else jpde.FieldCollection(fields)
    tstate = tpde.field_from_state(jstate.attributes_serialized, np.asarray(jstate.data))
    return jstate, tstate


@functools.cache
def _jax_window(case_id, steps):
    """``pde_tpu``'s fused window (kernel #7 in interpret mode) over `steps`."""
    import os

    _, _, _, n_fields, make_eq, dt, _ = CASES[case_id]
    jstate, _ = _states(case_id)
    old = os.environ.get("PDE_TPU_PALLAS_INTERPRET")
    os.environ["PDE_TPU_PALLAS_INTERPRET"] = "1"
    try:
        window = make_eq(jpde).make_fused_euler_window(jstate, dt)
        if n_fields == 1:
            return [np.asarray(window(jstate.data, steps))]
        return [np.asarray(x) for x in window([f.data for f in jstate], steps)]
    finally:
        if old is None:
            del os.environ["PDE_TPU_PALLAS_INTERPRET"]
        else:
            os.environ["PDE_TPU_PALLAS_INTERPRET"] = old


def _torch_window(case_id):
    _, _, _, _, make_eq, dt, _ = CASES[case_id]
    _, tstate = _states(case_id)
    window = make_eq(tpde).make_fused_euler_window(tstate, dt)
    return window, [torch.tensor(d) for d in _data(case_id)]


@pytest.mark.parametrize("case_id", CASES)
def test_plain_pass_matches_jax_kernel(case_id):
    window, datas = _torch_window(case_id)
    k = window.program.ladder[0]
    launches = cs.multi_stencil_2d.launches
    got = window(datas, k)
    assert cs.multi_stencil_2d.launches == launches  # the CPU takes the plain version
    rtol = CASES[case_id][-1]
    for g, e in zip(got, _jax_window(case_id, k), strict=True):
        np.testing.assert_allclose(g.numpy(), e, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("case_id", CASES)
def test_tile_emulation_matches_jax_kernel(case_id):
    """The kernel's row march, replayed on strips of 8 columns and chunks of 8
    rows (the name predates the march)."""
    window, datas = _torch_window(case_id)
    spec = window.specs[0]
    got = cs.multi_stencil_2d_marched(datas, spec, plan=(8, 8))
    rtol = CASES[case_id][-1]
    for g, e in zip(got, _jax_window(case_id, spec.k), strict=True):
        np.testing.assert_allclose(g.numpy(), e, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("tile", [4, 8, 64])
@pytest.mark.parametrize("case_id", ["cahn-hilliard-two-bcs", "brusselator-neumann",
                                     "mixed-bcs-pointwise"])
def test_tile_emulation_matches_plain_at_every_k(case_id, tile):
    """The replay of the kernel's row march on strips of `tile` columns and
    chunks of `tile` rows (the name predates the march): strips and chunks
    smaller than the halo (periodic halos wrapping more than once), ragged
    edge strips, and one block over the whole grid, at every k of the ladder."""
    window, datas = _torch_window(case_id)
    for spec in window.specs:
        expected = cs.multi_stencil_2d_plain(datas, spec)
        got = cs.multi_stencil_2d_marched(datas, spec, plan=(tile, tile))
        for g, e in zip(got, expected, strict=True):
            np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("steps", [0, 1, 5, 13])
def test_ladder_window_matches_single_steps(steps):
    window, datas = _torch_window("brusselator-neumann")
    one = cs.multi_stencil_spec(window.program, 1, torch.float64)
    expected = datas
    for _ in range(steps):
        expected = cs.multi_stencil_2d_plain(expected, one)
    got = window(datas, steps)
    for g, e in zip(got, expected, strict=True):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-12, atol=1e-12)
    assert all(g is not d for g, d in zip(got, datas)) or steps == 0


# -- the emitter ---------------------------------------------------------------------------
def test_emitter_is_deterministic_and_names_planes_and_sides():
    first, _ = _torch_window("brusselator-neumann")
    second, _ = _torch_window("brusselator-neumann")
    assert first.program is not second.program
    assert first.program.source == second.program.source
    assert first.program.digest == second.program.digest
    source = first.program.source
    for plane in ("O.c[0][q]", "O.c[1][q]", "O.lo[0][q]", "O.hi[1][q]"):
        assert plane in source
    for side in ("rf & pde_tpu_torch::kLowEdge", "rf & pde_tpu_torch::kHighEdge",
                 "cf & pde_tpu_torch::kLowEdge", "cf & pde_tpu_torch::kHighEdge"):
        assert side in source
    for k in first.program.ladder:
        assert f"case {k}: return pde_tpu_torch::launch_2d<Program, float, {k}," in source
        assert f"case {k}: return pde_tpu_torch::launch_2d<Program, double, {k}," in source
    periodic, _ = _torch_window("brusselator-periodic")
    assert "kLowEdge" not in periodic.program.source
    assert periodic.program.digest != first.program.digest


def test_emitter_buffers_derived_operands_only():
    window, _ = _torch_window("cahn-hilliard-noflux")
    program = window.program
    assert program.depth == 2 and program.ladder == [4, 2, 1]
    # the chemical potential is the one materialised operand; c is read in place
    assert len(program.buffers) == 1 and program.buffers[0].depth == 1
    assert program.tiles[torch.float32][4] == (256, 288)  # strip, threads
    wave, _ = _torch_window("wave-system")
    assert wave.program.buffers == [] and wave.program.depth == 1


# -- gates and the wrapper -------------------------------------------------------------------
def _solver_reason(eq, state):
    solver = tpde.EulerSolver(eq)
    solver.make_stepper(state, dt=1e-3)
    assert "fused_step" not in solver.info
    return solver.info["fused_unsupported"]


def test_gate_rejects_side_input_bcs():
    """Per-point BC values are side inputs of the serial 2D window and of the
    3D window (per-face tables); what the gate still rejects is a vector
    state with such values, as pde_tpu does."""
    grid = tpde.UnitGrid([16, 16])
    state = tpde.ScalarField(grid, 0.5, dtype=torch.float64)
    eq = tpde.PDE({"c": "laplace(c)"}, bc={"value": np.linspace(0, 1, 16)})
    assert eq.make_fused_euler_window(state, 1e-3).program.sides is not None
    cube = tpde.ScalarField(tpde.UnitGrid([8, 8, 8]), 0.5, dtype=torch.float64)
    face = {"value": np.linspace(0, 1, 64).reshape(8, 8)}
    eq = tpde.PDE({"c": "laplace(c)"}, bc=face)
    sides = eq.make_fused_euler_window(cube, 1e-3).program.sides
    assert [sides.kind(i) for i in range(len(sides.entries))] == ["x", "x", "y", "y", "z", "z"]
    solver = tpde.EulerSolver(eq)
    solver.make_stepper(cube, dt=1e-3)
    assert solver.info["fused_step"]
    vector = tpde.VectorField(cube.grid, 0.5, dtype=torch.float64)
    eq = tpde.PDE({"v": "vector_laplace(v)"}, bc=face)
    with pytest.raises(tpde.KernelUnsupportedError, match="require scalar BC values"):
        eq.make_fused_euler_window(vector, 1e-3)
    assert "require scalar BC values" in _solver_reason(eq, vector)


def test_gate_rejects_corner_weight():
    state = tpde.ScalarField(tpde.UnitGrid([16, 16], periodic=True), 0.1, dtype=torch.float64)
    with tpde.config({"operators.cartesian.laplacian_2d_corner_weight": 1 / 3}):
        for eq in (tpde.PDE({"c": "laplace(c**3 - c - laplace(c))"}), tpde.CahnHilliardPDE()):
            with pytest.raises(tpde.KernelUnsupportedError, match="pde_tpu/models/pde.py:750-762"):
                eq.make_fused_euler_window(state, 1e-3)


def test_gate_rejects_3d_grid():
    """3D grids take the 3D kernel now (ROADMAP B7), per-face array BCs as
    its side inputs; what it does not take, 3D SDEs, still raises."""
    state = tpde.ScalarField(tpde.UnitGrid([8, 8, 8], periodic=True), 0.1, dtype=torch.float64)
    for eq in (tpde.PDE({"c": "laplace(c)"}), tpde.CahnHilliardPDE()):
        window = eq.make_fused_euler_window(state, 1e-3)
        assert window.multi_field and window.program.library == "multi_stencil_3d"
    with pytest.raises(tpde.KernelUnsupportedError, match="3D SDE"):
        tpde.PDE({"c": "laplace(c)"}, noise=0.1).make_fused_euler_window(state, 1e-3)
    closed = tpde.ScalarField(tpde.UnitGrid([8, 8, 8]), 0.1, dtype=torch.float64)
    face = {"value": np.linspace(0, 1, 64).reshape(8, 8)}
    window = tpde.PDE({"c": "laplace(c)"}, bc=face).make_fused_euler_window(closed, 1e-3)
    assert window.program.library == "multi_stencil_3d" and window.program.sides is not None


def test_gate_rejects_vector_state():
    """Vector states fuse as component planes (tests/test_torch_vector_solve.py);
    the gate still rejects the vector configurations pde_tpu refuses."""
    state = tpde.VectorField(tpde.UnitGrid([8, 8], periodic=True), dtype=torch.float64)
    with pytest.raises(tpde.KernelUnsupportedError, match="vector_laplace"):
        tpde.PDE({"v": "0.1 * laplace(v)"}).make_fused_euler_window(state, 1e-3)
    with pytest.raises(tpde.KernelUnsupportedError, match="noise"):
        tpde.PDE({"v": "vector_laplace(v)"}, noise=0.1).make_fused_euler_window(state, 1e-3)


@pytest.mark.parametrize(
    "rhs,match",
    [("0.1 * c", "depth 0"), ("sin(t) * laplace(c)", "autonomous"),
     ("x * laplace(c)", "autonomous")],
)
def test_gate_rejects_unlowerable_rhs(rhs, match):
    state = tpde.ScalarField(tpde.UnitGrid([8, 8], periodic=True), 0.1, dtype=torch.float64)
    with pytest.raises(tpde.KernelUnsupportedError, match=match):
        tpde.PDE({"c": rhs}).make_fused_euler_window(state, 1e-3)


def test_gate_rejects_other_kinds_and_dtypes():
    state = tpde.ScalarField(tpde.UnitGrid([8, 8], periodic=True), 0.1, dtype=torch.float64)
    eq = tpde.PDE({"c": "laplace(c)"})
    # RK4 and AB2 windows are ported: four halo cells a step, and one carried
    # rate plane; any other kind is refused
    assert eq._emit_fused_window(state, 1e-3, kind="rk4").program.depth == 4
    assert eq._emit_fused_window(state, 1e-3, kind="ab2").n_aux == 1
    with pytest.raises(ValueError, match="Unknown window kind"):
        eq._emit_fused_window(state, 1e-3, kind="bdf2")
    with pytest.raises(tpde.KernelUnsupportedError, match="float32 or float64"):
        eq.make_fused_euler_window(state.copy(dtype=torch.bfloat16), 1e-3)


def test_build_without_nvcc_raises(monkeypatch):
    """No fallback: a build that cannot find nvcc raises."""
    window, _ = _torch_window("wave-system")
    monkeypatch.setenv("PDE_TPU_TORCH_NVCC", "/nonexistent/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        cs.build_programs([window.program])


def test_wrapper_checks_inputs():
    window, datas = _torch_window("brusselator-periodic")
    spec = window.specs[0]
    with pytest.raises(ValueError, match="planes"):
        cs.multi_stencil_2d(datas[:1], spec)
    with pytest.raises(ValueError):
        cs.multi_stencil_2d([d.float() for d in datas], spec)
    with pytest.raises(RuntimeError, match="No multi-stencil kernel"):
        cs.multi_stencil_2d([torch.zeros(16, 16, dtype=torch.float64, device="meta")] * 2, spec)
    outs = [torch.empty_like(d) for d in datas]
    assert cs.multi_stencil_2d(datas, spec, outs=outs) == outs
    for out, ref in zip(outs, cs.multi_stencil_2d_plain(datas, spec), strict=True):
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
