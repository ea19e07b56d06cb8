"""The module holding the generated 3D multi-field kernel (``ops/cuda_stencil_3d``).

One k-step pass of the port's 3D window, through the kernel's plain version
and through the replay of its march, is held against each of the two
``pde_tpu`` kernels it replaces, in interpret mode on the same numpy inputs,
fp64, at rtol = atol = 1e-12: ``make_fused_multi_stencil_window_3d`` with
``ychunk=False`` (kernel #5, x bands of whole planes) and with
``ychunk=True`` (kernel #4, x bands by y chunks). Also: the ladder window
against ``pde_tpu``'s ``make_chunked_multi_window_3d``, the emitter (with the
2D programs' generated source pinned to its value before the emitter became
n-D), and the gates.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import affine_bc_specs as jax_affine_bc_specs
from pde_tpu.ops.pallas_cartesian import make_chunked_multi_window_3d as jax_chunked_window_3d
from pde_tpu.ops.pallas_cartesian import make_fused_multi_stencil_window_3d as jax_window_3d
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.ops import cuda_stencil_3d as s3

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
DT = 1e-3

# id: (periodic, bc); 16^3 unit cube, so that the y-chunked kernel finds a chunk
BCS = {
    "periodic": (True, None),
    "dirichlet": (False, {"value": 1.5}),
    "mixed": ([True, False, False], {"x": "periodic", "y": {"value": 2.0}, "z": {"derivative": -0.5}}),
}


def _euler_lap(specs, b):
    """The Euler-Laplacian step of ``pde_tpu``'s y-chunk tests, for either package."""

    def make_step(h):
        def step(works):
            (w,) = works
            return [h.trim(w, 1) + b * h.lap(w, bc=specs)]

        return step

    return make_step


def _allen_cahn(specs, dt):
    """One Euler step of ``0.5 * laplace(c) - c**3 + c``."""

    def make_step(h):
        def step(works):
            (w,) = works
            c = h.trim(w, 1)
            return [c + dt * (0.5 * h.lap(w, bc=specs) - c * c * c + c)]

        return step

    return make_step


STEPS = {"euler-laplace": lambda specs: _euler_lap(specs, DT), "allen-cahn": lambda specs: _allen_cahn(specs, DT)}


def _setup(bc_id):
    periodic, bc = BCS[bc_id]
    jgrid = jpde.CartesianGrid([(0, 1)] * 3, (16, 16, 16), periodic=periodic)
    tgrid = tpde.CartesianGrid([(0, 1)] * 3, (16, 16, 16), periodic=periodic)
    jspecs = tspecs = None
    if bc is not None:
        jspecs = jax_affine_bc_specs(jgrid, jgrid.get_boundary_conditions(bc))
        tspecs = cc.affine_bc_specs(tgrid, tgrid.get_boundary_conditions(bc))
    data = np.random.default_rng(sorted(BCS).index(bc_id)).uniform(-1, 1, (16, 16, 16))
    return jgrid, tgrid, jspecs, tspecs, data


@functools.cache
def _jax_pass(step_id, bc_id, ychunk, k):
    jgrid, _, jspecs, _, data = _setup(bc_id)
    window, k_used = jax_window_3d(
        jgrid, STEPS[step_id](jspecs), 1, 1, dtype=np.float64, interpret=True, ychunk=ychunk, k=k
    )
    assert k_used == k
    return np.asarray(window([data])[0])


def _port_spec(step_id, bc_id, k):
    _, tgrid, _, tspecs, data = _setup(bc_id)
    program = s3.StencilProgram3D(tgrid, STEPS[step_id](tspecs), 1, 1)
    assert program.ladder == [3, 1]
    return cs.multi_stencil_spec(program, k, torch.float64), [torch.tensor(data)]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("bc_id", BCS)
@pytest.mark.parametrize("step_id", STEPS)
@pytest.mark.parametrize("ychunk", [False, True], ids=["kernel5", "kernel4-ychunk"])
def test_plain_pass_matches_jax_kernel(ychunk, step_id, bc_id, k):
    spec, datas = _port_spec(step_id, bc_id, k)
    launches = s3.multi_stencil_3d.launches
    (got,) = s3.multi_stencil_3d(datas, spec)
    assert s3.multi_stencil_3d.launches == launches  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), _jax_pass(step_id, bc_id, ychunk, k), **TOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("bc_id", BCS)
@pytest.mark.parametrize("step_id", STEPS)
@pytest.mark.parametrize("ychunk", [False, True], ids=["kernel5", "kernel4-ychunk"])
def test_march_replay_matches_jax_kernel(ychunk, step_id, bc_id, k):
    """Plans of 4 x 8 x 4 (chunks, column tiles, seams wrapped on periodic
    axes) and the kernel's own plan."""
    spec, datas = _port_spec(step_id, bc_id, k)
    expected = _jax_pass(step_id, bc_id, ychunk, k)
    for tile in ((4, 8, 4), None):
        (got,) = s3.multi_stencil_3d_marched(datas, spec, tile=tile)
        np.testing.assert_allclose(got.numpy(), expected, **TOL)


# -- the march's replay on edge grids, at every k of the ladder ----------------------------------
EDGE = {
    # the triple seam: halos deeper than an 8^3 grid on every axis
    "allen-cahn 8^3 periodic": ("UnitGrid", ([8, 8, 8],), True, 1,
                                lambda p: p.PDE({"u": "laplace(u) + u - u**3"})),
    "cahn-hilliard ragged no-flux": (
        "CartesianGrid", ([(0, 1), (0, 2), (0, 3)], (10, 12, 14)), False, 1,
        lambda p: p.CahnHilliardPDE(bc_c={"derivative": 0}, bc_mu={"derivative": 0})),
    "brusselator 8^3 periodic": (
        "UnitGrid", ([8, 8, 8],), True, 2,
        lambda p: p.PDE({"u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
                         "v": "0.05 * laplace(v) + u - u**2 * v"})),
    "dot-grad ragged no-flux": (
        "CartesianGrid", ([(0, 1), (0, 2), (0, 3)], (10, 12, 14)), False, 1,
        lambda p: p.PDE({"c": "0.1 * laplace(c) + 0.05 * dot(gradient(c), gradient(c))"},
                        bc={"derivative": 0})),
    "mixed faces": (
        "CartesianGrid", ([(0, 1), (0, 2), (0, 3)], (9, 6, 11)), [False, True, False], 1,
        lambda p: p.PDE({"c": "0.01 * laplace(c) - 0.1 * gradient_squared(c) + 0.01 * tanh(c)"},
                        bc={"x-": {"value": 1}, "x+": {"curvature": 0.5}, "y": "periodic",
                            "z": {"type": "mixed", "value": 1.0, "const": 0.2}})),
}


def _edge_window(case_id, dtype=torch.float64):
    cls, args, periodic, n_fields, make_eq = EDGE[case_id]
    grid = getattr(tpde, cls)(*args, periodic=periodic)
    rng = np.random.default_rng(sorted(EDGE).index(case_id))
    datas = [torch.tensor(rng.uniform(-0.5, 0.5, grid.shape) + i, dtype=dtype) for i in range(n_fields)]
    fields = [tpde.ScalarField(grid, d) for d in datas]
    state = fields[0] if n_fields == 1 else tpde.FieldCollection(fields)
    return make_eq(tpde).make_fused_euler_window(state, 1e-4), datas


@pytest.mark.parametrize("case_id", EDGE)
def test_march_replay_matches_plain_at_every_k(case_id):
    window, datas = _edge_window(case_id)
    for spec in window.specs:
        expected = s3.multi_stencil_3d_plain(datas, spec)
        for tile in (None, (2, 3, 4)):
            got = s3.multi_stencil_3d_marched(datas, spec, tile=tile)
            for g, e in zip(got, expected, strict=True):
                torch.testing.assert_close(g, e, rtol=1e-12, atol=1e-12)


# -- the ladder window ---------------------------------------------------------------------
def test_ladder_window_matches_jax_window():
    """37 steps through the port's ladder (3, 1) and through the JAX
    package's (4, 2, 1), in interpret mode, Allen-Cahn with mixed faces."""
    jgrid, tgrid, jspecs, tspecs, data = _setup("mixed")
    expected = jax_chunked_window_3d(
        jgrid, _allen_cahn(jspecs, DT), 1, 1, dtype=np.float64, interpret=True
    )([data], 37)[0]
    window = s3.make_chunked_multi_window_3d(tgrid, _allen_cahn(tspecs, DT), 1, 1,
                                             dtype=torch.float64)
    assert window.multi_field and window.n_aux == 0
    (got,) = window([torch.tensor(data)], 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("steps", [0, 1, 5])
def test_ladder_window_matches_single_steps(steps):
    window, datas = _edge_window("brusselator 8^3 periodic")
    one = cs.multi_stencil_spec(window.program, 1, torch.float64)
    expected = datas
    for _ in range(steps):
        expected = s3.multi_stencil_3d_plain(expected, one)
    for g, e in zip(window(datas, steps), expected, strict=True):
        np.testing.assert_allclose(g.numpy(), e.numpy(), **TOL)


# -- the emitter -----------------------------------------------------------------------------
def test_3d_emitter_names_axes_faces_and_ladder():
    window, _ = _edge_window("mixed faces")
    program = window.program
    assert program.rank == 3 and program.library == "multi_stencil_3d"
    source = program.source
    assert '#include "multi_stencil_3d.cuh"' in source
    assert "kYPeriodic = true" in source and "kXPeriodic = false" in source
    # the ghosts follow the march's flags: the plane's for x, the column's for y and z
    for face in ("if (pf & pde_tpu_torch::kLowEdge)", "if (pf & pde_tpu_torch::kHighEdge)",
                 "if (cf & pde_tpu_torch::kLowEdgeZ)", "if (cf & pde_tpu_torch::kHighEdgeZ)"):
        assert face in source
    assert "cf & pde_tpu_torch::kLowEdge)" not in source  # y is periodic
    # x neighbours from the planes before and after, y and z within the plane
    for read in ("O.lo[0][q]", "O.hi[0][q]", "O.c[0][q + WZ]", "O.c[0][q - 1]"):
        assert read in source
    for k in program.ladder:
        cx, ty, tz = program.tiles[torch.float32][k]
        assert f"case {k}: return pde_tpu_torch::launch_3d<Program, float, {k}, {cx}, {ty}, {tz}>" \
            in source
    periodic, _ = _edge_window("allen-cahn 8^3 periodic")
    assert "kLowEdge" not in periodic.program.source


def test_3d_program_geometry():
    window, _ = _edge_window("cahn-hilliard ragged no-flux")
    program = window.program
    # depth 2 with one operand buffer, the chemical potential: two stages a
    # step, each volume in a ring of three planes
    assert program.depth == 2 and len(program.buffers) == 1 and program.ladder == [1]
    assert [st.lag for st in program.march.stages] == [1, 2]
    assert program.march.slots == (3, 3)
    assert program.tiles[torch.float32] == {1: (32, 32, 64)}
    allen_cahn, _ = _edge_window("allen-cahn 8^3 periodic")
    assert allen_cahn.program.ladder == [3, 1]
    assert allen_cahn.program.tiles[torch.float32] == {3: (32, 32, 64), 1: (32, 32, 64)}
    assert allen_cahn.program.tiles[torch.float64] == {3: (32, 16, 64), 1: (32, 32, 64)}


# 2D programs' generated source. The KPZ windows' sources were hashed before the
# stencil tracer and helpers became n-D; "cahn-hilliard", "cahn-hilliard two
# bcs" and "kpz stencil" (the SDE windows' program struct alone) were re-pinned
# when the row march's stage functions replaced the square window's sweeps in
# kernels #7 and #8, whose entry points take the chunk of rows a block marches
SOURCE_2D = {
    "cahn-hilliard": "010f751596a294eac695e5d3368944d41d8c57ea24cf16089c0ca76ec9aa509d",
    "cahn-hilliard two bcs": "2cf1a77a4bf50e443cd7b80c7f644ebcbbf8b896dfd88971ebded1a7cb967a2f",
    "kpz staged": "f6ca855e9918b684a9854ad2410271932bbee5a2abcf9045b1d63fcf53155946",
    "kpz irwin4": "69230499c1ee571342bfb9c179a18ecba91557b1e2f954a83a1b5258923f7bce",
    "kpz stencil": "13d2737b77dff71890d9d0a8f6ae301d0bb4340b7f01ec6fc6c49f123eac6125",
}


def test_2d_generated_source_is_unchanged():
    def digest(text):
        return hashlib.sha256(text.encode()).hexdigest()

    state = tpde.ScalarField(tpde.UnitGrid([32, 32], periodic=True), 0.1, dtype=torch.float32)
    window = tpde.PDE({"c": "laplace(c**3 - c - laplace(c))"}).make_fused_euler_window(state, 1e-3)
    got = {"cahn-hilliard": digest(window.program.source)}
    grid = tpde.CartesianGrid([(0, 2), (0, 3)], [16, 24])
    state = tpde.ScalarField(grid, 0.1, dtype=torch.float32)
    window = tpde.CahnHilliardPDE(bc_c={"derivative": 0}, bc_mu={"value": 0.5}) \
        .make_fused_euler_window(state, 1e-3)
    got["cahn-hilliard two bcs"] = digest(window.program.source)
    for route, cfg in (("staged", {}), ("irwin4", {"sde.increment_dist": "irwin4"})):
        with tpde.config(cfg):
            window = tpde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1) \
                .make_fused_euler_window(state, 1e-3)
        got[f"kpz {route}"] = digest(window.program.source)
        got["kpz stencil"] = digest(window.program.stencil.source)
    assert got == SOURCE_2D


# 3D programs' generated source, hashed when the x-marching kernel's stage
# functions replaced the volume window's sweeps
SOURCE_3D = {
    "allen-cahn": "83eca7d0b2574e8ec01ab0605f54b5230d44266cc0abcd3788bc044855385626",
    "mixed faces": "53b8834a1ceb2a2179bac81e0263cee96ce3d029e2e617478713cb36fa8a1436",
}


def test_3d_generated_source_is_unchanged():
    def digest(text):
        return hashlib.sha256(text.encode()).hexdigest()

    state = tpde.ScalarField(tpde.UnitGrid([16, 16, 16], periodic=True), 0.1, dtype=torch.float32)
    got = {"allen-cahn": digest(tpde.AllenCahnPDE().make_fused_euler_window(state, 1e-3)
                                .program.source)}
    grid = tpde.CartesianGrid([(0, 1), (0, 2), (0, 3)], [10, 12, 14])
    state = tpde.ScalarField(grid, 0.1, dtype=torch.float32)
    eq = tpde.PDE({"c": "0.1 * laplace(c) - 0.05 * gradient_squared(c)"},
                  bc={"x": {"value": 0.2}, "y": {"derivative": 0.1}, "z": {"curvature": 0.5}})
    got["mixed faces"] = digest(eq.make_fused_euler_window(state, 1e-3).program.source)
    assert got == SOURCE_3D


# -- gates and the wrapper -------------------------------------------------------------------
def test_gates():
    state = tpde.ScalarField(tpde.UnitGrid([8, 8, 8]), 0.1, dtype=torch.float64)
    with pytest.raises(tpde.KernelUnsupportedError, match="2D kernel"):
        cs.StencilProgram(state.grid, _euler_lap(None, DT), 1, 1)
    with pytest.raises(tpde.KernelUnsupportedError, match="3D kernel"):
        s3.StencilProgram3D(tpde.UnitGrid([8, 8], periodic=True), _euler_lap(None, DT), 1, 1)
    with pytest.raises(tpde.KernelUnsupportedError, match="3D boundary conditions"):
        noflux = ((0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
        s3.StencilProgram3D(state.grid, _euler_lap((noflux, noflux), DT), 1, 1)
    face = np.linspace(0, 1, 64).reshape(8, 8)
    eq = tpde.PDE({"c": "laplace(c)"}, bc={"value": face})
    assert eq.make_fused_euler_window(state, 1e-3).program.sides.kind(0) == "x"
    eq = tpde.KPZInterfacePDE(noise=0.1)
    with pytest.raises(tpde.KernelUnsupportedError, match="3D SDE"):
        eq.make_fused_euler_window(state, 1e-3)
    with pytest.raises(tpde.KernelUnsupportedError, match="float32 or float64"):
        tpde.PDE({"c": "laplace(c)"}).make_fused_euler_window(state.copy(dtype=torch.bfloat16), 1e-3)


def test_wrapper_checks_inputs():
    window, datas = _edge_window("brusselator 8^3 periodic")
    spec = window.specs[0]
    with pytest.raises(ValueError, match="planes"):
        s3.multi_stencil_3d(datas[:1], spec)
    with pytest.raises(ValueError):
        s3.multi_stencil_3d([d.float() for d in datas], spec)
    with pytest.raises(RuntimeError, match="No multi-stencil kernel"):
        s3.multi_stencil_3d([torch.zeros(8, 8, 8, dtype=torch.float64, device="meta")] * 2, spec)
    outs = [torch.empty_like(d) for d in datas]
    assert s3.multi_stencil_3d(datas, spec, outs=outs) == outs
    for out, ref in zip(outs, s3.multi_stencil_3d_plain(datas, spec), strict=True):
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
