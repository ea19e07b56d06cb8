"""The 3D multi-field ext kernel (TPU kernel #6, and #4's ``ext_x`` mode):
one k-step pass of its plain version against ``pde_tpu``'s
``make_fused_multi_ext_window_3d`` (every axis extended) in interpret mode on
the same extended blocks and edge flags, fp64, at 1e-12, for an Allen-Cahn
step with a squared gradient over Dirichlet/Neumann/Robin/curvature faces and
for a coupled two-field step; the replay of the kernel's march against the
plain version at plans that cut the block several times; a self-wrapped
block against the serial kernel's plain version; the generated ext source;
the wrapper on the CPU; and the gate."""

import functools

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import affine_bc_specs as jax_affine_bc_specs
from pde_tpu.ops.pallas_cartesian import make_fused_multi_ext_window_3d as jax_multi_ext_3d
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_ext_3d as e3
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
LOCAL = (6, 5, 7)
FLAG_SETS = [
    [0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0], [0, 1, 0, 1, 0, 1], [1, 0, 1, 0, 1, 0],
    [1, 1, 1, 1, 1, 1],
]
# id: (periodic, bc) on an anisotropic 12x10x14 grid
BCS = {
    "mixed faces": (False, {"x-": {"value": 1.0}, "x+": {"derivative": 0.3},
                            "y-": {"type": "mixed", "value": 2.0, "const": 0.5},
                            "y+": {"curvature": 1.0}, "z": {"value": -0.5}}),
    "periodic x": ([True, False, False], {"x": "periodic", "y": {"derivative": 0.1},
                                          "z": {"value": 0.2}}),
    "periodic": (True, None),
}


def _allen_cahn_gsq(specs):
    """One Euler step of ``0.5 laplace(c) - 0.05 |grad c|^2 - c^3 + c``, for
    either package's helpers."""

    def make_step(h):
        def step(works):
            (w,) = works
            c = h.trim(w, 1)
            rate = 0.5 * h.lap(w, bc=specs) - 0.05 * h.gradient_squared(w, bc=specs) - c * c * c + c
            return [c + DT * rate]

        return step

    return make_step


def _coupled(specs):
    """One Euler step of a Brusselator with a squared gradient in v."""

    def make_step(h):
        def step(works):
            u, v = works
            cu, cv = h.trim(u, 1), h.trim(v, 1)
            du = 0.1 * h.lap(u, bc=specs) + 1 - 2 * cu + cu * cu * cv
            dv = (0.05 * h.lap(v, bc=specs) + cu - cu * cu * cv
                  + 0.1 * h.gradient_squared(u, bc=specs))
            return [cu + DT * du, cv + DT * dv]

        return step

    return make_step


STEPS = {"allen-cahn-gsq": (_allen_cahn_gsq, 1), "coupled": (_coupled, 2)}


def _setup(bc_id):
    periodic, bc = BCS[bc_id]
    args = ([(0, 1), (0, 2), (0, 3)], [12, 10, 14])
    jgrid = jpde.CartesianGrid(*args, periodic=periodic)
    tgrid = tpde.CartesianGrid(*args, periodic=periodic)
    jspecs = tspecs = None
    if bc is not None:
        jspecs = jax_affine_bc_specs(jgrid, jgrid.get_boundary_conditions(bc))
        tspecs = cc.affine_bc_specs(tgrid, tgrid.get_boundary_conditions(bc))
    return jgrid, tgrid, jspecs, tspecs


@functools.cache
def _jax_step(step_id, bc_id, k):
    jgrid, _, jspecs, _ = _setup(bc_id)
    make, n_fields = STEPS[step_id]
    step, k_used = jax_multi_ext_3d(
        jgrid, make(jspecs), 1, n_fields, local_shape=LOCAL, ext_axes=(True,) * 3,
        dtype=np.float64, k=k, interpret=True,
    )
    assert k_used == k
    return step


@functools.cache
def _program(step_id, bc_id):
    _, tgrid, _, tspecs = _setup(bc_id)
    make, n_fields = STEPS[step_id]
    return e3.ExtStencilProgram3D(tgrid, make(tspecs), 1, n_fields)


def _buffers(n_fields, halo, seed, local=LOCAL):
    gen = np.random.default_rng(seed)
    shape = tuple(n + 2 * halo for n in local)
    return [gen.uniform(-0.5, 0.5, shape) + f for f in range(n_fields)]


def _masked(flags, periodic):
    return [int(f and not periodic[i // 2]) for i, f in enumerate(flags)]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("rung", [-1, 0], ids=["1", "top"])
@pytest.mark.parametrize("bc_id", BCS)
@pytest.mark.parametrize("step_id", STEPS)
def test_plain_matches_jax_kernel(step_id, bc_id, rung, flags):
    """k = 1 and the top k of the program's ladder."""
    program = _program(step_id, bc_id)
    k = program.ladder[rung]
    flags = _masked(flags, program.geometry.periodic)
    spec = e3.multi_stencil_ext_3d_spec(program, k, torch.float64, LOCAL, k)
    exts = _buffers(program.n_fields, k, seed=3 * k + sum(flags))
    expected = _jax_step(step_id, bc_id, k)(exts, np.asarray(flags, dtype=np.int32))
    launches = e3.multi_stencil_ext_3d.launches
    got = e3.multi_stencil_ext_3d_plain([torch.tensor(x) for x in exts], spec, flags)
    assert e3.multi_stencil_ext_3d.launches == launches
    for g, e in zip(got, expected, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **TOL)


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("bc_id", ["mixed faces", "periodic x"])
@pytest.mark.parametrize("step_id", STEPS)
def test_march_replay_matches_plain(step_id, bc_id, flags):
    """At every k of the ladder, a halo wider than the pass needs, plans that
    cut the block several times (ragged) and the kernel's own plan."""
    program = _program(step_id, bc_id)
    flags = _masked(flags, program.geometry.periodic)
    for k in program.ladder:
        spec = e3.multi_stencil_ext_3d_spec(program, k, torch.float64, LOCAL, 4)
        exts = [torch.tensor(x) for x in _buffers(program.n_fields, 4, seed=k)]
        plain = e3.multi_stencil_ext_3d_plain(exts, spec, flags)
        for tile in ((2, 3, 4), (4, 2, 3), None):
            marched = e3.multi_stencil_ext_3d_marched(exts, spec, flags, tile=tile)
            for a, b in zip(marched, plain, strict=True):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("step_id", STEPS)
def test_self_wrapped_block_matches_serial_plain(step_id):
    """A block of a periodic grid whose halo is its own wrap: the ext plain
    version equals the serial kernel's plain version."""
    program = _program(step_id, "periodic")
    serial = s3.StencilProgram3D(program.grid, program.make_step, 1, program.n_fields)
    gen = np.random.default_rng(5)
    planes = [torch.tensor(gen.uniform(-0.5, 0.5, (12, 10, 14))) for _ in range(program.n_fields)]
    for k in program.ladder:
        spec = e3.multi_stencil_ext_3d_spec(program, k, torch.float64, (12, 10, 14), 3)
        exts = [torch.tensor(np.pad(p.numpy(), 3, mode="wrap")) for p in planes]
        got = e3.multi_stencil_ext_3d_plain(exts, spec, [0] * 6)
        want = s3.multi_stencil_3d_plain(planes, cs.multi_stencil_spec(serial, k, torch.float64))
        for a, b in zip(got, want, strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_on_the_cpu_runs_the_plain_version():
    program = _program("coupled", "mixed faces")
    spec = e3.multi_stencil_ext_3d_spec(program, program.ladder[0], torch.float64, LOCAL, 3)
    flags = [[1, 0, 1, 0, 1, 0], [0, 1, 0, 1, 0, 1], [0, 0, 0, 0, 0, 0]]
    ins = [[torch.tensor(x) for x in _buffers(2, 3, seed=b)] for b in range(3)]
    outs = [[torch.zeros_like(p) for p in planes] for planes in ins]
    launches = e3.multi_stencil_ext_3d.launches
    assert e3.multi_stencil_ext_3d(ins, outs, flags, spec) == outs
    assert e3.multi_stencil_ext_3d.launches == launches
    interior = tuple(slice(3, 3 + n) for n in LOCAL)
    for ext, out, f in zip(ins, outs, flags):
        for plane, want in zip(out, e3.multi_stencil_ext_3d_plain(ext, spec, f)):
            torch.testing.assert_close(plane[interior], want, rtol=0, atol=0)
            plane[interior] = 0.0
            assert not bool(plane.any())  # the halo shell is left as it was
    with pytest.raises(ValueError, match="2 input and output volumes"):
        e3.multi_stencil_ext_3d([p[:1] for p in ins], outs, flags, spec)
    meta = [[torch.zeros_like(p, device="meta") for p in planes] for planes in ins]
    with pytest.raises(RuntimeError, match="No 3D multi-stencil ext kernel"):
        e3.multi_stencil_ext_3d(meta, [[torch.zeros_like(p) for p in q] for q in meta], flags,
                                spec)


def test_generated_ext_source():
    program = _program("allen-cahn-gsq", "periodic x")
    assert program.library == "multi_stencil_ext_3d" and program.rank == 3
    source = program.source
    assert '#include "multi_stencil_3d.cuh"' in source
    # the ghosts follow the march's flags, which the ext kernel's geometry
    # sets from the block's face flags: no x face here (x is periodic)
    assert "kXPeriodic = true" in source and "pf & pde_tpu_torch::kLowEdge" not in source
    assert "if (cf & pde_tpu_torch::kLowEdge)" in source
    assert "else if (cf & pde_tpu_torch::kHighEdgeZ)" in source
    for k in program.ladder:
        cx, ty, tz = program.tiles[torch.float64][k]
        assert f"launch_ext_3d<Program, double, {k}, {cx}, {ty}, {tz}>" in source
    # the serial program of the same rhs has the same program struct (its stage
    # functions, which both kernels call) and its own entry points
    serial = s3.StencilProgram3D(program.grid, program.make_step, 1, 1)

    def struct(text):
        return text[text.index("struct Program {"):text.index("}  // namespace")]

    assert struct(serial.source) == struct(source)
    assert "launch_ext_3d" not in serial.source and "launch_3d<Program" in serial.source


def test_gate():
    program = _program("allen-cahn-gsq", "mixed faces")
    with pytest.raises(tpde.KernelUnsupportedError, match="halo"):
        e3.multi_stencil_ext_3d_spec(program, 3, torch.float64, LOCAL, 1)
    with pytest.raises(tpde.KernelUnsupportedError, match="Shard too small"):
        e3.multi_stencil_ext_3d_spec(program, 1, torch.float64, (6, 1, 7), 2)
    with pytest.raises(tpde.KernelUnsupportedError, match="ladder"):
        e3.multi_stencil_ext_3d_spec(program, 2, torch.float64, LOCAL, 3)
    with pytest.raises(tpde.KernelUnsupportedError, match="float32 or float64"):
        e3.multi_stencil_ext_3d_spec(program, 1, torch.bfloat16, LOCAL, 1)
    with pytest.raises(tpde.KernelUnsupportedError, match="ExtStencilProgram3D"):
        e3.multi_stencil_ext_3d_spec(
            s3.StencilProgram3D(program.grid, program.make_step, 1, 1), 1, torch.float64,
            LOCAL, 1)
    # a periodic axis has no global face: the kernel drops its test at compile time
    periodic = _program("allen-cahn-gsq", "periodic x")
    spec = e3.multi_stencil_ext_3d_spec(periodic, 1, torch.float64, LOCAL, 1)
    exts = [torch.tensor(x) for x in _buffers(1, 1, seed=0)]
    with pytest.raises(ValueError, match="periodic axis 0"):
        e3.multi_stencil_ext_3d_plain(exts, spec, [1, 0, 0, 0, 0, 0])
