"""The module holding the multi-field ext kernel (TPU kernel #8): the replay
of its row march against its plain version on extended blocks with edge
flags, for
Cahn-Hilliard (depth 2, one operand buffer) and a coupled two-field rhs; the
plain version of one block that wraps onto itself against the serial
kernel's plain version; the generated ext source. ``pde_tpu``'s kernel #8 is
held against the port at the solver level (``test_torch_sharded_solve.py``)."""

import numpy as np
import pytest
import torch

import pde_tpu_torch as tpde
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.parallel import GridMesh

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


FLAG_SETS = [[0, 0, 0, 0], [1, 0, 0, 1], [0, 1, 1, 0], [1, 1, 1, 1]]
CAHN_HILLIARD = {"c": "laplace(0.5 * c**3 - c - 0.1 * laplace(c))"}
COUPLED = {
    "u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
    "v": "0.05 * laplace(v) + u - u**2 * v + 0.1 * gradient_squared(u)",
}


def _window(rhs, bc, shape, decomposition, dt=1e-4):
    grid = tpde.CartesianGrid([(0, 1), (0, 2)], shape, periodic=bc is None)
    fields = [tpde.ScalarField(grid, 0.0, dtype=torch.float64, label=v) for v in rhs]
    state = fields[0] if len(fields) == 1 else tpde.FieldCollection(fields)
    eq = tpde.PDE(rhs, bc="periodic" if bc is None else bc)
    mesh = GridMesh(grid, decomposition, devices=["cpu"] * int(np.prod(decomposition)))
    return eq.make_fused_euler_window(state, dt, mesh=mesh), mesh


def _buffers(spec, n_planes, seed):
    n, m = spec.shape
    h = spec.halo
    gen = np.random.default_rng(seed)
    return [torch.tensor(gen.uniform(-0.5, 0.5, (n + 2 * h, m + 2 * h))) for _ in range(n_planes)]


CASES = {
    "cahn-hilliard no-flux": (CAHN_HILLIARD, {"derivative": 0}, (24, 20), [2, 2]),
    "cahn-hilliard mixed": (
        CAHN_HILLIARD, {"x": {"value": 0.2}, "y": {"curvature": 0.1}}, (24, 40), [2, 2]),
    "coupled robin": (
        COUPLED, {"x": {"type": "mixed", "value": 2.0, "const": 0.5}, "y": {"derivative": 0.1}},
        (24, 20), [2, 2]),
}


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("case", CASES)
def test_tile_emulation_matches_plain(case, flags):
    """The replay of the ext kernel's row march on strips and chunks of 4 and
    5 cells (the name predates the march)."""
    rhs, bc, shape, decomposition = CASES[case]
    window, _ = _window(rhs, bc, shape, decomposition)
    for spec in window.specs:
        ext = _buffers(spec, len(rhs), seed=spec.k)
        plain = ce.multi_stencil_ext_2d_plain(ext, spec, flags)
        for tile in (4, 5):
            tiled = ce.multi_stencil_ext_2d_marched(ext, spec, flags, plan=(tile, tile))
            for a, b in zip(tiled, plain, strict=True):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("rhs", [CAHN_HILLIARD, COUPLED], ids=["cahn-hilliard", "coupled"])
def test_self_wrapped_block_matches_serial_plain(rhs):
    """A 1x1 mesh of a periodic grid: the block's halo is its own wrap, so
    the ext plain version equals the serial kernel's plain version."""
    window, _ = _window(rhs, None, (16, 12), [1, 1])
    serial = cs.make_chunked_multi_window_2d(
        window.program.grid, window.program.make_step, window.program.depth, len(rhs),
        dtype=torch.float64,
    )
    gen = np.random.default_rng(3)
    planes = [torch.tensor(gen.uniform(-0.5, 0.5, (16, 12))) for _ in rhs]
    for spec, serial_spec in zip(window.specs, serial.specs, strict=True):
        h = spec.halo
        ext = [torch.tensor(np.pad(p.numpy(), h, mode="wrap")) for p in planes]
        got = ce.multi_stencil_ext_2d_plain(ext, spec, [0, 0, 0, 0])
        want = cs.multi_stencil_2d_plain(planes, serial_spec)
        for a, b in zip(got, want, strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_on_the_cpu_runs_the_plain_version():
    window, mesh = _window(*CASES["coupled robin"])
    spec = window.specs[0]
    ins = [_buffers(spec, 2, seed=b) for b in range(len(mesh))]
    outs = [[torch.zeros_like(p) for p in planes] for planes in ins]
    flags = [mesh.edge_flags(b) for b in range(len(mesh))]
    launches = ce.multi_stencil_ext_2d.launches
    ce.multi_stencil_ext_2d(ins, outs, flags, spec)
    assert ce.multi_stencil_ext_2d.launches == launches
    h, (n, m) = spec.halo, spec.shape
    for ext, out, f in zip(ins, outs, flags):
        for plane, want in zip(out, ce.multi_stencil_ext_2d_plain(ext, spec, f)):
            torch.testing.assert_close(plane[h:h + n, h:h + m], want, rtol=0, atol=0)


def test_generated_ext_source():
    window, _ = _window(*CASES["cahn-hilliard no-flux"])
    program = window.program
    assert program.library == "multi_stencil_ext_2d"
    source = program.source
    assert '#include "march_2d.cuh"' in source
    # the ghosts follow the flags the ext geometry sets from the edge flags
    assert "if (rf & pde_tpu_torch::kLowEdge)" in source
    assert "else if (cf & pde_tpu_torch::kHighEdge)" in source
    for k in program.ladder:
        tx, threads = program.tiles[torch.float64][k]
        assert f"launch_ext_2d<Program, double, {k}, {tx}, {threads}>" in source
    # the serial program of the same rhs has the same stage functions, its own entry points
    serial = cs.StencilProgram(program.grid, program.make_step, program.depth, 1)
    assert "launch_ext_2d" not in serial.source and "launch_2d<Program" in serial.source
    def struct(text):
        return text[text.index("namespace {"):text.index("}  // namespace")]

    assert struct(serial.source) == struct(source)
    # the probe cut the ladder to the halo a 12x10 block can supply
    assert [s.k for s in window.specs] == [4, 2, 1] and window.specs[0].halo == 8


def test_gate():
    window, _ = _window(*CASES["cahn-hilliard no-flux"])
    program = window.program
    with pytest.raises(tpde.KernelUnsupportedError, match="halo"):
        ce.multi_stencil_ext_spec(program, 4, torch.float64, (12, 10), 4)
    with pytest.raises(tpde.KernelUnsupportedError, match="Shard too small"):
        ce.multi_stencil_ext_spec(program, 1, torch.float64, (12, 1), 2)
    # bf16 (B1(f)) on blocks that cut the columns, through the program's bf16
    # entry points at its float32 plan; refused on a rows-only cut, as pde_tpu's
    # gate (pde_tpu/ops/pallas_cartesian.py:4121-4127, pde_tpu/parallel/fused.py:443)
    with pytest.raises(tpde.KernelUnsupportedError, match="B1\\(f\\).*4121-4127"):
        ce.multi_stencil_ext_spec(program, 1, torch.bfloat16, (12, 20), 2)
    with pytest.raises(tpde.KernelUnsupportedError, match="bf16 entry points"):
        ce.multi_stencil_ext_spec(program, 1, torch.bfloat16, (12, 10), 2)
    bf16 = ce.ExtStencilProgram(program.grid, program.make_step, program.depth,
                                program.n_fields, bf16=True)
    assert "multi_stencil_ext_2d_bf16" in bf16.source and "_f32" not in bf16.source
    spec = ce.multi_stencil_ext_spec(bf16, 1, torch.bfloat16, (12, 10), 2)
    assert spec.tile == bf16.tiles[torch.float32][1]
    with pytest.raises(tpde.KernelUnsupportedError, match="float32 or float64"):
        ce.multi_stencil_ext_spec(program, 1, torch.float16, (12, 10), 2)
    # a periodic axis has no global edge: the kernel drops its test at compile time
    periodic, _ = _window(CAHN_HILLIARD, None, (24, 20), [2, 2])
    spec = periodic.specs[0]
    with pytest.raises(ValueError, match="periodic axis 1"):
        ce.multi_stencil_ext_2d_plain(_buffers(spec, 1, seed=0), spec, [0, 0, 1, 0])
