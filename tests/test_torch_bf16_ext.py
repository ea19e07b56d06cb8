"""bf16 storage on decomposed 2D grids (ROADMAP B1(f)), on the CPU: the ext
kernels #12 (the diffusion windows, with side inputs and in the radial mode)
and #8 (the expression windows: Cahn-Hilliard Euler, RK4 and AB2, with and
without ``bc_inputs``) take bf16 where the mesh cuts the columns, as
``pde_tpu``'s ``ext_cols`` gates take it; every level is rounded to bf16.

- #12's plain version against ``pde_tpu``'s ext kernel in interpret mode
  (``ext_cols=True``) on 16x64 blocks, within 2**-6 of max|f|; its march
  replay and tile emulation bit-equal to it.
- Decomposed bf16 diffusion windows on [2, 2] and [1, 2] bit-equal to the
  serial plain window (every level rounded, so the ladders do not matter).
- #8: bf16 solves on [2, 2] fused, against ``pde_tpu``'s decomposed runs in
  interpret mode within 2**-6 of max|f| (Euler and RK4; ``pde_tpu``'s AB2
  raises on bf16 states, in its serial and its decomposed runs, so the port's
  is held against the fp64 run alone) and within steps * 2**-8 of max|f| of
  an fp64 run; the march replay bit-equal to the plain version; a window of
  n steps bit-equal to n windows of one.
- The routes: a rows-only cut and the serial #7 keep bf16 on the plain loops
  under the ``torch`` engine, and the ``cuda`` engine refuses, naming
  ``pde_tpu``'s gates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.ops.pallas_cartesian import affine_bc_specs as jax_affine_bc_specs
from pde_tpu.ops.pallas_cartesian import make_affine_laplace_ext_2d as jax_affine_laplace_ext_2d
from pde_tpu_torch.ops import cuda_cartesian as cc
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.parallel import GridMesh

torch.set_num_threads(1)

BF16 = torch.bfloat16
B = 0.01
DT = 0.1
T0 = 0.3
LOCAL = (16, 64)
FLAG_SETS = [[0, 0, 0, 0], [1, 0, 1, 0], [0, 1, 0, 1], [1, 1, 1, 1]]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _bf16(shape, seed, low=-1.0, high=1.0):
    """Seeded bf16 values: the ml_dtypes array pde_tpu takes, and the torch tensor."""
    values = np.random.default_rng(seed).uniform(low, high, shape).astype(jnp.bfloat16)
    return values, torch.tensor(values.astype(np.float32)).to(BF16)


# -- kernel #12 ---------------------------------------------------------------------------------
# id -> (grid class, arguments, keyword arguments, conditions or None); 32x128 grids
# of unit spacing, blocks of 16x64
GRIDS = {
    "periodic": ("CartesianGrid", ([(0, 32), (0, 128)], [32, 128]), {"periodic": True}, None),
    "bounded": ("CartesianGrid", ([(0, 32), (0, 128)], [32, 128]), {},
                {"x-": {"value": 0.3}, "x+": {"derivative": 0.1},
                 "y-": {"type": "mixed", "value": 0.5, "const": 0.2}, "y+": {"value": -0.2}}),
    "radial": ("CylindricalSymGrid", ((16, 48), (0, 128), (32, 128)), {"periodic_z": True},
               {"r-": {"value": 0.2}, "r+": {"derivative": 0}, "z": "periodic"}),
}


def _ext_spec(case, k, dtype=BF16):
    cls, args, kwargs, bc = GRIDS[case]
    jgrid, tgrid = getattr(jpde, cls)(*args, **kwargs), getattr(tpde, cls)(*args, **kwargs)
    bcs = None if bc is None else tgrid.get_boundary_conditions(bc)
    spec = ce.affine_laplace_ext_spec(tgrid, LOCAL, a=1.0, b=B, k=k, halo=k, dtype=dtype, bcs=bcs)
    return jgrid, spec


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("k", [1, 4, 12])
@pytest.mark.parametrize("case", GRIDS)
def test_ext_plain_matches_jax(case, k, flags):
    """pde_tpu's ext kernel #12 with ext_cols=True in interpret mode on a bf16
    block (the radial mode on the cylinder's, k up to its top), against the
    port's plain version; both within k * 2**-8 of max|f| of an fp64 pass."""
    if case == "radial":
        k = min(k, cc.RADIAL_TOP_STEPS)
    flags = [0, 0, 0, 0] if case == "periodic" else flags
    if case == "radial":
        flags = flags[:2] + [0, 0]
    jgrid, spec = _ext_spec(case, k)
    values, ext = _bf16((LOCAL[0] + 2 * k, LOCAL[1] + 2 * k), seed=k + sum(flags))
    bc = GRIDS[case][3]
    radial = None
    if case == "radial":
        radial = (float(jgrid.axes_bounds[0][0]), float(jgrid.discretization[0]))
    bc_specs = None if bc is None else jax_affine_bc_specs(jgrid,
                                                           jgrid.get_boundary_conditions(bc))
    kernel = jax_affine_laplace_ext_2d(
        LOCAL, a=1.0, b=B, k=k, discretization=jgrid.discretization, ext_cols=True,
        dtype=jnp.bfloat16, interpret=True, radial=radial, bc_specs=bc_specs)
    row0 = LOCAL[0] if flags[1] else 0
    expected = np.asarray(kernel(jnp.asarray(values), np.asarray(flags + [row0], dtype=np.int32)),
                          dtype=np.float64)
    block_flags = flags + [row0] if case == "radial" else flags
    got = ce.affine_laplace_ext_2d_plain(ext, spec, block_flags)
    assert got.dtype == BF16
    got = got.double().numpy()
    top = float(np.abs(values.astype(np.float64)).max())
    _, spec64 = _ext_spec(case, k, torch.float64)
    exact = ce.affine_laplace_ext_2d_plain(ext.double(), spec64, block_flags).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=k * 2**-8 * top)
    # pde_tpu's radial row factors are formed in bf16 (see test_torch_bf16.py):
    # beyond k = 2 the two are held within k * 2**-7 of max|f|
    atol = max(2**-6, k * 2**-7) if case == "radial" else 2**-6
    np.testing.assert_allclose(got, expected, rtol=0, atol=atol * top)


SIDE_CASES = {
    "bounded rows, side inputs": (
        "CartesianGrid", ([(0, 32), (0, 128)], [32, 128]), {"periodic": [False, True]},
        lambda: {"x-": {"value": 0.5 * np.sin(np.linspace(0.0, 6.0, 128))},
                 "x+": {"value_expression": "0.2*sin(3*t)"}, "y": "periodic"}, cc.SIDES_TOP_STEPS),
    "bounded, side inputs": (
        "CartesianGrid", ([(0, 32), (0, 128)], [32, 128]), {},
        lambda: {"x": {"derivative": 0}, "y-": {"value": np.linspace(-0.5, 0.5, 32)},
                 "y+": {"value_expression": "0.1*cos(t)"}}, cc.SIDES_TOP_STEPS),
    "radial, side inputs": (
        "CylindricalSymGrid", ((16, 48), (0, 128), (32, 128)), {"periodic_z": True},
        lambda: {"r-": {"value_expression": "0.1*sin(3*t)"},
                 "r+": {"value": 0.5 * np.cos(np.linspace(0.0, 4.0, 128))}, "z": "periodic"},
        cc.RADIAL_SIDES_TOP_STEPS),
}
REPLAYS = [*GRIDS, *SIDE_CASES]


def _replay_case(case, k):
    """(spec, a block's flags with its origin, its side inputs) of a bf16 pass
    of the second block of a [2, 2] mesh."""
    if case in GRIDS:
        _, spec = _ext_spec(case, k)
        return spec, [1, 0, 0, 1] if case == "bounded" else [0, 0, 0, 0] if case == "periodic" \
            else [1, 0, 0, 0, 0], None
    cls, args, kwargs, make_bc, _ = SIDE_CASES[case]
    grid = getattr(tpde, cls)(*args, **kwargs)
    bcs = grid.get_boundary_conditions(make_bc())
    spec = ce.affine_laplace_ext_spec(grid, LOCAL, a=1.0, b=B, k=k, halo=k, dtype=BF16, bcs=bcs)
    mesh = GridMesh(grid, [2, 2], devices=["cpu"] * 4)
    times = [T0 + s * DT for s in range(k)]
    sides = cc.AffineSideInputs(grid, bcs).for_pass(BF16, "cpu", times, row_pad=cc.SIDE_PAD)
    flags = [0 if spec.periodic[i // 2] else f for i, f in enumerate(mesh.edge_flags(1))]
    return spec, flags + list(mesh.block_origin(1)), sides


@pytest.mark.parametrize("case", REPLAYS)
def test_ext_replay_and_emulation_equal_plain(case):
    k = 3
    spec, flags, sides = _replay_case(case, k)
    _, ext = _bf16((LOCAL[0] + 2 * k, LOCAL[1] + 2 * k), seed=4)
    plain = ce.affine_laplace_ext_2d_plain(ext, spec, flags, sides)
    for plan in (None, (16, 8)):
        torch.testing.assert_close(ce.affine_laplace_ext_2d_marched(ext, spec, flags, plan, sides),
                                   plain, rtol=0, atol=0)
    torch.testing.assert_close(ce.affine_laplace_ext_2d_tiled(ext, spec, flags, (16, 8), sides),
                               plain, rtol=0, atol=0)


# -- decomposed diffusion windows against the serial plain window --------------------------------
WINDOWS = {
    "periodic": ("UnitGrid", ([32, 128],), {"periodic": True}, "periodic"),
    "bounded columns": ("CartesianGrid", ([(0, 32), (0, 128)], [32, 128]), {},
                        {"x": {"derivative": 0}, "y": {"value": 0.2}}),
    **{case: (cls, args, kwargs, make_bc()) for case, (cls, args, kwargs, make_bc, _)
       in SIDE_CASES.items()},
}


def _serial_plain(grid, bcs, data, steps):
    """The serial plain window: `steps` one-step plain passes of the global grid
    in the bf16 arithmetic (the spec of the ext kernel's gate, which takes
    bounded columns; every level rounded, so any ladder gives these values)."""
    spec = cc.affine_laplace_spec(grid, a=1.0, b=DT * 0.1, k=1, dtype=BF16, bcs=bcs, ext_cols=True)
    inputs = cc.AffineSideInputs(grid, bcs) if spec.has_sides else None
    for s in range(steps):
        sides = None if inputs is None else inputs.for_pass(BF16, "cpu", [T0 + s * DT])
        data = cc.affine_laplace_2d_plain(data, spec, sides)
    return data


@pytest.mark.parametrize("cut", [[2, 2], [1, 2]])
@pytest.mark.parametrize("case", WINDOWS)
def test_decomposed_window_is_the_serial_plain_window(case, cut):
    cls, args, kwargs, bc = WINDOWS[case]
    grid = getattr(tpde, cls)(*args, **kwargs)
    _, data = _bf16(grid.shape, seed=6)
    state = tpde.ScalarField(grid, data)
    eq = tpde.DiffusionPDE(0.1, bc=bc)
    mesh = GridMesh(grid, cut, devices=["cpu"] * int(np.prod(cut)))
    window = eq.make_fused_euler_window(state, DT, mesh=mesh)
    assert window.sharded and all(spec.dtype == BF16 for spec in window.specs)
    launches = ce.affine_laplace_ext_2d.launches
    timed = (T0, 23) if window.needs_t else (23,)
    got = window([[b] for b in mesh.split_field_data(data)], *timed)
    assert ce.affine_laplace_ext_2d.launches == launches  # the plain versions on the CPU
    got = mesh.combine_field_data([b[0] for b in got])
    bcs = None if bc == "periodic" else grid.get_boundary_conditions(bc)
    torch.testing.assert_close(got, _serial_plain(grid, bcs, data, 23), rtol=0, atol=0)


@pytest.mark.parametrize("route", ["[2, 2] fused", "[2, 1] plain", "[2, 1] cuda"])
def test_diffusion_routes_on_meshes(route):
    """bf16 on a mesh that cuts the columns takes #12; a rows-only cut runs the
    plain sharded stepper under the torch engine and is refused under the
    cuda engine, naming pde_tpu's gate."""
    grid = tpde.UnitGrid([32, 128], periodic=True)
    _, data = _bf16(grid.shape, seed=8)
    state = tpde.ScalarField(grid, data)
    eq = tpde.DiffusionPDE(0.1)
    cut = [2, 2] if route.startswith("[2, 2]") else [2, 1]
    if route.endswith("cuda"):
        with pytest.raises(RuntimeError, match="B1\\(f\\).*5764-5767"):
            tpde.ExplicitSolver(eq, backend="cuda", decomposition=cut).make_stepper(state, dt=DT)
        return
    solver = tpde.ExplicitSolver(eq, backend="torch", decomposition=cut)
    result, _ = solver.make_stepper(state, dt=DT)(state, 0.0, 2.0)
    assert result.dtype == BF16 and solver.info["decomposition"] == cut
    if route.endswith("fused"):
        assert solver.info["fused_step"] is True
        torch.testing.assert_close(result.data, _serial_plain(grid, None, data, 20), rtol=0, atol=0)
    else:
        assert solver.info.get("fused_step", False) is False
        assert "5764-5767" in solver.info["fused_unsupported"]


# -- kernel #8 ----------------------------------------------------------------------------------
NOFLUX = {"derivative": 0}
SIDES = {"x": {"value": 0.2}, "y": {"value_expression": "0.1*sin(t)"}}
SCHEMES = {
    "euler": (jpde.ExplicitSolver, tpde.ExplicitSolver, {}),
    "rk4": (jpde.RungeKuttaSolver, tpde.RungeKuttaSolver, {"adaptive": False}),
    "ab2": (None, tpde.AdamsBashforthSolver, {}),  # pde_tpu's AB2 raises on bf16 states
}
CH_SHAPE = [32, 32]


def _ch_run(pkg, solver_cls, kwargs, bc, values, decomposition, steps=20):
    grid = pkg.UnitGrid(CH_SHAPE)
    state = pkg.ScalarField(grid, values)
    solver = solver_cls(pkg.CahnHilliardPDE(bc_c=bc, bc_mu=bc), decomposition=decomposition,
                        **kwargs)
    result, _ = solver.make_stepper(state, dt=1e-3)(state, 0.0, steps * 1e-3)
    return np.asarray(result.data if pkg is jpde else result.to_numpy(), dtype=np.float64), solver


@pytest.mark.parametrize("bc", [NOFLUX, SIDES], ids=["no-flux", "bc inputs"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_cahn_hilliard_on_a_mesh_matches_jax_and_fp64(scheme, bc, monkeypatch):
    jax_solver, port_solver, kwargs = SCHEMES[scheme]
    values, _ = _bf16(CH_SHAPE, seed=0, low=-0.5, high=0.5)
    launches = ce.multi_stencil_ext_2d.launches
    got, solver = _ch_run(tpde, port_solver, kwargs, bc, values, [2, 2])
    assert solver.info["fused_step"] is True and solver.info["decomposition"] == [2, 2]
    assert ce.multi_stencil_ext_2d.launches == launches  # the plain versions on the CPU
    top = float(np.abs(values.astype(np.float64)).max())
    exact, _ = _ch_run(tpde, port_solver, kwargs, bc, values.astype(np.float64), None)
    np.testing.assert_allclose(got, exact, rtol=0, atol=20 * 2**-8 * top)
    if jax_solver is not None:
        monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
        monkeypatch.delenv("PDE_TPU_DISABLE_FUSED", raising=False)
        expected, jsolver = _ch_run(jpde, jax_solver, kwargs, bc, values, [2, 2])
        assert jsolver.info.get("fused_step") is True
        np.testing.assert_allclose(got, expected, rtol=0, atol=2**-6 * top)


def _ch_window(scheme, bc, cut=(2, 2)):
    grid = tpde.UnitGrid(CH_SHAPE)
    values, data = _bf16(CH_SHAPE, seed=1, low=-0.5, high=0.5)
    state = tpde.ScalarField(grid, values)
    mesh = GridMesh(grid, list(cut), devices=["cpu"] * int(np.prod(cut)))
    hook = {"euler": "make_fused_euler_window", "rk4": "make_fused_rk4_window",
            "ab2": "make_fused_ab2_window"}[scheme]
    window = getattr(tpde.CahnHilliardPDE(bc_c=bc, bc_mu=bc), hook)(state, 1e-3, mesh=mesh)
    return window, mesh, data


@pytest.mark.parametrize("scheme", SCHEMES)
def test_ext_march_replays_plain_version(scheme):
    """The bf16 ext program's march (planes in float32, each field's next
    level rounded to bf16 in the last stage) equals its plain version bit for
    bit at every k of the ladder and under every edge flag."""
    window, _, _ = _ch_window(scheme, NOFLUX)
    program = window.program
    assert program.bf16 and "multi_stencil_ext_2d_bf16" in program.source
    assert "_f32(" not in program.source and "__nv_bfloat16>(ins" in program.source
    for flags in FLAG_SETS:
        for spec in window.specs:
            assert spec.dtype == BF16
            exts = [_bf16(tuple(n + 2 * spec.halo for n in spec.shape), seed=spec.k + i,
                          low=-0.5, high=0.5)[1] for i in range(program.n_fields)]
            plain = ce.multi_stencil_ext_2d_plain(exts, spec, flags)
            assert all(p.dtype == BF16 for p in plain)
            for plan in ((8, 5), None):
                replay = ce.multi_stencil_ext_2d_marched(exts, spec, flags, plan=plan)
                for a, b in zip(replay, plain, strict=True):
                    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("scheme", ["euler", "rk4"])
def test_window_of_n_steps_is_n_windows_of_one(scheme):
    """Every level is bf16, so the ladder of passes does not change a result."""
    window, mesh, data = _ch_window(scheme, SIDES)
    blocks = [[b] for b in mesh.split_field_data(data)]
    deep = window(blocks, 0.0, 8) if window.needs_t else window(blocks, 8)
    for i in range(8):
        blocks = window(blocks, i * 1e-3, 1) if window.needs_t else window(blocks, 1)
    for a, b in zip(deep, blocks, strict=True):
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


@pytest.mark.parametrize("route", ["serial", "[2, 1]"])
def test_cahn_hilliard_routes(route):
    """The serial #7 and #8 on a rows-only cut refuse bf16, as pde_tpu's gates:
    the torch engine runs the plain loops, the cuda engine names the gate."""
    values, _ = _bf16(CH_SHAPE, seed=2, low=-0.5, high=0.5)
    cut, line = (None, "3815") if route == "serial" else ([2, 1], "4121-4127")
    _, solver = _ch_run(tpde, tpde.ExplicitSolver, {"backend": "torch"}, NOFLUX, values, cut,
                        steps=2)
    assert solver.info.get("fused_step", False) is False
    assert line in solver.info["fused_unsupported"]
    with pytest.raises(RuntimeError, match=f"B1\\(f\\).*{line}"):
        _ch_run(tpde, tpde.ExplicitSolver, {"backend": "cuda"}, NOFLUX, values, cut, steps=2)


# -- #8's bf16 kernel: edge-free interior blocks --------------------------------------------------
# The bf16 ext kernel (csrc/march_bf16_ext_2d.cuh) marches a block edge-free where its
# window meets no flagged side; its replay carries that classification. On 32x32 blocks
# (a 64x64 grid on [2, 2]) the plans (8, 5) and (16, 8) give blocks of both kinds
BIG_SHAPE = [64, 64]
PLANS = [(8, 5), (16, 8), None]
# Cahn-Hilliard on a grid periodic along its rows, bounded along its columns
ROWS_PERIODIC = {"x": "periodic", "y": {"derivative": 0}}
# the float32 and float64 programs of #7 and #8 (the one library of both dtypes),
# before the bf16 kernel had a template of its own: its edits leave them as they were
FP_DIGESTS = {
    "#7 periodic euler": "68e5f08b0abef64b", "#8 periodic euler": "25fc2d9deabb1410",
    "#7 periodic rk4": "23341ee703e945e8", "#8 periodic rk4": "185e48f4bbb98cdf",
    "#7 periodic ab2": "4b310a3cea327f83", "#8 periodic ab2": "b5cbcc8337096506",
    "#7 no-flux euler": "44af5d08f9283ff8", "#8 no-flux euler": "0b46924f5b9a06f8",
    "#7 no-flux rk4": "f590d17b7c1d06c6", "#8 no-flux rk4": "485dd6beaa7f5d5d",
    "#7 no-flux ab2": "8d2cd7a93e687711", "#8 no-flux ab2": "403e7c99736fed7a",
    "#7 side inputs euler": "a198ff99cf420467", "#8 side inputs euler": "e90b409721b3a3ea",
    "#7 side inputs rk4": "a37ee931563f63a5", "#8 side inputs rk4": "4afa287d7befbc7e",
}
SIDE_BC = {"x-": {"value_expression": "0.1*sin(3*t)"}, "x+": {"value": np.linspace(0, 0.1, 32)},
           "y-": {"value_expression": "cos(x)*sin(t)"}, "y+": {"derivative": 0}}


def _fp_equation(case):
    if case == "periodic":
        return tpde.UnitGrid([32, 32], periodic=True), tpde.CahnHilliardPDE()
    if case == "no-flux":
        return tpde.UnitGrid([32, 32]), tpde.CahnHilliardPDE(bc_c=NOFLUX, bc_mu=NOFLUX)
    return tpde.UnitGrid([32, 32]), tpde.PDE({"c": "laplace(c**3 - c - laplace(c))"}, bc=SIDE_BC)


def test_fp_programs_keep_their_sources():
    """The float32 and float64 programs of #7 and #8 keep their digests (of
    their source, template and flags), so their kernels keep their SASS."""
    got = {}
    for case in ("periodic", "no-flux", "side inputs"):
        grid, eq = _fp_equation(case)
        for dtype in (torch.float32, torch.float64):
            state = tpde.ScalarField(grid, 0.1, dtype=dtype)
            mesh = GridMesh(grid, [2, 2], devices=["cpu"] * 4)
            for scheme in ("euler", "rk4", "ab2"):
                if case == "side inputs" and scheme == "ab2":
                    continue
                hook = getattr(eq, {"euler": "make_fused_euler_window",
                                    "rk4": "make_fused_rk4_window",
                                    "ab2": "make_fused_ab2_window"}[scheme])
                serial, ext = hook(state, 1e-3).program, hook(state, 1e-3, mesh=mesh).program
                assert "march_bf16_ext_2d" not in ext.source
                for kernel, program in (("#7", serial), ("#8", ext)):
                    label = f"{kernel} {case} {scheme}"
                    assert got.setdefault(label, program.digest) == program.digest
    assert got == FP_DIGESTS


@pytest.mark.parametrize("bc", [None, NOFLUX, SIDES], ids=["periodic", "no-flux", "bc inputs"])
@pytest.mark.parametrize("scheme", ["euler", "rk4"])
def test_bf16_source(scheme, bc):
    """A bf16 program's library launches the bf16 kernel's template: one
    launch whose blocks branch once between the interior march and the ext
    kernels' row march, on the program's stage functions, whose last stage
    rounds each field's next level to bf16."""
    program = _big_window(scheme, bc)[0].program
    assert program.bf16 and program.headers == (ce.BF16_EXT_TEMPLATE,)
    assert '#include "march_bf16_ext_2d.cuh"' in program.source
    assert '#include "march_2d.cuh"' not in program.source
    launcher = "launch_bf16_ext_sides_2d" if bc is SIDES else "launch_bf16_ext_2d"
    for k in program.ladder:
        tx, threads = program.tiles[torch.float32][k]
        assert (f"{launcher}<Program, float, {k}, {tx}, {threads}, __nv_bfloat16>(ins"
                in program.source)
    assert "__float2bfloat16_rn" in program.source
    template = ce.BF16_EXT_TEMPLATE.read_text()
    assert '#include "march_2d.cuh"' in template
    for march in ("InteriorRowMarch<P, T, K, TX, NT, Geo, ST> march(geo, in, out, smem);",
                  "RowMarch<P, T, K, TX, NT, Geo, ST> march(geo, in, out, smem, {}, sides);"):
        assert template.count(march) == 1
    fp = ce.ExtStencilProgram(program.grid, program.make_step, program.depth, program.n_fields,
                              carry=program.carry, sides=program.sides)
    assert not fp.bf16 and fp.headers == () and fp.digest != program.digest


def _classified(spec, flags, plan):
    """(interior, edge) blocks of a pass at `plan`: their origins."""
    tx, chunk = plan
    n_rows, n_cols = spec.shape
    halo = spec.k * spec.program.depth
    blocks = {True: [], False: []}
    for r0 in range(0, n_rows, chunk):
        for c0 in range(0, n_cols, tx):
            inside = ce.ext_window_interior(spec.shape, spec.halo, flags, (r0, c0), tx, halo,
                                            chunk, spec.program.geometry.periodic)
            blocks[inside].append((r0, c0))
    return blocks[True], blocks[False], halo


def _big_window(scheme, bc):
    periodic = [True, False] if bc is ROWS_PERIODIC else bc is None
    grid = tpde.UnitGrid(BIG_SHAPE, periodic=periodic)
    values, _ = _bf16(BIG_SHAPE, seed=3, low=-0.5, high=0.5)
    state = tpde.ScalarField(grid, values)
    mesh = GridMesh(grid, [2, 2], devices=["cpu"] * 4)
    if bc is SIDES:
        eq = tpde.PDE({"c": "laplace(c**3 - c - laplace(c))"},
                      bc={**SIDES, "x+": {"value": np.linspace(-0.2, 0.2, BIG_SHAPE[1])}})
    else:
        eq = tpde.CahnHilliardPDE() if bc is None else tpde.CahnHilliardPDE(bc_c=bc, bc_mu=bc)
    hook = {"euler": "make_fused_euler_window", "rk4": "make_fused_rk4_window"}[scheme]
    return getattr(eq, hook)(state, 1e-3, mesh=mesh), mesh


@pytest.mark.parametrize("bc", [NOFLUX, ROWS_PERIODIC], ids=["no-flux", "rows periodic"])
@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("plan", [(8, 5), (8, 8), (64, 16)])
def test_interior_blocks_have_no_edge(plan, flags, bc):
    """Every block the bf16 kernel classifies interior has, in the ext
    kernel's window of ``csrc/march_2d.cuh`` (every flag set), no edge flag on any
    column or row, and every cell loaded and in the domain; at every k of the
    Euler ladder, on 32x32 blocks (a strip of 64 overhangs the buffer: no
    block of it is interior). On a grid periodic along its rows the rows'
    flags are ignored, as the kernel ignores them."""
    window, _ = _big_window("euler", bc)
    periodic = window.program.geometry.periodic
    assert periodic == ((True, False) if bc is ROWS_PERIODIC else (False, False))
    live = [bool(f) and not periodic[i // 2] for i, f in enumerate(flags)]
    exts = [torch.zeros(tuple(n + 2 * window.specs[0].halo for n in (32, 32)))]
    seen = 0
    for spec in window.specs:
        interior, edge, halo = _classified(spec, flags, plan)
        assert (interior, edge) == _classified(spec, [int(f) for f in live], plan)[:2]
        if not any(live):
            # every window in the buffer is interior: only an overhanging strip is not
            assert all(c0 + plan[0] + halo > 32 + spec.halo for _, c0 in edge)
        for origin in interior:
            win = ce._ext_row_window(exts, spec.shape, spec.halo, live, origin, plan[0], halo)
            assert bool(win.load.all()) and bool(win.domain.all())
            assert not any(bool(e.any()) for e in win.edges)
            rows = min(plan[1], spec.shape[0] - origin[0]) + 2 * halo
            assert all(win.plane(w) == (True, True, False, False) for w in range(rows))
        seen += len(interior)
    assert (seen > 0) == (plan[0] < 32)


@pytest.mark.parametrize("bc", [None, NOFLUX, SIDES], ids=["periodic", "no-flux", "bc inputs"])
@pytest.mark.parametrize("scheme", ["euler", "rk4"])
def test_bf16_replay_with_interior_blocks_is_plain(scheme, bc):
    """The bf16 kernel's replay, its interior blocks marching edge-free, equals
    #8's plain version bit for bit at every k of the ladder, under every edge
    flag, with and without side inputs, at plans with interior blocks and at
    the kernel's own."""
    window, mesh = _big_window(scheme, bc)
    program = window.program
    assert program.bf16
    sides = program.sides is not None
    interiors = 0
    for flags in FLAG_SETS if bc is not None else [[0, 0, 0, 0]]:
        for spec in window.specs:
            exts = [_bf16(tuple(n + 2 * spec.halo for n in spec.shape), seed=spec.k + i,
                          low=-0.5, high=0.5)[1] for i in range(program.n_fields)]
            block_flags = flags + ([32, 0] if sides else [])
            views = program.sides.passes(T0, spec.k, 1e-3, BF16, "cpu")(0, spec.k) if sides \
                else None
            plain = ce.multi_stencil_ext_2d_plain(exts, spec, block_flags, views)
            for plan in PLANS:
                if plan is not None:
                    interiors += len(_classified(spec, flags, plan)[0])
                replay = ce.multi_stencil_ext_2d_marched(exts, spec, block_flags, plan=plan,
                                                         sides=views)
                for a, b in zip(replay, plain, strict=True):
                    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert interiors > 0


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "float"])
def test_launch_chunk(bf16):
    """The bf16 kernel marches chunks of at most BF16_EDGE_CHUNK rows where
    a block of the launch has a flagged side, the launch's default elsewhere
    (and in the float32 and float64 kernels)."""
    from pde_tpu_torch.ops.cuda_stencil_2d import chunk_rows

    window, _ = _big_window("euler", NOFLUX)
    base = window.program
    program = ce.ExtStencilProgram(base.grid, base.make_step, base.depth, base.n_fields,
                                   bf16=bf16)
    default = chunk_rows(2048, 8, 4)
    assert default > ce.BF16_EDGE_CHUNK
    flagged = ce.launch_chunk(program, 2048, 8, [[1, 0, 1, 0, 0, 0]] + [[0, 0, 0, 0, 0, 0]] * 3)
    assert flagged == (ce.BF16_EDGE_CHUNK if bf16 else default)
    assert ce.launch_chunk(program, 2048, 8, [[0, 0, 0, 0]] * 4) == default
    assert ce.launch_chunk(program, 40, 1, [[1, 1, 1, 1]]) == chunk_rows(40, 1, 1)
