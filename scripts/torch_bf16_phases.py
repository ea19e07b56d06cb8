"""Phases 71-72 of ``chip_smoke.py``: bf16 storage (ROADMAP B1(f)) in kernels
#1, #12 and #8, on one NVIDIA GPU.

A bf16 pass loads bf16, steps in float32 with the float32 kernel's
coefficients, rounds every level to bf16 and stores bf16, at the float32
plan; its entry points (``<library>_bf16``) live in libraries of their own.

``chip_smoke.py`` builds :func:`units` with its other libraries and calls
:func:`kernels_phase` and :func:`main_phase`; run alone, this script builds
them, all at once, and runs the phases::

    python3 scripts/torch_bf16_phases.py

The cases, 4096² unless named: the periodic grid (#1's main path); rows
bounded by value 0 with periodic columns (scalar sides); rows bounded with a
per-point array on x- and ``0.1*sin(3*t)`` on x+ (side inputs, tables from
t0 = 0.35); the cylinder of config 4 with a hole (r in [512, 4608), z
periodic), r value 0 (the radial mode); the same with ``0.1*sin(3*t)`` on r-
and a per-point array on r+ (the radial mode with side inputs); #12 on the
four 2048² blocks of [2, 2] meshes of each; #8 on Cahn-Hilliard
(``CahnHilliardPDE()``, periodic), its Euler and RK4 programs over [2, 2],
and with side inputs (``bc_inputs``): ``laplace(c**3 - c - laplace(c))``
with ``0.1*sin(3*t)`` on x-, a per-point array on x+, ``cos(x)*sin(t)`` on
y- and no flux on y+ (``chip_smoke.py``'s phase 58 conditions), Euler and
RK4 over [2, 2], tables from t0 = 0.35.

Phase 71 (``[bf16 kernels]``): every bf16 entry point against its plain
version on the same inputs (#1's ``uniform(0, 1)`` cast to bf16, #12's and
#8's ``uniform(-0.5, 0.5)``) at every k of its library (#8: of its ladder),
within one bf16 ulp of max|f| (``2**(floor(log2 max|f|) - 7)``), with the
share of cells that differ, ms a pass (CUDA events), and ptxas' registers
and spills; #8's bf16 kernel (``csrc/march_bf16_ext_2d.cuh``, edge-free
interior blocks) also at a second chunk of rows (64, which moves blocks
between its interior and edge marches), bit-identical, with the share of
blocks marching interior at each chunk; and the float32 kernels of #8 and
#7 on the same programs, their source digests (pinned by
``tests/test_torch_bf16_ext.py``) and SASS (``[bf16 fp kernels]``).
Phase 72 (``[bf16 main]``): the main path, ``DiffusionPDE(0.1)`` on the
4096² periodic bf16 state (``uniform(0, 1)``, seed 72) for 2048 steps
at dt = 0.1 through ``solve(backend="cuda")``: fused, the ladder's launches
counted from 0, [2, 2] bit-equal to serial, the difference from the float32
run reported, cell-updates/s beside float32's in turns; the same for the
other cases (serially and on [2, 2], bit-equal); Cahn-Hilliard 1024² on
[2, 2] (``uniform(-0.1, 0.1)``, seed 0, dt = 1e-3) for 2048 steps, Euler and
RK4, fused, against #8's plain version over the first 128 steps, periodic
and with the side inputs (from t0 = 0.35; the serial bf16 runs take the plain
loop, as ``pde_tpu``'s #7 refuses bf16), each with its launches counted from
0. Then one pass of each kernel at the top of its window's ladder beside its
plain version, its bound (4 bytes a cell, and the operations the update
needs) and, for the periodic rows, one bf16 ``nn.Conv2d``/``F.conv2d`` with
the composed stencil (``[bf16 passes]``). :func:`main_phase` returns the
kernels line's rows.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

N = 4096
HOLE = 512
CH_N = 1024
DT = 0.1
CH_DT = 1e-3
T0 = 0.35
WINDOW = 2048
CH_PLAIN_STEPS = 128  # steps of #8's plain windows, the bulk of phase 72's time
MESH = [2, 2]
RADIAL_FLOPS = 8  # operations of a radial update: four products, four sums
SIDES_RHS = "laplace(c**3 - c - laplace(c))"  # Cahn-Hilliard with side inputs
#: #8's cases: (scheme, with side inputs)
CH_CASES = (("euler", False), ("rk4", False), ("euler", True), ("rk4", True))
#: the second chunk of rows of #8's plan-independence check (the launch's
#: default is 128 rows, or 32 where a block has a flagged side)
SECOND_CHUNK = 64


def ch_conditions(np, cols: int) -> dict:
    """The side-input case's conditions (``chip_smoke.py``'s phase 58): a
    time-dependent value, a per-point array along the columns, a value
    varying in space and time, no flux."""
    return {"x-": {"value_expression": "0.1*sin(3*t)"},
            "x+": {"value": 0.1 * np.cos(np.linspace(0.0, 2.0 * np.pi, cols))},
            "y-": {"value_expression": "cos(x)*sin(t)"}, "y+": {"derivative": 0}}


def ch_case(pde, np, n: int, sides: bool):
    """Cahn-Hilliard on an n² grid: periodic, or bounded with the side inputs."""
    if sides:
        return pde.UnitGrid([n, n]), pde.PDE({"c": SIDES_RHS}, bc=ch_conditions(np, n))
    return pde.UnitGrid([n, n], periodic=True), pde.CahnHilliardPDE()


def ch_label(scheme: str, sides: bool) -> str:
    return scheme + (", side inputs" if sides else "")


def cases(pde, np) -> dict:
    """label -> (grid, conditions, #1's library, the library's top k, the
    windows' top k) of the diffusion cases."""
    from pde_tpu_torch.ops import cuda_cartesian as cc

    periodic = pde.UnitGrid([N, N], periodic=True)
    rows = pde.UnitGrid([N, N], periodic=[False, True])
    cylinder = pde.CylindricalSymGrid((HOLE, HOLE + N), (0, N), (N, N), periodic_z=True)
    wave = np.sin(np.linspace(0.0, 2.0 * np.pi, N))
    return {
        "periodic": (periodic, "periodic", "affine_laplace_2d", cc.MAX_STEPS, cc.TOP_STEPS),
        "bounded rows": (rows, {"x": {"value": 0}, "y": "periodic"}, "affine_laplace_2d",
                         cc.MAX_STEPS, cc.TOP_STEPS),
        "side inputs": (rows, {"x-": {"value": 0.5 * wave},
                               "x+": {"value_expression": "0.1*sin(3*t)"}, "y": "periodic"},
                        cc.SIDES_LIBRARY, cc.SIDES_TOP_STEPS, cc.SIDES_TOP_STEPS),
        "cylinder": (cylinder, {"r": {"value": 0}, "z": "periodic"}, cc.RADIAL_LIBRARY,
                     cc.RADIAL_TOP_STEPS, cc.RADIAL_TOP_STEPS),
        "cylinder, side inputs": (
            cylinder, {"r-": {"value_expression": "0.1*sin(3*t)"}, "r+": {"value": 0.5 * wave},
                       "z": "periodic"}, cc.RADIAL_SIDES_LIBRARY, cc.RADIAL_SIDES_TOP_STEPS,
            cc.RADIAL_SIDES_TOP_STEPS),
    }


def update_flops(smoke, label: str) -> int:
    """Operations of one update in case `label`: the 5-point update's
    (``chip_smoke._affine_flops``), or the radial one's."""
    return RADIAL_FLOPS if label.startswith("cylinder") else smoke._affine_flops((1.0, 1.0))


def units(pde, torch, np, device) -> dict:
    """The build units: the bf16 libraries of #1 and #12 of every case, and
    the bf16 ext programs of Cahn-Hilliard's Euler and RK4 steps over [2, 2],
    periodic and with side inputs (``programs``, by :data:`CH_CASES`)."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    affine = {}
    for label, (grid, _, library, _, _) in cases(pde, np).items():
        periodic = tuple(bool(p) for p in grid.periodic)
        affine[("#1", label)] = cc.kernel_source(periodic, library, True)
        radial = label.startswith("cylinder")
        affine[("#12", label)] = ce.affine_ext_source(periodic, radial=radial,
                                                      sides="side inputs" in label, bf16=True)
    pde.config["parallel.devices_per_device"] = 4
    programs, fp = {}, {}
    for scheme, sides in CH_CASES:
        grid, eq = ch_case(pde, np, N, sides)
        mesh = GridMesh(grid, MESH, devices=[device] * 4)
        hook = eq.make_fused_euler_window if scheme == "euler" else eq.make_fused_rk4_window
        for dtype in (torch.bfloat16, torch.float32):
            state = pde.ScalarField(grid, 0.0, dtype=dtype, device=device)
            if dtype == torch.bfloat16:
                programs[(scheme, sides)] = hook(state, CH_DT, mesh=mesh).program
            else:  # the float32 kernels of #8 and #7, which the bf16 redesign leaves
                fp[("#8", scheme, sides)] = hook(state, CH_DT, mesh=mesh).program
                fp[("#7", scheme, sides)] = hook(state, CH_DT).program
    pde.config["parallel.devices_per_device"] = 1
    return {"affine": affine, "programs": programs, "fp": fp,
            "units": list(affine.values()) + list(programs.values()) + list(fp.values())}


def _ulps(torch, out, ref) -> tuple[float, float, float]:
    """(max_abs, max_abs in bf16 ulps of max|ref|, share of cells that differ)."""
    torch.cuda.synchronize()
    diff = (out.double() - ref.double()).abs()
    top = float(ref.double().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    return float(diff.max()), float(diff.max()) / ulp, float((diff > 0).double().mean())


def _times(k: int, first: int = 0) -> list[float]:
    return [T0 + (first + s) * DT for s in range(k)]


def _check(smoke, torch, label, out, ref) -> tuple[float, float, float]:
    err, ulps, share = _ulps(torch, out, ref)
    smoke._require(bool(torch.isfinite(out.double()).all()) and ulps <= 1.0,
                   f"{label}: {ulps:.2f} bf16 ulps of max|f| from its plain version")
    return err, ulps, share


def kernels_phase(smoke, pde, torch, np, device, smi, built, logs, built_paths) -> dict:
    """Phase 71 (see the module docstring); `logs` holds ptxas' report and
    `built_paths` the library of each build unit by digest. Returns
    {(kernel, case, k): (max_abs, ulps, share, ms)} and the top k's entries
    under (kernel, case, "top")."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(71)
    results, lines = {}, []
    pde.config["parallel.devices_per_device"] = 4
    for label, (grid, bc, library, top, first) in cases(pde, np).items():
        bcs = None if bc == "periodic" else grid.get_boundary_conditions(bc)
        inputs = cc.AffineSideInputs(grid, bcs) if "side inputs" in label else None
        data = torch.rand(grid.shape, generator=gen, device=device).to(bf16)
        out = torch.empty_like(data)
        mesh = GridMesh(grid, MESH, devices=[device] * 4)
        ins, outs, flags = smoke._ext_side_blocks(torch, mesh, top, bf16, gen)
        width = 6 if inputs is not None else 5 if label.startswith("cylinder") else 4
        flags = [f[:width] for f in flags]
        for kernel in ("#1", "#12"):
            row = []
            for k in range(1, top + 1):
                if kernel == "#1":
                    spec = cc.affine_laplace_spec(grid, a=1.0, b=0.1 * DT, k=k, dtype=bf16,
                                                  bcs=bcs)
                    sides = None if inputs is None else inputs.for_pass(bf16, device, _times(k))

                    def run(spec=spec, sides=sides):
                        cc.affine_laplace_2d(data, spec, out=out, sides=sides)

                    run()
                    got, ref = out, cc.affine_laplace_2d_plain(data, spec, sides)
                else:
                    spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0,
                                                      b=0.1 * DT, k=k, halo=top, dtype=bf16,
                                                      bcs=bcs)
                    sides = None if inputs is None else inputs.for_pass(
                        bf16, device, _times(k), row_pad=cc.SIDE_PAD)
                    in0, out0 = [p[0] for p in ins], [p[0] for p in outs]

                    def run(spec=spec, sides=sides, in0=in0, out0=out0):
                        ce.affine_laplace_ext_2d(in0, out0, flags, spec, sides=sides)

                    run()
                    got = torch.stack([p[top:-top, top:-top] for p in out0])
                    ref = torch.stack([ce.affine_laplace_ext_2d_plain(p, spec, f, sides)
                                       for p, f in zip(in0, flags, strict=True)])
                err, ulps, share = _check(smoke, torch, f"{kernel} bf16 {label} k={k}", got, ref)
                ms = smoke._cuda_ms(torch, run, 10)
                results[(kernel, label, k)] = (err, ulps, share, ms)
                row.append(f"k={k} {ulps:.2f}/{share:.3%}/{ms:.4f}")
            results[(kernel, label, "top")] = results[(kernel, label, first)]
            unit = built["affine"][(kernel, label)]
            regs = []
            for kk in sorted({first, top}):
                tx, threads, _, _ = cc.affine_row_plan(kk, 4)
                regs.append(f"k={kk} " + " | ".join(smoke._ptxas_of(
                    logs[unit.digest], unit.library + "_kernel", f"IfLi{kk}ELi{tx}ELi{threads}E")))
            lines.append(f"{kernel} {label} (ulps of max|f| / cells differing / ms a pass) "
                         + ", ".join(row) + "; ptxas " + "; ".join(regs))
    for (scheme, sides), program in built["programs"].items():
        grid, _ = ch_case(pde, np, N, sides)
        mesh = GridMesh(grid, MESH, devices=[device] * 4)
        ladder, halo = smoke._ext_ladder(program, mesh.local_shape)
        ins, outs, flags = smoke._ext_side_blocks(torch, mesh, halo, bf16, gen, program.n_fields)
        flags = [f[:6] if sides else f[:4] for f in flags]
        name = ch_label(scheme, sides)
        row = []
        for k in ladder:
            spec = ce.multi_stencil_ext_spec(program, k, bf16, mesh.local_shape, halo)
            views = program.sides.passes(T0, k, CH_DT, bf16, device)(0, k) if sides else None

            def run(spec=spec, views=views, chunk=None):
                ce.multi_stencil_ext_2d(ins, outs, flags, spec, sides=views, chunk=chunk)

            inner = (slice(halo, -halo),) * 2
            tx, threads = spec.tile
            got, interior = [], []
            for chunk in (None, SECOND_CHUNK):  # a result does not depend on the plan
                run(chunk=chunk)
                got.append(torch.stack([torch.stack([p[inner] for p in planes])
                                        for planes in outs]))
                rows = chunk or ce.launch_chunk(program, mesh.local_shape[0],
                                                -(-mesh.local_shape[1] // tx), flags)
                blocks = [ce.ext_window_interior(mesh.local_shape, halo, f[:4], (r0, c0), tx,
                                                 k * program.depth, rows,
                                                 program.geometry.periodic)
                          for f in flags for r0 in range(0, mesh.local_shape[0], rows)
                          for c0 in range(0, mesh.local_shape[1], tx)]
                interior.append(f"{sum(blocks) / len(blocks):.1%} at {rows} rows")
            smoke._require(torch.equal(got[0], got[1]),
                           f"#8 bf16 CH {name} k={k}: the two chunks differ")
            ref = torch.stack([torch.stack(ce.multi_stencil_ext_2d_plain(p, spec, f, views))
                               for p, f in zip(ins, flags, strict=True)])
            err, ulps, share = _check(smoke, torch, f"#8 bf16 CH {name} k={k}", got[0], ref)
            ms = smoke._cuda_ms(torch, run, 10)
            results[("#8", name, k)] = (err, ulps, share, ms)
            kernel = f"multi_stencil_bf16{'_sides' if sides else ''}_ext_2d_kernel"
            regs = " | ".join(smoke._ptxas_of(logs[program.digest], kernel,
                                              f"Li{k}ELi{tx}ELi{threads}E"))
            row.append(f"k={k} {ulps:.2f}/{share:.3%}/{ms:.4f} ms ({regs}; interior blocks "
                       f"{' and '.join(interior)}, bit-identical)")
        results[("#8", name, "top")] = results[("#8", name, ladder[0])]
        lines.append(f"#8 Cahn-Hilliard {name} over {MESH} (ladder {ladder}, halo {halo}): "
                     + ", ".join(row))
    pde.config["parallel.devices_per_device"] = 1
    print(f"[bf16 kernels] every bf16 entry point against its plain version at {N}^2 (#12 "
          f"and #8 over the four {N // 2}^2 blocks of {MESH}), on {smi}: " + "; ".join(lines)
          + " ok", flush=True)
    sass = []
    for (kernel, scheme, sides), program in built["fp"].items():
        k = program.ladder[0]
        tx, threads = program.tiles[torch.float32][k]
        name = ("multi_stencil_sides" if sides else "multi_stencil") + (
            "_ext_2d_kernel" if kernel == "#8" else "_2d_kernel")
        sass.append(f"{kernel} CH {ch_label(scheme, sides)} (digest {program.digest}) k={k} "
                    "float: " + smoke._sass_summary(built_paths[program.digest], (
                        name, f"EfLi{k}ELi{tx}ELi{threads}E")))
    print("[bf16 fp kernels] the float32 kernels of #8 and #7 on the same programs: "
          + "; ".join(sass), flush=True)
    return results


def _solve(eq, state, steps, t0=0.0, dt=DT, **kwargs):
    return eq.solve(state, t_range=[t0, t0 + steps * dt], dt=dt, tracker=None, backend="cuda",
                    solver="euler", adaptive=False, ret_info=True, **kwargs)


def _plain_window(window, mesh):
    """The decomposed window `window` with #8's plain version in place of its
    kernel (on the card's tensors), through the same exchange and ladder."""
    import torch

    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel.fused import _side_flags, sharded_window

    halo = window.exchange.halo
    n_rows, n_cols = mesh.local_shape
    interior = (slice(halo, halo + n_rows), slice(halo, halo + n_cols))

    def run(ins, outs, flags, spec, sides=None):
        for ext, out, f in zip(ins, outs, flags, strict=True):
            for plane, result in zip(out, ce.multi_stencil_ext_2d_plain(ext, spec, f, sides),
                                     strict=True):
                plane[interior] = result

    inputs = window.program.sides
    if inputs is None:
        return sharded_window(mesh, window.specs, halo, window.program.n_fields, run)
    return sharded_window(
        mesh, window.specs, halo, window.program.n_fields, run, _side_flags(mesh),
        lambda t0, steps, device: inputs.passes(t0, steps, CH_DT, torch.bfloat16, device),
        inputs.needs_t)


def main_phase(smoke, pde, torch, np, device, smi, built, results) -> list[dict]:
    """Phase 72 (see the module docstring). Returns the kernels line's rows."""
    import torch.nn.functional as F

    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    bf16, f32 = torch.bfloat16, torch.float32
    cells = N * N
    counters = (cc.affine_laplace_2d, ce.affine_laplace_ext_2d)
    pde.config["parallel.devices_per_device"] = 4
    launches, parts, main_state = {}, [], None
    for label, (grid, bc, _, _, top) in cases(pde, np).items():
        ladder = [top >> i for i in range(top.bit_length())]
        passes = smoke._ladder_passes(ladder, WINDOW)
        state = pde.ScalarField(grid, np.random.default_rng(72).uniform(0.0, 1.0, grid.shape),
                                dtype=bf16, device=device)
        eq = pde.DiffusionPDE(0.1, bc=bc)
        t0 = T0 if "side inputs" in label else 0.0
        runs = {}
        for where, kwargs in (("serial", {}), (str(MESH), {"decomposition": MESH})):
            for counter in counters:
                counter.launches = counter.bf16_launches = 0
            (result, info), seconds = smoke._synced_seconds(
                torch, lambda: _solve(eq, state, WINDOW, t0, **kwargs))
            kernel = counters[0] if where == "serial" else counters[1]
            launches[(label, where)] = kernel.bf16_launches
            checks = [info["solver"].get("fused_step") is True,
                      "fused_unsupported" not in info["solver"],
                      kernel.bf16_launches == kernel.launches == passes,
                      sum(c.launches for c in counters) == passes, result.dtype == bf16,
                      bool(torch.isfinite(result.data.double()).all())]
            smoke._require(all(checks), f"the bf16 {label} run {where}: {checks}")
            runs[where] = (result, seconds)
        smoke._require(torch.equal(runs["serial"][0].data, runs[str(MESH)][0].data),
                       f"the bf16 {label} run on {MESH} is not bit-equal to serial")
        part = (f"{label}: {WINDOW} steps fused in {passes} launches (ladder {ladder}) serially "
                f"({runs['serial'][1]:.3f} s) and on {MESH} ({runs[str(MESH)][1]:.3f} s), "
                "bit-equal")
        if label == "periodic":
            main_state = state
            (ref32, _), _ = smoke._synced_seconds(
                torch, lambda: _solve(eq, state.copy(dtype=f32), WINDOW))
            err, ulps, _ = _ulps(torch, runs["serial"][0].data, ref32.data)
            part += (f"; {err:.4e} from the float32 run ({ulps:.1f} bf16 ulps of max|f| "
                     f"{float(ref32.data.abs().max()):.4f})")
        parts.append(part)
    # the main path's rate beside float32's, in turns
    eq = pde.DiffusionPDE(0.1)
    state32 = main_state.copy(dtype=f32)
    steppers = {
        "bf16": (pde.EulerSolver(eq, backend="cuda").make_stepper(main_state, dt=DT), main_state),
        "float32": (pde.EulerSolver(eq, backend="cuda").make_stepper(state32, dt=DT), state32),
        f"bf16 {MESH}": (pde.EulerSolver(eq, backend="cuda", decomposition=MESH)
                         .make_stepper(main_state, dt=DT), main_state),
    }
    order = ["bf16", "float32", f"bf16 {MESH}", f"bf16 {MESH}", "float32", "bf16"]
    rates = [(name, smoke._window_rate(torch, steppers[name][0], steppers[name][1], DT))
             for name in order]
    # Cahn-Hilliard 1024^2 on [2, 2] through #8, periodic and with side inputs
    counter = ce.multi_stencil_ext_2d
    for scheme, sides in CH_CASES:
        name = ch_label(scheme, sides)
        ch_grid, ch_eq = ch_case(pde, np, CH_N, sides)
        ch_state = pde.ScalarField(
            ch_grid, np.random.default_rng(0).uniform(-0.1, 0.1, ch_grid.shape), dtype=bf16,
            device=device)
        mesh = GridMesh(ch_grid, MESH, devices=[device] * 4)
        t0 = T0 if sides else 0.0
        solver, kwargs = ("euler", {}) if scheme == "euler" else ("runge-kutta",
                                                                  {"adaptive": False})
        counter.launches = counter.bf16_launches = counter.sides_launches = 0
        (result, info), seconds = smoke._synced_seconds(torch, lambda: ch_eq.solve(
            ch_state, t_range=[t0, t0 + WINDOW * CH_DT], dt=CH_DT, tracker=None,
            backend="cuda", solver=solver, decomposition=MESH, ret_info=True, **kwargs))
        program = built["programs"][(scheme, sides)]
        ladder, _ = smoke._ext_ladder(program, mesh.local_shape)
        passes = smoke._ladder_passes(ladder, WINDOW)
        launches[(f"CH {name}", str(MESH))] = counter.bf16_launches
        checks = [info["solver"].get("fused_step") is True,
                  counter.bf16_launches == counter.launches == passes,
                  counter.sides_launches == (passes if sides else 0), result.dtype == bf16,
                  bool(torch.isfinite(result.data.double()).all())]
        smoke._require(all(checks), f"the bf16 CH {name} run on {MESH}: {checks}")
        hook = "make_fused_euler_window" if scheme == "euler" else "make_fused_rk4_window"
        window = getattr(ch_eq, hook)(ch_state, CH_DT, mesh=mesh)
        smoke._require(window.program.digest == program.digest,
                       f"the bf16 CH {name} window at {CH_N}^2 is not phase 71's program")
        blocks = [[b] for b in mesh.split_field_data(ch_state.data)]
        args = (t0, CH_PLAIN_STEPS) if window.needs_t else (CH_PLAIN_STEPS,)
        fused = mesh.combine_field_data([b[0] for b in window(blocks, *args)])
        plain, plain_seconds = smoke._synced_seconds(torch, lambda: mesh.combine_field_data(
            [b[0] for b in _plain_window(window, mesh)(blocks, *args)]))
        err, ulps, share = _ulps(torch, fused, plain)
        smoke._require(ulps <= 16.0, f"CH {name} {CH_PLAIN_STEPS} steps: {ulps:.1f} ulps "
                                     "from #8's plain version")
        what = ("CahnHilliardPDE() periodic" if not sides else
                f"PDE({{'c': '{SIDES_RHS}'}}) with side inputs from t0 = {T0}")
        parts.append(f"{what} {CH_N}^2 {scheme} on {MESH}: {WINDOW} steps fused in "
                     f"{passes} launches (ladder {ladder}), {seconds:.3f} s "
                     f"({CH_N * CH_N * WINDOW / seconds:.4e} cell-updates/s); {CH_PLAIN_STEPS} "
                     f"steps {ulps:.2f} bf16 ulps of max|f| from #8's plain version "
                     f"({plain_seconds:.1f} s), {share:.3%} of cells differing")
    print(f"[bf16 main] through solve(backend='cuda', adaptive=False, tracker=None) on bf16 "
          f"states, on {smi}: " + "; ".join(parts) + f"; the main path's cell-updates/s of "
          f"{WINDOW}-step windows (best of 3 x 3 after a warm-up), in turns: "
          + ", ".join(f"{name} {rate:.4e}" for name, rate in rates) + " ok", flush=True)

    # one top-k pass of each kernel beside its plain version, the bound and a convolution
    gen = torch.Generator(device=device).manual_seed(72)
    rows, lines = [], []
    for label, (grid, bc, _, _, top) in cases(pde, np).items():
        bcs = None if bc == "periodic" else grid.get_boundary_conditions(bc)
        inputs = cc.AffineSideInputs(grid, bcs) if "side inputs" in label else None
        data = torch.rand(grid.shape, generator=gen, device=device).to(bf16)
        spec = cc.affine_laplace_spec(grid, a=1.0, b=0.1 * DT, k=top, dtype=bf16, bcs=bcs)
        sides = None if inputs is None else inputs.for_pass(bf16, device, _times(top))
        mesh = GridMesh(grid, MESH, devices=[device] * 4)
        local = mesh.local_shape
        ext_spec = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=0.1 * DT, k=top, halo=top,
                                              dtype=bf16, bcs=bcs)
        ext_sides = None if inputs is None else inputs.for_pass(bf16, device, _times(top),
                                                                row_pad=cc.SIDE_PAD)
        ins, _, flags = smoke._ext_side_blocks(torch, mesh, top, bf16, gen)
        in0 = [p[0] for p in ins]
        width = 6 if inputs is not None else 5 if label.startswith("cylinder") else 4
        flags = [f[:width] for f in flags]
        tables = 0
        if spec.radial is not None:
            tables += cc.radial_rows(spec, device).numel() * 4
        if sides is not None:
            tables += sum(a.numel() * 4 for a in sides.arrays if a is not None)
        plain_ms = smoke._cuda_ms(torch, lambda: cc.affine_laplace_2d_plain(data, spec, sides), 3)
        ext_plain_ms = smoke._cuda_ms(torch, lambda: [ce.affine_laplace_ext_2d_plain(
            x, ext_spec, f, ext_sides) for x, f in zip(in0, flags, strict=True)], 3)
        flops = update_flops(smoke, label) * top * cells
        bound_1 = smoke._bound(2 * cells * 2 + tables, flops)
        ext_cells = 4 * (local[0] + 2 * top) * (local[1] + 2 * top)
        bound_12 = smoke._bound((ext_cells + cells) * 2 + tables, flops)
        conv_ms = ext_conv_ms = None
        if label == "periodic":  # one bf16 convolution with the composed stencil
            weight = smoke._composed_stencil(torch, 1.0, 0.1 * DT, (1.0, 1.0), top).to(
                device=device, dtype=bf16)
            conv_ms, _ = smoke._library_conv(torch, data, weight, 3)
            stacked = torch.stack(in0)[:, None]
            ext_conv_ms = smoke._cuda_ms(torch, lambda: F.conv2d(stacked, weight[None, None]), 3)
        what = f"{label}, k={top}"
        for kernel, key, plain, bound, library_ms, launched, replaces in (
                ("#1", "affine_laplace_2d", plain_ms, bound_1, conv_ms,
                 launches[(label, "serial")], "pde_tpu/ops/pallas_cartesian.py:793"),
                ("#12", "affine_laplace_ext_2d", ext_plain_ms, bound_12, ext_conv_ms,
                 launches[(label, str(MESH))], "pde_tpu/ops/pallas_cartesian.py:5792")):
            err, ulps, share, ms = results[(kernel, label, "top")]
            lines.append(f"{kernel} {what}: {ms:.4f} ms, plain {plain:.4f}, bound "
                         f"{bound[0]:.4f} ({bound[1]}, {bound[0] / ms:.1%} of it)"
                         + ("" if library_ms is None else f", bf16 convolution {library_ms:.4f}"))
            rows.append({
                "name": f"{key} (bf16, {label})", "route": "cuda",
                "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
                "replaces": f"{replaces} (bf16 storage)", "launches": launched,
                "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                "bound_by": bound[1],
                # a convolution for the periodic rows; row factors, ghosts and per-point or
                # time-dependent sides are no convolution's
                "library_ms": library_ms,
            })
    for (scheme, sides), program in built["programs"].items():
        name = ch_label(scheme, sides)
        ch_grid, _ = ch_case(pde, np, N, sides)
        ch_mesh = GridMesh(ch_grid, MESH, devices=[device] * 4)
        ladder, halo = smoke._ext_ladder(program, ch_mesh.local_shape)
        spec = ce.multi_stencil_ext_spec(program, ladder[0], bf16, ch_mesh.local_shape, halo)
        ins, _, flags = smoke._ext_side_blocks(torch, ch_mesh, halo, bf16, gen, program.n_fields)
        flags = [f[:6] if sides else f[:4] for f in flags]
        views = program.sides.passes(T0, spec.k, CH_DT, bf16, device)(0, spec.k) if sides \
            else None
        plain = smoke._cuda_ms(torch, lambda: [ce.multi_stencil_ext_2d_plain(
            p, spec, f, views) for p, f in zip(ins, flags, strict=True)], 3)
        ext_cells = 4 * (ch_mesh.local_shape[0] + 2 * halo) * (ch_mesh.local_shape[1] + 2 * halo)
        tables = 0 if views is None else sum(v.numel() * 4 for v in views)
        bound = smoke._bound((ext_cells + cells) * 2 * program.n_fields + tables,
                             smoke._program_flops(program) * spec.k * cells)
        err, ulps, share, ms = results[("#8", name, "top")]
        lines.append(f"#8 CH {name} k={spec.k} over {MESH} of {N}^2: {ms:.4f} ms, plain "
                     f"{plain:.4f}, bound {bound[0]:.4f} ({bound[1]}, {bound[0] / ms:.1%} of it)")
        rows.append({
            "name": f"multi_stencil_ext_2d (bf16, Cahn-Hilliard {name})", "route": "cuda",
            "source": "pde_tpu_torch/csrc/march_bf16_ext_2d.cuh",
            "replaces": "pde_tpu/ops/pallas_cartesian.py:4081 (bf16 storage"
                        + (", bc_inputs: pde_tpu/parallel/fused.py:476-516)" if sides else ")"),
            "launches": launches[(f"CH {name}", str(MESH))], "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None,  # a nonlinear rhs: no PyTorch call computes the step
        })
    pde.config["parallel.devices_per_device"] = 1
    print(f"[bf16 passes] one top-k pass of each bf16 kernel at {N}^2 (#12 and #8 over the four "
          f"{N // 2}^2 blocks of {MESH}) on {smi}: " + "; ".join(lines) + " ok", flush=True)
    return rows


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False; no result")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    built = units(pde, torch, np, device)
    start = time.perf_counter()
    builds = cs.build_programs(built["units"])
    print(f"built {len(builds)} libraries in {time.perf_counter() - start:.1f} s (CPU s "
          + ", ".join(f"{u.library} {b['cpu_seconds']:.1f}" for u, b in zip(built["units"], builds))
          + ")", flush=True)
    logs = {u.digest: b["log"] for u, b in zip(built["units"], builds)}
    paths = {u.digest: b["path"] for u, b in zip(built["units"], builds)}
    start = time.perf_counter()
    results = kernels_phase(smoke, pde, torch, np, device, smi, built, logs, paths)
    print(f"phase 71 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    rows = main_phase(smoke, pde, torch, np, device, smi, built, results)
    print(f"phase 72 in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    main()
