"""Phases 68-70 of ``chip_smoke.py``: fixed-dt RK4 of a two-deep rhs on 3D
grids (Cahn-Hilliard, Swift-Hohenberg, Kuramoto-Sivashinsky) through kernels
#5 and #6, the step cut at its RK stages into four passes (``cut_step`` of
``ops/cuda_stencil_3d.py``: each a one-step march of two planes of halo,
two blocks an SM, the values between passes in device memory), on one
NVIDIA GPU.

``chip_smoke.py`` builds :func:`units` with its other libraries and calls
:func:`kernels_phase` and :func:`main_phase`; run alone, this script builds
them, all at once, and runs the phases::

    python3 scripts/torch_rk4_3d_phases.py

The four kernels of the template ``csrc/multi_stencil_3d.cuh`` that run the
passes, each instantiated once a pass: #5's ``multi_stencil_3d_kernel`` and
its side-input kernel A (``multi_stencil_sides_3d_kernel``), #6's
``multi_stencil_ext_3d_kernel`` and its side-input kernel B
(``multi_stencil_sides_ext_3d_kernel``), whose passes compute the cells
around their blocks that the later passes read, so that a step keeps one
exchange of eight cells: #6's two passes of two RK stages (4 and 0 cells),
B's four of one (6, 4, 2, 0).
The programs: the three models on a periodic 256³ grid, serially and over a
[2, 2, 2] mesh (eight 128³ blocks), and ``laplace(c**3 - c - laplace(c))``
on a bounded 256³ grid with a face in time (y- ``0.1*sin(3*t)``, y+ 0, the
rest no-flux) for A and B.

Phase 68 (``[rk4 3d kernels]``): every pass kernel against its plain version
on the same inputs (those the plain passes before it give from
``uniform(-0.5, 0.5)``; the ext passes on every block's region), fp32
within 1e-6 of max|f| a step, fp64 within 1e-12, and the whole step.
Phase 69 (``[rk4 3d main]``): the slice's main path, ``CahnHilliardPDE()``
on a periodic 256³ fp32 grid from ``uniform(-0.1, 0.1)`` (seed 0) for 2048
steps at dt = 1e-3 through ``solve(backend="cuda", solver="runge-kutta",
adaptive=False, tracker=None)``: fused, four launches a step serially
(each pass 2048) and two on [2, 2, 2] (#6's passes of two RK stages),
against the plain loop on the card, [2, 2, 2] bit-equal to serial,
cell-updates/s beside the plain loop's, the idle share of a traced window
of each, and the host's microseconds a launch; the face-in-time program for 256 steps serially
(kernel A) and on [2, 2, 2] (kernel B), bit-equal. Phase 70 (``[rk4 3d
passes]``): each pass kernel of CH and of the face-in-time program (SH and
KS serially too) beside its plain version and its bound (its inputs read
once and its outputs written once), the step beside the step's bound,
launches per 2048-step window, ptxas' registers and spills.
:func:`main_phase` returns the kernels line's rows, one a kernel: its
step against the step's bound (the row's in PERF.md), its pass kernels
listed under ``passes``, each beside its own bound.

With ``--parent DIR`` (a directory holding another copy of ``pde_tpu_torch``,
for example the parent commit's unpacked by ``git archive`` into a
git-ignored folder) the script then builds, in a process a copy, the 3D
programs whose rings fit a plan (Allen-Cahn 256³ Euler and RK4, serially and
on [2, 2, 2], scalar faces and side inputs; Cahn-Hilliard's Euler step) and
prints ptxas' report and the SASS summary (``scripts/torch_tree_compare.py``'s
reading) of each of their kernels in DIR's copy beside this tree's, and
whether the SASS is the same::

    python3 scripts/torch_rk4_3d_phases.py --parent _archive/parent
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

N = 256  # the 3D width of scripts/perf_3d.py
DT = 1e-3
WINDOW = 2048
SIDE_STEPS = 256
T0 = 0.35
MESH = [2, 2, 2]
MODELS = ("cahn-hilliard", "swift-hohenberg", "kuramoto-sivashinsky")
CH_EXPR = "laplace(c**3 - c - laplace(c))"
# the kernels' names by (where, with side inputs)
KERNELS = {("serial", False): "multi_stencil_3d_kernel",
           ("serial", True): "multi_stencil_sides_3d_kernel",
           ("ext", False): "multi_stencil_ext_3d_kernel",
           ("ext", True): "multi_stencil_sides_ext_3d_kernel"}


def _model(pde, name):
    return {"cahn-hilliard": pde.CahnHilliardPDE, "swift-hohenberg": pde.SwiftHohenbergPDE,
            "kuramoto-sivashinsky": pde.KuramotoSivashinskyPDE}[name]()


def _timed_bc():
    return {"x": {"derivative": 0}, "y-": {"value_expression": "0.1*sin(3*t)"},
            "y+": {"value": 0}, "z": {"derivative": 0}}


def units(pde, torch, device) -> dict:
    """The programs of the phases by (model, where), where "serial" or
    "ext" (the [2, 2, 2] mesh's), model one of :data:`MODELS` or "sides"
    (the face-in-time program); and the build units, one a program (a
    library holds its passes)."""
    from pde_tpu_torch.parallel import GridMesh

    periodic = pde.UnitGrid([N] * 3, periodic=True)
    bounded = pde.UnitGrid([N] * 3, periodic=False)
    pde.config["parallel.devices_per_device"] = 8
    programs = {}
    for name, grid, eq in [(m, periodic, _model(pde, m)) for m in MODELS] + [
            ("sides", bounded, pde.PDE({"c": CH_EXPR}, bc=_timed_bc()))]:
        state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
        mesh = GridMesh(grid, MESH, devices=[device] * 8)
        programs[(name, "serial")] = eq.make_fused_rk4_window(state, DT).program
        programs[(name, "ext")] = eq.make_fused_rk4_window(state, DT, mesh=mesh).program
    pde.config["parallel.devices_per_device"] = 1
    for (name, where), program in programs.items():
        if program.passes is None or program.ladder != [1] or (
                where == "serial" and len(program.passes) != 4):
            raise AssertionError(f"the two-deep RK4 step of {name} ({where}) was not cut")
    return {"programs": programs, "units": list(programs.values())}


def _views(program, dtype, device):
    if program.sides is None:
        return None
    return program.sides.passes(T0, 1, DT, dtype, device)(0, 1)


def _serial_inputs(s3, program, data, views) -> list:
    """Each pass's inputs, from the passes' plain versions in turn from `data`."""
    held, inputs = {}, []
    for p in program.cut(data.dtype):
        ins = [data] + [held[i] for i in p.reads]
        inputs.append(ins)
        held.update(zip(p.writes, s3.pass_plain(p, ins, views)))
    return inputs


def _ext_inputs(e3, spec, ins, flags, views) -> list:
    """Each ext pass's inputs per block (extended buffers), from the passes'
    plain versions in turn from the exchanged buffers `ins`."""
    held = [{} for _ in ins]
    inputs = []
    passes = spec.program.cut(spec.dtype)
    for p in passes:
        block_ins = [planes + [h[i] for i in p.reads] for planes, h in zip(ins, held)]
        inputs.append(block_ins)
        if p is passes[-1]:
            break
        outs = [[planes[0].new_zeros(planes[0].shape) for _ in p.writes] for planes in ins]
        _ext_plain_pass(e3, p, block_ins, outs, flags, spec, views)
        for h, o in zip(held, outs):
            h.update(zip(p.writes, o))
    return inputs


def _ext_plain_pass(e3, p, block_ins, outs, flags, spec, views) -> None:
    """Pass p's plain version on every block, into its region of `outs`."""
    region = e3._region(spec, p.extent)
    for ins, targets, block_flags in zip(block_ins, outs, flags, strict=True):
        edges, origin = e3._multi_flags(block_flags, spec)
        for target, value in zip(targets, e3.ext_pass_plain(p, ins, spec, edges, origin, views),
                                 strict=True):
            target[region] = value


def kernels_phase(smoke, pde, torch, np, device, smi, units) -> dict:
    """Phase 68 (see the module docstring); returns the max_abs errors by
    (model, where, dtype, pass), pass "step" the whole step's."""
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.parallel import GridMesh

    gen = torch.Generator(device=device).manual_seed(68)
    errs, lines = {}, []
    pde.config["parallel.devices_per_device"] = 8
    for (name, where), program in units["programs"].items():
        grid = program.grid
        for dtype in (torch.float32, torch.float64):
            views = _views(program, dtype, device)
            label = f"{name} {where} {str(dtype)[6:]}"
            if where == "serial":
                spec = cs.multi_stencil_spec(program, 1, dtype)
                data = torch.rand(grid.shape, generator=gen, dtype=dtype, device=device) - 0.5
                for p, ins in zip(program.cut(dtype), _serial_inputs(s3, program, data, views)):
                    got = s3.multi_stencil_3d_pass(p, ins, spec, sides=views)
                    ref = s3.pass_plain(p, ins, views)
                    errs[(name, where, dtype, p.index)] = max(
                        smoke._check_rel(torch, f"{label} pass {p.index}", g, r, dtype, 1)
                        for g, r in zip(got, ref, strict=True))
                (out,) = s3.multi_stencil_3d([data], spec, sides=views)
                (ref,) = s3.multi_stencil_3d_plain([data], spec, views)
            else:
                mesh = GridMesh(grid, MESH, devices=[device] * 8)
                halo = program.depth
                spec = e3.multi_stencil_ext_3d_spec(program, 1, dtype, mesh.local_shape, halo)
                ins, outs, flags = smoke._ext_side_blocks(torch, mesh, halo, dtype, gen)
                if program.sides is None:
                    flags = [f[:6] for f in flags]
                for p, block_ins in zip(program.cut(dtype),
                                        _ext_inputs(e3, spec, ins, flags, views)):
                    region = e3._region(spec, p.extent)
                    got = [[b[0].new_zeros(b[0].shape) for _ in p.writes] for b in ins]
                    e3.multi_stencil_ext_3d_pass(p, block_ins, got, flags, spec, views)
                    want = [[b[0].new_zeros(b[0].shape) for _ in p.writes] for b in ins]
                    _ext_plain_pass(e3, p, block_ins, want, flags, spec, views)
                    errs[(name, where, dtype, p.index)] = max(
                        smoke._check_rel(torch, f"{label} pass {p.index}",
                                         torch.stack([g[region] for g in gs]),
                                         torch.stack([w[region] for w in ws]), dtype, 1)
                        for gs, ws in zip(zip(*got), zip(*want), strict=True))
                e3.multi_stencil_ext_3d(ins, outs, flags, spec, sides=views)
                inner = (slice(halo, -halo),) * 3
                out = torch.stack([p[0][inner] for p in outs])
                ref = torch.stack([e3.multi_stencil_ext_3d_plain(p, spec, f, views)[0]
                                   for p, f in zip(ins, flags, strict=True)])
            err = smoke._check_rel(torch, f"{label} step", out, ref, dtype, 1)
            errs[(name, where, dtype, "step")] = err
            passes = ", ".join(f"{errs[(name, where, dtype, p.index)]:.1e}"
                               for p in program.cut(dtype))
            lines.append(f"{label} plans {spec.tile} passes max_abs {passes}, the step {err:.2e} "
                         f"(max|ref| {float(ref.abs().max()):.3e})")
    pde.config["parallel.devices_per_device"] = 1
    print(f"[rk4 3d kernels] every pass kernel of the cut RK4 step against its plain version "
          f"on the inputs the plain passes before it give, at {N}^3 (ext over {MESH}, on every "
          f"block's region), on {smi}: " + "; ".join(lines) + " ok", flush=True)
    return errs


def _solve(eq, state, steps, t0=0.0, **kwargs):
    return eq.solve(state, t_range=[t0, t0 + steps * DT], dt=DT, tracker=None,
                    solver="runge-kutta", adaptive=False, ret_info=True, **kwargs)


def _reset(counters) -> None:
    for counter in counters:
        counter.launches = counter.sides_launches = 0
        counter.pass_launches = {}


def _pass_bytes(p, cells: int, itemsize: int, grow: float = 1.0) -> float:
    """Bytes a pass must move: each input read once, each output written
    once, over `cells` cells (`grow` times them for an ext pass's region)."""
    return (p.n_fields + len(p.outputs)) * cells * grow * itemsize


def main_phase(smoke, pde, torch, np, device, smi, units, errs, logs) -> list[dict]:
    """Phases 69-70 (see the module docstring); `logs` holds ptxas' report
    of each build unit by digest. Returns the kernels line's rows."""
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.parallel import GridMesh

    f32 = torch.float32
    cells = N**3
    programs = units["programs"]
    n_passes = {where: len(programs[("cahn-hilliard", where)].passes)
                for where in ("serial", "ext")}
    pde.config["parallel.devices_per_device"] = 8
    grid = pde.UnitGrid([N] * 3, periodic=True)
    state = pde.ScalarField(grid, np.random.default_rng(0).uniform(-0.1, 0.1, (N,) * 3),
                            dtype=f32, device=device)
    eq = pde.CahnHilliardPDE()
    counters = (s3.multi_stencil_3d, e3.multi_stencil_ext_3d)

    # -- 69. the main path ---------------------------------------------------------------------
    _solve(eq, state, 2, backend="cuda")  # warm-up: the library loaded
    _solve(eq, state, 2, backend="cuda", decomposition=MESH)
    runs, launches, per_pass, idle = {}, {}, {}, {}
    for where, kwargs in (("serial", {}), (str(MESH), {"decomposition": MESH})):
        passes = n_passes["serial" if where == "serial" else "ext"]
        _reset(counters)
        (result, info), seconds = smoke._synced_seconds(
            torch, lambda: _solve(eq, state, WINDOW, backend="cuda", **kwargs))
        kernel = s3.multi_stencil_3d if where == "serial" else e3.multi_stencil_ext_3d
        launches[where] = kernel.launches
        per_pass[where] = dict(kernel.pass_launches)
        others = sum(c.launches for c in counters) - kernel.launches
        checks = [info["solver"].get("fused_step") is True,
                  "fused_unsupported" not in info["solver"],
                  kernel.launches == passes * WINDOW, others == 0,
                  per_pass[where] == {i: WINDOW for i in range(passes)},
                  info["solver"]["steps"] == WINDOW, bool(torch.isfinite(result.data).all())]
        smoke._require(all(checks), f"the CH 256^3 RK4 main path {where}: {checks}")
        runs[where] = (result, seconds, info["solver"].get("fused_step"))
        # one traced window of the same run: the card's idle share
        stepper = pde.RungeKuttaSolver(eq, backend="cuda", adaptive=False,
                                       **kwargs).make_stepper(state, dt=DT)
        wall_us, busy_us = smoke._traced_window(torch, stepper, state, 0.0, WINDOW * DT)
        idle[where] = ("not measured (the trace holds no device time)" if busy_us == 0
                       else f"{1.0 - busy_us / wall_us:.2%}")
    serial = runs["serial"][0]
    smoke._require(torch.equal(serial.data, runs[str(MESH)][0].data),
                   f"CH 256^3 RK4 on {MESH} is not bit-equal to serial")
    # the host's time a launch: the serial window's launches enqueued behind a
    # spin of the stream, so the card does not pace them
    window = eq.make_fused_rk4_window(state, DT)
    datas = [state.data.contiguous()]
    window(datas, 4)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start = time.perf_counter()
    window(datas, 64)
    host_us = (time.perf_counter() - start) / (64 * n_passes["serial"]) * 1e6
    torch.cuda.synchronize()
    (plain, _), plain_seconds = smoke._synced_seconds(
        torch, lambda: _solve(eq, state, WINDOW, backend="numpy"))
    err = smoke._check_rel(torch, "CH 256^3 RK4 against the plain loop", serial.data,
                           plain.data, f32, WINDOW)
    parts = [f"CahnHilliardPDE() {N}^3 fp32 periodic, {WINDOW} steps at dt {DT}: "
             + ", ".join(f"{where} fused_step={fused} {seconds:.3f} s "
                         f"({cells * WINDOW / seconds:.4e} cell-updates/s), "
                         f"{launches[where]} launches ({per_pass[where]} by pass), idle share "
                         f"{idle[where]} of a traced window"
                         for where, (_, seconds, fused) in runs.items())
             + f", {MESH} bit-equal to serial; the host {host_us:.1f} us a launch (enqueued "
             f"behind a spin); the plain loop on the card {plain_seconds:.3f} s "
             f"({cells * WINDOW / plain_seconds:.4e} cell-updates/s), max_abs against it "
             f"{err:.3e} (max|f| {float(plain.data.abs().max()):.3e})"]
    # the face in time: kernels A and B
    sides_eq = pde.PDE({"c": CH_EXPR}, bc=_timed_bc())
    bounded = pde.UnitGrid([N] * 3, periodic=False)
    sides_state = pde.ScalarField(bounded, np.random.default_rng(1).uniform(-0.1, 0.1, (N,) * 3),
                                  dtype=f32, device=device)
    _solve(sides_eq, sides_state, 2, T0, backend="cuda")
    _solve(sides_eq, sides_state, 2, T0, backend="cuda", decomposition=MESH)
    side_runs = {}
    for where, kwargs in (("serial", {}), (str(MESH), {"decomposition": MESH})):
        _reset(counters)
        (result, info), seconds = smoke._synced_seconds(
            torch, lambda: _solve(sides_eq, sides_state, SIDE_STEPS, T0, backend="cuda",
                                  **kwargs))
        kernel = s3.multi_stencil_3d if where == "serial" else e3.multi_stencil_ext_3d
        launches[f"sides {where}"] = kernel.sides_launches
        per_pass[f"sides {where}"] = dict(kernel.pass_launches)
        passes = len(programs[("sides", "serial" if where == "serial" else "ext")].passes)
        checks = [info["solver"].get("fused_step") is True,
                  kernel.sides_launches == kernel.launches == passes * SIDE_STEPS,
                  sum(c.launches for c in counters) == passes * SIDE_STEPS,
                  bool(torch.isfinite(result.data).all())]
        smoke._require(all(checks), f"the face-in-time RK4 run {where}: {checks}")
        side_runs[where] = (result, seconds)
    smoke._require(torch.equal(side_runs["serial"][0].data, side_runs[str(MESH)][0].data),
                   f"the face-in-time RK4 run on {MESH} is not bit-equal to serial")
    parts.append(f"{CH_EXPR} {N}^3 fp32 bounded (y- 0.1*sin(3*t), y+ 0, no-flux), "
                 f"{SIDE_STEPS} steps from t0 = {T0}: " + ", ".join(
                     f"{where} {seconds:.3f} s ({cells * SIDE_STEPS / seconds:.4e} "
                     f"cell-updates/s), {launches[f'sides {where}']} side-input launches"
                     for where, (_, seconds) in side_runs.items())
                 + f", {MESH} bit-equal to serial")
    print(f"[rk4 3d main] through solve(backend='cuda', solver='runge-kutta', adaptive=False, "
          f"tracker=None) on {smi}: " + "; ".join(parts) + " ok", flush=True)

    # -- 70. each pass kernel --------------------------------------------------------------------
    gen = torch.Generator(device=device).manual_seed(70)
    mesh = GridMesh(grid, MESH, devices=[device] * 8)
    local = mesh.local_shape
    timed, lines = {}, []
    for (name, where), program in programs.items():
        if where == "ext" and name not in ("cahn-hilliard", "sides"):
            continue
        views = _views(program, f32, device)
        kernel = KERNELS[(where, program.sides is not None)]
        if where == "serial":
            spec = cs.multi_stencil_spec(program, 1, f32)
            data = torch.rand(grid.shape, generator=gen, dtype=f32, device=device) - 0.5
            inputs = _serial_inputs(s3, program, data, views)
            outs = {p.index: [torch.empty_like(data) for _ in p.writes] for p in program.passes}
            run = {p.index: (lambda p=p, ins=ins: s3.multi_stencil_3d_pass(
                p, ins, spec, outs[p.index], views))
                for p, ins in zip(program.passes, inputs)}
            plain = {p.index: (lambda p=p, ins=ins: s3.pass_plain(p, ins, views))
                     for p, ins in zip(program.passes, inputs)}
            step_out = [torch.empty_like(data)]
            step = (lambda: s3.multi_stencil_3d([data], spec, outs=step_out, sides=views),
                    lambda: s3.multi_stencil_3d_plain([data], spec, views))
            block_cells, grows = cells, [1.0] * len(program.passes)
        else:
            halo = program.depth
            spec = e3.multi_stencil_ext_3d_spec(program, 1, f32, local, halo)
            ins, outs_ext, flags = smoke._ext_side_blocks(torch, mesh, halo, f32, gen)
            if program.sides is None:
                flags = [f[:6] for f in flags]
            inputs = _ext_inputs(e3, spec, ins, flags, views)
            outs = {p.index: [[x.new_zeros(x.shape) for _ in p.writes] for x in
                              [b[0] for b in ins]] for p in program.passes}
            run = {p.index: (lambda p=p, b=b: e3.multi_stencil_ext_3d_pass(
                p, b, outs[p.index], flags, spec, views)) for p, b in zip(program.passes, inputs)}
            plain = {p.index: (lambda p=p, b=b: _ext_plain_pass(
                e3, p, b, outs[p.index], flags, spec, views))
                for p, b in zip(program.passes, inputs)}
            step = (lambda: e3.multi_stencil_ext_3d(ins, outs_ext, flags, spec, sides=views),
                    lambda: [e3.multi_stencil_ext_3d_plain(b, spec, f, views)
                             for b, f in zip(ins, flags, strict=True)])
            block_cells = cells
            grows = [((local[0] + 2 * p.extent) / local[0]) ** 3 for p in program.passes]
        table = smoke._sides3d_table_bytes(program, 1, 4) if program.sides is not None else 0
        rows = []
        for p, tile in zip(program.passes, spec.tile, strict=True):
            ms = smoke._cuda_ms(torch, run[p.index], 20)
            plain_ms = smoke._cuda_ms(torch, plain[p.index], 2)
            moved = _pass_bytes(p, block_cells, 4, grows[p.index]) + table
            bound = smoke._bound(moved, smoke._program_flops(p) * block_cells * grows[p.index])
            regs = " | ".join(smoke._ptxas_of(logs[program.digest], kernel, f"N5pass{p.index}",
                                              "ProgramEfLi1ELi{}ELi{}ELi{}E".format(*tile)))
            rows.append((p, ms, plain_ms, bound, regs, tile))
            timed[(name, where, p.index)] = (ms, plain_ms, bound)
        step_ms = smoke._cuda_ms(torch, step[0], 20)
        step_plain = smoke._cuda_ms(torch, step[1], 2)
        # the step's bound (the same work as one march a step): the fields
        # read once and written once, over blocks each block's extended
        # buffer read once
        read = cells if where == "serial" else 8 * math.prod(m + 2 * program.depth for m in local)
        step_bound = smoke._bound((read + cells) * 4 + table,
                                  smoke._program_flops(program) * cells)
        timed[(name, where, "step")] = (step_ms, step_plain, step_bound)
        what = f"one {N}^3 step" if where == "serial" else f"eight {N // 2}^3 blocks"
        design = sum(_pass_bytes(p, 1, 4, grows[p.index]) for p in program.passes)
        lines.append(
            f"{name} {kernel} ({what}): the step {step_ms:.4f} ms, plain {step_plain:.4f} ms, "
            f"bound {step_bound[0]:.4f} ms ({step_bound[1]}, {step_bound[0] / step_ms:.1%} of "
            f"it), {design:.1f} B a cell-step moved by the passes, "
            f"{len(program.passes) * WINDOW} launches a {WINDOW}-step window; " + "; ".join(
                f"pass {p.index} at {tile} ({p.n_fields} in, {len(p.outputs)} out, extent "
                f"{p.extent}, {p.march.step_slots} planes, "
                f"{p.smem_bytes(1, tile, 4)} B) {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound[0]:.4f} ms ({bound[1]}, {bound[0] / ms:.1%}); ptxas {regs}"
                for p, ms, plain_ms, bound, regs, tile in rows))
    print(f"[rk4 3d passes] the cut RK4 step's pass kernels, fp32, on {smi}: "
          + "; ".join(lines) + " ok", flush=True)
    pde.config["parallel.devices_per_device"] = 1
    out = []
    for (name, where), row_name, replaces, count in (
            (("cahn-hilliard", "serial"), "multi_stencil_3d (RK4 step, {n} passes)",
             "pde_tpu/ops/pallas_cartesian.py:2935 (halo_per_step 8: "
             "pde_tpu/models/pde.py:898-924)", per_pass["serial"]),
            (("sides", "serial"), "multi_stencil_3d (RK4 step, {n} passes, side inputs)",
             "pde_tpu/ops/pallas_cartesian.py:2935 (halo_per_step 8, bc_inputs)",
             per_pass["sides serial"]),
            (("cahn-hilliard", "ext"), "multi_stencil_ext_3d (RK4 step, {n} passes)",
             "pde_tpu/ops/pallas_cartesian.py:3443 (pde_tpu/parallel/fused.py:597-842)",
             per_pass[str(MESH)]),
            (("sides", "ext"), "multi_stencil_ext_3d (RK4 step, {n} passes, side inputs)",
             "pde_tpu/ops/pallas_cartesian.py:3443 (bc_inputs)", per_pass[f"sides {MESH}"])):
        n = len(programs[(name, where)].passes)
        ms, plain_ms, bound = timed[(name, where, "step")]
        out.append({
            "name": row_name.format(n=n), "route": "cuda",
            "source": "pde_tpu_torch/csrc/multi_stencil_3d.cuh", "replaces": replaces,
            "launches": sum(count.values()), "max_abs_err": errs[(name, where, f32, "step")],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None,  # a nonlinear rhs: no PyTorch call computes the step
            # the pass kernels of the step, each beside its own bound (its
            # inputs read once and its outputs written once)
            "passes": [{"index": i, "launches": count.get(i, 0),
                        "max_abs_err": errs[(name, where, f32, i)],
                        "ms": timed[(name, where, i)][0], "plain_ms": timed[(name, where, i)][1],
                        "own_bound_ms": timed[(name, where, i)][2][0]} for i in range(n)],
        })
    return out


# builds, in a process whose package is DIR's, the 3D programs whose rings fit
# a plan, and prints {label: {kernel, path, log, ladder, tiles}} as JSON
_BUILD_FITTING = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import pde_tpu_torch as pde
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.parallel import GridMesh
grid = pde.UnitGrid([256] * 3, periodic=True)
box = pde.UnitGrid([256] * 3, periodic=False)
state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device="cpu")
bounded = pde.ScalarField(box, 0.0, dtype=torch.float32, device="cpu")
timed = {"x": {"derivative": 0}, "y-": {"value_expression": "0.1*sin(3*t)"},
         "y+": {"value": 0}, "z": {"derivative": 0}}
ac, ac_sides = pde.AllenCahnPDE(), pde.PDE({"u": "laplace(u) + u - u**3"}, bc=timed)
programs = {}
with pde.config({"parallel.devices_per_device": 8}):
    for label, st, eq, where in (("allen-cahn", state, ac, "serial"),
                                 ("allen-cahn", state, ac, "ext"),
                                 ("allen-cahn sides", bounded, ac_sides, "serial"),
                                 ("allen-cahn sides", bounded, ac_sides, "ext")):
        mesh = GridMesh(st.grid, [2, 2, 2], devices=["cpu"] * 8) if where == "ext" else None
        kernel = ("multi_stencil" + ("_sides" if "sides" in label else "")
                  + ("_ext" if mesh else "") + "_3d_kernel")
        for scheme in ("euler", "rk4"):
            programs[f"{label} {scheme} {where}"] = (kernel, getattr(
                eq, f"make_fused_{scheme}_window")(st, 1e-3, mesh=mesh).program)
    programs["cahn-hilliard euler serial"] = ("multi_stencil_3d_kernel", pde.CahnHilliardPDE()
                                              .make_fused_euler_window(state, 1e-3).program)
builds = cs.build_programs([p for _, p in programs.values()])
print(json.dumps({label: {"kernel": kernel, "path": b["path"], "log": b["log"],
                          "ladder": p.ladder,
                          "tiles": {str(d)[6:]: t for d, t in p.tiles.items()}}
                  for (label, (kernel, p)), b in zip(programs.items(), builds)}))
"""


def compare(smoke, parent: str) -> None:
    """ptxas' report and the SASS summary of the kernels of the 3D programs
    whose rings fit a plan, in `parent`'s copy beside this tree's, for each
    dtype and k."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from scripts.torch_tree_compare import _sass

    copies = [parent, str(ROOT)]
    procs = {copy: subprocess.Popen([sys.executable, "-c", _BUILD_FITTING, copy],
                                    stdout=subprocess.PIPE, text=True) for copy in copies}
    builds = {}
    for copy, proc in procs.items():
        stdout, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the build in {copy} failed ({proc.returncode})")
        builds[copy] = json.loads(stdout.strip().splitlines()[-1])
    nvcc = cc._nvcc()
    same = True
    for label, mine in builds[str(ROOT)].items():
        kernel = mine["kernel"]
        for dtype, tag in (("float32", "Ef"), ("float64", "Ed")):
            for k in mine["ladder"]:
                tile = mine["tiles"][dtype][str(k)]
                needles = (kernel, "{}Li{}ELi{}ELi{}ELi{}E".format(tag, k, *tile))
                cells, hashes = [], []
                for copy in copies:
                    built = builds[copy][label]
                    ptx = " | ".join(smoke._ptxas_of(built["log"], *needles))
                    sass = ", ".join(sorted(_sass(nvcc, built["path"], needles, None).values()))
                    hashes.append(sass)
                    cells.append(f"{copy}: {ptx}; SASS {sass or 'not read'}")
                same = same and hashes[0] == hashes[1] and bool(hashes[0])
                print(f"[rk4 3d sass] {label} {kernel} {dtype} k={k}: " + " || ".join(cells)
                      + f" -> {'same SASS' if hashes[0] == hashes[1] else 'SASS DIFFERS'}",
                      flush=True)
    print(f"[rk4 3d sass] the kernels of the 3D programs that fit a plan "
          f"{'keep' if same else 'do NOT keep'} {parent}'s SASS", flush=True)


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
    built = units(pde, torch, device)
    programs = built["units"]
    start = time.perf_counter()
    builds = cs.build_programs(programs)
    print(f"built {len(programs)} libraries in {time.perf_counter() - start:.1f} s (CPU s "
          + ", ".join(f"{p.library} {b['cpu_seconds']:.1f}" for p, b in zip(programs, builds))
          + ")", flush=True)
    start = time.perf_counter()
    errs = kernels_phase(smoke, pde, torch, np, device, smi, built)
    print(f"phase 68 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    rows = main_phase(smoke, pde, torch, np, device, smi, built, errs,
                      {p.digest: b["log"] for p, b in zip(programs, builds)})
    print(f"phases 69-70 in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    if "--parent" in sys.argv:
        start = time.perf_counter()
        compare(smoke, sys.argv[sys.argv.index("--parent") + 1])
        print(f"the comparison in {time.perf_counter() - start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
