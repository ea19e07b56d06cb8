"""Phases 68-70 of ``chip_smoke.py``: fixed-dt RK4 of a two-deep rhs on 3D
grids (Cahn-Hilliard, Swift-Hohenberg, Kuramoto-Sivashinsky) through the
layout of kernels #5 and #6 that reads the fields from the pass's input
and keeps each volume in a compact plane (``Program::kInputPoints`` of
``csrc/multi_stencil_3d.cuh``), on one NVIDIA GPU.

``chip_smoke.py`` builds :func:`units` with its other libraries and calls
:func:`kernels_phase` and :func:`main_phase`; run alone, this script builds
them, all at once, and runs the phases::

    python3 scripts/torch_rk4_3d_phases.py

The four kernels that carry the layout: #5's ``multi_stencil_3d_kernel`` and
its side-input kernel A (``multi_stencil_sides_3d_kernel``), #6's
``multi_stencil_ext_3d_kernel`` and its side-input kernel B
(``multi_stencil_sides_ext_3d_kernel``). The programs: the three models on a
periodic 256³ grid, serially and over a [2, 2, 2] mesh (eight 128³ blocks),
and ``laplace(c**3 - c - laplace(c))`` on a bounded 256³ grid with a face in
time (y- ``0.1*sin(3*t)``, y+ 0, the rest no-flux) for A and B.

Phase 68 (``[rk4 3d kernels]``): one pass of each kernel against its plain
version on the same inputs (``uniform(-0.5, 0.5)``), fp32 within 1e-6 of
max|f| a step, fp64 within 1e-12. Phase 69 (``[rk4 3d main]``): the slice's main path,
``CahnHilliardPDE()`` on a periodic 256³ fp32 grid from ``uniform(-0.1,
0.1)`` (seed 0) for 2048 steps at dt = 1e-3 through ``solve(backend="cuda",
solver="runge-kutta", adaptive=False, tracker=None)``: fused, one launch a
step, against the plain loop on the card, the same run on [2, 2, 2] bit-equal
to serial, cell-updates/s beside the plain loop's; the face-in-time program
for 256 steps serially (kernel A) and on [2, 2, 2] (kernel B), bit-equal.
Phase 70 (``[rk4 3d passes]``): one pass of each kernel (and of SH and KS
serially) beside its plain version and its bound, launches per 2048-step
window, ptxas' registers and spills of every instantiation. :func:`main_phase`
returns the kernels line's four rows.

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
    (the face-in-time program); and the build units, one a program."""
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
    for program in programs.values():
        if not program.input_points or program.ladder != [1]:
            raise AssertionError("a two-deep RK4 program kept the rings' layout")
    return {"programs": programs, "units": list(programs.values())}


def _views(program, dtype, device):
    if program.sides is None:
        return None
    return program.sides.passes(T0, 1, DT, dtype, device)(0, 1)


def kernels_phase(smoke, pde, torch, np, device, smi, units) -> dict:
    """Phase 68 (see the module docstring); returns the max_abs errors by
    (model, where, dtype)."""
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
            if where == "serial":
                spec = cs.multi_stencil_spec(program, 1, dtype)
                data = torch.rand(grid.shape, generator=gen, dtype=dtype, device=device) - 0.5
                (out,) = s3.multi_stencil_3d([data], spec, sides=views)
                (ref,) = s3.multi_stencil_3d_plain([data], spec, views)
            else:
                mesh = GridMesh(grid, MESH, devices=[device] * 8)
                halo = program.depth
                spec = e3.multi_stencil_ext_3d_spec(program, 1, dtype, mesh.local_shape, halo)
                ins, outs, flags = smoke._ext_side_blocks(torch, mesh, halo, dtype, gen)
                if program.sides is None:
                    flags = [f[:6] for f in flags]
                e3.multi_stencil_ext_3d(ins, outs, flags, spec, sides=views)
                inner = (slice(halo, -halo),) * 3
                out = torch.stack([p[0][inner] for p in outs])
                ref = torch.stack([e3.multi_stencil_ext_3d_plain(p, spec, f, views)[0]
                                   for p, f in zip(ins, flags, strict=True)])
            err = smoke._check_rel(torch, f"{name} {where} {dtype}", out, ref, dtype, 1)
            errs[(name, where, dtype)] = err
            lines.append(f"{name} {where} {str(dtype)[6:]} plan {spec.tile} max_abs {err:.2e} "
                         f"(max|ref| {float(ref.abs().max()):.3e})")
    pde.config["parallel.devices_per_device"] = 1
    print(f"[rk4 3d kernels] one RK4 pass of each kernel in the layout that reads the fields "
          f"from the input against its plain version at {N}^3 (ext over {MESH}), on {smi}: "
          + "; ".join(lines) + " ok", flush=True)
    return errs


def _solve(eq, state, steps, t0=0.0, **kwargs):
    return eq.solve(state, t_range=[t0, t0 + steps * DT], dt=DT, tracker=None,
                    solver="runge-kutta", adaptive=False, ret_info=True, **kwargs)


def main_phase(smoke, pde, torch, np, device, smi, units, errs, logs) -> list[dict]:
    """Phases 69-70 (see the module docstring); `logs` holds ptxas' report
    of each build unit by digest. Returns the kernels line's four rows."""
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.parallel import GridMesh

    f32 = torch.float32
    cells = N**3
    programs = units["programs"]
    pde.config["parallel.devices_per_device"] = 8
    grid = pde.UnitGrid([N] * 3, periodic=True)
    state = pde.ScalarField(grid, np.random.default_rng(0).uniform(-0.1, 0.1, (N,) * 3),
                            dtype=f32, device=device)
    eq = pde.CahnHilliardPDE()
    counters = (s3.multi_stencil_3d, e3.multi_stencil_ext_3d)

    # -- 69. the main path ---------------------------------------------------------------------
    _solve(eq, state, 2, backend="cuda")  # warm-up: the library loaded
    _solve(eq, state, 2, backend="cuda", decomposition=MESH)
    runs, launches = {}, {}
    for where, kwargs in (("serial", {}), (str(MESH), {"decomposition": MESH})):
        for counter in counters:
            counter.launches = counter.sides_launches = 0
        (result, info), seconds = smoke._synced_seconds(
            torch, lambda: _solve(eq, state, WINDOW, backend="cuda", **kwargs))
        kernel = s3.multi_stencil_3d if where == "serial" else e3.multi_stencil_ext_3d
        launches[where] = kernel.launches
        others = sum(c.launches for c in counters) - kernel.launches
        checks = [info["solver"].get("fused_step") is True,
                  "fused_unsupported" not in info["solver"], kernel.launches == WINDOW,
                  others == 0, info["solver"]["steps"] == WINDOW,
                  bool(torch.isfinite(result.data).all())]
        smoke._require(all(checks), f"the CH 256^3 RK4 main path {where}: {checks}")
        runs[where] = (result, seconds, info["solver"].get("fused_step"))
    serial = runs["serial"][0]
    smoke._require(torch.equal(serial.data, runs[str(MESH)][0].data),
                   f"CH 256^3 RK4 on {MESH} is not bit-equal to serial")
    (plain, _), plain_seconds = smoke._synced_seconds(
        torch, lambda: _solve(eq, state, WINDOW, backend="numpy"))
    err = smoke._check_rel(torch, "CH 256^3 RK4 against the plain loop", serial.data,
                           plain.data, f32, WINDOW)
    parts = [f"CahnHilliardPDE() {N}^3 fp32 periodic, {WINDOW} steps at dt {DT}: "
             + ", ".join(f"{where} fused_step={fused} {seconds:.3f} s "
                         f"({cells * WINDOW / seconds:.4e} cell-updates/s), "
                         f"{launches[where]} launches"
                         for where, (_, seconds, fused) in runs.items())
             + f", {MESH} bit-equal to serial; the plain loop on the card {plain_seconds:.3f} s "
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
        for counter in counters:
            counter.launches = counter.sides_launches = 0
        (result, info), seconds = smoke._synced_seconds(
            torch, lambda: _solve(sides_eq, sides_state, SIDE_STEPS, T0, backend="cuda",
                                  **kwargs))
        kernel = s3.multi_stencil_3d if where == "serial" else e3.multi_stencil_ext_3d
        launches[f"sides {where}"] = kernel.sides_launches
        checks = [info["solver"].get("fused_step") is True,
                  kernel.sides_launches == kernel.launches == SIDE_STEPS,
                  sum(c.launches for c in counters) == SIDE_STEPS,
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

    # -- 70. one pass of each kernel -------------------------------------------------------------
    gen = torch.Generator(device=device).manual_seed(70)
    mesh = GridMesh(grid, MESH, devices=[device] * 8)
    local = mesh.local_shape
    timed, lines = {}, []
    for (name, where), program in programs.items():
        views = _views(program, f32, device)
        if where == "serial":
            spec = cs.multi_stencil_spec(program, 1, f32)
            data = torch.rand(grid.shape, generator=gen, dtype=f32, device=device) - 0.5
            out = [torch.empty_like(data)]
            ms = smoke._cuda_ms(torch, lambda: s3.multi_stencil_3d([data], spec, outs=out,
                                                                   sides=views), 20)
            plain_ms = smoke._cuda_ms(torch, lambda: s3.multi_stencil_3d_plain([data], spec,
                                                                               views), 3)
            moved = 2 * cells * 4
        else:
            if name not in ("cahn-hilliard", "sides"):
                continue
            halo = program.depth
            spec = e3.multi_stencil_ext_3d_spec(program, 1, f32, local, halo)
            ins, outs, flags = smoke._ext_side_blocks(torch, mesh, halo, f32, gen)
            if program.sides is None:
                flags = [f[:6] for f in flags]
            ms = smoke._cuda_ms(torch, lambda: e3.multi_stencil_ext_3d(ins, outs, flags, spec,
                                                                       sides=views), 20)
            plain_ms = smoke._cuda_ms(torch, lambda: [e3.multi_stencil_ext_3d_plain(
                p, spec, f, views) for p, f in zip(ins, flags, strict=True)], 3)
            moved = (8 * math.prod(m + 2 * halo for m in local) + cells) * 4
        if program.sides is not None:
            moved += smoke._sides3d_table_bytes(program, 1, 4)
        bound = smoke._bound(moved, smoke._program_flops(program) * cells)
        kernel = KERNELS[(where, program.sides is not None)]
        regs = []
        for dtype, letter in ((f32, "f"), (torch.float64, "d")):
            tile = program.tiles[dtype][1]
            tag = "E{}Li1ELi{}ELi{}ELi{}E".format(letter, *tile)
            regs.append(f"{str(dtype)[6:]} {tile}: " + " | ".join(
                smoke._ptxas_of(logs[program.digest], kernel, tag)))
        timed[(name, where)] = (ms, plain_ms, bound)
        what = f"one {N}^3 pass" if where == "serial" else f"eight {N // 2}^3 blocks"
        lines.append(f"{name} {kernel} ({what}, "
                     f"{program.march.step_slots} planes, "
                     f"{program.smem_bytes(1, spec.tile, 4)} B of shared memory at {spec.tile}) "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
                     f"({bound[1]}, {bound[0] / ms:.1%} of it), "
                     f"{smoke._ladder_passes([1], WINDOW)} launches a {WINDOW}-step window "
                     f"(ladder [1]); ptxas " + "; ".join(regs))
    print(f"[rk4 3d passes] k = 1 passes, fp32, on {smi}: " + "; ".join(lines) + " ok",
          flush=True)
    pde.config["parallel.devices_per_device"] = 1
    rows = []
    for (name, where), row_name, replaces, launched in (
            (("cahn-hilliard", "serial"), "multi_stencil_3d (RK4, fields from the input)",
             "pde_tpu/ops/pallas_cartesian.py:2935 (halo_per_step 8: "
             "pde_tpu/models/pde.py:898-924)", launches["serial"]),
            (("sides", "serial"), "multi_stencil_3d (RK4, fields from the input, side inputs)",
             "pde_tpu/ops/pallas_cartesian.py:2935 (halo_per_step 8, bc_inputs)",
             launches["sides serial"]),
            (("cahn-hilliard", "ext"), "multi_stencil_ext_3d (RK4, fields from the input)",
             "pde_tpu/ops/pallas_cartesian.py:3443 (pde_tpu/parallel/fused.py:597-842)",
             launches[str(MESH)]),
            (("sides", "ext"), "multi_stencil_ext_3d (RK4, fields from the input, side inputs)",
             "pde_tpu/ops/pallas_cartesian.py:3443 (bc_inputs)", launches[f"sides {MESH}"])):
        ms, plain_ms, bound = timed[(name, where)]
        rows.append({
            "name": row_name, "route": "cuda", "source": "pde_tpu_torch/csrc/multi_stencil_3d.cuh",
            "replaces": replaces, "launches": launched,
            "max_abs_err": errs[(name, where, f32)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None,  # a nonlinear rhs: no PyTorch call computes the step
        })
    return rows


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
