"""Phases 64-67 of ``chip_smoke.py``: boundary values that vary along a side
and in time on cylindrical grids, through the side inputs of the radial
modes of kernels #1 (``affine_laplace_radial_sides_2d_kernel``) and #12
(``affine_laplace_radial_sides_ext_2d_kernel``), on one NVIDIA GPU.

``chip_smoke.py`` builds :func:`units` with its other libraries and calls
:func:`kernels_phase` and :func:`main_phase`; run alone, this script builds
them and the scalar radial libraries it times beside them, all at once, and
runs the phases::

    python3 scripts/torch_radial_sides_phases.py

The cases, config 4's width (4096² cells, fp32 and fp64, ``uniform(0, 1)``),
the t-tables from t0 = 0.35 at dt = 0.1:

- (a) z periodic, a hole at r = 512 (``CylindricalSymGrid((512, 4608), (0,
  4096), (4096, 4096), periodic_z=True)``): ``0.1*sin(3*t)`` on r-, a
  per-point Dirichlet array along z on r+;
- (b) z bounded, r from 0 (``CylindricalSymGrid(4096, (0, 4096), (4096,
  4096))``): no-flux r, a per-point Dirichlet array along r on z-,
  ``cos(t)`` as z+'s derivative.

Phase 64 (``[radial sides]``): the serial kernel against its plain version
at every k of its ladder, fp32 and fp64 (fp32 within 1.5e-7 of max|f|, fp64
within 1e-14), and the ext kernel against its plain version over the blocks
of [2, 2] and [2, 1] meshes of both cylinders at every k (halo the top k).
Phase 65 (``[radial sides main]``): ``DiffusionPDE(0.1)`` on (a) for 2048
steps at dt = 0.1 from t0 through ``solve(backend="cuda", solver="euler",
adaptive=False)``, serially and with ``decomposition=[2, 2]`` and ``[2,
1]``: fused, no ``fused_unsupported``, each decomposed run bit-equal to the
serial one, the side-input launches counted from 0; cell-updates/s of
2048-step windows beside the scalar-side radial window's (r value 0), in
turns. Phase 66 (``[radial sides passes]``): one top-k pass of each kernel
on (a) fp32 beside the scalar radial pass at the same k on the same grid,
the plain version and the bound; ptxas' registers and spills of every k.
Phase 67 is the kernels line's two rows (:func:`main_phase` returns them).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

N = 4096
HOLE = 512  # the inner radius of case (a)'s cylinder
T0 = 0.35
DT = 0.1
WINDOW = 2048
MESHES = ([2, 2], [2, 1])
F32_RTOL = 1.5e-7  # the kernels against their plain versions, relative to max|f|
F64_RTOL = 1e-14
FLOPS = 8  # operations of a radial update: four products, four sums


def side_cases(pde, np, n: int | None = None) -> dict:
    """label -> (grid, conditions with side inputs, scalar conditions of the
    same kinds: value 0 where a side has values, no-flux where it has a
    derivative) of cases (a) and (b) on n² cells (:data:`N` by default)."""
    n = N if n is None else n
    hole = pde.CylindricalSymGrid((HOLE * n // N, HOLE * n // N + n), (0, n), (n, n),
                                  periodic_z=True)
    solid = pde.CylindricalSymGrid(n, (0, n), (n, n))
    wave = np.sin(np.linspace(0.0, 2.0 * np.pi, n))
    noflux = {"derivative": 0}
    return {
        "(a) z periodic, a hole": (
            hole, {"r-": {"value_expression": "0.1*sin(3*t)"}, "r+": {"value": wave},
                   "z": "periodic"},
            {"r": {"value": 0}, "z": "periodic"}),
        "(b) z bounded": (
            solid, {"r": noflux, "z-": {"value": 0.5 * wave},
                    "z+": {"derivative_expression": "cos(t)"}},
            {"r": noflux, "z-": {"value": 0}, "z+": noflux}),
    }


def units() -> list:
    """The build units of the phases: the radial side-input libraries of #1
    and #12, z bounded and periodic."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce

    periodic = ((False, False), (False, True))
    return ([cc.kernel_source(p, cc.RADIAL_SIDES_LIBRARY) for p in periodic]
            + [ce.affine_ext_source(p, radial=True, sides=True) for p in periodic])


def scalar_units() -> list:
    """The scalar radial libraries of #1 and #12 on z periodic (case (a)'s
    periodicity), which phase 66 times beside the side-input modes."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce

    return [cc.kernel_source((False, True), cc.RADIAL_LIBRARY),
            ce.affine_ext_source((False, True), radial=True)]


def _times(k: int, first: int = 0) -> list[float]:
    return [T0 + (first + s) * DT for s in range(k)]


def _check(smoke, torch, label, out, ref, dtype) -> float:
    """max_abs of `out` against `ref`, raising past fp32's 1.5e-7 or fp64's
    1e-14 of max|ref|."""
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    tol = (F64_RTOL if dtype == torch.float64 else F32_RTOL) * scale
    smoke._require(bool(torch.isfinite(out).all()) and err <= tol,
                   f"{label}: max_abs {err:.3e} past {tol:.1e} (max|ref| {scale:.3e})")
    return err


def kernels_phase(smoke, pde, torch, np, device, smi) -> dict:
    """Phase 64 (see the module docstring); returns the max_abs errors by
    (kernel, case, mesh, dtype, k)."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    gen = torch.Generator(device=device).manual_seed(64)
    top = cc.RADIAL_SIDES_TOP_STEPS
    errs, lines = {}, []
    for label, (grid, bc, _) in side_cases(pde, np).items():
        bcs = grid.get_boundary_conditions(bc)
        inputs = cc.AffineSideInputs(grid, bcs)
        for dtype in (torch.float32, torch.float64):
            data = torch.rand(grid.shape, generator=gen, dtype=dtype, device=device)
            out = torch.empty_like(data)
            row = []
            for k in range(1, top + 1):
                spec = cc.affine_laplace_spec(grid, a=1.0, b=0.1 * DT, k=k, dtype=dtype, bcs=bcs)
                sides = inputs.for_pass(dtype, device, _times(k))
                cc.affine_laplace_2d(data, spec, out=out, sides=sides)
                err = _check(smoke, torch, f"#1 radial side inputs {label} k={k} {dtype}", out,
                             cc.affine_laplace_2d_plain(data, spec, sides), dtype)
                errs[("#1", label, None, dtype, k)] = err
                row.append(f"{err:.1e}")
            lines.append(f"#1 {label} {str(dtype)[6:]} k=1..{top} " + "/".join(row))
            for cut in MESHES:
                mesh = GridMesh(grid, cut, devices=[device] * int(np.prod(cut)))
                ins, outs, flags = smoke._ext_side_blocks(torch, mesh, top, dtype, gen)
                row = []
                for k in range(1, top + 1):
                    spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0,
                                                      b=0.1 * DT, k=k, halo=top, dtype=dtype,
                                                      bcs=bcs)
                    sides = inputs.for_pass(dtype, device, _times(k), row_pad=cc.SIDE_PAD)
                    ce.affine_laplace_ext_2d([p[0] for p in ins], [p[0] for p in outs], flags,
                                             spec, sides=sides)
                    got = torch.stack([p[0][top:-top, top:-top] for p in outs])
                    ref = torch.stack([ce.affine_laplace_ext_2d_plain(p[0], spec, f, sides)
                                       for p, f in zip(ins, flags, strict=True)])
                    err = _check(smoke, torch, f"#12 radial side inputs {label} {cut} k={k} "
                                 f"{dtype}", got, ref, dtype)
                    errs[("#12", label, str(cut), dtype, k)] = err
                    row.append(f"{err:.1e}")
                lines.append(f"#12 {label} {cut} {str(dtype)[6:]} k=1..{top} " + "/".join(row))
    print(f"[radial sides] the radial side-input modes of #1 and #12 against their plain "
          f"versions at {N}^2, tables from t0={T0}, max_abs (fp32 within {F32_RTOL:g}, fp64 "
          f"within {F64_RTOL:g} of max|f|), on {smi}: " + "; ".join(lines) + " ok", flush=True)
    return errs


def _table_bytes(spec, sides) -> int:
    """Bytes of the radial table and the side tables a pass reads."""
    from pde_tpu_torch.ops.cuda_cartesian import RADIAL_PAD

    itemsize = spec.dtype.itemsize
    rows = (spec.table_rows() + 2 * RADIAL_PAD) * 2 * itemsize
    return rows + sum(a.numel() * itemsize for a in sides.arrays if a is not None)


def main_phase(smoke, pde, torch, np, device, smi, errs, logs) -> list[dict]:
    """Phases 65-66 (see the module docstring) on case (a); `logs` holds
    ptxas' report of each build unit by digest. Returns the kernels line's
    two rows."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    f32 = torch.float32
    label = "(a) z periodic, a hole"
    grid, bc, scalar_bc = side_cases(pde, np)[label]
    cells = N * N
    top = cc.RADIAL_SIDES_TOP_STEPS
    ladder = [top >> i for i in range(top.bit_length())]
    passes = smoke._ladder_passes(ladder, WINDOW)
    state = pde.ScalarField(grid, np.random.default_rng(65).uniform(0.0, 1.0, grid.shape),
                            dtype=f32, device=device)
    eq = pde.DiffusionPDE(0.1, bc=bc)
    t_range = [T0, T0 + WINDOW * DT]
    kwargs = dict(dt=DT, tracker=None, backend="cuda", solver="euler", adaptive=False,
                  ret_info=True)
    pde.config["parallel.devices_per_device"] = 4

    # -- 65. the main paths -----------------------------------------------------------------
    cc.affine_laplace_2d.launches = cc.affine_laplace_2d.radial_sides_launches = 0
    (serial, info), seconds = smoke._synced_seconds(torch, lambda: eq.solve(
        state, t_range=t_range, **kwargs))
    launches_1 = cc.affine_laplace_2d.radial_sides_launches
    checks = [info["solver"].get("fused_step") is True,
              "fused_unsupported" not in info["solver"], launches_1 == passes,
              cc.affine_laplace_2d.launches == launches_1, info["solver"]["steps"] == WINDOW,
              bool(torch.isfinite(serial.data).all())]
    smoke._require(all(checks), f"the serial cylindrical main path with side inputs: {checks}")
    parts = [f"serial {seconds:.3f} s through solve, {launches_1} radial side-input launches "
             f"({passes} passes a {WINDOW}-step window, ladder {ladder})"]
    launches_12 = {}
    for cut in MESHES:
        ce.affine_laplace_ext_2d.launches = ce.affine_laplace_ext_2d.radial_sides_launches = 0
        (result, info), seconds = smoke._synced_seconds(torch, lambda: eq.solve(
            state, t_range=t_range, decomposition=cut, **kwargs))
        launches_12[str(cut)] = ce.affine_laplace_ext_2d.radial_sides_launches
        checks = [info["solver"].get("fused_step") is True,
                  "fused_unsupported" not in info["solver"],
                  launches_12[str(cut)] == passes,
                  ce.affine_laplace_ext_2d.launches == launches_12[str(cut)],
                  torch.equal(result.data, serial.data)]
        smoke._require(all(checks), f"the decomposed cylindrical main path with side inputs on "
                                    f"{cut}: {checks}")
        parts.append(f"{cut} {seconds:.3f} s, {launches_12[str(cut)]} launches, bit-equal to "
                     "serial")
    scalar_eq = pde.DiffusionPDE(0.1, bc=scalar_bc)
    steppers = {
        "side inputs": pde.EulerSolver(eq, backend="cuda").make_stepper(state, dt=DT),
        "scalar sides": pde.EulerSolver(scalar_eq, backend="cuda").make_stepper(state, dt=DT),
        "side inputs [2, 2]": pde.EulerSolver(eq, backend="cuda", decomposition=[2, 2])
        .make_stepper(state, dt=DT),
    }
    order = ["side inputs", "scalar sides", "side inputs [2, 2]", "side inputs [2, 2]",
             "scalar sides", "side inputs"]
    rates = [(name, smoke._window_rate(torch, steppers[name], state, DT)) for name in order]
    print(f"[radial sides main] DiffusionPDE(0.1) on {label} {N}^2 fp32 (r- 0.1*sin(3*t), "
          f"r+ a per-point array), dt {DT}, {WINDOW} steps from t0 = {T0} through "
          f"solve(backend='cuda', solver='euler', adaptive=False) on {smi}: "
          + "; ".join(parts) + "; fused, no fused_unsupported; cell-updates/s of "
          f"{WINDOW}-step windows (best of 3 x 3 after a warm-up), in turns: "
          + ", ".join(f"{name} {rate:.4e}" for name, rate in rates)
          + " (scalar sides: r value 0, the scalar radial window, ladder "
          f"{[cc.RADIAL_TOP_STEPS >> i for i in range(cc.RADIAL_TOP_STEPS.bit_length())]}) ok",
          flush=True)

    # -- 66. one top-k pass of each kernel ------------------------------------------------------
    gen = torch.Generator(device=device).manual_seed(66)
    bcs, scalar_bcs = grid.get_boundary_conditions(bc), grid.get_boundary_conditions(scalar_bc)
    b = 0.1 * DT
    inputs = cc.AffineSideInputs(grid, bcs)
    data = torch.rand(grid.shape, generator=gen, dtype=f32, device=device)
    out = torch.empty_like(data)
    spec = cc.affine_laplace_spec(grid, a=1.0, b=b, k=top, dtype=f32, bcs=bcs)
    sides = inputs.for_pass(f32, device, _times(top))
    scalar_spec = cc.affine_laplace_spec(grid, a=1.0, b=b, k=top, dtype=f32, bcs=scalar_bcs)
    timed = {  # label -> (run, repeats), in turns below
        "#1 side inputs": (lambda: cc.affine_laplace_2d(data, spec, out=out, sides=sides), 50),
        "#1 scalar": (lambda: cc.affine_laplace_2d(data, scalar_spec, out=out), 50),
        "#1 plain": (lambda: cc.affine_laplace_2d_plain(data, spec, sides), 3),
    }
    mesh = GridMesh(grid, [2, 2], devices=[device] * 4)
    local = mesh.local_shape
    ins, outs, flags = smoke._ext_side_blocks(torch, mesh, top, f32, gen)
    in0, out0 = [p[0] for p in ins], [p[0] for p in outs]
    ext_spec = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=b, k=top, halo=top, dtype=f32,
                                          bcs=bcs)
    ext_sides = inputs.for_pass(f32, device, _times(top), row_pad=cc.SIDE_PAD)
    ext_scalar = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=b, k=top, halo=top,
                                            dtype=f32, bcs=scalar_bcs)
    radial_flags = [f[:5] for f in flags]
    timed.update({
        "#12 side inputs": (lambda: ce.affine_laplace_ext_2d(in0, out0, flags, ext_spec,
                                                             sides=ext_sides), 50),
        "#12 scalar": (lambda: ce.affine_laplace_ext_2d(in0, out0, radial_flags, ext_scalar), 50),
        "#12 plain": (lambda: [ce.affine_laplace_ext_2d_plain(x, ext_spec, f, ext_sides)
                               for x, f in zip(in0, flags, strict=True)], 3),
    })
    ms = {name: [] for name in timed}
    for name in [*timed, *reversed(timed)]:
        run, repeats = timed[name]
        ms[name].append(smoke._cuda_ms(torch, run, repeats))
    best = {name: min(values) for name, values in ms.items()}
    bound_1 = smoke._bound(2 * cells * 4 + _table_bytes(spec, sides), FLOPS * top * cells)
    ext_cells = 4 * (local[0] + 2 * top) * (local[1] + 2 * top)
    bound_12 = smoke._bound((ext_cells + cells) * 4 + _table_bytes(ext_spec, ext_sides),
                            FLOPS * top * cells)
    regs = []
    for unit in units():
        kernel = unit.library + "_kernel"
        for dtype, letter in ((f32, "f"), (torch.float64, "d")):
            per_k = []
            for k in range(1, top + 1):
                tx, threads, _, _ = cc.affine_row_plan(k, dtype.itemsize)
                per_k.append(f"k={k} " + " | ".join(smoke._ptxas_of(
                    logs[unit.digest], kernel, f"I{letter}Li{k}ELi{tx}ELi{threads}E")))
            regs.append(f"{kernel} z periodic {unit.periodic[1]} {str(dtype)[6:]}: "
                        + "; ".join(per_k))
    print(f"[radial sides passes] one k={top} pass on {label} {N}^2 fp32 on {smi}, ms (two "
          "turns): " + ", ".join(f"{name} {'/'.join(f'{v:.4f}' for v in values)}"
                                 for name, values in ms.items())
          + f"; #1's bound {bound_1[0]:.4f} ms ({bound_1[1]}, {bound_1[0] / best['#1 side inputs']:.1%} "
          f"of it), #12's over the four {local[0]}x{local[1]} blocks {bound_12[0]:.4f} ms "
          f"({bound_12[1]}, {bound_12[0] / best['#12 side inputs']:.1%} of it); ptxas: "
          + "; ".join(regs), flush=True)
    pde.config["parallel.devices_per_device"] = 1
    return [{
        "name": "affine_laplace_2d (radial side inputs)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:793 (radial= with bcs=)",
        "launches": launches_1,
        "max_abs_err": errs[("#1", label, None, f32, top)],
        "ms": best["#1 side inputs"], "plain_ms": best["#1 plain"],
        "bound_ms": bound_1[0], "bound_by": bound_1[1],
        "library_ms": None,  # row factors and per-point, time-dependent ghosts: no convolution
    }, {
        "name": "affine_laplace_ext_2d (radial side inputs)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:5792 (radial= with bc_specs=: "
                    "pde_tpu/parallel/fused.py:187-240)",
        "launches": launches_12["[2, 2]"],
        "max_abs_err": errs[("#12", label, "[2, 2]", f32, top)],
        "ms": best["#12 side inputs"], "plain_ms": best["#12 plain"],
        "bound_ms": bound_12[0], "bound_by": bound_12[1],
        "library_ms": None,
    }]


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
    programs = units() + scalar_units()
    start = time.perf_counter()
    builds = cs.build_programs(programs)
    print(f"built {len(programs)} libraries in {time.perf_counter() - start:.1f} s (CPU s "
          + ", ".join(f"{p.library} {p.periodic} {b['cpu_seconds']:.1f}"
                      for p, b in zip(programs, builds)) + ")", flush=True)
    start = time.perf_counter()
    errs = kernels_phase(smoke, pde, torch, np, device, smi)
    print(f"phase 64 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    rows = main_phase(smoke, pde, torch, np, device, smi, errs,
                      {p.digest: b["log"] for p, b in zip(programs, builds)})
    print(f"phases 65-66 in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    main()
