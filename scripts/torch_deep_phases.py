"""Phases 73-74 of ``chip_smoke.py``: every depth that kernels #1 and #12 take
in ``pde_tpu`` (ROADMAP §B.1 item 4, B1(g)), the deep march of
``pde_tpu_torch/csrc/affine_deep_2d.cuh``, on one NVIDIA GPU.

A deep pass takes k at run time and keeps each level's rows in shared
memory; it serves every k past the register march's top in each 5-point
mode (the radial mode past 8, side inputs past 6, both past 5, the Cartesian
modes past 16), up to 32 on kernel #1 and 16 on #12, in libraries of its own.

``chip_smoke.py`` builds :func:`units` with its other libraries and calls
:func:`kernels_phase` and :func:`main_phase`; run alone, this script builds
them, all at once, and runs the phases::

    python3 scripts/torch_deep_phases.py

The cases, 4096² (``uniform(0, 1)`` data, a = 1, b = 0.01): the periodic
grid; the grid bounded by value 0 on x and no flux on y; the same with side
inputs (a per-point array on x- and y-, ``0.1*sin(3*t)`` on x+, tables from
t0 = 0.35); config 4's cylinder with a hole (r in [512, 4608), z periodic,
r value 0) and with z bounded (no flux); both with side inputs
(``0.1*sin(3*t)`` on r-, a per-point array on r+; with z bounded, a
per-point array on z- and ``cos(t)`` as z+'s derivative); #12 on the four
2048² blocks of [2, 2] of the cylinders and of the side-input grid.

Phase 73 (``[deep kernels]``): each deep entry point against its plain
version on the same inputs at k = top + 1, 12, 16 and 32 (those past its
register top; #12 up to 16), fp32, fp64 and, where ``pde_tpu`` takes bf16
(periodic columns; #12 on column cuts), bf16: fp32 within 1e-6 x k of
max|f| and bit for bit in the modes that round each product and sum (the
radial modes with side inputs, and in bf16), fp64 within 1e-12, bf16 within
one bf16 ulp; ms a pass (CUDA events) beside the bound (the larger of the
bytes, each cell read and written once and the tables, over 3.35 TB/s and
the operations over 67 TFLOP/s, fp64's counted twice), ptxas' registers and
spills. Then a deep
pass against the ladder of register passes of the same depth
(``[deep ladder]``): bit for bit where every product and sum is rounded.

Phase 74 (``[deep windows]``): the windows at ``pde_tpu``'s depth, 2048
steps, fp32: ``make_fused_euler_window_cyl`` on the cylinder (k = 16, the
ladder 16, 8, 4, 2, 1: 128 deep launches, counted from 0) against the k = 8
ladder of ``make_fused_euler_window_2d``, serially and on [2, 2]
(``make_fused_euler_window_sharded(k=16)``, bit-equal to serial, 128 deep ext
launches); ``make_fused_euler_window_2d(k=16)`` on the side-input grid and
the cylinder with side inputs against their default ladders likewise; the
periodic grid at k = 32 (64 deep launches) against the default k = 12;
cell-updates/s of each beside the default ladder's, in turns. Then the sweep
of k = 8..16 a step (``[deep sweep]``) and the mode's register top, the
radial mode and the radial side-input mode, fp32 and fp64, on the cylinder
(the register passes to their tops, the deep ones past them), which decides
the windows' default tops; and the deep passes at k = 16 and 32 on the plan
whose shared memory lets two blocks share an SM beside the default plan. :func:`main_phase` returns the kernels line's rows.
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
DT = 0.1
DIFFUSIVITY = 0.1
T0 = 0.35
WINDOW = 2048
MESH = [2, 2]
KS = (12, 16, 32)  # with top + 1, the depths phase 73 takes past each mode's top
EXT_TOP = 16
RADIAL_FLOPS = 8  # operations of a radial update: four products, four sums
#: fp64's operations count twice against the bound's fp32 rate: the data
#: sheet's 34 TFLOP/s in fp64 (no tensor cores) against 67 in fp32
FP64_OPS = 2
SWEEP_KS = range(8, 17)


def cases(pde, np) -> dict:
    """label -> (grid, conditions, with side inputs) of the deep passes."""
    periodic = pde.UnitGrid([N, N], periodic=True)
    bounded = pde.UnitGrid([N, N])
    cylinder = pde.CylindricalSymGrid((HOLE, HOLE + N), (0, N), (N, N), periodic_z=True)
    closed = pde.CylindricalSymGrid((HOLE, HOLE + N), (0, N), (N, N))
    wave = np.sin(np.linspace(0.0, 2.0 * np.pi, N))
    return {
        "periodic": (periodic, "periodic", False),
        "bounded": (bounded, {"x": {"value": 0}, "y": {"derivative": 0}}, False),
        "side inputs": (bounded, {"x-": {"value": 0.5 * wave},
                                  "x+": {"value_expression": "0.1*sin(3*t)"},
                                  "y-": {"value": 0.25 * wave}, "y+": {"derivative": 0}}, True),
        "cylinder": (cylinder, {"r": {"value": 0}, "z": "periodic"}, False),
        "cylinder, z bounded": (closed, {"r": {"value": 0}, "z": {"derivative": 0}}, False),
        "cylinder, side inputs": (cylinder, {"r-": {"value_expression": "0.1*sin(3*t)"},
                                             "r+": {"value": 0.5 * wave}, "z": "periodic"},
                                  True),
        "cylinder z bounded, side inputs": (
            closed, {"r-": {"value_expression": "0.1*sin(3*t)"}, "r+": {"value": 0.5 * wave},
                     "z-": {"value": 0.25 * wave}, "z+": {"derivative_expression": "cos(t)"}},
            True),
    }


#: the cases #12 takes past its register tops (its Cartesian passes stop at 16)
EXT_CASES = ("side inputs", "cylinder", "cylinder, z bounded", "cylinder, side inputs",
             "cylinder z bounded, side inputs")
#: the cases whose columns are periodic: #1 takes bf16 there; #12 on the
#: blocks of [2, 2], which cut the columns, of the cylinders with z periodic
BF16_CASES = ("periodic", "cylinder", "cylinder, side inputs")
BF16_EXT_CASES = ("cylinder", "cylinder, side inputs")


def _bcs(grid, bc):
    return None if bc == "periodic" else grid.get_boundary_conditions(bc)


def _top(cc, label: str, sides: bool) -> int:
    """The register march's top in case `label`'s mode (the radial mode on
    the cylinders)."""
    return cc.register_top(label.startswith("cylinder"), sides)


def deep_ks(cc, label: str, sides: bool, cap: int) -> list[int]:
    """The depths phase 73 takes in a mode: top + 1 and :data:`KS` past its
    register top, up to `cap`."""
    top = _top(cc, label, sides)
    return sorted(k for k in {top + 1, *KS} if top < k <= cap)


def _times(k: int, first: int = 0) -> list[float]:
    return [T0 + (first + s) * DT for s in range(k)]


def units(pde, torch, np, device) -> dict:
    """The build units of the deep libraries the phases run: (kernel, case,
    bf16) -> unit, and ``units``, the distinct ones; ``register``, the register
    march's libraries that phase 74's default ladders, the ladder check and
    the sweep run (``chip_smoke.py``'s other phases build them too)."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce

    found = {}
    for label, (grid, bc, sides) in cases(pde, np).items():
        spec = cc.affine_laplace_spec(grid, a=1.0, b=DIFFUSIVITY * DT,
                                      k=_top(cc, label, sides) + 1, dtype=torch.float32,
                                      bcs=_bcs(grid, bc))
        for bf16 in (False, True):
            if bf16 and label not in BF16_CASES:
                continue
            found[("#1", label, bf16)] = cc.kernel_source(spec.periodic, cc.library_of(spec),
                                                          bf16)
            if label in EXT_CASES and (not bf16 or label in BF16_EXT_CASES):
                found[("#12", label, bf16)] = ce.affine_ext_source(
                    spec.periodic, spec.radial is not None, sides=sides, bf16=bf16, deep=True)
    distinct = list({unit.digest: unit for unit in found.values()}.values())
    register = [cc.kernel_source(periodic, library, bf16) for periodic, library, bf16 in (
        ((True, True), "affine_laplace_2d", False), ((True, True), "affine_laplace_2d", True),
        ((False, False), cc.SIDES_LIBRARY, False), ((False, True), cc.RADIAL_LIBRARY, False),
        ((False, True), cc.RADIAL_LIBRARY, True), ((False, True), cc.RADIAL_SIDES_LIBRARY, False),
        ((False, False), cc.RADIAL_SIDES_LIBRARY, False))] + [
        ce.affine_ext_source(periodic, radial, sides=sides) for periodic, radial, sides in (
            ((False, True), True, False), ((False, True), True, True),
            ((False, False), False, True))]
    return {"affine": found, "units": distinct, "register": register}


def _rel(torch, out, ref) -> tuple[float, float]:
    """(max_abs, max_abs over max|ref|), in fp64."""
    diff = float((out.double() - ref.double()).abs().max())
    return diff, diff / float(ref.double().abs().max())


def _ulps(torch, out, ref) -> tuple[float, float]:
    """(max_abs, max_abs in bf16 ulps of max|ref|)."""
    diff = float((out.double() - ref.double()).abs().max())
    top = float(ref.double().abs().max())
    return diff, diff / 2.0 ** (math.floor(math.log2(top)) - 7)


def _check(smoke, torch, what, spec, out, ref, k) -> tuple[float, str]:
    """Hold a pass to its plain version; returns (max_abs, the error as shown)."""
    torch.cuda.synchronize()
    smoke._require(bool(torch.isfinite(out.double()).all()), f"{what}: non-finite values")
    if spec.dtype == torch.bfloat16:
        err, ulps = _ulps(torch, out, ref)
        smoke._require(ulps <= 1.0, f"{what}: {ulps:.2f} bf16 ulps of max|f| from its plain "
                                    "version")
        return err, f"{ulps:.2f} ulp"
    err, rel = _rel(torch, out, ref)
    rounded = spec.radial is not None and spec.has_sides
    if spec.dtype == torch.float64:
        tol = smoke.F64_TOL
    else:
        tol = 0.0 if rounded else smoke.F32_STEP_RTOL * k
    smoke._require(rel <= tol, f"{what}: {rel:.3e} of max|f| from its plain version (allowed "
                               f"{tol:.1e})")
    return err, f"{rel:.2e}"


def _regs(smoke, log: str) -> str:
    """ptxas' registers and spills of a deep library's kernels."""
    return " | ".join(smoke._ptxas_of(log, "deep_")) or "ptxas not read"


def _bytes(cc, spec, sides, cells: int, itemsize: int) -> int:
    """Bytes a pass must move: each cell read and written once, and the tables."""
    tables = 0
    if spec.radial is not None:
        tables += spec.table_rows() * 2 * spec.compute_dtype.itemsize
    if sides is not None:
        tables += sum(a.numel() * a.element_size() for a in sides.arrays if a is not None)
    return 2 * cells * itemsize + tables


def kernels_phase(smoke, pde, torch, np, device, smi, built, logs) -> dict:
    """Phase 73 (see the module docstring); `logs` holds ptxas' report of each
    build unit by digest. Returns {(kernel, case, dtype name, k): (max_abs,
    ms, plain ms, bound)}."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(73)
    results, lines = {}, []
    cells = N * N
    pde.config["parallel.devices_per_device"] = 4
    for label, (grid, bc, sides_case) in cases(pde, np).items():
        bcs = _bcs(grid, bc)
        inputs = cc.AffineSideInputs(grid, bcs) if sides_case else None
        flops = RADIAL_FLOPS if label.startswith("cylinder") else smoke._affine_flops((1.0, 1.0))
        mesh = GridMesh(grid, MESH, devices=[device] * 4)
        for kernel in ("#1", "#12"):
            if kernel == "#12" and label not in EXT_CASES:
                continue
            cap = cc.DEEP_MAX_STEPS if kernel == "#1" else EXT_TOP
            for dtype in (f32, f64, bf16):
                bf = dtype == bf16
                if bf and label not in (BF16_CASES if kernel == "#1" else BF16_EXT_CASES):
                    continue
                row = []
                if kernel == "#1":
                    data = torch.rand(grid.shape, generator=gen, device=device).to(dtype)
                    out = torch.empty_like(data)
                else:
                    ins, outs, flags = smoke._ext_side_blocks(torch, mesh, EXT_TOP, dtype, gen)
                    width = 6 if sides_case else 5 if label.startswith("cylinder") else 4
                    flags = [f[:width] for f in flags]
                    in0, out0 = [p[0] for p in ins], [p[0] for p in outs]
                for k in deep_ks(cc, label, sides_case, cap):
                    if kernel == "#1":
                        spec = cc.affine_laplace_spec(grid, a=1.0, b=DIFFUSIVITY * DT, k=k,
                                                      dtype=dtype, bcs=bcs)
                        sides = None if inputs is None else inputs.for_pass(dtype, device,
                                                                            _times(k))

                        def run(spec=spec, sides=sides):
                            cc.affine_laplace_2d(data, spec, out=out, sides=sides)

                        def plain(spec=spec, sides=sides):
                            return cc.affine_laplace_2d_plain(data, spec, sides)

                        run()
                        got, ref = out, plain()
                        n_bytes = _bytes(cc, spec, sides, cells, dtype.itemsize)
                    else:
                        spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0,
                                                          b=DIFFUSIVITY * DT, k=k, halo=EXT_TOP,
                                                          dtype=dtype, bcs=bcs)
                        sides = None if inputs is None else inputs.for_pass(
                            dtype, device, _times(k), row_pad=cc.SIDE_PAD)

                        def run(spec=spec, sides=sides):
                            ce.affine_laplace_ext_2d(in0, out0, flags, spec, sides=sides)

                        def plain(spec=spec, sides=sides):
                            return [ce.affine_laplace_ext_2d_plain(p, spec, f, sides)
                                    for p, f in zip(in0, flags, strict=True)]

                        run()
                        got = torch.stack([p[EXT_TOP:-EXT_TOP, EXT_TOP:-EXT_TOP] for p in out0])
                        ref = torch.stack(plain())
                        ext_cells = 4 * (mesh.local_shape[0] + 2 * EXT_TOP) * (
                            mesh.local_shape[1] + 2 * EXT_TOP)
                        n_bytes = _bytes(cc, spec, sides, cells, dtype.itemsize) + (
                            ext_cells - cells) * dtype.itemsize
                    smoke._require(spec.deep, f"{kernel} {label} k={k} is not a deep pass")
                    what = f"{kernel} deep {label} {str(dtype)[6:]} k={k}"
                    err, shown = _check(smoke, torch, what, spec, got, ref, k)
                    ms = smoke._cuda_ms(torch, run, 10)
                    plain_ms = smoke._cuda_ms(torch, plain, 2) if dtype == f32 else None
                    bound = smoke._bound(n_bytes, flops * k * cells
                                         * (FP64_OPS if dtype == f64 else 1))
                    results[(kernel, label, str(dtype)[6:], k)] = (err, ms, plain_ms, bound)
                    row.append(f"k={k} {shown} {ms:.4f} ms ({ms / k:.5f} a step, bound "
                               f"{bound[0]:.4f}, {bound[0] / ms:.1%})")
                unit = built["affine"][(kernel, label, bf)]
                lines.append(f"{kernel} {label} {str(dtype)[6:]} [{unit.library}, tx "
                             f"{spec.tile[0]}]: " + ", ".join(row) + "; ptxas "
                             + _regs(smoke, logs[unit.digest]))
    pde.config["parallel.devices_per_device"] = 1
    print(f"[deep kernels] every deep entry point against its plain version at {N}^2 (#12 "
          f"over the four {N // 2}^2 blocks of {MESH}, halo {EXT_TOP}), on {smi}: "
          + "; ".join(lines) + " ok", flush=True)
    _ladder_check(smoke, pde, torch, np, device, smi)
    return results


def _ladder_check(smoke, pde, torch, np, device, smi) -> None:
    """A deep pass against register passes of the same depth in turn: bit for
    bit where every product and sum is rounded (the radial side-input mode,
    bf16 in the radial mode); the Cartesian bf16 pass reported."""
    from pde_tpu_torch.ops import cuda_cartesian as cc

    gen = torch.Generator(device=device).manual_seed(731)
    all_cases = cases(pde, np)
    parts = []
    for label, dtype, k, split, exact in (
            ("cylinder, side inputs", torch.float32, 10, (5, 5), True),
            ("cylinder z bounded, side inputs", torch.float64, 10, (5, 5), True),
            ("cylinder", torch.bfloat16, 16, (8, 8), True),
            ("periodic", torch.bfloat16, 32, (16, 16), False)):
        grid, bc, sides_case = all_cases[label]
        bcs = _bcs(grid, bc)
        inputs = cc.AffineSideInputs(grid, bcs) if sides_case else None
        data = torch.rand(grid.shape, generator=gen, device=device).to(dtype)
        deep = cc.affine_laplace_spec(grid, a=1.0, b=DIFFUSIVITY * DT, k=k, dtype=dtype,
                                      bcs=bcs)
        got = cc.affine_laplace_2d(data, deep, sides=None if inputs is None else
                                   inputs.for_pass(dtype, device, _times(k)))
        ref, first = data, 0
        for kk in split:
            spec = cc.affine_laplace_spec(grid, a=1.0, b=DIFFUSIVITY * DT, k=kk, dtype=dtype,
                                          bcs=bcs)
            smoke._require(not spec.deep, f"{label} k={kk} is not a register pass")
            ref = cc.affine_laplace_2d(ref, spec, sides=None if inputs is None else
                                       inputs.for_pass(dtype, device, _times(kk, first)))
            first += kk
        torch.cuda.synchronize()
        equal = torch.equal(got, ref)
        smoke._require(equal or not exact, f"the deep {label} pass at k={k} differs from "
                                           f"the register passes {split}")
        parts.append(f"{label} {str(dtype)[6:]} k={k} against {split}: "
                     + ("bit-equal" if equal else f"{_rel(torch, got, ref)[1]:.2e} of max|f|"))
    print(f"[deep ladder] a deep pass against register passes of the same depth, {N}^2, on "
          f"{smi}: " + "; ".join(parts) + " ok", flush=True)


def _window_seconds(torch, window, data, args, repeats: int = 3) -> float:
    """Best seconds of one window call after a warm-up, the card synchronized."""
    window(data, *args)
    best = math.inf
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        window(data, *args)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - start)
    return best


def main_phase(smoke, pde, torch, np, device, smi, built, results) -> list[dict]:
    """Phase 74 (see the module docstring). Returns the kernels line's rows."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh
    from pde_tpu_torch.parallel.fused import make_fused_euler_window_sharded

    f32 = torch.float32
    cells = N * N
    all_cases = cases(pde, np)
    serial_counter, ext_counter = cc.affine_laplace_2d, ce.affine_laplace_ext_2d
    pde.config["parallel.devices_per_device"] = 4
    launches, parts = {}, []
    for label, k in (("cylinder", 16), ("cylinder, side inputs", 16), ("side inputs", 16),
                     ("periodic", 32)):
        grid, bc, sides_case = all_cases[label]
        bcs = _bcs(grid, bc)
        state = torch.as_tensor(np.random.default_rng(74).uniform(0.0, 1.0, grid.shape),
                                dtype=f32, device=device)
        args = (T0, WINDOW) if sides_case else (WINDOW,)
        for counter in (serial_counter, ext_counter):
            counter.launches = counter.deep_launches = 0
        if label.startswith("cylinder"):  # pde_tpu's named entry point, k = 16 by default
            deep = cc.make_fused_euler_window_cyl(grid, diffusivity=DIFFUSIVITY, dt=DT, bcs=bcs,
                                                  dtype=f32)
        else:
            deep = cc.make_fused_euler_window_2d(grid, diffusivity=DIFFUSIVITY, dt=DT,
                                                 dtype=f32, k=k, bcs=bcs)
        result, seconds = smoke._synced_seconds(torch, lambda: deep(state, *args))
        ladder = [s.k for s in deep.specs]
        deep_passes = WINDOW // k
        launches[(label, "serial")] = serial_counter.deep_launches
        passes = serial_counter.launches
        checks = [ladder == [k >> i for i in range(k.bit_length())],
                  serial_counter.deep_launches == deep_passes,
                  passes == smoke._ladder_passes(ladder, WINDOW),
                  bool(torch.isfinite(result).all())]
        smoke._require(all(checks), f"the deep {label} window: {checks}")
        default = cc.make_fused_euler_window_2d(grid, diffusivity=DIFFUSIVITY, dt=DT, dtype=f32,
                                                bcs=bcs)
        reference = default(state, *args)
        _, rel = _rel(torch, result, reference)
        smoke._require(rel <= smoke.F32_STEP_RTOL * WINDOW,
                       f"the deep {label} window strays {rel:.2e} from the default ladder")
        part = (f"{label}: {WINDOW} steps in {passes} launches (ladder "
                f"{ladder}, {deep_passes} deep), {seconds:.3f} s, {rel:.2e} of max|f| from the "
                f"default ladder {[s.k for s in default.specs]}")
        if label != "periodic":  # on [2, 2]: the ext kernel's deep passes, bit-equal to serial
            mesh = GridMesh(grid, MESH, devices=[device] * 4)
            sharded = make_fused_euler_window_sharded(mesh, diffusivity=DIFFUSIVITY, dt=DT,
                                                      dtype=f32, bcs=bcs, k=16)
            for counter in (serial_counter, ext_counter):
                counter.launches = counter.deep_launches = 0
            blocks, block_seconds = smoke._synced_seconds(torch, lambda: sharded(
                [[b] for b in mesh.split_field_data(state)], *args))
            combined = mesh.combine_field_data([b[0] for b in blocks])
            launches[(label, str(MESH))] = ext_counter.deep_launches
            checks = [ext_counter.deep_launches == WINDOW // 16, serial_counter.launches == 0,
                      torch.equal(combined, result)]
            smoke._require(all(checks), f"the deep {label} window on {MESH}: {checks}")
            part += (f"; on {MESH} {ext_counter.launches} launches ({ext_counter.deep_launches}"
                     f" deep), {block_seconds:.3f} s, bit-equal to serial")
        # cell-updates/s beside the default ladder's, in turns
        rates = []
        for name, window in (("deep", deep), ("default", default), ("default", default),
                             ("deep", deep)):
            rates.append((name, cells * WINDOW / _window_seconds(torch, window, state, args)))
        part += "; cell-updates/s " + ", ".join(f"{n} {r:.4e}" for n, r in rates)
        parts.append(part)
    pde.config["parallel.devices_per_device"] = 1
    print(f"[deep windows] the windows at pde_tpu's depth, fp32 {N}^2, on {smi}: "
          + "; ".join(parts) + " ok", flush=True)
    _sweep(smoke, pde, torch, np, device, smi)
    return _rows(smoke, pde, torch, np, device, results, launches)


def _sweep(smoke, pde, torch, np, device, smi) -> None:
    """Time a step of k = 8..16 in the radial mode and the radial side-input
    mode, fp32 and fp64, on the cylinder: the register passes to their tops,
    the deep ones past them; and the deep passes at k = 16 and 32 on the
    plan whose shared memory lets two blocks share an SM beside the default
    plan's (the widest strip that fits one block's 227 KB)."""
    import dataclasses

    from pde_tpu_torch.ops import cuda_cartesian as cc

    gen = torch.Generator(device=device).manual_seed(741)
    all_cases = cases(pde, np)
    lines = []
    for label in ("cylinder", "cylinder, side inputs"):
        grid, bc, sides_case = all_cases[label]
        bcs = _bcs(grid, bc)
        inputs = cc.AffineSideInputs(grid, bcs) if sides_case else None
        for dtype in (torch.float32, torch.float64):
            data = torch.rand(grid.shape, generator=gen, device=device, dtype=dtype)
            out = torch.empty_like(data)
            per_step = {}
            for k in sorted({_top(cc, label, sides_case), *SWEEP_KS}):
                spec = cc.affine_laplace_spec(grid, a=1.0, b=DIFFUSIVITY * DT, k=k, dtype=dtype,
                                              bcs=bcs)
                sides = None if inputs is None else inputs.for_pass(dtype, device, _times(k))
                ms = smoke._cuda_ms(torch, lambda spec=spec, sides=sides: cc.affine_laplace_2d(
                    data, spec, out=out, sides=sides), 20)
                per_step[k] = (ms / k, spec.deep)
            best = min(per_step, key=lambda kk: per_step[kk][0])
            plans = []
            for k in (16, 32):
                spec = cc.affine_laplace_spec(grid, a=1.0, b=DIFFUSIVITY * DT, k=k, dtype=dtype,
                                              bcs=bcs)
                half = dataclasses.replace(spec, tile=cc.affine_deep_plan(
                    k, dtype.itemsize, True, sides_case, budget=cc.DEEP_SMEM // 2))
                sides = None if inputs is None else inputs.for_pass(dtype, device, _times(k))
                for plan in (spec, half, half, spec):
                    ms = smoke._cuda_ms(torch, lambda plan=plan, sides=sides: cc.affine_laplace_2d(
                        data, plan, out=out, sides=sides), 10)
                    plans.append(f"k={k} tx {plan.tile[0]} {ms / k:.5f}")
            lines.append(f"{label} {str(dtype)[6:]}: " + ", ".join(
                f"k={k}{'*' if deep else ''} {ms:.5f}" for k, (ms, deep) in per_step.items())
                + f" (least at k={best}); deep plans in turns, ms a step: " + ", ".join(plans))
    print(f"[deep sweep] ms a step at {N}^2 (* the deep march), on {smi}: " + "; ".join(lines)
          + " ok", flush=True)


def _rows(smoke, pde, torch, np, device, results, launches) -> list[dict]:
    """The kernels line's rows: #1's deep radial pass at k = 16 and its
    periodic pass at k = 32 (with one circular nn.Conv2d of the composed 65x65
    stencil), #12's deep radial pass at k = 16 over [2, 2]; launches from
    phase 74's windows."""
    from pde_tpu_torch.ops import cuda_cartesian as cc

    rows = []
    for name, kernel, label, k, key, replaces in (
            ("affine_laplace_deep_2d (radial, k=16)", "#1", "cylinder", 16,
             ("cylinder", "serial"), "pde_tpu/ops/pallas_cartesian.py:793"),
            ("affine_laplace_deep_2d (periodic, k=32)", "#1", "periodic", 32,
             ("periodic", "serial"), "pde_tpu/ops/pallas_cartesian.py:793"),
            ("affine_laplace_deep_ext_2d (radial, k=16)", "#12", "cylinder", 16,
             ("cylinder", str(MESH)), "pde_tpu/ops/pallas_cartesian.py:5792")):
        err, ms, plain_ms, bound = results[(kernel, label, "float32", k)]
        library_ms = None  # no PyTorch call has the radial mode's row factors and ghosts
        if label == "periodic":
            grid = cases(pde, np)["periodic"][0]
            data = torch.rand(grid.shape, generator=torch.Generator(device=device).manual_seed(75),
                              device=device)
            spec = cc.affine_laplace_spec(grid, a=1.0, b=DIFFUSIVITY * DT, k=k,
                                          dtype=torch.float32)
            weight = smoke._composed_stencil(torch, 1.0, DIFFUSIVITY * DT, (1.0, 1.0), k).to(
                device=device, dtype=torch.float32)
            library_ms, conv = smoke._library_conv(torch, data, weight, 3)
            scale = float(data.abs().max())
            conv_err = float((conv - cc.affine_laplace_2d(data, spec)).abs().max())
            smoke._require(conv_err <= smoke.LIBRARY_RTOL * scale,
                           f"the composed convolution strays {conv_err:.3e} from the deep pass")
        rows.append({
            "name": name, "route": "cuda", "source": "pde_tpu_torch/csrc/affine_deep_2d.cuh",
            "replaces": f"{replaces} (k past the register march's top)",
            "launches": launches[key], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
        })
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
    everything = built["units"] + built["register"]
    builds = cs.build_programs(everything)
    print(f"built {len(builds)} libraries in {time.perf_counter() - start:.1f} s (CPU s "
          + ", ".join(f"{u.library} {b['cpu_seconds']:.1f}" for u, b in zip(everything, builds))
          + ")", flush=True)
    logs = {u.digest: b["log"] for u, b in zip(built["units"], builds)}
    start = time.perf_counter()
    results = kernels_phase(smoke, pde, torch, np, device, smi, built, logs)
    print(f"phase 73 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    rows = main_phase(smoke, pde, torch, np, device, smi, built, results)
    print(f"phase 74 in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    main()
