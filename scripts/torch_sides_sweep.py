"""Times the side-input passes of kernels #1 (B1(c)) and #7 (B2(b)) against
the same kernels with scalar sides, on one NVIDIA GPU.

Kernel #1 on a 4096² fp32 ``UnitGrid`` with ``pde_tpu``'s hardware
configuration (a per-point Dirichlet array on x-, ``sin(3*t)`` on y-,
no-flux elsewhere; ``docs/BENCHMARKS.md:78-80``): one pass at every k the
side-input library holds (``cc.SIDES_TOP_STEPS``), beside the scalar
no-flux pass at the same k and at the main path's top k, in turns (side
inputs, scalar, scalar, side inputs). Kernel #7 on Cahn-Hilliard 4096² fp32
with each side-input case of ``chip_smoke.py``'s phase 42 (time-dependent
sides, a side varying in space and time, a Robin side whose gamma varies,
RK4 with per-stage times): the top-k pass beside the scalar no-flux pass, in
turns. Each pass is held against its plain version (1e-6 a step relative to
max|f|) and timed with CUDA events over 20 passes; ptxas' registers and
spills of each side-input instantiation beside it.

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_sides_sweep.py

One line per kernel, then the card's name and power limit as ``nvidia-smi``
gives them.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N = 4096
REPEATS = 20


def _turns(torch, chip_smoke, fns: dict) -> dict:
    """ms of each callable, timed in turns A B .. B A: {label: [first, second]}."""
    ms: dict = {}
    for label in list(fns) + list(fns)[::-1]:
        ms.setdefault(label, []).append(chip_smoke._cuda_ms(torch, fns[label], REPEATS))
    return ms


def _check(torch, out, ref, k: int, label: str) -> None:
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not err <= 1e-6 * k * float(ref.abs().max()):
        raise AssertionError(f"{label}: max_abs {err:.3e} against the plain version")


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    if not torch.cuda.is_available():
        raise SystemExit("torch_sides_sweep: no CUDA device")
    device = torch.device("cuda", 0)
    smi = chip_smoke._nvidia_smi()
    f32 = torch.float32
    grid = pde.UnitGrid([N, N])
    bcs = grid.get_boundary_conditions(chip_smoke._affine_sides_bc(np, N))
    noflux = grid.get_boundary_conditions({"derivative": 0})
    units = chip_smoke._side_input_units(pde, torch, device)
    state = units["state"]
    scalar_window = pde.PDE({"c": chip_smoke.SIDES_RHS}, bc={"derivative": 0}) \
        .make_fused_euler_window(state, 1e-3)
    builds = units["units"] + [cc.kernel_source((False, False)), scalar_window.program]
    start = time.perf_counter()
    built = cs.build_programs(builds)
    print(f"[build] {len(builds)} libraries in {time.perf_counter() - start:.1f} s", flush=True)
    logs = {unit.digest: b["log"] for unit, b in zip(builds, built)}

    inputs = cc.AffineSideInputs(grid, bcs)
    data = torch.rand((N, N), device=device, generator=torch.Generator(device).manual_seed(5))
    out = torch.empty_like(data)
    lines = []
    for k in range(1, cc.SIDES_TOP_STEPS + 1):
        spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=f32, bcs=bcs)
        sides = inputs.for_pass(f32, device, [0.35 + 0.1 * s for s in range(k)])
        scalar = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=f32, bcs=noflux)
        _check(torch, cc.affine_laplace_2d(data, spec, sides=sides),
               cc.affine_laplace_2d_plain(data, spec, sides), k, f"#1 k={k}")
        ms = _turns(torch, chip_smoke, {
            "side inputs": lambda: cc.affine_laplace_2d(data, spec, out=out, sides=sides),
            "scalar": lambda: cc.affine_laplace_2d(data, scalar, out=out)})
        itemsize = cc._DTYPES[f32][2]
        tx, threads = cc.affine_row_plan(k, itemsize)[:2]
        ptx = chip_smoke._ptxas_of(logs[units["units"][0].digest], "sides_2d_kernel",
                                   f"IfLi{k}ELi{tx}ELi{threads}E")
        lines.append(f"#1 k={k}: side inputs {ms['side inputs'][0]:.4f}/"
                     f"{ms['side inputs'][1]:.4f} ms ({min(ms['side inputs']) / k:.5f} a step), "
                     f"scalar no-flux {ms['scalar'][0]:.4f}/{ms['scalar'][1]:.4f} "
                     f"({min(ms['scalar']) / k:.5f} a step); ptxas {' | '.join(ptx)}")
    top = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=cc.TOP_STEPS, dtype=f32, bcs=noflux)
    top_ms = chip_smoke._cuda_ms(torch, lambda: cc.affine_laplace_2d(data, top, out=out), REPEATS)
    lines.append(f"#1 scalar no-flux k={cc.TOP_STEPS}: {top_ms:.4f} ms "
                 f"({top_ms / cc.TOP_STEPS:.5f} a step)")

    datas = [state.data]
    outs = [torch.empty_like(state.data)]
    sspec = scalar_window.specs[0]
    for label in ("t sides", "xt side", "robin gamma along the side", "t sides rk4"):
        program = units["windows"][label].program
        spec = cs.multi_stencil_spec(program, program.ladder[0], f32)
        block = program.sides.block(0.35, 0, spec.k, 1e-3, f32, device)
        views = program.sides.for_pass(f32, device, spec.k, block, 0)
        _check(torch, cs.multi_stencil_2d(datas, spec, sides=views)[0],
               cs.multi_stencil_2d_plain(datas, spec, views)[0], spec.k, f"#7 {label}")
        ms = _turns(torch, chip_smoke, {
            "side inputs": lambda: cs.multi_stencil_2d(datas, spec, outs=outs, sides=views),
            "scalar": lambda: cs.multi_stencil_2d(datas, sspec, outs=outs)})
        ptx = chip_smoke._ptxas_of(logs[program.digest], "sides_2d_kernel",
                                   f"EfLi{spec.k}E")
        lines.append(f"#7 {label} k={spec.k}: side inputs {ms['side inputs'][0]:.4f}/"
                     f"{ms['side inputs'][1]:.4f} ms, scalar no-flux Euler k={sspec.k} "
                     f"{ms['scalar'][0]:.4f}/{ms['scalar'][1]:.4f}; ptxas {' | '.join(ptx)}")
    print(f"[sides sweep] {N}^2 fp32 on {smi}:\n" + "\n".join(lines), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
