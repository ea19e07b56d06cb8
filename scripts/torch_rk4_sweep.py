"""Design sweep of the RK4 programs of pde_tpu_torch's generated kernels #7 (2D
row march, ``csrc/march_2d.cuh``) and #5 (3D x march,
``csrc/multi_stencil_3d.cuh``) on one NVIDIA GPU.

An RK4 step's output stage reads k1, k2 and k3, which earlier stages
computed. The stage cut either stores them, as the partial sums ``k1``,
``k1 + 2 k2`` and ``k1 + 2 k2 + 2 k3``, in volumes of their own ("stored":
the RK4 windows' ``StencilProgram(carry=True)``, what the port runs) or
evaluates them again from their operands in the later stage ("recomputed": the
same program built here with ``carry=False``; every stencil of k1-k3 again,
the operands' rings widened to the output's lag). Cases, fp32 and
fp64, periodic, ``uniform`` inputs from seed 13: ``CahnHilliardPDE()`` 4096²
(depth 2, k = 1), ``AllenCahnPDE()`` 4096² (depth 1, k = 2 and 1) and
``AllenCahnPDE()`` 256³ (k = 1). Each pass is held against its plain version
(1e-6 x k relative to max|f| in fp32, 1e-12 in fp64) and timed with CUDA
events over 30 passes, the two variants in turns (stored, recomputed,
recomputed, stored); beside each, its slots a step and ptxas' registers and
spills.

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_rk4_sweep.py

One line per case, variant and k, then the card's name and power limit as
``nvidia-smi`` gives them.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402  (the repository root's helpers)

CASES = {  # label: (model, shape, dt)
    "cahn-hilliard 4096^2": ("CahnHilliardPDE", (4096, 4096), 1e-3),
    "allen-cahn 4096^2": ("AllenCahnPDE", (4096, 4096), 1e-2),
    "allen-cahn 256^3": ("AllenCahnPDE", (256, 256, 256), 0.05),
}


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_rk4_sweep: no CUDA device")
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3

    device = torch.device("cuda", 0)
    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=device).manual_seed(13)
    windows = {}
    for label, (model, shape, dt) in CASES.items():
        grid = pde.UnitGrid(list(shape), periodic=True)
        for dtype in (f32, f64):
            state = pde.ScalarField(grid, torch.zeros(shape, dtype=dtype, device=device))
            stored = getattr(pde, model)().make_fused_rk4_window(state, dt)
            p = stored.program
            windows[(label, dtype, "stored")] = stored
            windows[(label, dtype, "recomputed")] = s3.make_chunked_multi_window(
                p.grid, p.make_step, p.depth, p.n_fields, dtype=dtype, carry=False)
    programs = [w.program for w in windows.values()]
    logs = {p.digest: built["log"] for p, built in zip(programs, cs.build_programs(programs))}

    wrappers = {2: (cs.multi_stencil_2d, cs.multi_stencil_2d_plain, "multi_stencil_2d_kernel"),
                3: (s3.multi_stencil_3d, s3.multi_stencil_3d_plain, "multi_stencil_3d_kernel")}
    results: dict = {}
    for label, (_, shape, _) in CASES.items():
        for dtype in (f32, f64):
            datas = [-0.1 + 0.2 * torch.rand(shape, generator=gen, dtype=dtype, device=device)]
            for order in (("stored", "recomputed"), ("recomputed", "stored")):
                for variant in order:
                    window = windows[(label, dtype, variant)]
                    wrapper, plain, _ = wrappers[window.program.geometry.rank]
                    for spec in window.specs:
                        out = wrapper(datas, spec)
                        ref = plain(datas, spec)
                        torch.cuda.synchronize()
                        scale = float(ref[0].abs().max())
                        err = float((out[0] - ref[0]).abs().max())
                        tol = (smoke.F64_TOL if dtype == f64 else
                               smoke.F32_STEP_RTOL * spec.k) * scale
                        if not (bool(torch.isfinite(out[0]).all()) and err <= tol):
                            raise AssertionError(f"{label} {variant} k={spec.k}: {err:.3e}")
                        outs = [torch.empty_like(datas[0])]
                        ms = smoke._cuda_ms(torch, lambda: wrapper(datas, spec, outs=outs), 30)
                        results.setdefault((label, dtype, variant, spec.k), [err]).append(ms)
    for (label, dtype, variant, k), (err, *ms) in results.items():
        program = windows[(label, dtype, variant)].program
        _, _, kernel = wrappers[program.geometry.rank]
        tile = program.tiles[dtype][k]
        tag = "E{}Li{}E".format("f" if dtype == f32 else "d", k) + "".join(
            f"Li{t}E" for t in tile)
        cells = int(np.prod(program.geometry.shape))
        print(f"[rk4 sweep] {label} {str(dtype)[6:]} {variant} k={k}: "
              + " / ".join(f"{t:.4f}" for t in ms) + f" ms a pass ({min(ms) / k:.4f} ms a "
              f"step, {cells * k / min(ms) * 1e3:.4e} cell-updates/s), max_abs {err:.3e}; "
              f"plan {tile}, slots {program.march.slots} ({program.march.step_slots} a step); "
              f"ptxas: " + " | ".join(smoke._ptxas_of(logs[program.digest], kernel, tag)),
              flush=True)
    print(smoke._nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
