"""Times the k = 1 RK4 pass of a two-deep rhs through #5 (the layout of
compact planes that reads the fields from the pass's input) at every column
tile whose planes fit one block's shared memory, on one NVIDIA GPU, to set
the plan rule of ``StencilProgram3D.tile_for``.

For Cahn-Hilliard and Kuramoto-Sivashinsky on a periodic 256³ grid, fp32
and fp64, one program per plan ``(32, ty, tz)`` (``ty`` of ``MARCH_TY``,
``tz`` of ``MARCH_TZ`` and ``MARCH_TZ_NARROW``, its compact planes within
``SMEM_MAX``), all built at once: each pass against the plain version
(``uniform(-0.5, 0.5)``), then timed with CUDA events over 20 passes, the
plans in turns (forward, then backward), beside the window cells a block
loads per cell it writes, the plan the rule picks, ptxas' registers and
spills. Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_rk4_3d_sweep.py
"""

from __future__ import annotations

import itertools
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 256
DT = 1e-3
MODELS = ("cahn-hilliard", "kuramoto-sivashinsky")


def _programs(pde, torch, s3):
    """(model, dtype, plan) -> a program at that plan, and the rule's plans."""
    from pde_tpu_torch.ops import cuda_cartesian_3d as c3

    grid = pde.UnitGrid([N] * 3, periodic=True)
    state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device="cpu")
    programs, rule = {}, {}
    for name in MODELS:
        eq = pde.CahnHilliardPDE() if name == "cahn-hilliard" else pde.KuramotoSivashinskyPDE()
        base = eq.make_fused_rk4_window(state, DT).program
        for dtype in (torch.float32, torch.float64):
            rule[(name, dtype)] = base.tiles[dtype][1]
            for ty, tz in itertools.product(c3.MARCH_TY, (c3.MARCH_TZ, *c3.MARCH_TZ_NARROW)):
                plan = (c3.MARCH_CX, ty, tz)
                if base.smem_bytes(1, plan, dtype.itemsize) > s3.SMEM_MAX:
                    continue

                def tile_for(self, k, itemsize, plan=plan, size=dtype.itemsize):
                    found = s3.StencilProgram3D.tile_for(self, k, itemsize)
                    return plan if self.input_points and itemsize == size else found

                fixed = type("FixedPlan", (s3.StencilProgram3D,), {"tile_for": tile_for})
                programs[(name, dtype, plan)] = fixed(grid, base.make_step, base.depth,
                                                      base.n_fields, carry=True)
    return programs, rule


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False; no result")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    programs, rule = _programs(pde, torch, s3)
    start = time.perf_counter()
    builds = cs.build_programs(list(programs.values()))
    print(f"built {len(programs)} libraries in {time.perf_counter() - start:.1f} s", flush=True)
    logs = {key: b["log"] for key, b in zip(programs, builds)}
    gen = torch.Generator(device=device).manual_seed(27)
    for name in MODELS:
        for dtype in (torch.float32, torch.float64):
            keys = [key for key in programs if key[:2] == (name, dtype)]
            data = torch.rand((N,) * 3, generator=gen, dtype=dtype, device=device) - 0.5
            out = [torch.empty_like(data)]
            runs, errs = {}, {}
            for key in keys:
                spec = cs.multi_stencil_spec(programs[key], 1, dtype)
                (got,) = s3.multi_stencil_3d([data], spec, outs=[torch.empty_like(data)])
                (ref,) = s3.multi_stencil_3d_plain([data], spec)
                errs[key] = smoke._check_rel(torch, f"{key}", got, ref, dtype, 1)
                runs[key] = (lambda spec=spec: s3.multi_stencil_3d([data], spec, outs=out))
            ms = {key: [] for key in keys}
            for key in [*keys, *reversed(keys)]:
                ms[key].append(smoke._cuda_ms(torch, runs[key], 20))
            halo = 2 * programs[keys[0]].depth
            parts = []
            for key in sorted(keys, key=lambda k: min(ms[k])):
                plan = key[2]
                regs = " | ".join(smoke._ptxas_of(
                    logs[key], "multi_stencil_3d_kernel",
                    "E{}Li1ELi{}ELi{}ELi{}E".format("f" if dtype == torch.float32 else "d",
                                                    *plan)))
                ratio = (plan[1] + halo) * (plan[2] + halo) / (plan[1] * plan[2])
                bytes_ = programs[key].smem_bytes(1, plan, dtype.itemsize)
                parts.append(f"{plan}{' (the rule)' if plan == rule[(name, dtype)] else ''} "
                             f"{'/'.join(f'{v:.4f}' for v in ms[key])} ms, {bytes_} B, "
                             f"{ratio:.2f} cells loaded a cell, max_abs {errs[key]:.1e}; {regs}")
            print(f"[rk4 3d sweep] {name} {N}^3 {str(dtype)[6:]} k = 1 on {smi}, fastest first: "
                  + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
