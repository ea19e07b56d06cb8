"""Design sweep of pde_tpu_torch's generated 3D multi-field kernels on one NVIDIA GPU.

Times plans of the x-marching template (``march_program_3d`` of
``pde_tpu_torch/csrc/multi_stencil_3d.cuh``) on chip_smoke's 256³ periodic
fp32 passes (``uniform(-0.1, 0.1)``, seed 13): Allen-Cahn
``laplace(u) + u - u**3`` at dt = 0.05 (depth 1, no operand buffer) and
``CahnHilliardPDE()`` at dt = 1e-3 (depth 2, one buffer). The variants are
the plan ``(cx, ty, tz)`` (x planes per chunk, the output column tile) at
each k, tiles past the two-blocks-per-SM budget, and the kernel's launch
bounds asking two blocks per SM (a copy of the template, built beside it).

Each variant is held against its plain version (chip_smoke's fp32
tolerance, 1e-6 x k relative to max|f|) and timed with CUDA events over 50
passes, all variants in turns, twice; ptxas' registers and spills beside
each, and the SASS opcode counts of the production kernel at the main pass.
Then the production wrappers: Allen-Cahn and Cahn-Hilliard at every k of
their ladders with their ms per step, and Allen-Cahn's ext pass over the
eight 128³ blocks of a 2x2x2 mesh (``multi_stencil_ext_3d``, flags 0).

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_multi3d_sweep.py [--production]

``--production`` skips the variants and times only what any checkout of the
port since its 3D ext kernels has (the wrappers above): copied into an older
checkout, it times that checkout's kernels, so that old and new can be read
in turns in one call.

One line per variant and wrapper (both rounds' ms, error, ptxas' registers
and spills), then the card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import hashlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as smoke  # noqa: E402  (the repository root's helpers)

N = 256
CASES = {  # label: (equation, dt)
    "allen-cahn": (lambda pde: pde.PDE(smoke.ALLEN_CAHN_3D), 0.05),
    "cahn-hilliard": (lambda pde: pde.CahnHilliardPDE(), 1e-3),
}


def _variant(case: str, k: int, plan, bounds: int = 1) -> dict:
    return {"case": case, "k": k, "plan": plan, "bounds": bounds}


# one build unit per case and launch bound, all built in parallel
VARIANTS = (
    # Allen-Cahn: every k at its plan, then chunks, tiles, launch bounds and
    # tiles past the budget
    _variant("allen-cahn", 1, (32, 32, 64)),
    _variant("allen-cahn", 2, (32, 32, 64)),
    _variant("allen-cahn", 3, (32, 32, 64)),
    _variant("allen-cahn", 4, (32, 16, 64)),
    _variant("allen-cahn", 2, (16, 32, 64)),
    _variant("allen-cahn", 2, (64, 32, 64)),
    _variant("allen-cahn", 2, (32, 16, 64)),
    _variant("allen-cahn", 2, (32, 32, 32)),
    _variant("allen-cahn", 2, (32, 32, 64), bounds=2),
    _variant("allen-cahn", 3, (16, 32, 64)),
    _variant("allen-cahn", 3, (64, 32, 64)),
    _variant("allen-cahn", 3, (32, 16, 64)),
    _variant("allen-cahn", 3, (32, 32, 32)),
    _variant("allen-cahn", 3, (32, 16, 128)),
    _variant("allen-cahn", 3, (32, 32, 64), bounds=2),
    _variant("allen-cahn", 4, (32, 32, 64)),
    _variant("allen-cahn", 4, (16, 16, 64)),
    _variant("allen-cahn", 4, (64, 16, 64)),
    _variant("allen-cahn", 4, (32, 8, 64)),
    _variant("allen-cahn", 4, (32, 32, 32)),
    _variant("allen-cahn", 4, (32, 16, 64), bounds=2),
    # Cahn-Hilliard (depth 2): k = 1 and 2, plans
    _variant("cahn-hilliard", 1, (32, 32, 64)),
    _variant("cahn-hilliard", 1, (16, 32, 64)),
    _variant("cahn-hilliard", 1, (64, 32, 64)),
    _variant("cahn-hilliard", 1, (32, 16, 64)),
    _variant("cahn-hilliard", 1, (32, 32, 32)),
    _variant("cahn-hilliard", 1, (32, 32, 64), bounds=2),
    _variant("cahn-hilliard", 2, (32, 16, 64)),
    _variant("cahn-hilliard", 2, (32, 8, 64)),
    _variant("cahn-hilliard", 2, (32, 32, 64)),
    _variant("cahn-hilliard", 2, (32, 16, 64), bounds=2),
)


def _needle(v) -> str:
    """A piece of the mangled kernel names of variant `v` (float)."""
    return "EfLi{}ELi{}ELi{}ELi{}E".format(v["k"], *v["plan"])


def _label(v) -> str:
    bounds = "" if v["bounds"] == 1 else f" min blocks {v['bounds']}"
    return f"{v['case']} k={v['k']} plan={v['plan']}{bounds}"


class _Unit:
    """A source for ``build_programs``: the variants of one case and bound."""

    library = "multi3d_sweep"

    def __init__(self, source: str, flags: str):
        self.source = source
        self.digest = hashlib.sha256((source + flags).encode()).hexdigest()[:16]


def _source(program, variants, bounds: int, template: str, emit_program) -> str:
    """The program struct and one entry point per variant; a launch bound
    other than the template's puts an edited copy of the template inline."""
    if bounds == 1:
        lines = ['#include "multi_stencil_3d.cuh"', ""]
    else:
        edited = template.replace("__launch_bounds__(kMarchThreads, 1)",
                                  f"__launch_bounds__(kMarchThreads, {bounds})")
        if edited == template:
            raise AssertionError("the template's launch bounds are not where the sweep expects")
        lines = [edited, ""]
    lines += emit_program(program)
    for v in variants:
        lines += [
            f'extern "C" int variant_{v["index"]}(const void* const* ins, void* const* outs, '
            "int nx, int ny, int nz, void* stream) {",
            f"  return pde_tpu_torch::launch_3d<Program, float, {v['k']}, "
            f"{', '.join(map(str, v['plan']))}>(ins, outs, nx, ny, nz, stream);",
            "}",
        ]
    return "\n".join(lines) + "\n"


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_multi3d_sweep: torch.cuda.is_available() is False; no result")
    production_only = sys.argv[1:] == ["--production"]

    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    f32 = torch.float32
    grid = pde.UnitGrid([N] * 3, periodic=True)
    state = pde.ScalarField.random_uniform(grid, -0.1, 0.1, dtype=f32, device=device,
                                           rng=np.random.default_rng(13))
    data = state.data
    windows = {case: make(pde).make_fused_euler_window(state, dt)
               for case, (make, dt) in CASES.items()}
    ac_ext = smoke._ext_windows_3d(pde, torch, device)["allen-cahn periodic"]

    variants = [dict(v, index=i) for i, v in enumerate(VARIANTS)]
    units, groups = [], []
    if not production_only:
        flags = " ".join(cc._NVCC_FLAGS)
        template = s3.StencilProgram3D.template.read_text()
        for case in CASES:
            for bounds in sorted({v["bounds"] for v in variants}):
                group = [v for v in variants if v["case"] == case and v["bounds"] == bounds]
                if group:
                    groups.append(group)
                    units.append(_Unit(_source(windows[case].program, group, bounds, template,
                                               s3.emit_program_3d),
                                       flags + template + (cs._CSRC / "march_3d.cuh").read_text()))
    production = [w.program for w in windows.values()] + [ac_ext.program]
    built = cs.build_programs(units + production)
    print(f"[sweep] built {len(built)} libraries on {smi}", flush=True)

    def check(label, got, ref, k):
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        if not (all(bool(torch.isfinite(g).all()) for g in got)
                and err <= smoke.F32_STEP_RTOL * k * scale):
            raise AssertionError(f"{label} disagrees with its plain version: {err}")
        return err

    runs = []  # (label, fn, error, ptxas, k)
    outs = [torch.empty_like(data)]
    refs = {}  # (case, k): k plain steps

    def reference(case, k):
        if (case, k) not in refs:
            one = cs.multi_stencil_spec(windows[case].program, 1, f32)
            ref = [data]
            for _ in range(k):
                ref = s3.multi_stencil_3d_plain(ref, one)
            refs[(case, k)] = ref
        return refs[(case, k)]

    for group, b in zip(groups, built):
        lib = ctypes.CDLL(b["path"])
        for v in group:
            k = v["k"]
            fn = getattr(lib, f"variant_{v['index']}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            ins = (ctypes.c_void_p * 1)(data.data_ptr())
            out_ptrs = (ctypes.c_void_p * 1)(outs[0].data_ptr())

            def launch(fn=fn, ins=ins, out_ptrs=out_ptrs):
                err = fn(ctypes.addressof(ins), ctypes.addressof(out_ptrs), N, N, N,
                         torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise RuntimeError(f"variant launch failed with CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            ref = reference(v["case"], k)
            err = check(_label(v), outs, ref, k)
            ptx = " | ".join(smoke._ptxas_of(b["log"], "multi_stencil_3d_kernel", _needle(v)))
            runs.append((_label(v), launch, err, ptx, k))

    # the production wrappers at every k of their ladders, and the ext pass
    for case, window in windows.items():
        outs_p = [torch.empty_like(data)]
        for spec in window.specs:
            def serial_pass(spec=spec, outs_p=outs_p):
                s3.multi_stencil_3d([data], spec, outs=outs_p)

            serial_pass()
            torch.cuda.synchronize()
            err = check(f"{case} k={spec.k}", outs_p, s3.multi_stencil_3d_plain([data], spec),
                        spec.k)
            runs.append((f"production multi_stencil_3d {case} k={spec.k} tile {spec.tile}",
                         serial_pass, err, "", spec.k))
    gen = np.random.default_rng(5)
    ac_ext_spec = ac_ext.specs[0]
    shape = (N // 2 + 2 * ac_ext_spec.halo,) * 3
    ac_ins = [[torch.as_tensor(gen.uniform(-0.1, 0.1, shape), dtype=f32, device=device)]
              for _ in range(8)]
    ac_ext_outs = [[torch.empty_like(x[0])] for x in ac_ins]

    def ext_pass():
        e3.multi_stencil_ext_3d(ac_ins, ac_ext_outs, [[0] * 6] * 8, ac_ext_spec)

    ext_pass()
    torch.cuda.synchronize()
    interior = (slice(ac_ext_spec.halo, ac_ext_spec.halo + N // 2),) * 3
    err = max(check("ext", [o[0][interior]], e3.multi_stencil_ext_3d_plain(x, ac_ext_spec, [0] * 6),
                    ac_ext_spec.k) for x, o in zip(ac_ins, ac_ext_outs))
    runs.append((f"production multi_stencil_ext_3d allen-cahn 8x128^3 halo {ac_ext_spec.halo} "
                 f"k={ac_ext_spec.k} tile {ac_ext_spec.tile}", ext_pass, err, "", ac_ext_spec.k))

    if not production_only:  # SASS of the production kernel at the main pass: opcodes by count
        from torch_sde_sweep import _sass_histogram

        spec = windows["allen-cahn"].specs[0]
        print(f"[sweep] SASS of the production multi_stencil_3d kernel (Allen-Cahn, float, "
              f"k = {spec.k}, plan {spec.tile}): " + _sass_histogram(
                  Path(cc._nvcc()).parent / "cuobjdump", built[len(units)]["path"],
                  "multi_stencil_3d_kernel", "EfLi{}ELi{}ELi{}ELi{}E".format(spec.k, *spec.tile)),
              flush=True)

    times = [[smoke._cuda_ms(torch, fn, 50) for _, fn, _, _, _ in runs] for _ in range(2)]
    for j, (label, _, err, ptx, k) in enumerate(runs):
        print(f"[sweep] {label}: {times[0][j]:.4f} / {times[1][j]:.4f} ms (two rounds in turns, "
              f"{times[0][j] / k:.4f} ms per step), max_abs {err:.3e}; {ptx}", flush=True)
    print(smi)


if __name__ == "__main__":
    sys.exit(main())
