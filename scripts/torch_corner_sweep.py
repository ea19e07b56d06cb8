"""Design sweep of the 9-point corner-weight mode of kernel #1 on one NVIDIA GPU.

Times the 9-point row march (``CornerRowMarch`` of
``pde_tpu_torch/csrc/affine_march_2d.cuh``) on the main path's pass under
``operators.cartesian.laplacian_2d_corner_weight`` = 1/3: ``DiffusionPDE(0.1)``
at dt = 0.1 on a periodic 4096² ``UnitGrid`` (``uniform(0, 1)``, seed 21),
beside the 5-point march on the same grid, so that what the diagonals cost
shows apart:

- the production wrappers: the 9-point mode at k = 1-8 (fp32) and k = 4, 8
  (fp64), the 5-point march at k = 4, 8 and 12 (fp32);
- variants of the 9-point kernel, the template as it is with other launch
  bounds and prefetch: blocks per SM 2, 3 and 4 (the plan's) with 1 or 3
  level-0 rows in flight, fp32 at k = 4, 6 and 8; fp64 with 1 and 2 (the
  plan's) blocks per SM at k = 4 and 8 (with 2, 1 and 3 rows in flight).

Each is held against its plain version (1e-6 x k relative to max|f| in fp32,
1e-12 in fp64) and timed with CUDA events over 50 passes, all in turns,
twice; ptxas' registers and spills beside each.

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_corner_sweep.py

One line per wrapper and variant (both rounds' ms, ms per step, share of the
byte bound, error, registers and spills), then the card's name and power
limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import hashlib
import sys
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402  (the repository root's helpers)

REPEATS = 50
N = 4096
KEY = "operators.cartesian.laplacian_2d_corner_weight"
F32_KS = (4, 6, 8)
F64_KS = (4, 8)


class _Variant:
    """A build unit of one variant of the 9-point kernel: the template as it
    is, its entry points at other launch bounds and prefetch."""

    library = "affine_laplace_corner_2d"

    def __init__(self, cc, min_blocks: int, prefetch: int):
        self.min_blocks, self.prefetch = min_blocks, prefetch
        self.f64 = min_blocks <= cc.CORNER_MIN_BLOCKS[8]
        lines = ['#include "affine_march_2d.cuh"']
        for ctype, suffix, itemsize, ks in (("float", "f32", 4, F32_KS),
                                            ("double", "f64", 8, F64_KS)):
            if itemsize == 8 and not self.f64:
                continue
            lines += [f'extern "C" int affine_laplace_corner_2d_{suffix}(const void* in, '
                      "void* out, const int* ints, const double* doubles, void* stream) {",
                      "  switch (ints[3]) {"]
            for k in ks:
                tx, threads, _, _ = cc.corner_row_plan(k, itemsize)
                lines.append(f"    case {k}: return pde_tpu_torch::launch_affine_corner_2d<"
                             f"{ctype}, {k}, {tx}, {threads}, {prefetch}, {min_blocks}, true, "
                             "true>(in, out, ints, doubles, stream);")
            lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
        self.source = "\n".join(lines)
        template = Path(cc.__file__).resolve().parent.parent / "csrc" / "affine_march_2d.cuh"
        text = self.source + template.read_text() + " ".join(cc._NVCC_FLAGS)
        self.digest = hashlib.sha256(text.encode()).hexdigest()[:16]

    @property
    def label(self) -> str:
        return f"variant {self.min_blocks} blocks/SM, {self.prefetch} rows in flight"


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_corner_sweep: no CUDA device")
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    smi = smoke._nvidia_smi()
    cells = N * N
    f32, f64 = torch.float32, torch.float64
    grid = pde.UnitGrid([N, N], periodic=True)
    variants = [_Variant(cc, blocks, prefetch) for blocks in (2, 3, 4) for prefetch in (1, 3)]
    variants += [_Variant(cc, 1, 3)]
    units = [cc.kernel_source((True, True)), cc.kernel_source((True, True), cc.CORNER_LIBRARY)]
    builds = cs.build_programs(units + variants)
    logs = {unit.digest: built["log"] for unit, built in zip(units + variants, builds,
                                                             strict=True)}
    print(f"[corner sweep] {len(units) + len(variants)} libraries built", flush=True)

    gen = np.random.default_rng(21)
    data = {dtype: torch.as_tensor(gen.uniform(0, 1, grid.shape), dtype=dtype, device=device)
            for dtype in (f32, f64)}
    outs = {dtype: torch.empty_like(x) for dtype, x in data.items()}
    runs = []  # (label, k, dtype, fn, reference, registers)

    def wrapper_run(label, spec, library):
        dtype = spec.dtype
        tx, threads, _, _ = spec.tile
        tag = "I{}Li{}ELi{}ELi{}E".format("f" if dtype == f32 else "d", spec.k, tx, threads)
        unit = cc.kernel_source((True, True), library)
        regs = smoke._ptxas_of(logs[unit.digest], f"{library}_kernel", tag)
        runs.append((f"{label} {str(dtype)[6:]}", spec.k, dtype,
                     lambda d=data[dtype], s=spec, o=outs[dtype]:
                     cc.affine_laplace_2d(d, s, out=o),
                     cc.affine_laplace_2d_plain(data[dtype], spec), regs))

    for k in (4, 8, 12):
        wrapper_run("5-point wrapper", cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k,
                                                              dtype=f32), "affine_laplace_2d")
    with pde.config({KEY: 1 / 3}):
        specs = {(dtype, k): cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=dtype)
                 for dtype, ks in ((f32, range(1, 9)), (f64, F64_KS)) for k in ks}
    for (dtype, k), spec in specs.items():
        wrapper_run("9-point wrapper", spec, cc.CORNER_LIBRARY)
    for variant in variants:
        lib = ctypes.CDLL(builds[len(units) + variants.index(variant)]["path"])
        for dtype, ks in ((f32, F32_KS), (f64, F64_KS if variant.f64 else ())):
            if not ks:
                continue
            fn = getattr(lib, f"affine_laplace_corner_2d_{'f32' if dtype == f32 else 'f64'}")
            fn.argtypes = [ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
            for k in ks:
                spec = replace(specs[(dtype, k)], tile=(*specs[(dtype, k)].tile[:2],
                                                        variant.prefetch, variant.min_blocks))
                tx, threads, prefetch, _ = spec.tile
                ints = (ctypes.c_int * 9)(N, N, cc.block_plan(spec)[1], k, tx, threads,
                                          prefetch, 1, 1)
                doubles = cc.step_doubles(spec)

                def launch(d=data[dtype], o=outs[dtype], i=ints, dd=doubles, f=fn):
                    err = f(d.data_ptr(), o.data_ptr(), ctypes.addressof(i),
                            ctypes.addressof(dd), torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant launch failed with CUDA error {err}")
                    return o

                tag = "I{}Li{}ELi{}ELi{}ELi{}ELi{}E".format(
                    "f" if dtype == f32 else "d", k, tx, threads, prefetch, variant.min_blocks)
                runs.append((f"{variant.label} {str(dtype)[6:]}", k, dtype, launch,
                             cc.affine_laplace_2d_plain(data[dtype], spec),
                             smoke._ptxas_of(logs[variant.digest], "corner_2d_kernel", tag)))

    times = {}
    for _ in range(2):  # every run in turns, twice
        for i, (_, _, _, fn, _, _) in enumerate(runs):
            times.setdefault(i, []).append(smoke._cuda_ms(torch, fn, REPEATS))
    for i, (label, k, dtype, fn, ref, regs) in enumerate(runs):
        got = fn()
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        tol = (smoke.F64_TOL if dtype == f64 else smoke.F32_STEP_RTOL * k) * scale
        itemsize = 8 if dtype == f64 else 4
        bound = smoke._bound(2 * cells * itemsize, smoke.CORNER_FLOPS * k * cells)[0]
        ms = times[i]
        print(f"[corner sweep] {label} k={k}: {ms[0]:.4f} / {ms[1]:.4f} ms "
              f"({min(ms) / k:.5f} a step, {bound / min(ms):.1%} of the bound); "
              f"max_rel {err / scale:.2e} {'ok' if err <= tol else 'FAIL'}; "
              f"{' | '.join(regs)}", flush=True)
    print(smi)


if __name__ == "__main__":
    main()
