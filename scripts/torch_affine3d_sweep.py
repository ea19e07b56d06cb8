"""Design sweep of pde_tpu_torch's two 3D affine Laplacian kernels on one NVIDIA GPU.

Times plans of the x-marching template (``march_3d`` of
``pde_tpu_torch/csrc/affine_laplace_3d.cuh``) on the main path's pass,
``DiffusionPDE(1.0)`` at dt = 0.05 on a 256³ periodic fp32 grid
(``uniform(-0.1, 0.1)``, seed 0), through the serial kernel (row 3) and, for
some, through the halo-extended kernel (row 11) over the eight 128³ blocks of
a 2x2x2 mesh (halo k, flags 0): the plan ``(cx, ty, tz)`` (x planes per
chunk, the output column tile) at k = 1 to 4.

Each variant is held against its plain version (chip_smoke's fp32 tolerance,
1e-6 x k relative to max|f|) and timed with CUDA events over 50 passes, all
variants in turns, twice; ptxas' registers and spills beside each, and the
SASS opcode counts of the production kernel at the main pass. Then the
production wrappers: the serial and the ext kernel at every k with their ms
per step, and, as passes that share none of this code, ``chip_smoke.py``'s
Allen-Cahn 256³ pass (``multi_stencil_3d``) and its ext pass over eight 128³
blocks (``multi_stencil_ext_3d``).

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_affine3d_sweep.py [--production]

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
DT = 0.05


def _variant(k: int, plan: tuple[int, int, int], ext: bool = False) -> dict:
    return {"k": k, "plan": plan, "ext": ext}


# one build unit per group, all built in parallel
GROUPS = (
    (  # k = 2, the main pass: x planes per chunk and the column tile
        _variant(2, (32, 32, 64), ext=True),
        _variant(2, (16, 32, 64)),
        _variant(2, (64, 32, 64)),
        _variant(2, (32, 16, 64)),
        _variant(2, (32, 32, 32)),
    ),
    (  # k = 1, 3 and 4
        _variant(1, (32, 32, 64), ext=True),
        _variant(1, (64, 32, 64)),
        _variant(3, (32, 32, 64), ext=True),
        _variant(3, (64, 32, 64)),
        _variant(4, (32, 32, 64), ext=True),
        _variant(4, (64, 32, 64)),
        _variant(4, (32, 16, 64)),
    ),
)


def _needle(v) -> str:
    """A piece of the mangled kernel names of variant `v` (float, periodic)."""
    return "IfLi{}ELi{}ELi{}ELi{}ELb1ELb1ELb1E".format(v["k"], *v["plan"])


def _label(v) -> str:
    return f"k={v['k']} plan={v['plan']}"


class _Unit:
    """A source for ``build_programs``: one group of variants."""

    library = "affine3d_sweep"

    def __init__(self, source: str, templates: str, flags: str):
        self.source = source
        self.digest = hashlib.sha256((source + templates + flags).encode()).hexdigest()[:16]


def _source(group, first: int) -> str:
    lines = ['#include "affine_laplace_ext_3d.cuh"', ""]
    for i, v in enumerate(group, first):
        args = f"float, {v['k']}, {', '.join(map(str, v['plan']))}, true, true, true"
        lines += [
            f'extern "C" int variant_{i}(const void* in, void* out, const int* ints, '
            "const double* doubles, void* stream) {",
            f"  return pde_tpu_torch::launch_affine_3d<{args}>(in, out, ints, doubles, stream);",
            "}",
        ]
        if v["ext"]:
            lines += [
                f'extern "C" int ext_variant_{i}(const void* const* ins, void* const* outs, '
                "const int* edges, const int* ints, const double* doubles, void* stream) {",
                f"  return pde_tpu_torch::launch_affine_ext_3d<{args}>(ins, outs, edges, ints, "
                "doubles, stream);",
                "}",
            ]
    return "\n".join(lines) + "\n"


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_affine3d_sweep: torch.cuda.is_available() is False; no result")
    production_only = sys.argv[1:] == ["--production"]

    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_cartesian_3d as c3
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    f32 = torch.float32
    grid = pde.UnitGrid([N] * 3, periodic=True)
    state = pde.ScalarField.random_uniform(grid, -0.1, 0.1, dtype=f32, device=device,
                                           rng=np.random.default_rng(0))
    data = state.data
    out = torch.empty_like(data)
    ac_window = pde.PDE(smoke.ALLEN_CAHN_3D).make_fused_euler_window(state, DT)
    ac_ext = smoke._ext_windows_3d(pde, torch, device)["allen-cahn periodic"]

    def ext_buffers(halo, seed):
        gen = np.random.default_rng(seed)
        shape = (N // 2 + 2 * halo,) * 3
        return [torch.as_tensor(gen.uniform(-0.1, 0.1, shape), dtype=f32, device=device)
                for _ in range(8)]

    units, first = [], 0
    if not production_only:
        templates = (c3._TEMPLATE.read_text() + e3._TEMPLATE.read_text())
        for group in GROUPS:
            units.append(_Unit(_source(group, first), templates, " ".join(cc._NVCC_FLAGS)))
            first += len(group)
    production = [c3.kernel_source((True,) * 3), e3.affine_ext_source((True,) * 3),
                  ac_window.program, ac_ext.program]
    built = cs.build_programs(units + production)
    print(f"[sweep] built {len(built)} libraries on {smi}", flush=True)

    runs = []  # (label, fn, error, ptxas)
    specs = {k: c3.affine_laplace_3d_spec(grid, a=1.0, b=DT, k=k, dtype=f32) for k in range(1, 5)}
    refs = {k: c3.affine_laplace_3d_plain(data, spec) for k, spec in specs.items()}

    def check(label, got, ref, k):
        err = float((got - ref).abs().max())
        if not (bool(torch.isfinite(got).all())
                and err <= smoke.F32_STEP_RTOL * k * float(ref.abs().max())):
            raise AssertionError(f"{label} disagrees with its plain version: {err}")
        return err

    i = 0
    for group, unit, b in zip(GROUPS, units, built):
        lib = ctypes.CDLL(b["path"])
        for v in group:
            k, plan = v["k"], v["plan"]
            spec = specs[k]
            doubles = (ctypes.c_double * 23)(spec.a, spec.b, *spec.scales,
                                             *[x for side in spec.sides for x in side])
            ints = (ctypes.c_int * 10)(*spec.shape, *plan, k, 1, 1, 1)
            fn = getattr(lib, f"variant_{i}")
            fn.argtypes = [ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int

            def launch(fn=fn, ints=ints, doubles=doubles):
                err = fn(data.data_ptr(), out.data_ptr(), ctypes.addressof(ints),
                         ctypes.addressof(doubles), torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise RuntimeError(f"variant launch failed with CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            err = check(_label(v), out, refs[k], k)
            ptx = " | ".join(smoke._ptxas_of(b["log"], "affine_laplace_3d_kernel", _needle(v)))
            runs.append((f"serial {_label(v)}", launch, err, ptx))
            if v["ext"]:
                ext_spec = e3.affine_laplace_ext_3d_spec(grid, (N // 2,) * 3, a=1.0, b=DT, k=k,
                                                         halo=k, dtype=f32)
                ins, outs = ext_buffers(k, 1), ext_buffers(k, 2)
                xfn = getattr(lib, f"ext_variant_{i}")
                xfn.argtypes = [ctypes.c_void_p] * 6
                xfn.restype = ctypes.c_int
                in_ptrs = (ctypes.c_void_p * 8)(*[x.data_ptr() for x in ins])
                out_ptrs = (ctypes.c_void_p * 8)(*[x.data_ptr() for x in outs])
                edges = (ctypes.c_int * 48)()
                xints = (ctypes.c_int * 12)(8, *ext_spec.shape, k, *plan, k, 1, 1, 1)

                def ext_launch(xfn=xfn, in_ptrs=in_ptrs, out_ptrs=out_ptrs, edges=edges,
                               xints=xints, doubles=doubles, ins=ins, outs=outs):
                    err = xfn(ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs),
                              ctypes.addressof(edges), ctypes.addressof(xints),
                              ctypes.addressof(doubles),
                              torch.cuda.current_stream(device).cuda_stream)
                    if err:
                        raise RuntimeError(f"ext variant launch failed with CUDA error {err}")

                ext_launch()
                torch.cuda.synchronize()
                interior = (slice(k, k + N // 2),) * 3
                xerr = max(check(f"ext {_label(v)}", o[interior],
                                 e3.affine_laplace_ext_3d_plain(x, ext_spec, [0] * 6), k)
                           for x, o in zip(ins, outs))
                xptx = " | ".join(smoke._ptxas_of(b["log"], "affine_laplace_ext_3d_kernel",
                                                  _needle(v)))
                runs.append((f"ext 8x128^3 {_label(v)}", ext_launch, xerr, xptx))
            i += 1

    # the production wrappers at every k, and passes that share none of this code
    for k, spec in specs.items():
        def serial_pass(spec=spec):
            c3.affine_laplace_3d(data, spec, out=out)

        serial_pass()
        torch.cuda.synchronize()
        err = check(f"affine_laplace_3d k={k}", out, refs[k], k)
        runs.append((f"production affine_laplace_3d k={k} tile {spec.tile}", serial_pass, err, ""))
    for k in range(1, 5):
        ext_spec = e3.affine_laplace_ext_3d_spec(grid, (N // 2,) * 3, a=1.0, b=DT, k=k, halo=k,
                                                 dtype=f32)
        ins, outs = ext_buffers(k, 3), ext_buffers(k, 4)
        flags0 = [[0] * 6] * 8

        def ext_pass(ins=ins, outs=outs, ext_spec=ext_spec, flags0=flags0):
            e3.affine_laplace_ext_3d(ins, outs, flags0, ext_spec)

        ext_pass()
        torch.cuda.synchronize()
        interior = (slice(k, k + N // 2),) * 3
        err = max(check(f"affine_laplace_ext_3d k={k}", o[interior],
                        e3.affine_laplace_ext_3d_plain(x, ext_spec, [0] * 6), k)
                  for x, o in zip(ins, outs))
        runs.append((f"production affine_laplace_ext_3d 8x128^3 halo {k} k={k} tile "
                     f"{ext_spec.tile}", ext_pass, err, ""))
    ac_spec = ac_window.specs[0]
    ac_outs = [torch.empty_like(data)]
    runs.append((f"Allen-Cahn 256^3 k={ac_spec.k} pass (multi_stencil_3d, tile {ac_spec.tile})",
                 lambda: s3.multi_stencil_3d([data], ac_spec, outs=ac_outs), 0.0, ""))
    ac_ext_spec = ac_ext.specs[0]
    ac_ins = [[x] for x in ext_buffers(ac_ext_spec.halo, 5)]
    ac_ext_outs = [[x] for x in ext_buffers(ac_ext_spec.halo, 6)]
    runs.append((f"Allen-Cahn 8x128^3 k={ac_ext_spec.k} ext pass (multi_stencil_ext_3d, tile "
                 f"{ac_ext_spec.tile})",
                 lambda: e3.multi_stencil_ext_3d(ac_ins, ac_ext_outs, [[0] * 6] * 8, ac_ext_spec),
                 0.0, ""))

    if not production_only:  # SASS of the production kernel at the main pass: opcodes by count
        from torch_sde_sweep import _sass_histogram

        plan = c3.march_plan_3d(2, 4)
        print(f"[sweep] SASS of the production affine_laplace_3d kernel (float, k = 2, plan "
              f"{plan}, periodic): " + _sass_histogram(
                  Path(cc._nvcc()).parent / "cuobjdump", built[len(units)]["path"],
                  "affine_laplace_3d_kernel", "IfLi2ELi{}ELi{}ELi{}ELb1ELb1ELb1E".format(*plan)),
              flush=True)

    times = [[smoke._cuda_ms(torch, fn, 50) for _, fn, _, _ in runs] for _ in range(2)]
    for j, (label, _, err, ptx) in enumerate(runs):
        k = next((int(part[2:]) for part in label.split() if part.startswith("k=")), None)
        per_step = f", {times[0][j] / k:.4f} ms per step" if k and "Allen" not in label else ""
        print(f"[sweep] {label}: {times[0][j]:.4f} / {times[1][j]:.4f} ms (two rounds in turns"
              f"{per_step}), max_abs {err:.3e}; {ptx}", flush=True)
    print(smi)


if __name__ == "__main__":
    sys.exit(main())
