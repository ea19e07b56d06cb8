"""Design sweep of pde_tpu_torch's two Euler-Maruyama kernels on one NVIDIA GPU.

Builds two one-field steps at 4096² periodic fp32 and k = 8 into variants of
the template's ``sde_window_2d_kernel`` (``pde_tpu_torch/csrc/multi_stencil_2d.cuh``):

- ``kpz``: ``KPZInterfacePDE(nu=1, lmbda=1, noise=0.1)``, dt = 1e-3, the
  main path's pass;
- ``noise only``: the identity step of ``DiffusionPDE(0.0, noise=1.0)``
  (``chip_smoke._zero_rate_windows``), which leaves the noise path alone.

Variants of each: staged increments read with 1, 2, 3 or 5 of a thread's
rows of loads in flight (tile 64; 2 is the template's default), and irwin4
increments drawn in the kernel at tiles 64, 96 and 128, one, two or four
cells per loop trip (tile 64 and two cells are the defaults). Each variant
is held against its plain version (chip_smoke's fp32 tolerance) and timed
with CUDA events over 20 passes, all variants in turns, twice; beside them,
the deterministic pass of each step (the generated ``multi_stencil_2d``
without noise), the production wrappers, and the SASS opcode counts of the
production kernels.

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_sde_sweep.py [--production]

``--production`` skips the variants and the SASS and times only what any
checkout of the port has (the wrappers of every increment route of
``chip_smoke.SDE_ROUTES`` on both steps, the deterministic passes, and
``chip_smoke.py``'s Cahn-Hilliard 1024² k = 4 pass of row 7's template, 200
passes a reading): copied into an older checkout, it times that checkout's
kernels, so that old and new can be read in turns in one call.

One line per variant (both rounds' ms, error, ptxas' registers and spills),
then the card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import hashlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402  (the repository root's helpers)

K = 8
# (noise mode, tile, rows of staged loads in flight, drawn cells per loop trip)
VARIANTS = (
    ("staged", 64, 1, 1),
    ("staged", 64, 2, 1),
    ("staged", 64, 3, 1),
    ("staged", 64, 5, 1),
    ("irwin4", 64, 2, 1),
    ("irwin4", 64, 2, 2),
    ("irwin4", 64, 2, 4),
    ("irwin4", 96, 2, 2),
    ("irwin4", 128, 2, 2),
)


class _Unit:
    """A source for ``build_programs``: every variant of one step."""

    library = "sde_sweep"

    def __init__(self, source: str, template: str, flags: str):
        self.source = source
        self.digest = hashlib.sha256((source + template + flags).encode()).hexdigest()[:16]


def _source(cs, sde, stencil) -> str:
    lines = ['#include "multi_stencil_2d.cuh"', '#include "philox.cuh"', "",
             *cs.emit_program(stencil)]
    for i, (noise, tile, rows, unroll) in enumerate(VARIANTS):
        if noise == "staged":
            policy = "pde_tpu_torch::StagedNoise<float>"
            init = "{static_cast<const float*>(noise), static_cast<size_t>(n_rows) * n_cols}"
        else:
            policy = f"pde_tpu_torch::PhiloxNoise<float, pde_tpu_torch::{sde._LAW_ENUM[noise]}>"
            init = "{key0, key1, step0, static_cast<float>(scale)}"
        lines += [
            f'extern "C" int variant_{i}(const void* in, void* out, const void* noise, int n_rows,',
            "                          int n_cols, unsigned key0, unsigned key1, unsigned step0,",
            "                          double scale, void* stream) {",
            "  (void)noise, (void)key0, (void)key1, (void)step0, (void)scale;",
            f"  const {policy} policy{init};",
            f"  return pde_tpu_torch::launch_sde<Program, float, {K}, {tile}, {policy}, {rows}, "
            f"{unroll}>(in, out, n_rows, n_cols, stream, policy);",
            "}",
            "",
        ]
    return "\n".join(lines)


def _sass_histogram(cuobjdump: Path, library: str, *needles: str) -> str:
    """Opcode counts of the one kernel of `library` whose mangled name holds
    every needle, from ``cuobjdump -sass`` (static instructions, not executed)."""
    import collections
    import re
    import subprocess

    text = subprocess.run([str(cuobjdump), "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    for block in text.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        if all(n in name for n in needles):
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", block)
            counts = collections.Counter(op.split(".")[0] for op in ops)
            return f"{len(ops)} instructions; " + ", ".join(
                f"{op} {n}" for op, n in counts.most_common(16))
    return "kernel not found"


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sde_sweep: torch.cuda.is_available() is False; no result")
    production_only = sys.argv[1:] == ["--production"]

    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_sde_2d as sde
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    f32 = torch.float32
    grid = pde.UnitGrid([4096, 4096], periodic=True)
    data = torch.as_tensor(np.random.default_rng(11).uniform(-0.5, 0.5, grid.shape), dtype=f32,
                           device=device)
    state = pde.ScalarField(grid, data)
    windows = {}  # (rhs, route): the window of each increment route of chip_smoke
    for route, cfg, _ in smoke.SDE_ROUTES:
        with pde.config(cfg):
            windows[("kpz", route)] = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1) \
                .make_fused_euler_window(state, 1e-3)
    zero_rate, scale = smoke._zero_rate_windows(pde, sde, torch, grid, 1e-3)
    windows.update({("noise only", route): window for route, window in zero_rate.items()})
    inputs = {"kpz": data, "noise only": torch.zeros_like(data)}
    # row 7's template, which the SDE kernels share: chip_smoke's Cahn-Hilliard k = 4 pass
    ch_data = torch.as_tensor(np.random.default_rng(10).uniform(-0.1, 0.1, (1024, 1024)),
                              dtype=f32, device=device)
    ch_window = pde.PDE({"c": "laplace(c**3 - c - laplace(c))"}).make_fused_euler_window(
        pde.ScalarField(pde.UnitGrid([1024, 1024], periodic=True), ch_data), 1e-3)

    steps = {rhs: windows[(rhs, "normal")].program.stencil for rhs in inputs}
    units = {} if production_only else {
        rhs: _Unit(_source(cs, sde, stencil), cs._TEMPLATE.read_text() + sde._PHILOX.read_text(),
                   " ".join(cc._NVCC_FLAGS)) for rhs, stencil in steps.items()}
    production = [w.program for w in windows.values()] + list(steps.values()) + [
        ch_window.program]
    built = cs.build_programs(list(units.values()) + production)
    libs = {rhs: ctypes.CDLL(b["path"]) for rhs, b in zip(units, built)}
    logs = {rhs: b["log"] for rhs, b in zip(units, built)}
    print(f"[sweep] built {len(built)} libraries on {smi}", flush=True)

    ctl = (0x1234ABCD, 0x0BADF00D, 1000)
    gen = torch.Generator(device=device).manual_seed(12)
    out = torch.empty_like(data)
    runs = []  # (label, fn, error, ptxas)
    for rhs, x in inputs.items():
        staged_spec = windows[(rhs, "normal")].specs[0]
        kn_spec = windows[(rhs, "irwin4")].specs[0]
        assert staged_spec.k == kn_spec.k == K
        noise = (0.01 if rhs == "kpz" else scale) * torch.randn(
            (K, *grid.shape), generator=gen, dtype=f32, device=device)
        refs = {"staged": sde.sde_stencil_2d_plain(x, noise, staged_spec),
                "irwin4": sde.sde_kernel_noise_2d_plain(x, ctl, kn_spec)}
        for i, (mode, tile, rows, unroll) in enumerate(() if production_only else VARIANTS):
            fn = getattr(libs[rhs], f"variant_{i}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_uint] * 3 + [
                ctypes.c_double, ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def launch(fn=fn, x=x, noise=noise, kn_scale=kn_spec.scale):
                err = fn(x.data_ptr(), out.data_ptr(), noise.data_ptr(), *grid.shape, *ctl,
                         kn_scale, torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise RuntimeError(f"variant launch failed with CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            ref = refs[mode]
            err = float((out - ref).abs().max())
            tol = smoke.F32_STEP_RTOL * K * float(ref.abs().max())
            if not (bool(torch.isfinite(out).all()) and err <= tol):
                raise AssertionError(f"{rhs} variant {i} disagrees with its plain version: {err}")
            ptx = smoke._ptxas_of(logs[rhs], "sde_window_2d_kernel", f"EfLi{K}ELi{tile}E",
                                  "StagedNoise" if mode == "staged" else "PhiloxNoise",
                                  f"ELi{rows}ELi{unroll}E")
            label = f"rows={rows}" if mode == "staged" else f"cells per trip={unroll}"
            runs.append((f"{rhs} {mode} tile={tile} {label}",
                         launch, err, " | ".join(ptx)))
        det_spec = cs.multi_stencil_spec(steps[rhs], K, f32)
        runs.append((f"{rhs} deterministic pass (multi_stencil_2d, tile {det_spec.tile})",
                     lambda x=x, spec=det_spec: cs.multi_stencil_2d([x], spec, outs=[out]), 0.0,
                     ""))
        for route, _, kernel in smoke.SDE_ROUTES:  # the wrappers, as the windows call them
            spec = windows[(rhs, route)].specs[0]

            def wrapper_pass(x=x, noise=noise, spec=spec):
                if spec.program.noise == "staged":
                    return sde.sde_stencil_2d(x, noise, spec, out=out)
                return sde.sde_kernel_noise_2d(x, ctl, spec, out=out)

            runs.append((f"{rhs} production {route} ({kernel}, tile {spec.tile})", wrapper_pass,
                         0.0, ""))
    ch_spec = ch_window.specs[0]
    ch_out = [torch.empty_like(ch_data)]
    runs.append((f"Cahn-Hilliard 1024^2 k={ch_spec.k} pass (multi_stencil_2d, tile "
                 f"{ch_spec.tile}), 200 passes a reading",
                 lambda: cs.multi_stencil_2d([ch_data], ch_spec, outs=ch_out), 0.0, ""))

    # SASS of the production kernels at the main path's pass: opcodes by count
    if not production_only:
        cuobjdump = Path(cc._nvcc()).parent / "cuobjdump"
        for route in ("normal", "irwin4"):
            b = built[len(units) + list(windows).index(("kpz", route))]
            print(f"[sweep] SASS of the production {route} kernel (float, k = {K}, tile 64): "
                  + _sass_histogram(cuobjdump, b["path"], "sde_window_2d_kernel",
                                    f"EfLi{K}ELi64E"), flush=True)

    repeats = [200 if label.startswith("Cahn") else 20 for label, _, _, _ in runs]
    times = [[smoke._cuda_ms(torch, fn, n) for (_, fn, _, _), n in zip(runs, repeats)]
             for _ in range(2)]
    for j, (label, _, err, ptx) in enumerate(runs):
        print(f"[sweep] {label}: {times[0][j]:.4f} / {times[1][j]:.4f} ms (two rounds in turns), "
              f"max_abs {err:.3e}; {ptx}", flush=True)
    print(smi)


if __name__ == "__main__":
    sys.exit(main())
